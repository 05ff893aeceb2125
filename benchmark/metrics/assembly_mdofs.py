"""Assembly throughput: DoF x assemblies completed / window (MDoF/s)."""


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "stream" or not w["units"]:
        return None
    return ctx["n_dofs"] * w["units"] / w["window_s"] / 1e6
