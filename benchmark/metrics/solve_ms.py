"""Time to solution of one load case: the window over the cases
completed in it (ms)."""


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "closed_loop" or not w["units"]:
        return None
    return w["window_s"] * 1e3 / w["units"]
