"""Layer: launch path.  The port's kernel launches counted over the
window (its launch counters), per load case.  Moves solve_ms."""


def read(ctx):
    w, d = ctx["window"], ctx.get("launches")
    if w["kind"] != "closed_loop" or not d or not w["units"]:
        return None
    return sum(d.values()) / w["units"]
