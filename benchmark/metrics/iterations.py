"""Layer: solver.  CG iterations per load case, the mean over the
window, as the port's pcg returns them.  Moves solve_ms."""


def read(ctx):
    cases = ctx["window"]["cases"]
    if not cases:
        return None
    return sum(c["iterations"] for c in cases) / len(cases)
