"""Layer: solver.  CUDA-event time of the CG calls over their
iterations, all cases of the window (ms).  Moves solve_ms."""


def read(ctx):
    cases = [c for c in ctx["window"]["cases"] if "cg_ms" in c]
    its = sum(c["iterations"] for c in cases)
    if not its:
        return None
    return sum(c["cg_ms"] for c in cases) / its
