"""Layer: assembly and preconditioner build.  CUDA-event time from a
load case's start to its CG start, the mean (ms).  Moves solve_ms."""


def read(ctx):
    cases = [c for c in ctx["window"]["cases"] if "pre_ms" in c]
    if not cases:
        return None
    return sum(c["pre_ms"] for c in cases) / len(cases)
