"""Layer: solver.  The preconditioner's share of the CG: host seconds in
the port's ``vcycle`` spans over those in its ``cg`` spans, traced
segment.  Moves solve_ms."""

from benchmark import port_spans


def read(ctx):
    return port_spans.share(port_spans.report(), lambda n: n == "vcycle", "cg")
