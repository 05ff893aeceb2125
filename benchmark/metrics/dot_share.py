"""Layer: solver.  The dot products' share of the CG: host seconds in the
port's ``cg.dot`` spans over those in ``cg``, traced segment.  Moves
solve_ms."""

from benchmark import port_spans


def read(ctx):
    return port_spans.share(port_spans.report(), lambda n: n == "cg.dot", "cg")
