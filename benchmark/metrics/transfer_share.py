"""Layer: solver.  The transfers' share of the V-cycle: host seconds in
the port's ``vcycle.l{l}.restrict`` and ``vcycle.l{l}.prolong`` spans,
every level, over those in ``vcycle``, traced segment.  Moves
solve_ms."""

from benchmark import port_spans


def _transfer(name):
    return port_spans.level_of(name) is not None and \
        name.endswith((".restrict", ".prolong"))


def read(ctx):
    return port_spans.share(port_spans.report(), _transfer, "vcycle")
