"""Layer: solver.  The coarse chain's share of the V-cycle: host seconds in
the port's ``vcycle.l{l}.*`` spans of levels l >= 1 and in
``vcycle.coarse``, over those in ``vcycle``, traced segment.  Moves
solve_ms."""

from benchmark import port_spans


def _coarse(name):
    level = port_spans.level_of(name)
    return name == "vcycle.coarse" or (level is not None and level >= 1)


def read(ctx):
    return port_spans.share(port_spans.report(), _coarse, "vcycle")
