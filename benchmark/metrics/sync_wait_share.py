"""Layer: launch path.  The CG's host waits on the device: host seconds in
the port's ``cg.test`` spans (the reads of the stopping test and of the
returned residual) over those in ``cg``, traced segment.  Near 0 while
the host sets the pace, it rises as the host gets ahead of the device.
Moves solve_ms."""

from benchmark import port_spans


def read(ctx):
    return port_spans.share(port_spans.report(), lambda n: n == "cg.test", "cg")
