"""Layer: device.  1 - device busy / traced window, solve traffic.
Moves solve_ms."""

from benchmark.core import idle_share


def read(ctx):
    if ctx["window"]["kind"] != "closed_loop":
        return None
    return idle_share(ctx.get("trace"))
