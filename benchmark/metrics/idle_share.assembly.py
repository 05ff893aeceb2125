"""Layer: device.  1 - device busy / traced window, assembly traffic.
Moves assembly_mdofs."""

from benchmark.core import idle_share


def read(ctx):
    if ctx["window"]["kind"] != "stream":
        return None
    return idle_share(ctx.get("trace"))
