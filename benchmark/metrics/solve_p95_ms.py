"""The 95th percentile of every load case's host-clock time (ms)."""

from benchmark.core import p95


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "closed_loop" or not w["cases"]:
        return None
    return p95(c["ms"] for c in w["cases"])
