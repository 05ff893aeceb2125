"""The port's own spans, for the per-layer metrics that read them.

The port records its spans (``arcanefem_tpu_torch/utils/tracing.py``)
only while ``torch.profiler`` records, so in a ``--trace 1`` run the
report holds the traced segment alone.  A port without the tracing
module, or a run in which no span was recorded, gives no report, and
each reader then gives None.
"""

from __future__ import annotations


def report() -> dict:
    """The port's span report ({name: {calls, incl_s, self_s, parent,
    counts}}), or {} where the port records none."""
    try:
        from arcanefem_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.report()


def share(rep: dict, part, whole: str) -> float | None:
    """Inclusive host seconds of the spans whose name satisfies ``part``
    over those of the span ``whole``; None without ``whole``."""
    total = rep.get(whole, {}).get("incl_s", 0.0)
    if total <= 0.0:
        return None
    return sum(r["incl_s"] for name, r in rep.items() if part(name)) / total


def level_of(name: str) -> int | None:
    """l of a ``vcycle.l{l}.<phase>`` span name, else None."""
    parts = name.split(".")
    if len(parts) == 3 and parts[0] == "vcycle" and parts[1][:1] == "l" \
            and parts[1][1:].isdigit():
        return int(parts[1][1:])
    return None
