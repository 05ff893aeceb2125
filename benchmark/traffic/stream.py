"""Back-to-back assemblies on one stream, the host synchronising every
``sync_every``.

Each assembly takes one coordinate set of the system's bank of ``bank``,
drawn from the seed.  The window ends with the first synchronise at or
after ``seconds``; every assembly enqueued before it counts.  The
window's first assembly (a copy) and its last are kept for the check.
The last assembly of each group is checked for non-finite values; a
group whose last assembly has one counts as failed, all of it.
"""

from __future__ import annotations

import time

import torch


def warmup(system, mix: dict, rng) -> None:
    for k in range(int(mix["sync_every"])):
        system.assemble(k % int(mix["bank"]))
    system.sync()


def window(system, mix: dict, seconds: float, rngs: dict, events: bool = False) -> dict:
    group, bank = int(mix["sync_every"]), int(mix["bank"])
    first, finite = None, []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        for k in rngs["draw"].integers(0, bank, size=group).tolist():
            vals = system.assemble(k)
            if first is None:
                first = system.keep({"k": k, "vals": vals})
        finite.append(torch.isfinite(vals).all())
        system.sync()
        t1 = time.perf_counter()
        if t1 >= deadline:
            break
    bad = sum(1 for ok in torch.stack(finite).cpu().tolist() if not ok)
    return {"kind": "stream", "window_s": t1 - t_start, "units": group * len(finite),
            "failed": group * bad, "cases": [], "samples": [first],
            "last": system.keep({"k": k, "vals": vals}, last=True)}


def traced(system, mix: dict, seconds: float, rng, span) -> int:
    """Groups of assemblies for ``seconds`` under a profiler: the count."""
    group, bank = int(mix["sync_every"]), int(mix["bank"])
    n, t_end = 0, time.perf_counter() + seconds
    while True:
        with span("group"):
            for k in rng.integers(0, bank, size=group).tolist():
                with span("assembly"):
                    system.assemble(k)
            system.sync()
        n += group
        if time.perf_counter() >= t_end:
            return n
