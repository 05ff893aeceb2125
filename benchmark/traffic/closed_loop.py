"""Closed loop, one client, one load case in flight.

Each load case is due when the previous one ends.  Its parameters are
drawn from the seed, each uniform in the range its mix gives under
``draws``.  A case is timed on the host clock from its start to the
device's synchronise; the window ends with the first case that ends at
or after ``seconds``, and every case started counts.

``check_sample`` cases of the window, drawn from the seed (a reservoir
sample), and the window's last case are kept for the check.  A case
fails when its solver stops above the configuration's ``rtol`` (the
residual it returns), reaches the configuration's ``max_iter``
iterations, or gives a non-finite solution or residual.
"""

from __future__ import annotations

import time

import torch


def draw(rng, draws: dict) -> dict:
    return {k: float(rng.uniform(lo, hi)) for k, (lo, hi) in sorted(draws.items())}


def warmup(system, mix: dict, rng) -> None:
    """Every shape of the window, twice: the first call loads and builds."""
    for _ in range(2):
        system.case(draw(rng, mix["draws"]))
    system.sync()


def window(system, mix: dict, seconds: float, rngs: dict, events: bool = False) -> dict:
    k_keep = int(mix["check_sample"])
    cases, finite, samples = [], [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        p = draw(rngs["draw"], mix["draws"])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if events else None
        t0 = time.perf_counter()
        out = system.case(p, ev)
        system.sync()
        t1 = time.perf_counter()
        cases.append({"ms": (t1 - t0) * 1e3, "iterations": out["iterations"],
                      "rel": out["rel"], "ev": ev})
        finite.append(torch.isfinite(out["x"]).all())
        i = len(cases) - 1
        if i < k_keep:
            samples.append(system.keep(out))
        else:
            j = int(rngs["sample"].integers(0, i + 1))
            if j < k_keep:
                samples[j] = system.keep(out)
        if t1 >= deadline:
            break
    finite = torch.stack(finite).cpu().tolist()
    failed = sum(1 for c, ok in zip(cases, finite)
                 if not ok or not c["rel"] <= system.rtol
                 or c["iterations"] >= system.max_iter)
    for c in cases:
        ev = c.pop("ev")
        if ev:
            c["pre_ms"] = ev[0].elapsed_time(ev[1])
            c["cg_ms"] = ev[1].elapsed_time(ev[2])
    return {"kind": "closed_loop", "window_s": t1 - t_start, "units": len(cases),
            "failed": failed, "cases": cases, "samples": samples,
            "last": system.keep(out, last=True)}


def traced(system, mix: dict, seconds: float, rng, span) -> int:
    """Load cases for ``seconds`` under a profiler: the count."""
    n, t_end = 0, time.perf_counter() + seconds
    while True:
        with span("case"):
            system.case(draw(rng, mix["draws"]), span=span)
            system.sync()
        n += 1
        if time.perf_counter() >= t_end:
            return n
