"""Phase timers — the `[ArcaneFem-Timer]` lines + JSON stats dump.

The port's copy of ``arcanefem_tpu/fem/timer.py``.  Mirrors the
reference's wall-clock phase instrumentation
(modules/poisson/FemModule.cc:28-39,416-420 `_printArcaneFemTime`) and the
testlab JSON time-stats dump (modules/testlab/FemModule.cc:19-56):
``meta`` and ``dump_json``.

One change: where the process has initialised CUDA, each phase ends with
``torch.cuda.synchronize()``, so that a phase's time is the card's work
and not the time it took to queue its launches (the JAX models end their
solve phase with ``block_until_ready`` for the same reason).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

import torch


class PhaseTimer:
    def __init__(self, verbose: bool = True):
        self.stats: dict[str, float] = {}
        self.meta: dict[str, float | int | str] = {}
        self.verbose = verbose

    @contextmanager
    def phase(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.stats[label] = self.stats.get(label, 0.0) + dt
            if self.verbose:
                print(f"[ArcaneFem-Timer] {label:<38} = {dt}")

    def dump_json(self, path: str, **meta) -> None:
        payload = {**self.meta, **meta, "time_stats": self.stats}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
