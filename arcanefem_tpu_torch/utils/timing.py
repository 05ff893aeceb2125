"""Device timing with CUDA events.

The counterpart of ``arcanefem_tpu/utils/timing.py::time_op``: independent
calls on a fixed input, warmed first, the best of ``outer`` repeats.
CUDA events bracket the calls on the current stream, so the figure is the
device's time for the work, launch gaps included.  :func:`slope_ms` is the
profilers' per-component time (``tools/profile_unstr.py``,
``tools/profile_iter.py``).
"""

from __future__ import annotations

import time

import torch


def time_op(fn, *args, reps: int = 5, outer: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_op measures on a CUDA device; none is available")
    best = float("inf")
    for _ in range(outer):
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / reps)
    return best


def elapsed_s(fn, device) -> tuple[float, object]:
    """(seconds, result) of one call of ``fn()`` on ``device``: CUDA events
    around it on a CUDA device (after a synchronisation), the host clock
    on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def slope_ms(step, v: torch.Tensor, k1: int, k2: int, reps: int = 3) -> float:
    """Milliseconds per application of ``step`` (a vector -> the next
    vector), as the JAX package's profilers time a component: the slope
    (t(k2) − t(k1)) / (k2 − k1) of the time of k applications in a row
    from ``v`` (:func:`elapsed_s`), which cancels the fixed cost of a run,
    with the best of ``reps`` runs at each k, after one untimed run; never
    below 0."""
    def run(k: int) -> float:
        def loop():
            x = v
            for _ in range(k):
                x = step(x)
            return x

        return elapsed_s(loop, v.device)[0]

    run(1)
    t1 = min(run(k1) for _ in range(reps))
    t2 = min(run(k2) for _ in range(reps))
    return max(t2 - t1, 0.0) / (k2 - k1) * 1e3
