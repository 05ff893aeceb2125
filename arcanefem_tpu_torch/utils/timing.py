"""Device timing with CUDA events.

The counterpart of ``arcanefem_tpu/utils/timing.py::time_op``: independent
calls on a fixed input, warmed first, the best of ``outer`` repeats.
CUDA events bracket the calls on the current stream, so the figure is the
device's time for the work, launch gaps included.
"""

from __future__ import annotations

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
