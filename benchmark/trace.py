"""The traced segment of a ``--trace 1`` run, read from ``torch.profiler``.

After the measured window the traffic runs for a short while more under
the profiler.  From its events:

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills), in seconds; ``window_s``: the segment's host-clock
  length; ``units``: load cases or assemblies run in it;
- ``device_ops``: seconds of device time by operation name, most first;
- ``idle_gaps``: the gaps between the device's busy intervals, in
  seconds, summed by what the host was doing at each gap's middle: the
  harness span (``case``, ``pcg``, ...) that held it and the innermost
  host operation, or ``python`` where no operation was open.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

TOP = 10


def _events(prof, spans: set):
    """(device events, host events) as (start_us, end_us, name) lists.
    The harness's spans also appear on the device's timeline, as
    annotations that cover a whole case: they are not device work."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        item = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type != cuda:
            host.append(item)
        elif e.name not in spans:
            dev.append(item)
    return dev, host


def merged(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gap_labels(gaps, host, spans: set) -> list[str]:
    """What the host was doing at each gap's middle (see module doc)."""
    if not gaps:
        return []
    mids = np.array([(s + e) / 2 for s, e in gaps])
    ops = sorted((s, e, n) for s, e, n in host if n not in spans)
    outer = [(s, e, n) for s, e, n in host if n in spans]
    labels = ["python"] * len(gaps)
    if ops:
        starts = np.array([o[0] for o in ops])
        ends = np.array([o[1] for o in ops])
        idx = np.searchsorted(starts, mids, side="right") - 1
        found = np.full(len(gaps), -1)
        for _ in range(64):  # walk back past siblings that ended earlier
            ok = (idx >= 0) & (found < 0)
            hit = ok & (ends[np.maximum(idx, 0)] >= mids)
            found[hit] = idx[hit]
            idx = np.where(ok & ~hit, idx - 1, idx)
        labels = [ops[f][2] if f >= 0 else "python" for f in found]
    span_of = np.full(len(gaps), "", dtype=object)
    for s, e, n in sorted(outer, key=lambda t: t[1] - t[0], reverse=True):
        # mids ascend (the gaps do); the innermost span is set last and wins
        span_of[np.searchsorted(mids, s):np.searchsorted(mids, e, side="right")] = n
    return [f"{sp}/{lb}" if sp else lb for sp, lb in zip(span_of, labels)]


def summarise(dev, host, window_s: float, units: int, spans: set) -> tuple[dict, dict]:
    """(summary, breakdown) of a segment's events."""
    busy = merged((s, e) for s, e, _ in dev)
    by_op = defaultdict(float)
    for s, e, n in dev:
        by_op[n] += (e - s) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by_gap = defaultdict(float)
    for (s, e), lb in zip(gaps, gap_labels(gaps, host, spans)):
        by_gap[lb] += (e - s) / 1e6
    summary = {"busy_s": sum(e - s for s, e in busy) / 1e6, "window_s": window_s,
               "units": units}
    breakdown = {
        "device_ops": [[n, v] for n, v in sorted(by_op.items(), key=lambda t: -t[1])[:TOP]],
        "idle_gaps": [[n, v] for n, v in sorted(by_gap.items(), key=lambda t: -t[1])[:TOP]]}
    return summary, breakdown


SPANS = ("case", "assemble", "load", "pcg", "solve_mg", "group", "assembly")


def segment(traffic, system, mix: dict, seconds: float, rng) -> tuple[dict, dict]:
    """Run the traffic for ``seconds`` under the profiler; (summary,
    breakdown)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if system.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = traffic.traced(system, mix, seconds, rng, record_function)
        window_s = time.perf_counter() - t0
    dev, host = _events(prof, set(SPANS))
    return summarise(dev, host, window_s, units, set(SPANS))
