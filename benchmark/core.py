"""What the harness finds by name, and the arithmetic shared by its readers.

Every configuration, workload (cell), traffic mix and metric is a file of
its own under ``benchmark/``; this module lists and loads them by file
name, so a new one is a new file and no edit:

- ``configs/<config>.json``: one configuration, whose ``system`` names
  ``systems/<system>.py``, the adapter that drives the port's route;
- ``workloads/<cell>.json``: one cell: its ``config``, its ``traffic``
  mix and the limits of its correctness check;
- ``traffic/<mix>.json``: one traffic mix's parameters, whose ``kind``
  names ``traffic/<kind>.py``, the loop that offers it;
- ``metrics/<metric>.py``: one metric's reader, ``read(ctx)``.

Which metrics a cell reports is read from ``BENCHMARK.json`` at the root
of the checkout: a metric with a ``workloads`` key in the cells it lists,
one without it in every cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
DATA_DIR = os.path.join(BENCH_DIR, ".data")

# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "arcanefem_tpu")


def names(kind: str, ext: str = ".json") -> list[str]:
    """The names of the files of ``kind`` (a folder of benchmark/)."""
    d = os.path.join(BENCH_DIR, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def load(kind: str, name: str) -> dict:
    """The JSON file ``<kind>/<name>.json``."""
    path = os.path.join(BENCH_DIR, kind, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def module(kind: str, name: str):
    """The Python file ``<kind>/<name>.py``, imported under a private name
    (metric names carry dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"_femark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str, per_layer: bool) -> list[dict]:
    """The ``end_to_end`` (or, with ``per_layer``, the ``per_layer``)
    metrics of ``bench`` that the cell reports."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def cell(name: str) -> tuple[dict, dict, dict]:
    """(workload, config, traffic mix) of the cell ``name``."""
    w = load("workloads", name)
    return w, load("configs", w["config"]), load("traffic", w["traffic"])


def forbidden_modules(mods=None) -> list[str]:
    """The top-level names in ``mods`` (default ``sys.modules``) that are
    JAX or the JAX package, compared whole: ``arcanefem_tpu_torch`` is
    not ``arcanefem_tpu``."""
    mods = sys.modules if mods is None else mods
    tops = {m.split(".", 1)[0] for m in mods}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


# -- arithmetic the metric readers share -------------------------------------

def p95(values) -> float:
    """The 95th percentile of all ``values`` (linear between order
    statistics, as ``numpy.percentile``)."""
    v = sorted(values)
    if not v:
        raise ValueError("p95 of no values")
    pos = 0.95 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values) -> float:
    """(third quartile - first quartile) / median, by
    ``statistics.quantiles(values, n=4)``: the spread a bound is set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def idle_share(trace: dict | None) -> float | None:
    """1 - (seconds in which an operation ran on the device) / (the traced
    window), from a trace summary; None without a trace or device time."""
    if not trace or trace.get("busy_s", 0.0) <= 0.0 or trace["window_s"] <= 0.0:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]


def worst(numbers: dict, more: dict) -> None:
    """numbers[k] = the larger of its reading and more[k]; NaN stays."""
    for k, v in more.items():
        old = numbers.get(k)
        if old is None or (old == old and not v <= old):
            numbers[k] = v


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def nospan(name: str) -> _NoSpan:
    """A span that records nothing (outside a traced segment)."""
    return _NoSpan()


def sync(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_share(cpu_s0: float, cpu_s1: float, window_s: float) -> dict | None:
    """The share of the window this process spent on the host's CPU, from
    two ``time.process_time()`` readings: near 1 for a host-bound loop."""
    if window_s <= 0.0:
        return None
    return {"cpu_share": (cpu_s1 - cpu_s0) / window_s}


def flush_tree(path: str) -> None:
    """fsync every file under ``path``, so that a first run's cache
    writes reach the disk in its set-up and not inside its window."""
    for d, _, files in os.walk(path):
        for f in files:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
