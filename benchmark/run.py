"""Run one cell of the benchmark on one NVIDIA card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run sets up the cell's configuration
through the port (``arcanefem_tpu_torch``), warms up every shape its
traffic uses, measures for ``--seconds``, and with ``--trace 1`` runs a
short segment more under ``torch.profiler``.  It then frees the program's
state, judges the outputs it kept against the plain reference
(``benchmark/reference``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, ``host`` (the share of the window this process spent on the
host's CPU), ``card`` (its power limit) and, traced, ``breakdown``;
then ``checks``, each number that decided ``correct`` beside its limit
(``failed_cases`` among them, limit 0), also the last lines on standard
error.

It exits with 3 and prints no result without a CUDA card (or with fewer
than the cell asks for), and with 4 if JAX or the JAX package was
imported by the time the window closed.  The port's mesh and topology
caches go to ``benchmark/.data/afem_cache`` (the first run of a sphere
cell in a checkout makes them), its kernels to ``build/`` in the
checkout.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter() at this process's start (from /proc; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import core  # noqa: E402

# the port reads AFEM_CACHE_DIR when it is imported: point it, and any
# kernel cache a library may keep, into the checkout before it is
EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4
ENV = {"AFEM_CACHE_DIR": os.path.join(core.DATA_DIR, "afem_cache"),
       "TORCH_EXTENSIONS_DIR": os.path.join(core.DATA_DIR, "torch_extensions"),
       "TRITON_CACHE_DIR": os.path.join(core.DATA_DIR, "triton")}


def streams(seed: int) -> dict:
    """The seed's independent host random streams."""
    import numpy as np

    draw, sample, warm = np.random.SeedSequence(seed).spawn(3)
    return {"draw": np.random.default_rng(draw), "sample": np.random.default_rng(sample),
            "warmup": np.random.default_rng(warm)}


def run(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        plain: bool = False, mesh_cache: bool = True, config_overrides: dict | None = None,
        t0: float | None = None):
    """One run of ``cell``: (result, checks) where result is the line's
    dict without ``checks``.  ``device``, ``plain`` (the port's plain
    twins instead of its kernels), ``mesh_cache`` and
    ``config_overrides`` (keys replaced in the configuration) let the
    CPU tests drive the same path at a small size."""
    import torch

    from benchmark import trace as tracing
    from benchmark.reference import compare

    t0 = time.perf_counter() if t0 is None else t0
    bench = core.spec()
    workload, config, mix = core.cell(cell)
    config = {**config, **(config_overrides or {})}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sysmod = core.module("systems", config["system"])
    traffic = core.module("traffic", mix["kind"])
    readers = {m["name"]: core.module("metrics", m["name"])
               for m in core.cell_metrics(bench, cell, per_layer=trace)}

    spans: dict = {}
    system = sysmod.System(config, mix, device, plain=plain, mesh_cache=mesh_cache,
                           spans=spans)
    system.seed(seed)
    if mesh_cache:
        core.flush_tree(core.DATA_DIR)
    rngs = streams(seed)
    traffic.warmup(system, mix, rngs["warmup"])
    gc.collect()
    gc.freeze()  # the set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t0

    counts0, cpu0 = system.counts(), time.process_time()
    window = traffic.window(system, mix, seconds, rngs, events=trace and device == "cuda")
    counts1, cpu1 = system.counts(), time.process_time()
    summary = breakdown = None
    if trace:
        summary, breakdown = tracing.segment(traffic, system, mix,
                                             float(mix["trace_seconds"]), rngs["warmup"])
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    bad = core.forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)

    ctx = {"setup_s": setup_s, "peak_bytes": peak, "window": window, "trace": summary,
           "launches": {k: counts1[k] - counts0.get(k, 0) for k in counts1},
           "spans": spans, "n_dofs": system.n_dofs,
           "n_cells": getattr(system, "n_cells", None), "nnz": getattr(system, "nnz", None)}
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, reader in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    system.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = system.check(window["samples"], window["last"])
    # a case whose solver stopped above rtol (or gave no finite answer) is wrong
    correct, checks = compare.judge({**numbers, "failed_cases": window["failed"]},
                                    {**workload["limits"], "failed_cases": 0})
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(workload["chips"]), "memory_peak_bytes": peak}
    if summary:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": correct and window["units"] > 0, "attempted": window["units"],
              "failed": window["failed"], "metrics": metrics, "device": dev,
              "host": core.host_share(cpu0, cpu1, window["window_s"])}
    if breakdown:
        result["breakdown"] = breakdown
    return result, checks


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in ENV.items():
        os.environ[k] = v
    os.makedirs(ENV["AFEM_CACHE_DIR"], exist_ok=True)

    import torch

    chips = int(core.load("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return EXIT_NO_CARD
    try:
        result, checks = run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except ForbiddenImport as e:
        print(f"benchmark: JAX or the JAX package was imported: {e}", file=sys.stderr)
        return EXIT_FORBIDDEN
    from benchmark import roofline

    result["card"] = roofline.power_limit()
    result["checks"] = checks
    print(f"host during the window: {json.dumps(result['host'])}", file=sys.stderr)
    bad = core.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was imported: {bad}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
