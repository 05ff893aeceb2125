"""Readings for the limits of ``correct``: the program's numbers and the
control's, seed by seed, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 3

sets the cell up once and, for each seed, draws that seed's inputs, runs
the cell's own traffic for ``--seconds`` and judges what it kept twice:
as the program produced it, and with the control in its place (the
reference rounded to bfloat16, the precision below the configuration's
float32; see ``reference/compare.py``).  One JSON line per seed:
``{"seed", "attempted", "program": {...}, "control": {...}}``.  A limit
lies above every ``program`` reading and below every ``control`` one.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from benchmark import core


def readings(cell: str, seeds, seconds: float, *, device: str = "cuda",
             plain: bool = False, mesh_cache: bool = True,
             config_overrides: dict | None = None):
    """Yield one record per seed (see the module docstring)."""
    from benchmark.run import streams

    workload, config, mix = core.cell(cell)
    config = {**config, **(config_overrides or {})}
    sysmod = core.module("systems", config["system"])
    traffic = core.module("traffic", mix["kind"])
    system = sysmod.System(config, mix, device, plain=plain, mesh_cache=mesh_cache,
                           spans={})
    for i, seed in enumerate(seeds):
        system.seed(seed)
        rngs = streams(seed)
        if i == 0:
            traffic.warmup(system, mix, rngs["warmup"])
        window = traffic.window(system, mix, seconds, rngs)
        samples, last = window["samples"], window["last"]
        yield {"seed": seed, "attempted": window["units"], "failed": window["failed"],
               "program": system.check(samples, last),
               "control": system.check(samples, last, control=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from benchmark.run import ENV

    for k, v in ENV.items():
        os.environ[k] = v
    os.makedirs(ENV["AFEM_CACHE_DIR"], exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(args.workload, seeds, args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
