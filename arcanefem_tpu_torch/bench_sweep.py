"""``python -m arcanefem_tpu_torch.bench --sweep``: sizes × assembly formats ×
device counts × headline, on one CUDA card (or ``--device cpu``).

The counterpart of ``bench.py::bench_sweep`` and its device-count child
``bench.py::_sweep_child_devices`` (the reference's
testlab/benchmarking/run-benchmark.sh: sizes small, medium, large,
CACHE_WARMING=5, MPI_N=(1 2 4 8), results.tsv).  Three axes, one JSON line
per row on stdout, with ``bench.py``'s keys and values, and a TSV of all the
rows (``--tsv``, default ``bench_sweep.tsv``):

1. ``assembly``: for each box n of ``--sizes``, ``box_tetra_mesh(n, n, n)``
   through ``testlab.run_lab`` (``--formats``, default the six of
   ``testlab.FORMATS``; ``--cache-warming``), float32 on the card and
   float64 on the CPU; one row per format;
2. ``devices``: for each P of ``--devices``, the sharded Poisson solve of
   ``box_tetra_mesh(10)`` (xmin = 0, xmax = 1, f = 1, penalty 1e12, rtol
   1e-10, float64; ``parallel.sharded.make_poisson_step``) on P ranks, one
   per card over NCCL, or on gloo with ``--device cpu`` (the counterpart of
   JAX's virtual CPU devices), launched by ``parallel.dryrun.spawn`` with
   :func:`devices_rank` as the ranks' body.  Rank 0 holds the gathered
   solution to the single-process ``models.poisson`` solve: a relative
   difference below 1e-6 is ``invariant``.  ``solve_s`` is the fastest of
   ``max(2, cache_warming)`` solves;
3. ``headline``: the port bench's PRIMARY and SECONDARY (``bench.run_metrics``,
   each in its child, at the bench's defaults and ``BENCH_*`` environment);
   each row is ``{"axis": "headline", **result}``.

Nothing falls back.  ``--device cpu`` needs ``--no-headline`` (the bench
measures a card) and exits 2 without it; a ``--devices`` count above the
visible cards is refused (exit 2) before any row runs.  A failed devices
child leaves ``{"axis": "devices", "devices": P, "error": true}``, a failed
headline child ``{"axis": "headline", "error": true}``, and a devices row
that is not ``invariant`` stays as it is; the sweep goes on to its end and
then exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

from .bench import check_env, log, run_metrics
from .bench_unstructured import launch_counts, reset_launch_counts
from .utils.timing import elapsed_s

BOX_N = 10  # the devices axis' box, as bench.py's
PENALTY = 1.0e12
RTOL = 1e-10
INVARIANT_TOL = 1e-6  # partition_rel_err below this: the row is invariant
DEFAULT_SIZES = {"cuda": "32,64,96", "cpu": "8,12,16"}


def tsv_text(rows: list[dict]) -> str:
    """The TSV of ``rows``, as ``bench.py::bench_sweep`` writes it: the keys
    in the order they are first seen, tab-separated, a missing value as
    an empty field."""
    keys: list = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    lines = ["\t".join(keys)]
    lines += ["\t".join(str(r.get(k, "")) for k in keys) for r in rows]
    return "\n".join(lines) + "\n"


def assembly_rows(n: int, formats, cache_warming: int, dtype, device) -> list[dict]:
    """Axis 1 at box n: one row per format of ``testlab.run_lab``."""
    from . import testlab
    from .mesh.generate import box_tetra_mesh

    stats = testlab.run_lab(box_tetra_mesh(n, n, n), formats=formats,
                            cache_warming=cache_warming, dtype=dtype, device=device)
    return [{"axis": "assembly", "size": f"box{n}", "nodes": stats["nbNode"],
             "elements": stats["nbElement"], "format": fmt, "devices": 1,
             "lhs_matrix_assembly_s": round(fs["lhs-matrix-assembly"], 5),
             "mdof_per_s": round(fs["mdof_per_s"], 1)}
            for fmt, fs in stats["formats"].items()]


def devices_rank(comm, *, box_n: int, reps: int, inputs=None, run_dir=None) -> dict:
    """One rank of the devices axis (``bench.py::_sweep_child_devices``):
    the sharded Poisson step on ``box_tetra_mesh(box_n)``, once checked
    against the single-process solve, then timed ``reps`` times.  Every
    rank returns the record, with the rank's kernel launches (K1 and
    ``slot_reduce`` on the card); rank 0's carries the gathered solution."""
    from .fem.bcs import BoundaryConditions, DirichletBC
    from .mesh.generate import box_tetra_mesh
    from .models.poisson import PoissonConfig
    from .models.poisson import solve as poisson_solve
    from .parallel.partition import build_sharded
    from .parallel.sharded import (
        all_gather_shards,
        make_poisson_step,
        put_sharded,
        stacked_node_mask,
    )

    reset_launch_counts()
    dev, P = comm.device, comm.world
    mesh = box_tetra_mesh(box_n, box_n, box_n)
    sp = build_sharded(mesh, P)
    sh = put_sharded(sp, comm, torch.float64)
    xmin, xmax = mesh.group_nodes("xmin"), mesh.group_nodes("xmax")
    nodes = np.concatenate([xmin, xmax])
    vals = np.concatenate([np.zeros(len(xmin)), np.ones(len(xmax))])
    mask, val = stacked_node_mask(sp, nodes, vals)
    step = make_poisson_step(sp, comm, rtol=RTOL, max_iter=2000)

    x, iters, res = step(sh, 1.0, mask, val, PENALTY)
    got = sp.scatter_global(all_gather_shards(comm, x))
    ref = poisson_solve(
        mesh, PoissonConfig(f=1.0, bcs=BoundaryConditions(dirichlet=[
            DirichletBC(surface="xmin", value=0.0),
            DirichletBC(surface="xmax", value=1.0)])),
        dtype=torch.float64, device=dev).u
    err = float(np.max(np.abs(got - ref) / (np.abs(ref).max() or 1.0)))
    times = []
    for _ in range(reps):
        comm.barrier()
        t, (x, iters, res) = elapsed_s(lambda: step(sh, 1.0, mask, val, PENALTY), dev)
        times.append(t)
    out = {"devices": P, "nodes": mesh.n_nodes, "solve_s": round(min(times), 4),
           "iterations": int(iters), "residual": float(res),
           "partition_rel_err": err, "invariant": err < INVARIANT_TOL,
           "launches": {k: v for k, v in launch_counts().items() if v}}
    if comm.rank == 0:
        out["_arrays"] = {"x": got}
    return out


def run_devices(P: int, *, device: str, box_n: int = BOX_N, reps: int = 2,
                timeout_s: float = 1800.0) -> tuple[dict | None, dict]:
    """(rank 0's record, its arrays) of :func:`devices_rank` on P ranks, or
    (None, {}) when a rank failed."""
    from .parallel.dryrun import spawn

    with tempfile.TemporaryDirectory(prefix="afem_sweep_") as d:
        out = os.path.join(d, "out.npz")
        rc = spawn(P, device=device, body=devices_rank, out=out, timeout_s=timeout_s,
                   run_dir=d, box_n=box_n, reps=reps)
        if rc != 0 or not os.path.exists(out):
            return None, {}
        z = np.load(out)
        return json.loads(str(z["records"])), {k: z[k] for k in z.files if k != "records"}


def devices_row(P: int, device: str, box_n: int, reps: int) -> dict:
    """bench.py's devices row of P ranks, or its error row; rank 0's
    launches go to the log."""
    rec, _ = run_devices(P, device=device, box_n=box_n, reps=reps)
    if rec is None:
        return {"axis": "devices", "devices": P, "error": True}
    log(f"[sweep] devices={P} rank 0 launches {json.dumps(rec['launches'])}")
    return {"axis": "devices", "size": f"box{box_n}", "nodes": rec["nodes"],
            "format": "sharded-rcb-pcg", "devices": P, "solve_s": rec["solve_s"],
            "iterations": rec["iterations"], "invariant": rec["invariant"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m arcanefem_tpu_torch.bench --sweep",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default=None,
                   help="comma list of box n (default 32,64,96 on the card, "
                        "8,12,16 on the CPU)")
    p.add_argument("--formats", default=None,
                   help="comma list of assembly formats (default: all six)")
    p.add_argument("--devices", default="1,2,4,8",
                   help="rank counts of the sharded axis")
    p.add_argument("--cache-warming", type=int, default=5)
    p.add_argument("--tsv", default="bench_sweep.tsv")
    p.add_argument("--no-headline", action="store_true",
                   help="skip the headline PRIMARY and SECONDARY rows")
    p.add_argument("--no-devices", action="store_true",
                   help="skip the device-count axis")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from .parallel.comm import check_devices

    if args.device == "cpu" and not args.no_headline:
        print("bench --sweep: the headline rows measure a CUDA card; with "
              "--device cpu pass --no-headline", file=sys.stderr)
        return 2
    counts = [] if args.no_devices else [int(d) for d in args.devices.split(",")]
    for P in counts:
        try:
            check_devices(args.device, P)
        except (RuntimeError, ValueError) as e:
            print(f"bench --sweep: --devices {P} refused on {args.device}: {e}; "
                  "--device cpu runs the ranks on gloo", file=sys.stderr)
            return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench --sweep: no CUDA device is available; pass --device cpu "
              "(with --no-headline) to run the sweep on the CPU", file=sys.stderr)
        return 1
    if not args.no_headline:
        check_env(os.environ)  # raise on a bad knob before any row runs

    sizes = [int(s) for s in (args.sizes or DEFAULT_SIZES[args.device]).split(",")]
    formats = args.formats.split(",") if args.formats else None
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    rows, errors = [], []

    def emit(row: dict) -> None:
        rows.append(row)
        print(json.dumps(row), flush=True)

    # axis 1: assembly formats x sizes
    reset_launch_counts()
    for n in sizes:
        for row in assembly_rows(n, formats, args.cache_warming, dtype, args.device):
            emit(row)
    log(f"[sweep] assembly launches {json.dumps(launch_counts())}")

    # axis 2: device counts, P ranks each
    if counts and args.device == "cuda":
        from .utils import kernels

        kernels.build()  # once here, not in P ranks side by side
    for P in counts:
        row = devices_row(P, args.device, BOX_N, max(2, args.cache_warming))
        if row.get("error"):
            errors.append(f"devices={P}: a rank failed")
        elif not row["invariant"]:
            errors.append(f"devices={P}: not partition-invariant")
        emit(row)

    # axis 3: the headline PRIMARY and SECONDARY
    if not args.no_headline:
        results, errs = run_metrics(os.environ)
        errors += errs
        for role in ("primary", "secondary"):
            if role in results:
                emit({"axis": "headline", **results[role]} if results[role] is not None
                     else {"axis": "headline", "error": True})

    bad = [r for r in rows if r["axis"] == "assembly" and not all(
        math.isfinite(r[k]) for k in ("lhs_matrix_assembly_s", "mdof_per_s"))]
    errors += [f"assembly {r['size']} {r['format']}: not finite" for r in bad]
    if args.tsv:
        with open(args.tsv, "w") as f:
            f.write(tsv_text(rows))
        log(f"[sweep] {len(rows)} rows -> {args.tsv}")
    for e in errors:
        log(f"[sweep] FAILED {e}")
    return 1 if errors else 0
