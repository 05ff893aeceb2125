"""Phase profile of the host AMG set-up on the bench's sphere system.

    python -m arcanefem_tpu_torch.tools.profile_amg_setup [KEY] [--device cuda|cpu]

The counterpart of ``tools/profile_amg_setup.py``: it reads the cached
supernode-ordered mesh and topology of ``KEY`` (default
``sphere_cut_v3_h5_r2``, the 1.9M-DoF sphere; the npz files
``<KEY>_snmesh.npz`` and ``topo_<KEY>_sn.npz`` under ``utils.cache.
CACHE_DIR``, which ``bench_unstructured --prime`` writes), assembles the
bench's fine operator on ``--device`` (float32, the penalty 1e12 on the
Dirichlet rows, as ``bench_unstructured.solve_sphere_cut``), and runs
``solver/amg_setup.py::amg_setup`` (theta 0.03, degree-2 Chebyshev; host
numpy and scipy) and then ``amg_from_numpy`` (the SELL layouts of every
level and transfer, on ``--device``) with ``AFEM_AMG_VERBOSE=1``.  It
prints their ``[amg] <label>: <s>s`` lines, then the phase table: one row
per level with the seconds of each phase, and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np
import torch

LEVEL_PHASES = ("strength", "aggregate", "filter", "rho_f", "rho_A", "smoothP",
                "galerkin", "to_bell", "transfers")
_LINE = re.compile(r"^\[amg\] +(\S.*?): ([0-9.]+)s$")
_PHASE = re.compile(r"^(\w+)\[(\d+)\]")


def parse(text: str) -> list[tuple[str, float]]:
    """(label, seconds) of every ``[amg]`` line of ``text``, in order."""
    return [(m.group(1), float(m.group(2)))
            for m in map(_LINE.match, text.splitlines()) if m]


def phase_table(marks: list[tuple[str, float]]) -> tuple[list[dict], dict]:
    """(one dict per level: ``level`` and the seconds of each of
    :data:`LEVEL_PHASES` it has, the seconds of the set-up's other marks by
    label: ``level i (n->m dofs)``, ``ell layouts``, ``coarse_inv``)."""
    levels: dict[int, dict] = {}
    other = {}
    for label, s in marks:
        m = _PHASE.match(label)
        if m and m.group(1) in LEVEL_PHASES:
            l = int(m.group(2))
            levels.setdefault(l, {"level": l})[m.group(1)] = s
        else:
            other[label] = other.get(label, 0.0) + s
    return [levels[l] for l in sorted(levels)], other


def format_table(rows: list[dict], other: dict) -> str:
    head = f"{'level':>5} " + " ".join(f"{p:>9}" for p in LEVEL_PHASES) + f" {'sum':>9}"
    lines = [head]
    for r in rows:
        vals = [r.get(p) for p in LEVEL_PHASES]
        lines.append(f"{r['level']:>5} " + " ".join(
            f"{'-':>9}" if v is None else f"{v:9.3f}" for v in vals)
            + f" {sum(v for v in vals if v is not None):9.3f}")
    tot = [sum(r.get(p, 0.0) for r in rows) for p in LEVEL_PHASES]
    lines.append(f"{'all':>5} " + " ".join(f"{v:9.3f}" for v in tot) + f" {sum(tot):9.3f}")
    lines += [f"{k}: {v:.3f}s" for k, v in other.items()]
    return "\n".join(lines)


def fine_operator(key: str, device) -> tuple[np.ndarray, object]:
    """(the penalised (N, W) float32 ELL values the set-up reads, the
    topology) of the cached sphere ``key``, assembled on ``device``."""
    from ..bench_unstructured import _load_mesh, _topology, dirichlet_data, mesh_files
    from ..ops.lane_assembly import TetraAssembler
    from ..sparse.bell import BellMatrix, fine_layout
    from ..utils.cache import CACHE_DIR

    paths = list(mesh_files(key, "sn", CACHE_DIR).values())
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"{p}: prime the sphere first (python -m "
                                    "arcanefem_tpu_torch.bench_unstructured --prime)")
    mesh = _load_mesh(paths[0])
    topo = _topology(mesh, paths[1])
    layout = fine_layout(topo, device)
    vals = TetraAssembler(topo, mesh.cells["tetra4"], device=device, layout=layout)(
        torch.as_tensor(mesh.coords, device=device).to(torch.float32))
    mask, _, _ = dirichlet_data(mesh, 1e12)
    diag = torch.as_tensor(layout.ell_to_sell[np.asarray(topo.diag_slot, np.int64)],
                           device=device)
    vals[diag[torch.as_tensor(mask, device=device)]] = 1e12
    return BellMatrix(vals, layout, diag).ell_values().cpu().numpy(), topo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m arcanefem_tpu_torch.tools.profile_amg_setup",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("key", nargs="?", default="sphere_cut_v3_h5_r2")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_amg_setup: no CUDA device is available; pass --device cpu",
              file=sys.stderr)
        return 1
    from ..solver.amg import amg_from_numpy
    from ..solver.amg_setup import amg_setup

    t0 = time.perf_counter()
    flat, topo = fine_operator(args.key, args.device)
    print(f"load and assemble {time.perf_counter() - t0:.1f}s  n={topo.n_nodes:,}",
          flush=True)
    os.environ["AFEM_AMG_VERBOSE"] = "1"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        d = amg_setup(flat, topo, theta=0.03, smoother="chebyshev", cheb_deg=2,
                      dtype=np.float32)
        setup_s = time.perf_counter() - t0
        M = amg_from_numpy(d, args.device, torch.float32)
        if args.device == "cuda":
            torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    rows, other = phase_table(parse(buf.getvalue()))
    print(format_table(rows, other), flush=True)
    levels = [m.n_nodes for m in M.mats] + [int(M.coarse_inv.shape[0])]
    print(f"amg_setup {setup_s:.1f}s, with amg_from_numpy {total_s:.1f}s; levels {levels}",
          flush=True)
    line = {"key": args.key, "n_dofs": int(topo.n_nodes), "levels": levels,
            "amg_setup_s": setup_s, "total_s": total_s, "phases": rows, "other": other,
            "device": args.device}
    if args.device == "cuda":
        from ..bench_unstructured import gpu_name_and_power

        line["gpu"] = gpu_name_and_power()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
