#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (arcanefem_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failed check raises, and the
script then exits non-zero without the final line:

1. device: the card's name and power limit; TF32 off;
2. build: compile csrc/*.cu with nvcc;
3. kernel parity: each kernel against its plain twin on random ELL inputs
   (n = 1M, W in 1, 8, 25, 136, with padding), f32 and f64;
4. main path at 1.9M DoF (sphere_cut h=5, refine=2): assembly, AMG set-up
   and AMG-PCG to rtol 1e-8 through the kernels, with the launch counts of
   that run; then each kernel timed against its plain twin at the shapes
   of the path;
5. the same system at h=8 with the plain twins in place of the kernels,
   and in float64 on the CPU: iterations and solutions must agree.

Then one JSON line with the kernels' records and, last, the device line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import sys
import time


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rel_err(got, want, scale) -> float:
    """max |got - want| / scale, per row; scale is sum_w |v·x| of the row."""
    import torch

    err = (got.double() - want.double()).abs()
    return float((err / scale.double().clamp(min=torch.finfo(torch.float64).tiny)).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs on "
              "an NVIDIA card", file=sys.stderr)
        return 1

    from arcanefem_tpu_torch.bench_unstructured import (
        gpu_name_and_power,
        solve_sphere_cut,
        sphere_cut_system,
    )
    from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
    from arcanefem_tpu_torch.sparse.ell_gather import (
        ell_gather_sum,
        ell_gather_sum_plain,
        ell_spmv,
        ell_spmv_plain,
        launch_counts,
        reset_launch_counts,
    )
    from arcanefem_tpu_torch.utils import kernels
    from arcanefem_tpu_torch.utils.timing import time_op

    dev = torch.device("cuda", 0)

    # 1. device
    smi = gpu_name_and_power()
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    print(f"[build] {kernels.library_path()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 3. kernel parity on random ELL inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for W in (1, 8, 25, 136):
            n = 1_000_000
            cols = torch.randint(0, n, (n, W), generator=gen, device=dev,
                                 dtype=torch.int32)
            vals = torch.rand((n, W), generator=gen, device=dev,
                              dtype=dtype) * 2 - 1
            pad = torch.rand((n, W), generator=gen, device=dev) < 0.2
            vals[pad] = 0
            ucols = torch.where(pad, -1, cols)
            x = torch.rand(n, generator=gen, device=dev, dtype=dtype) * 2 - 1
            y, u = ell_spmv(vals, cols, x), ell_gather_sum(ucols, x)
            torch.cuda.synchronize()
            e1 = _rel_err(y, ell_spmv_plain(vals, cols, x),
                          ell_spmv_plain(vals.abs(), cols, x.abs()))
            e2 = _rel_err(u, ell_gather_sum_plain(ucols, x),
                          ell_gather_sum_plain(ucols, x.abs()))
            print(f"[parity] {str(dtype)[6:]} W={W}: ell_spmv {e1:.2e}, "
                  f"ell_gather_sum {e2:.2e} (rtol {rtol:g} of sum |v x|)",
                  flush=True)
            _check(e1 <= rtol and e2 <= rtol, f"parity {dtype} W={W}")
            del cols, vals, pad, ucols, x, y, u

    # 4. main path at 1.9M DoF
    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(5.0, 2)
    host_s = time.perf_counter() - t0
    print(f"[main] host set-up (mesh, orders, topology) {host_s:.1f} s",
          flush=True)
    reset_launch_counts()
    res = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                           penalty=1e12, timed=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    n, iters = topo.n_nodes, res["iterations"]
    main_line = {
        "n_dofs": n, "nnz_stored": topo.nnz, "width": topo.width,
        "n_cells": int(mesh.cells["tetra4"].shape[0]),
        "assembly_s": res["assembly_s"], "amg_setup_s": res["amg_setup_s"],
        "solve_s": res["solve_s"], "iterations": iters,
        "ms_per_iter": res["solve_s"] / max(iters, 1) * 1e3,
        "rel": res["rel"], "true_residual": res["true_residual"],
        "amg_levels": res["levels"], "launches": counts,
    }
    print(f"[main] {json.dumps(main_line)}", flush=True)
    _check(res["rel"] <= 1e-8, f"monitored residual {res['rel']:.3e} > 1e-8")
    _check(res["true_residual"] <= 1e-4,
           f"true interior residual {res['true_residual']:.3e} > 1e-4")
    _check(bool(torch.isfinite(res["x"]).all()), "non-finite solution")
    _check(res["x"].shape == (n,), "solution shape")
    _check(all(c > 0 for c in counts.values()), f"a kernel never ran: {counts}")

    # the kernels at the main path's shapes, against their plain twins
    A = res["A"]
    xr = torch.rand(n, generator=gen, device=dev) * 2 - 1
    y, yp = ell_spmv(A.values, A.cols, xr), ell_spmv_plain(A.values, A.cols, xr)
    e1 = _rel_err(y, yp, ell_spmv_plain(A.values.abs(), A.cols, xr.abs()))
    _check(e1 <= 1e-5, f"fine-level ell_spmv parity {e1:.2e}")
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device=dev)
    cx = torch.as_tensor(mesh.coords[:, 0], device=dev).to(torch.float32)
    g, gp = (ell_gather_sum(asm.corner_cols, cx),
             ell_gather_sum_plain(asm.corner_cols, cx))
    _check(torch.equal(g, gp), "coordinate gather parity")
    records = [
        {"name": "ell_spmv", "route": "cuda",
         "source": "arcanefem_tpu_torch/csrc/ell_gather.cu",
         "replaces": "arcanefem_tpu/sparse/pallas_spmv.py:398",
         "launches": counts["ell_spmv"],
         "max_abs_err": float((y - yp).abs().max()),
         "ms": time_op(ell_spmv, A.values, A.cols, xr, reps=50, outer=3) * 1e3,
         "plain_ms": time_op(ell_spmv_plain, A.values, A.cols, xr, reps=50,
                             outer=3) * 1e3,
         "shape": [n, topo.width], "dtype": "float32"},
        {"name": "ell_gather_sum", "route": "cuda",
         "source": "arcanefem_tpu_torch/csrc/ell_gather.cu",
         "replaces": "arcanefem_tpu/sparse/pallas_spmv.py:444",
         "launches": counts["ell_gather_sum"],
         "max_abs_err": float((g - gp).abs().max()),
         "ms": time_op(ell_gather_sum, asm.corner_cols, cx, reps=50,
                       outer=3) * 1e3,
         "plain_ms": time_op(ell_gather_sum_plain, asm.corner_cols, cx,
                             reps=50, outer=3) * 1e3,
         "shape": list(asm.corner_cols.shape), "dtype": "float32"},
    ]
    for r in records:
        print(f"[kernel] {r['name']} {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3e}",
              flush=True)
    del res, A, asm, xr, y, yp, cx, g, gp, mesh, topo
    torch.cuda.empty_cache()

    # 5. the kernel path against the plain path, and against float64 on
    #    the CPU, at h=8
    mesh, topo = sphere_cut_system(8.0, 0)
    runs = {
        "kernel": solve_sphere_cut(mesh, topo, device=dev,
                                   dtype=torch.float32, penalty=1e12),
        "plain": solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                  penalty=1e12, plain=True),
        "cpu_f64": solve_sphere_cut(mesh, topo, device="cpu",
                                    dtype=torch.float64, penalty=1e30),
    }
    xk = runs["kernel"]["x"].double().cpu()
    for name, r in runs.items():
        diff = float((xk - r["x"].double().cpu()).abs().max()
                     / r["x"].double().abs().max().cpu())
        print(f"[h8] {name}: {r['iterations']} iterations, rel {r['rel']:.2e}, "
              f"true residual {r['true_residual']:.2e}, max diff from the "
              f"kernel path {diff:.2e}", flush=True)
        _check(abs(r["iterations"] - runs["kernel"]["iterations"]) <= 1,
               f"h=8 iterations, {name}")
        _check(diff <= 1e-4, f"h=8 solution, {name}")

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
