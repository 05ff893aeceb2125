#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (arcanefem_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failed check raises, and the
script then exits non-zero without the final line:

1. device: the card's name and power limit; TF32 off;
2. build: compile csrc/*.cu with nvcc;
3. kernel parity: each ELL kernel against its plain twin on random inputs
   (n = 1M, W in 1, 8, 25, 136, with padding), f32 and f64: K1 (in its
   SELL-32-σ layout, also held to the (n, W) definition) and K2, the
   batched K3b (on the same SELL layout) and K3a for B in 1, 3, 8 tables,
   contiguous and channel-minor (strided) tables and results, and K1 with
   bf16 weights;
   then the host cost of one launch of every wrapper beside a PyTorch op
   of the same size (``[launch]`` lines, tools/launch_cost.py);
4. main path at 1.9M DoF (sphere_cut h=5, refine=2): assembly (the
   element kernel tet_element and the slot-sorted reduction slot_reduce;
   K2 must not run), AMG set-up and AMG-PCG to rtol 1e-8 through the
   kernels, with the launch counts of that run and the SELL layout of
   every operator K1 ran on (``[sell]`` lines); then each kernel timed
   against its plain twin at the shapes of the path (tet_element in both
   input modes, slot_reduce beside one index_add_ of all its entries), K1
   at both σ, and a torch.profiler breakdown of one solve;
9. (run right after 4, on its mesh, operator and AMG hierarchy) the
   supernode route and the other bench knobs of the sphere: (a) the
   supernode operator, (b) with the block-Jacobi fine smoother, (c) with
   bf16 fine-level blocks too, (d) the ELL operator with the block-Jacobi
   smoother, (e) the bf16 V-cycle, (f) the batched coordinate gather; each
   solve checked and printed with its launch counts as an ``[sn]`` line,
   (a)-(c) with every supernode SpMV one ``bsr8_spmv`` launch (no K3a) and
   24, 22 and 25 iterations ± 1; two assemblies on each of the four
   assembly routes (``ASM_ROUTES``), all eight equal bit for bit
   (``[asm]``); then ``bsr8_spmv`` on f32 and bf16 blocks held to its
   twin (and K1) and timed beside cuSPARSE BSR, K3a at its three shapes
   (the supernode column gather and row reduce, which no path runs since
   ``bsr8_spmv``, as kernel checks), K3b on the fine operator's own SELL
   layout with 8 channel-minor tables and K1 bf16 held against their plain
   twins and timed;
g-i. (run after 9, on the same state) the compact route: (g) ``--spmv
   compact`` (pre-gather K2), (h) with ``--band-pre`` (each pre-gather of
   the CG operator, the levels and the transfers one K9a launch over its
   narrow and wide tiles: no K2), (i) with ``--asm-compact --asm-coords
   batched`` too (K9b, then K3a 9 times); each solve checked against the
   ELL run's iterations and printed with its launch counts as a
   ``[compact]`` line; the compact corners held equal to the split
   gather's; K2 at (g)'s CG pre-gather, K9a at (h)'s
   (``BandedGather.__call__``) and K9b at (i)'s coordinates
   (``call_batched``) held to their plain twins and timed; and
   ``--spmv diag`` must raise on this system, where plan_diag declines;
j. the RCM-ordered sphere at h=5, refine=1 (244,183 DoF): the ELL route,
   then ``--spmv diag`` (K10) on the same system, ``[diag]`` lines; K10
   held to its twin and timed there and on the 80^3 RCM box, beside K1 and
   CSR ``torch.mv`` on the same operator; the gather probes P1-P3
   (``tools/probe_gather.py``) at (K, G) = (160, 64) (window in shared
   memory) and (1024, 64) (L1/L2), each with its host µs per call beside
   ``torch.gather``'s;
5. the same system at h=8 with the plain twins in place of the kernels,
   and in float64 on the CPU: iterations and solutions must agree, on the
   ELL route and (9b) on the supernode route with the block smoother, also
   with bf16 V-cycle blocks (9c);
6. structured kernel parity: the stencil kernel (K5-K8) in every mode and
   layout, f32 and bf16 bands, and the stencil assembly (K4), stiffness
   only and fused with the BC, against their plain twins on a 96x80x136
   box (two 128-thread blocks per z row);
7. the structured path at 224^3 (11.4M DoF): the MG-PCG bench pass with
   the launch counts of one solve, a torch.profiler breakdown of one solve
   (the operator table in build/profile/), the Jacobi-PCG variant (K8a)
   and the flat-vector MG variant (K8a, K8b), each with its own counts
   and bench line, then each kernel held against its plain twin and timed
   at the path's shapes (CUDA events and profiler device time), and two
   fused 225^3 assemblies held equal bit for bit;
8. the MG path at 64^3 through the kernels, on the plain twins (float32 on
   the CPU) and in float64 on the CPU: iterations and solutions must agree.

Then one JSON line with the kernels' records and, last, the device line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.

A record's ``bound_ms`` is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its flops over 67 TFLOP/s
(the H100 SXM's HBM3 rate and non-tensor f32 rate, at 700 W); K1's counts
the nonzeros (8 bytes each, 12 per row), and ``slot_bound_ms`` the SELL
slots it stores.  ``ms`` is the CUDA-event time of back-to-back calls;
most records add ``device_ms``, the profiler's time per call of the
record's own kernel (null where the profiler did not trace it, with the
events it traced and expected in ``device_events``), because for a kernel
of a few microseconds the former measures the host's rate of issuing
launches.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

BOX_N, CHECK_N = 224, 64  # box sizes of phases 7 and 8
PARITY_BOX = (96, 80, 136)  # phase 6: nz + 3 = 139 pads to two z blocks
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel call."""
    tb, tf = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


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
        ell_spmv_plain,
    )
    from arcanefem_tpu_torch.sparse.sell import SellLayout, sell_spmv, sell_spmv_plain
    from arcanefem_tpu_torch.tools.launch_cost import measure_all
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

    # 3. kernel parity on random ELL inputs; K1 on the SELL layout of the
    #    real slots (built on the host), held to its SELL twin and to the
    #    (n, W) definition
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for W in (1, 8, 25, 136):
            n = 1_000_000
            cols = torch.randint(0, n, (n, W), generator=gen, device=dev,
                                 dtype=torch.int32)
            vals = torch.rand((n, W), generator=gen, device=dev,
                              dtype=dtype) * 2 - 1
            pad = torch.rand((n, W), generator=gen, device=dev) < 0.2
            pad[:: 97] = True  # empty rows
            vals[pad] = 0
            ucols = torch.where(pad, -1, cols)
            x = torch.rand(n, generator=gen, device=dev, dtype=dtype) * 2 - 1
            lay = SellLayout.build(cols.cpu().numpy(), (~pad).cpu().numpy(),
                                   device=dev)
            sv = lay.from_ell(vals)
            y, u = sell_spmv(sv, lay, x), ell_gather_sum(ucols, x)
            torch.cuda.synchronize()
            scale = ell_spmv_plain(vals.abs(), cols, x.abs())
            e1 = max(_rel_err(y, sell_spmv_plain(sv, lay, x), scale),
                     _rel_err(y, ell_spmv_plain(vals, cols, x), scale))
            e2 = _rel_err(u, ell_gather_sum_plain(ucols, x),
                          ell_gather_sum_plain(ucols, x.abs()))
            print(f"[parity] {str(dtype)[6:]} W={W}: sell_spmv {e1:.2e} (sigma "
                  f"{lay.sigma}, {lay.n_slots / max(lay.nnz, 1):.3f} slots per "
                  f"nonzero), ell_gather_sum {e2:.2e} (rtol {rtol:g} of sum |v x|)",
                  flush=True)
            _check(e1 <= rtol and e2 <= rtol, f"parity {dtype} W={W}")
            _batched_parity(vals, cols, ucols, lay, sv, gen, dtype, rtol)
            if dtype == torch.float32:
                vb, xf = sv.bfloat16(), x.float()
                e3 = _rel_err(sell_spmv(vb, lay, xf), sell_spmv_plain(vb, lay, xf),
                              sell_spmv_plain(vb.abs(), lay, xf.abs()))
                print(f"[parity] bf16 weights W={W}: sell_spmv {e3:.2e} (rtol 1e-5)",
                      flush=True)
                _check(e3 <= 1e-5, f"bf16 sell_spmv parity W={W}")
                del vb, xf
            del cols, vals, pad, ucols, x, y, u, sv, scale, lay

    # the host cost of one launch of each wrapper, where the card is idle
    for rec in measure_all(2000):
        print(f"[launch] {json.dumps(rec)}", flush=True)

    # 4. main path at 1.9M DoF
    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(5.0, 2)
    host_s = time.perf_counter() - t0
    print(f"[main] host set-up (mesh, orders, topology) {host_s:.1f} s",
          flush=True)
    _reset_all()
    res = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                           penalty=1e12, timed=True)
    torch.cuda.synchronize()
    counts = _counts_all()
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
    for rec in res["sell"]:
        print(f"[sell] {json.dumps(rec)}", flush=True)
    _check(res["rel"] <= 1e-8, f"monitored residual {res['rel']:.3e} > 1e-8")
    _check(res["true_residual"] <= 1e-4,
           f"true interior residual {res['true_residual']:.3e} > 1e-4")
    _check(bool(torch.isfinite(res["x"]).all()), "non-finite solution")
    _check(res["x"].shape == (n,), "solution shape")
    _check(counts["sell_spmv"] > 0 and counts["tet_element"] > 0
           and counts["slot_reduce"] > 0,
           f"K1 or an assembly kernel never ran: {counts}")
    _check(counts["ell_gather_sum"] == 0,
           f"the default assembly route launched K2: {counts}")

    # the kernels at the main path's shapes, against their plain twins; K1
    # also against the (N, W) definition and at the other sigma
    A = res["A"]
    lay = A.layout
    xr = torch.rand(n, generator=gen, device=dev) * 2 - 1
    ell_vals = A.ell_values()
    ell_cols = torch.as_tensor(topo.ell_cols.astype("int32"), device=dev)
    y, yp = sell_spmv(A.values, lay, xr), sell_spmv_plain(A.values, lay, xr)
    scale = ell_spmv_plain(ell_vals.abs(), ell_cols, xr.abs())
    e1 = max(_rel_err(y, yp, scale),
             _rel_err(y, ell_spmv_plain(ell_vals, ell_cols, xr), scale))
    _check(e1 <= 1e-5, f"fine-level sell_spmv parity {e1:.2e}")
    alt = SellLayout.build(topo.ell_cols, topo.ell_valid, device=dev,
                           sigma=1 if lay.sigma > 1 else 1024)
    alt_vals = alt.from_ell(ell_vals)
    e_alt = _rel_err(sell_spmv(alt_vals, alt, xr), yp, scale)
    _check(e_alt <= 1e-5, f"fine-level sell_spmv at sigma {alt.sigma}: {e_alt:.2e}")
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device=dev, layout=lay)
    crow = torch.as_tensor(topo.row_ptr, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(
        crow, torch.as_tensor(topo.csr_cols, device=dev, dtype=torch.int64),
        ell_vals.reshape(-1)[torch.as_tensor(topo.csr_to_ell, device=dev,
                                             dtype=torch.int64)],
        size=(n, n))
    e_csr = float((csr @ xr - yp).abs().max() / yp.abs().max())
    print(f"[kernel] CSR library SpMV vs plain: {e_csr:.3e} of max|y|", flush=True)

    def slot_bound(layout, value_bytes):
        """Bytes of the SELL slots K1 reads, x and y, the permutation."""
        perm = 0 if layout.perm is None else 4 * n
        return _bound(layout.n_slots * (value_bytes + 4) + n * 8 + perm,
                      2 * layout.n_slots)[0]

    k1_ms = time_op(sell_spmv, A.values, lay, xr, reps=50, outer=3) * 1e3
    alt_ms = time_op(sell_spmv, alt_vals, alt, xr, reps=50, outer=3) * 1e3
    k1 = {"name": "sell_spmv", "route": "cuda",
         "source": "arcanefem_tpu_torch/csrc/sell_spmv.cu",
         "replaces": "arcanefem_tpu/sparse/pallas_spmv.py:398",
         "launches": counts["sell_spmv"],
         "max_abs_err": float((y - yp).abs().max()),
         "ms": k1_ms,
         **dict(zip(("device_ms", "device_events"),
                    _device_ms(lambda: sell_spmv(A.values, lay, xr), "sell_spmv.cu"))),
         "plain_ms": time_op(sell_spmv_plain, A.values, lay, xr, reps=5,
                             outer=2) * 1e3,
         "library_ms": time_op(torch.mv, csr, xr, reps=50, outer=3) * 1e3,
         **dict(zip(("bound_ms", "bound_by"), _bound(
             topo.nnz * 8 + n * 12, 2 * topo.nnz))),
         "slot_bound_ms": slot_bound(lay, 4),
         "sigma": lay.sigma, "slots": lay.n_slots, "nnz": topo.nnz,
         "alt_sigma": alt.sigma, "alt_ms": alt_ms,
         **dict(zip(("alt_device_ms", "alt_device_events"),
                    _device_ms(lambda: sell_spmv(alt_vals, alt, xr), "sell_spmv.cu"))),
         "alt_slots": alt.n_slots, "alt_slot_bound_ms": slot_bound(alt, 4),
         "shape": [n, topo.width], "dtype": "float32"}
    print(f"[kernel] sell_spmv {k1['shape']}: {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms, library {k1['library_ms']:.4f} ms, bound "
          f"{k1['bound_ms']:.4f} ms, max_abs_err {k1['max_abs_err']:.3e}", flush=True)
    records = [k1, *_assembly_records(asm, mesh, counts)]
    print(f"[kernel] sell_spmv sigma {k1['sigma']}: {k1['slots']} slots "
          f"({k1['slots'] / k1['nnz']:.4f} per nonzero), {k1['ms']:.4f} ms, device "
          f"{_fmt_ms(k1['device_ms'])}, slot bound {k1['slot_bound_ms']:.4f} ms; sigma "
          f"{k1['alt_sigma']}: {k1['alt_slots']} slots, {k1['alt_ms']:.4f} ms, device "
          f"{_fmt_ms(k1['alt_device_ms'])}, slot bound {k1['alt_slot_bound_ms']:.4f} ms; "
          f"nonzero bound {k1['bound_ms']:.4f} ms, CSR torch.mv "
          f"{k1['library_ms']:.4f} ms", flush=True)
    del A, asm, xr, y, yp, csr, ell_vals, ell_cols, alt, alt_vals, scale
    torch.cuda.empty_cache()

    # device time by kernel of one main-path solve (its true-residual check
    # included), on phase 4's operator and hierarchy
    def solve_ell():
        return solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, system=res["system"])

    solve_ell()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_ell()
    torch.cuda.synchronize()
    _profile(solve_ell, os.path.join("build", "profile", "ell.txt"),
             time.perf_counter() - t0, groups=SPHERE_GROUPS)
    torch.cuda.empty_cache()

    records += supernode_phase(dev, gen, mesh, topo, res)
    res["system"].pop("sn", None)  # 1.35 GB of blocks no later phase reads
    records += compact_phase(dev, gen, mesh, topo, res)
    del res, mesh, topo
    torch.cuda.empty_cache()
    records += diag_phase(dev, gen)
    records += probe_phase(dev)
    torch.cuda.empty_cache()

    # 5. the kernel path against the plain path, and against float64 on
    #    the CPU, at h=8; 9b, 9c. the same for the supernode route with the
    #    block smoother, also with bf16 V-cycle blocks, on each run's own
    #    operator and hierarchy
    systems: dict = {}
    mesh, topo = sphere_cut_system(8.0, 0)
    setups = {"kernel": dict(device=dev, dtype=torch.float32, penalty=1e12),
              "plain": dict(device=dev, dtype=torch.float32, penalty=1e12,
                            plain=True),
              "cpu_f64": dict(device="cpu", dtype=torch.float64, penalty=1e30)}
    for route, opts in (("h8", {}), ("h8sn", dict(spmv="supernode", sn_block=True)),
                        ("h8snbf16", dict(spmv="supernode", sn_block=True, sn_bf16=True))):
        runs = {}
        for name, kw in setups.items():
            runs[name] = solve_sphere_cut(mesh, topo, **kw, **opts,
                                          system=systems.get(name))
            systems[name] = runs[name]["system"]
        xk = runs["kernel"]["x"].double().cpu()
        for name, r in runs.items():
            diff = float((xk - r["x"].double().cpu()).abs().max()
                         / r["x"].double().abs().max().cpu())
            print(f"[{route}] {name}: {r['iterations']} iterations, rel {r['rel']:.2e}, "
                  f"true residual {r['true_residual']:.2e}, max diff from the "
                  f"kernel path {diff:.2e} ({r['spmv_path']})", flush=True)
            _check(abs(r["iterations"] - runs["kernel"]["iterations"]) <= 1,
                   f"{route} iterations, {name}")
            _check(diff <= 1e-4, f"{route} solution, {name}")
            _check(r["rel"] <= 1e-8 and r["true_residual"] <= 1e-4,
                   f"{route} residuals, {name}")
        del runs, xk
    del systems, mesh, topo
    torch.cuda.empty_cache()

    records += structured_phases(dev, gen)

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _batched_parity(vals, cols, ucols, lay, sv, gen, dtype, rtol) -> None:
    """Phase 3, batched: K3b on the SELL layout ``lay`` (values ``sv``) of
    a K1/K2 case and K3a on its (n, W) index array, for B in 1, 3, 8
    tables, contiguous and channel-minor (tables and results strided), each
    table held against the single-table (n, W) definition."""
    import torch

    from arcanefem_tpu_torch.sparse.ell_gather import (
        ell_gather_sum_batched,
        ell_gather_sum_plain,
        ell_spmv_plain,
    )
    from arcanefem_tpu_torch.sparse.sell import sell_spmv_batched

    n, W = cols.shape
    for B in (1, 3, 8):
        tab = torch.rand((B, n), generator=gen, device=vals.device, dtype=dtype) * 2 - 1
        want = [(ell_spmv_plain(vals, cols, t), ell_spmv_plain(vals.abs(), cols, t.abs()),
                 ell_gather_sum_plain(ucols, t), ell_gather_sum_plain(ucols, t.abs()))
                for t in tab]
        for minor in (False, True):
            t = tab.T.contiguous().T if minor else tab
            outs = [torch.empty((n, B), dtype=dtype, device=vals.device).T
                    if minor else None for _ in range(2)]
            y = sell_spmv_batched(sv, lay, t, out=outs[0])
            u = ell_gather_sum_batched(ucols, t, out=outs[1])
            torch.cuda.synchronize()
            e1 = max(_rel_err(y[b], w[0], w[1]) for b, w in enumerate(want))
            e2 = max(_rel_err(u[b], w[2], w[3]) for b, w in enumerate(want))
            print(f"[parity] {str(dtype)[6:]} W={W} B={B} "
                  f"{'channel-minor' if minor else 'contiguous'}: sell_spmv_batched "
                  f"{e1:.2e}, ell_gather_sum_batched {e2:.2e} (rtol {rtol:g})", flush=True)
            _check(e1 <= rtol and e2 <= rtol, f"batched parity {dtype} W={W} B={B}")
            del y, u, t
        del tab, want


ASM_ROUTES = {  # the assembly's corner fetch (--asm-coords, --asm-compact, --band-pre)
    "split": {}, "batched": dict(coords_batched=True),
    "compact": dict(coords_compact=True),
    "compact batched banded": dict(coords_compact=True, coords_batched=True,
                                   band_pre=True)}


def _assembly_records(asm, mesh, counts) -> list[dict]:
    """Phase 4: tet_element (both input modes, which must agree exactly)
    and slot_reduce at the main path's shapes, held to their twins (the
    element table to 4 ulps of each cell's max |ke|, the reduction exactly)
    and timed; slot_reduce beside one index_add_ of all 16·nc entries, the
    reduction it replaces."""
    import torch

    from arcanefem_tpu_torch.ops.lane_assembly import (
        tet_corners_plain,
        tet_element,
        tet_element_gathered,
        tet_element_plain,
    )
    from arcanefem_tpu_torch.sparse.slot_reduce import slot_reduce, slot_reduce_plain
    from arcanefem_tpu_torch.utils.timing import time_op

    dev = asm.corner_cols.device
    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    cols, ptr, ids = asm.corner_cols, asm.ptr, asm.ids
    nc, n_slots, E = asm.n_cells, ptr.numel() - 1, ids.numel()

    def ulps(yk, yp):
        m = yp.abs().amax(dim=1, keepdim=True)
        e = float(((yk - yp).abs() / (torch.nextafter(m, m * 2 + 1) - m)).max())
        _check(e <= 4, f"tet_element: {e:.2f} ulps of a cell's max|ke| from its twin")
        return e

    def equal(yk, yp):
        _check(torch.equal(yk, yp), "slot_reduce differs from its twin")
        return 0.0

    corners = tet_corners_plain(coords, cols)
    ke, ke_g = tet_element(coords, cols), tet_element_gathered(corners)
    torch.cuda.synchronize()
    _check(torch.equal(ke, ke_g), "tet_element: the two input modes differ")
    e_g = ulps(ke_g, tet_element_plain(corners))
    table = ke.view(-1)
    slot_of = torch.repeat_interleave(torch.arange(n_slots, device=dev),
                                      (ptr[1:] - ptr[:-1]).long(), output_size=E)
    entries = table[ids.long()]
    recs = [
        _kernel_record(
            "tet_element", "tet_assembly.cu", "sparse/pallas_spmv.py:444",
            lambda: tet_element(coords, cols),
            lambda: tet_element_plain(tet_corners_plain(coords, cols)), None,
            (nc * 56 + coords.shape[0] * 12, 182 * nc), counts["tet_element"],
            [nc, 10], ulps),
        _kernel_record(
            "slot_reduce", "tet_assembly.cu", "sparse/pallas_spmv.py:444",
            lambda: slot_reduce(ptr, ids, table),
            lambda: slot_reduce_plain(ptr, ids, table),
            lambda: torch.zeros(n_slots, device=dev).index_add_(0, slot_of, entries),
            (8 * n_slots + 4 + 4 * E + 40 * nc, E), counts["slot_reduce"],
            [n_slots, E], equal)]
    recs[0]["gathered_ms"] = time_op(tet_element_gathered, corners, reps=20, outer=3) * 1e3
    recs[0]["gathered_device_ms"], recs[0]["gathered_device_events"] = _device_ms(
        lambda: tet_element_gathered(corners), "tet_assembly.cu")
    recs[0]["gathered_ulps"] = e_g
    recs[1]["max_contributors"] = int((ptr[1:] - ptr[:-1]).max())
    print(f"[kernel] tet_element on gathered corners (3, {4 * nc}): "
          f"{recs[0]['gathered_ms']:.4f} ms, device {_fmt_ms(recs[0]['gathered_device_ms'])}, "
          f"{e_g:.2f} ulps from its twin; slot_reduce: {E} contributors, at most "
          f"{recs[1]['max_contributors']} per slot", flush=True)
    return recs


SN_CONFIGS = {  # phase 9: bench_unstructured's flags of each configuration
    "a": dict(spmv="supernode"),
    "b": dict(spmv="supernode", sn_block=True),
    "c": dict(spmv="supernode", sn_block=True, sn_bf16=True),
    "d": dict(sn_block=True),
    "e": dict(vcycle_bf16=True),
    "f": dict(asm_coords="batched"),
}
# the supernode routes' iteration counts at 1.9M, held ± 1: (a) and (b)
# take the ELL operator's counts (phase 4, and (d) for the block smoother);
# (c)'s bf16 V-cycle blocks, whose exact products bsr8_spmv sums in f64
# (the three-step SpMV summed each block's 8 in f32 and took 28), take 25
SN_ITERS = {"a": 24, "b": 22, "c": 25}


def supernode_phase(dev, gen, mesh, topo, res4) -> list[dict]:
    """Phase 9: the configurations of SN_CONFIGS on phase 4's operator and
    AMG hierarchy (``res4``), then bsr8_spmv, K3a, K3b and K1 bf16 at the route's
    shapes; returns their records."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import (
        operator_self_check,
        solve_sphere_cut,
    )
    from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler, tet_corners_plain
    from arcanefem_tpu_torch.sparse.ell_gather import (
        ell_gather_sum_batched,
        ell_gather_sum_batched_plain,
        ell_spmv_batched_plain,
    )
    from arcanefem_tpu_torch.sparse.sell import (
        sell_spmv,
        sell_spmv_batched,
        sell_spmv_batched_plain,
        sell_spmv_plain,
    )
    import numpy as np

    from arcanefem_tpu_torch.sparse.supernode import block_products
    from arcanefem_tpu_torch.utils.timing import time_op

    system = res4["system"]
    runs, counts = {}, {}
    for key, opts in SN_CONFIGS.items():
        _reset_all()
        r = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                             penalty=1e12, timed=True, system=system, **opts)
        torch.cuda.synchronize()
        counts[key] = _counts_all()
        runs[key] = r
        line = {"config": key, "flags": opts, "spmv_path": r["spmv_path"],
                "iterations": r["iterations"], "rel": r["rel"],
                "true_residual": r["true_residual"], "solve_s": r["solve_s"],
                "ms_per_iter": r["solve_s"] / max(r["iterations"], 1) * 1e3,
                "assembly_s": r["assembly_s"],
                **{k: r[k] for k in ("sn_setup_s", "sn_check", "sn_blocks",
                                     "sn_bytes") if k in r},
                "launches": {k: v for k, v in counts[key].items() if v}}
        print(f"[sn] {json.dumps(line)}", flush=True)
        _check(r["rel"] <= 1e-8, f"[sn] {key}: monitored residual {r['rel']:.3e}")
        _check(r["true_residual"] <= 1e-4,
               f"[sn] {key}: true interior residual {r['true_residual']:.3e}")
        _check(bool(torch.isfinite(r["x"]).all()), f"[sn] {key}: non-finite x")
        _check(counts[key]["sell_spmv"] > 0, f"[sn] {key}: K1 never ran")
        if opts.get("spmv") == "supernode":
            # every supernode SpMV is one bsr8_spmv launch: no K3a
            _check(r["spmv_path"] == "SupernodeMatrix", f"[sn] {key}: spmv path")
            _check(counts[key]["bsr8_spmv"] > 0
                   and counts[key]["ell_gather_sum_batched"] == 0,
                   f"[sn] {key}: the supernode SpMV did not run through "
                   f"bsr8_spmv alone: {counts[key]}")
            _check(abs(r["iterations"] - SN_ITERS[key]) <= 1,
                   f"[sn] {key}: {r['iterations']} iterations, not {SN_ITERS[key]} ± 1")
        del r["x"]
    _check(counts["c"]["bsr8_spmv_bf16"] > 0, "[sn] c: bsr8_spmv on bf16 blocks never ran")
    _check(counts["e"]["sell_spmv_bf16"] > 0, "[sn] e: bf16 K1 never ran")
    _check(counts["f"]["ell_gather_sum_batched"] > 0
           and counts["f"]["ell_gather_sum"] == 0,
           f"[sn] f: the assembly did not gather through K3a alone: {counts['f']}")
    # device time by kernel of one (a) solve (its self-check included)
    def solve_a():
        return solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, system=system, **SN_CONFIGS["a"])

    solve_a()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_a()
    torch.cuda.synchronize()
    _profile(solve_a, os.path.join("build", "profile", "supernode_a.txt"),
             time.perf_counter() - t0, groups=SPHERE_GROUPS)
    print(f"[sn] iterations: ELL (phase 4) {res4['iterations']}, (b) supernode + "
          f"block-Jacobi {runs['b']['iterations']}, (d) ELL + block-Jacobi "
          f"{runs['d']['iterations']}", flush=True)

    # every assembly route feeds the same corners to the same element
    # kernel and sums each slot in one fixed order: two assemblies on each
    # route equal each other and the split route's, bit for bit, with no
    # deterministic-algorithms switch
    conn = mesh.cells["tetra4"]
    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    lay = system["A"].layout
    asm_b = TetraAssembler(topo, conn, device=dev, coords_batched=True, layout=lay)
    gs, gb = tet_corners_plain(coords, asm_b.corner_cols), asm_b.gather_corners(coords)
    same = all(torch.equal(gs[k], gb[k]) for k in range(3))
    print(f"[sn] (f) corners equal to the split gather's: {same}", flush=True)
    _check(same, "(f) batched coordinate gather != split gather")
    del gs, gb
    first, equal = None, {}
    for route, kw in ASM_ROUTES.items():
        asm_r = asm_b if kw == dict(coords_batched=True) else TetraAssembler(
            topo, conn, device=dev, layout=lay, **kw)
        v1, v2 = asm_r(coords), asm_r(coords)
        first = v1 if first is None else first
        equal[route] = [torch.equal(v1, v2), torch.equal(v1, first)]
        del asm_r, v1, v2
    print(f"[asm] two assemblies on each route: [equal to each other, equal to the "
          f"split route's] {json.dumps(equal)}", flush=True)
    _check(all(a and b for a, b in equal.values()),
           f"assembled values differ between runs or routes: {equal}")
    del first

    # the kernels at the route's shapes, against their plain twins
    A = system["A"]
    sn = system["sn"]
    n, W = A.n_nodes, A.width
    nnz, lay = topo.nnz, A.layout
    ell_vals = A.ell_values()
    ell_cols = torch.as_tensor(topo.ell_cols.astype("int32"), device=dev)
    nnzb, n_sup = sn.blocks.shape[0], sn.n_sup
    e_sn = operator_self_check(sn, A)
    print(f"[sn] supernode SpMV vs K1 sell_spmv on a unit-random x: {e_sn:.2e} of "
          f"each row's sum |a x| (tol 1e-5); {nnzb} blocks, {sn.nbytes / 1e9:.3f} GB",
          flush=True)
    _check(e_sn <= 1e-5, f"supernode SpMV vs K1: {e_sn:.2e}")
    x = torch.rand(n, generator=gen, device=dev) * 2 - 1
    records = _bsr8_records(sn, A, x, counts)
    # K3a's supernode role before bsr8_spmv, which no path runs any more:
    # the column gather into (nnzb, 8) and the row reduce of the block
    # products, kept at the route's shapes as kernel checks
    deg = np.diff(sn.bptr)
    rb = np.full((n_sup, int(deg.max())), -1, np.int32)
    rb[sn.brow, np.arange(nnzb) - np.repeat(sn.bptr[:-1], deg)] = np.arange(
        nnzb, dtype=np.int32)
    row_blocks = torch.as_tensor(rb, device=dev)
    sn_cols = sn.cols.view(-1, 1)
    xb = torch.nn.functional.pad(x, (0, n_sup * 8 - n)).view(n_sup, 8)
    xg = torch.empty((nnzb, 8), device=dev)
    yp = block_products(sn.blocks, ell_gather_sum_batched(sn_cols, xb.T, out=xg.T).T)
    yb = torch.empty((n_sup, 8), device=dev)
    bcol = torch.as_tensor(sn.bcol, device=dev)
    rsum = torch.sparse_csr_tensor(
        torch.as_tensor(sn.bptr, device=dev), torch.arange(nnzb, device=dev),
        torch.ones(nnzb, device=dev), size=(n_sup, nnzb))
    X8 = torch.rand((n, 8), generator=gen, device=dev) * 2 - 1
    Y8 = torch.empty((n, 8), device=dev)
    X8t, Y8t = X8.T.contiguous(), torch.empty((8, n), device=dev)
    crow = torch.as_tensor(topo.row_ptr, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(
        crow, torch.as_tensor(topo.csr_cols, device=dev, dtype=torch.int64),
        ell_vals.reshape(-1)[torch.as_tensor(topo.csr_to_ell, device=dev,
                                             dtype=torch.int64)], size=(n, n))
    asm_corner = asm_b.corner_cols
    vbf = A.values.bfloat16()
    perm_bytes = 0 if lay.perm is None else 4 * n
    cases = [
        # name, source line, kernel, plain twin, library call, (bytes, flops),
        # launches, shape, bytes of the SELL slots read (SELL kernels)
        ("ell_gather_sum_batched (sn cols)", "sparse/pallas_spmv.py:478",
         lambda: ell_gather_sum_batched(sn_cols, xb.T, out=xg.T),
         lambda: ell_gather_sum_batched_plain(sn_cols, xb.T),
         lambda: xb.index_select(0, bcol), (nnzb * 36 + n_sup * 32, 0),
         0, [nnzb, 1, 8], None),
        ("ell_gather_sum_batched (sn rows)", "sparse/pallas_spmv.py:478",
         lambda: ell_gather_sum_batched(row_blocks, yp.T, out=yb.T),
         lambda: ell_gather_sum_batched_plain(row_blocks, yp.T),
         lambda: torch.sparse.mm(rsum, yp),
         (nnzb * 32 + row_blocks.numel() * 4 + n_sup * 32, nnzb * 8),
         0, [n_sup, row_blocks.shape[1], 8], None),
        ("ell_gather_sum_batched (coords)", "sparse/pallas_spmv.py:478",
         lambda: ell_gather_sum_batched(asm_corner, coords.T),
         lambda: ell_gather_sum_batched_plain(asm_corner, coords.T),
         lambda: coords.index_select(0, asm_corner[:, 0].long()),
         (asm_corner.numel() * 16 + n * 12, 0),
         counts["f"]["ell_gather_sum_batched"], [asm_corner.shape[0], 1, 3], None),
        # K3b: 8 channel-minor tables on the fine operator's own SELL layout;
        # its floor, as K1's, counts the nonzeros: 8 bytes each, and per row
        # the permutation, 8 table values and 8 outputs
        ("sell_spmv_batched", "sparse/pallas_spmv.py:513",
         lambda: sell_spmv_batched(A.values, lay, X8.T, out=Y8.T),
         lambda: sell_spmv_batched_plain(A.values, lay, X8.T),
         lambda: torch.sparse.mm(csr, X8),
         (nnz * 8 + n * 64 + perm_bytes, 16 * nnz), 0, [n, W, 8],
         lay.n_slots * 8 + n * 64 + perm_bytes),
        # the same on table-major (8, n) tables, the layout JAX's
        # call_batched stacks: eight 4-byte loads from eight rows per slot
        ("sell_spmv_batched (table-major)", "sparse/pallas_spmv.py:513",
         lambda: sell_spmv_batched(A.values, lay, X8t, out=Y8t),
         lambda: sell_spmv_batched_plain(A.values, lay, X8t),
         lambda: torch.sparse.mm(csr, X8t.T),
         (nnz * 8 + n * 64 + perm_bytes, 16 * nnz), 0, [n, W, 8],
         lay.n_slots * 8 + n * 64 + perm_bytes),
        ("sell_spmv (bf16 weights)", "sparse/pallas_spmv.py:398",
         lambda: sell_spmv(vbf, lay, x), lambda: sell_spmv_plain(vbf, lay, x),
         None, (nnz * 6 + n * 12, 2 * nnz), counts["e"]["sell_spmv_bf16"], [n, W],
         lay.n_slots * 6 + n * 8 + perm_bytes),
    ]
    # sums are held to 1e-5 of each row's sum |v x|, as K1/K2; the W=1
    # gathers copy values and must equal their twins
    scales = {
        "ell_gather_sum_batched (sn rows)": ell_gather_sum_batched_plain(
            row_blocks, yp.T.abs()),
        "sell_spmv_batched": ell_spmv_batched_plain(ell_vals.abs(), ell_cols, X8.T.abs()),
        "sell_spmv_batched (table-major)": ell_spmv_batched_plain(
            ell_vals.abs(), ell_cols, X8t.abs()),
        "sell_spmv (bf16 weights)": sell_spmv_plain(vbf.abs(), lay, x.abs()),
    }
    # each of K3b's tables sums in K1's order: reported, not required
    yk = sell_spmv_batched(A.values, lay, X8.T, out=Y8.T)
    same = all(torch.equal(yk[b], sell_spmv(A.values, lay, X8[:, b].contiguous()))
               for b in range(8))
    e_def = _rel_err(yk, ell_spmv_batched_plain(ell_vals, ell_cols, X8.T),
                     scales["sell_spmv_batched"])
    print(f"[kernel] sell_spmv_batched: each table equal to K1 sell_spmv on it: {same}; "
          f"{e_def:.2e} of each row's sum |v x| from the (n, W) definition", flush=True)
    _check(e_def <= 1e-5, f"sell_spmv_batched vs the (n, W) definition: {e_def:.2e}")
    del yk
    for name, rep_, fk, fp, lib, (nbytes, flops), launches, shape, slot_bytes in cases:
        yk, yp_ = fk(), fp()
        torch.cuda.synchronize()
        err = float((yk.double() - yp_.double()).abs().max())
        if name in scales:
            rel = _rel_err(yk, yp_, scales[name])
            _check(rel <= 1e-5, f"{name} at the route's shape: {rel:.2e}")
        else:
            rel = err
            _check(torch.equal(yk, yp_), f"{name} at the route's shape: {err:.2e}")
        del yk, yp_
        sell = slot_bytes is not None
        src = "sell_spmv.cu" if sell else "ell_gather.cu"
        ms = time_op(fk, reps=20, outer=3) * 1e3
        dms, events = _device_ms(fk, src)
        pms = time_op(fp, reps=3, outer=2) * 1e3
        lms = time_op(lib, reps=20, outer=3) * 1e3 if lib else None
        bms, bby = _bound(nbytes, flops)
        records.append({
            "name": name, "route": "cuda", "source": f"arcanefem_tpu_torch/csrc/{src}",
            "replaces": f"arcanefem_tpu/{rep_}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dms, "device_events": events,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "library_ms": lms,
            "shape": shape,
            "dtype": "bfloat16 weights, float32" if "bf16" in name else "float32",
            **({"slot_bound_ms": _bound(slot_bytes, 0)[0], "sigma": lay.sigma,
                "slots": lay.n_slots} if sell else {})})
        print(f"[kernel] {name} {shape}: {ms:.4f} ms, device {_fmt_ms(dms)} "
              f"({events[0]} of {events[1]} kernel events traced; bound "
              f"{bms:.4f} ms, {bby}), plain {pms:.3f} ms, library "
              f"{'n/a' if lms is None else f'{lms:.4f} ms'}, max_abs_err {err:.3e} "
              f"({rel:.2e} held), launches {launches}", flush=True)
    # the 8x8 block products of the three-step SpMV, PyTorch ops (an XLA
    # einsum in the JAX package, no Pallas kernel) that the block-Jacobi
    # apply still runs; torch.bmm of the same, for the record
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = [time_op(f, *a, reps=20, outer=3) * 1e3 for f, a in (
        (block_products, (sn.blocks, xg)),
        (torch.bmm, (sn.blocks, xg.unsqueeze(-1))),
        (block_products, (sn.blocks.bfloat16(), xg)))]
    print(f"[kernel] 8x8 block products {[nnzb, 8, 8]} (PyTorch ops, no TPU kernel): "
          f"elementwise product and sum {ms[0]:.4f} ms, torch.bmm {ms[1]:.4f} ms, "
          f"bf16 blocks {ms[2]:.4f} ms; bytes bound "
          f"{_bound(nnzb * 320, nnzb * 128)[0]:.4f} ms", flush=True)
    return records


def _bsr8_records(sn, A, x, counts) -> list[dict]:
    """Phase 9: bsr8_spmv at the 1.9M route's shapes, on f32 blocks (the CG
    operator of (a)-(c)) and bf16 blocks (the V-cycle's fine level on
    (c)), through ``SupernodeSpmv``: held to its plain twin (1e-6 of each
    row's sum |a·x|) and, on f32 blocks, to K1 on the same operator (1e-5);
    timed beside the twin and cuSPARSE BSR (``torch.sparse_bsr_tensor`` of
    the same blocks times x, padded to 8 n_sup), whose refusal is recorded
    in its own words."""
    import torch

    from arcanefem_tpu_torch.sparse.sell import sell_spmv, sell_spmv_plain
    from arcanefem_tpu_torch.sparse.supernode import bsr8_spmv_plain

    n, n_sup, nnzb = sn.n, sn.n_sup, sn.blocks.shape[0]
    k1, k1_scale = (sell_spmv(A.values, A.layout, x),
                    sell_spmv_plain(A.values.abs(), A.layout, x.abs()))
    crow, bcol = sn.ptr.long(), sn.cols.long()
    xp = torch.nn.functional.pad(x, (0, 8 * n_sup - n))
    records = []
    for op, label, launches in ((sn, "f32 blocks", counts["a"]["bsr8_spmv"]),
                                (sn.as_bf16(), "bf16 blocks", counts["c"]["bsr8_spmv_bf16"])):
        blk = op.blocks
        bf16 = blk.dtype == torch.bfloat16
        scale = bsr8_spmv_plain(blk.abs(), op.cols, op.ptr, x.abs())

        def held(yk, yp, scale=scale, bf16=bf16, label=label):
            e = _rel_err(yk, yp, scale)
            _check(e <= 1e-6, f"bsr8_spmv ({label}) vs its twin: {e:.2e}")
            if not bf16:
                e1 = _rel_err(yk, k1, k1_scale)
                print(f"[sn] bsr8_spmv ({label}) vs K1 sell_spmv: {e1:.2e} of each "
                      "row's sum |a x| (tol 1e-5)", flush=True)
                _check(e1 <= 1e-5, f"bsr8_spmv ({label}) vs K1: {e1:.2e}")
            return e

        xl = xp.bfloat16() if bf16 else xp
        lib, note = None, None
        try:
            bsr = torch.sparse_bsr_tensor(crow, bcol, blk, size=(8 * n_sup, 8 * n_sup))
            yl = torch.mv(bsr, xl)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            note = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        else:
            lib = lambda bsr=bsr, xl=xl: torch.mv(bsr, xl)  # noqa: E731
            note = (f"{_rel_err(yl[:n], bsr8_spmv_plain(blk, op.cols, op.ptr, x), scale):.2e}"
                    " of each row's sum |a x| from the twin")
            del yl
        print(f"[sn] cuSPARSE BSR ({label}, torch.sparse_bsr_tensor @ x): {note}", flush=True)
        nbytes = blk.numel() * blk.element_size() + 4 * nnzb + 4 * (n_sup + 1) + 8 * n
        rec = _kernel_record(
            f"bsr8_spmv ({label})", "bsr8_spmv.cu", "sparse/pallas_spmv.py:478",
            lambda op=op: op(x), lambda blk=blk, op=op: bsr8_spmv_plain(blk, op.cols, op.ptr, x),
            lib, (nbytes, 128 * nnzb), launches, [n_sup, nnzb, 8, 8], held,
            dtype="bfloat16 blocks, float32" if bf16 else "float32")
        rec.update(library="cuSPARSE BSR (torch.sparse_bsr_tensor @ x)", library_note=note)
        records.append(rec)
        del scale
    return records


def _counted():
    from arcanefem_tpu_torch.ops import lane_assembly
    from arcanefem_tpu_torch.sparse import (
        band_gather,
        diag_spmv,
        ell_gather,
        sell,
        slot_reduce,
        supernode,
    )

    return ell_gather, sell, band_gather, diag_spmv, lane_assembly, slot_reduce, supernode


def _reset_all() -> None:
    for m in _counted():
        m.reset_launch_counts()


def _counts_all() -> dict:
    return {k: v for m in _counted() for k, v in m.launch_counts().items()}


def _route_run(tag, mesh, topo, dev, system, ell_iters, **opts):
    """One timed solve of a route with its launch counts, checked (rel <=
    1e-8, true residual <= 1e-4, finite x, iterations within 1 of the ELL
    run on the same system) and printed as a ``[tag]`` line."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut

    _reset_all()
    r = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                         penalty=1e12, timed=True, system=system, **opts)
    torch.cuda.synchronize()
    counts = _counts_all()
    line = {"flags": opts, "spmv_path": r["spmv_path"], "iterations": r["iterations"],
            "ell_iterations": ell_iters, "rel": r["rel"],
            "true_residual": r["true_residual"], "solve_s": r["solve_s"],
            "ms_per_iter": r["solve_s"] / max(r["iterations"], 1) * 1e3,
            "assembly_s": r["assembly_s"],
            **{k: r[k] for k in ("compact_setup_s", "compact_check", "vcycle_compact",
                                 "vcycle_band", "diag_setup_s", "diag_check") if k in r},
            "launches": {k: v for k, v in counts.items() if v}}
    print(f"[{tag}] {json.dumps(line)}", flush=True)
    _check(r["rel"] <= 1e-8, f"[{tag}] {opts}: monitored residual {r['rel']:.3e}")
    _check(r["true_residual"] <= 1e-4,
           f"[{tag}] {opts}: true interior residual {r['true_residual']:.3e}")
    _check(bool(torch.isfinite(r["x"]).all()), f"[{tag}] {opts}: non-finite x")
    _check(abs(r["iterations"] - ell_iters) <= 1,
           f"[{tag}] {opts}: {r['iterations']} iterations, ELL {ell_iters}")
    return r, counts


COMPACT_CONFIGS = {  # phases g-i: bench_unstructured's flags
    "g": dict(spmv="compact"),
    "h": dict(spmv="compact", band_pre=True),
    "i": dict(spmv="compact", band_pre=True, asm_compact=True, asm_coords="batched"),
}


def _kernel_names(src: str) -> tuple[str, ...]:
    """The ``__global__`` functions of ``arcanefem_tpu_torch/csrc/<src>``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "arcanefem_tpu_torch", "csrc", src)
    with open(path) as fh:
        names = tuple(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            fh.read()))
    _check(bool(names), f"no __global__ function found in {src}")
    return names


def _own_events_ms(events, names, calls: int) -> tuple[float | None, list[int]]:
    """(median ms, [n, calls]) of the n (name, µs) ``events`` whose kernel
    is one of ``names``; the ms is None, not measured, when n is under
    calls / 2 or at least 2 * calls."""
    pattern = re.compile(r"(?<!\w)(?:" + "|".join(names) + r")(?!\w)")
    mine = sorted(us for name, us in events if pattern.search(name))
    ok = calls <= 2 * len(mine) < 4 * calls
    return (mine[len(mine) // 2] / 1e3 if ok else None), [len(mine), calls]


def _device_ms(fn, src: str, calls: int = 20) -> tuple[float | None, list[int]]:
    """(device ms per call, [events traced, events expected]) of fn, whose
    wrapper launches one kernel of ``src`` per call, from torch.profiler
    over ``calls`` calls: only the events of the kernels defined in
    ``src`` are read, and their median duration is the time
    (``_own_events_ms``).  Late in a long run the profiler loses events
    and has returned stray events of other kernels, so a trace that does
    not give a time is taken again, up to three times, and after that
    the time is None.  For kernels longer than the host's ~15 µs per
    launch the CUDA-event time of back-to-back calls is the device time as
    well; for a kernel of a few microseconds the event time measures the
    host's rate of issuing launches, and this is the number to read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = _kernel_names(src)
    fn()
    torch.cuda.synchronize()
    best: tuple = (None, [0, calls])
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = _own_events_ms([(e.name, e.device_time_total) for e in prof.events()
                              if e.device_type == DeviceType.CUDA], names, calls)
        if got[0] is not None:
            return got
        best = max(best, got, key=lambda r: r[1][0])
    return best


def _fmt_ms(ms: float | None) -> str:
    """A device time for a [kernel] line: its ms, or that none was read."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _kernel_record(name, src, rep_, fk, fp, lib, nbytes_flops, launches, shape,
                   check, dtype="float32"):
    """Hold fk() to fp() with ``check`` (returns the held error, raises on
    failure), then time kernel, twin and library call (CUDA events, best of
    3×20; the twin 2×3); one ``kernels`` record."""
    import torch

    from arcanefem_tpu_torch.utils.timing import time_op

    yk, yp = fk(), fp()
    torch.cuda.synchronize()
    err = float((yk.double() - yp.double()).abs().max())
    held = check(yk, yp)
    del yk, yp
    ms = time_op(fk, reps=20, outer=3) * 1e3
    pms = time_op(fp, reps=3, outer=2) * 1e3
    lms = time_op(lib, reps=20, outer=3) * 1e3 if lib else None
    dms, events = _device_ms(fk, src)
    bms, bby = _bound(*nbytes_flops)
    print(f"[kernel] {name} {shape}: {ms:.4f} ms, device {_fmt_ms(dms)} "
          f"({events[0]} of {events[1]} kernel events traced; bound "
          f"{bms:.4f} ms, {bby}), plain {pms:.3f} ms, library "
          f"{'n/a' if lms is None else f'{lms:.4f} ms'}, max_abs_err {err:.3e} "
          f"({held:.2e} held), launches {launches}", flush=True)
    return {"name": name, "route": "cuda", "source": f"arcanefem_tpu_torch/csrc/{src}",
            "replaces": f"arcanefem_tpu/{rep_}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dms, "device_events": events,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "library_ms": lms,
            "shape": shape, "dtype": dtype}


def _equal(yk, yp) -> float:
    """A gather's check: equal to its plain twin."""
    import torch

    _check(torch.equal(yk, yp), "a gather differs from its plain twin")
    return 0.0


def compact_phase(dev, gen, mesh, topo, res4) -> list[dict]:
    """Phases g-i on phase 4's mesh, operator and AMG hierarchy, the
    compact corners against the split gather's, K2 at route (g)'s CG
    pre-gather and K9a and K9b at their routes' shapes, and the diag
    route's refusal on this system; returns the kernels' records."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut
    from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler, tet_corners_plain
    from arcanefem_tpu_torch.sparse import band_gather as bg
    from arcanefem_tpu_torch.sparse.ell_gather import ell_gather_sum, ell_gather_sum_plain

    system = res4["system"]
    counts = {}
    for key, opts in COMPACT_CONFIGS.items():
        r, counts[key] = _route_run("compact", mesh, topo, dev, system,
                                    res4["iterations"], **opts)
        _check(r["spmv_path"] == "CompactMatrix", f"[compact] {key}: spmv path")
        _check(counts[key]["sell_spmv"] > 0, f"[compact] {key}: K1 never ran")
        del r
    # device time by kernel of one (h) solve (its self-check included)
    def solve_h():
        return solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, system=system, **COMPACT_CONFIGS["h"])

    solve_h()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_h()
    torch.cuda.synchronize()
    _profile(solve_h, os.path.join("build", "profile", "compact_h.txt"),
             time.perf_counter() - t0, groups=SPHERE_GROUPS)
    _check(counts["g"]["band_gather"] == 0 and counts["g"]["ell_gather_sum"] > 0,
           f"[compact] g: K9a ran without --band-pre, or K2 never ran: {counts['g']}")
    _check(counts["h"]["band_gather"] > 0, "[compact] h: K9a never ran")
    # the banded pre-gathers are one launch each: no K2 for their wide tiles,
    # and on (i) K3a only for the 9 assemblies' remap gathers
    for key in "hi":
        _check(counts[key]["ell_gather_sum"] == 0,
               f"[compact] {key}: K2 ran beside the banded pre-gathers: {counts[key]}")
    _check(counts["i"]["band_gather_batched"] > 0, "[compact] i: K9b never ran")
    _check(counts["i"]["ell_gather_sum_batched"] == 9,
           f"[compact] i: K3a ran {counts['i']['ell_gather_sum_batched']} times, not 9")

    # the compact corners equal the split gather's; K9a on the CG operator's
    # pre-gather, K9b on the compact coordinates', each a whole band plan
    # (narrow and wide tiles) in one launch
    conn = mesh.cells["tetra4"]
    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    t0 = time.perf_counter()
    lay = system["A"].layout
    asm_c = TetraAssembler(topo, conn, device=dev, layout=lay, coords_batched=True,
                           coords_compact=True, band_pre=True)
    host_s = time.perf_counter() - t0
    gs = tet_corners_plain(coords, asm_c.corner_cols)
    gc = asm_c.gather_corners(coords)
    same = all(torch.equal(gs[k], gc[k]) for k in range(3))
    cb = asm_c.compact.pre
    print(f"[compact] (i) corners equal to the split gather's: {same}; coordinate "
          f"pre-gather {cb.n_narrow} of {cb.n_tiles} tiles narrow, "
          f"{asm_c.compact.remap.shape[0]} requests, host build {host_s:.1f} s", flush=True)
    _check(same, "(i) compact coordinate gather != split gather")
    del gs, gc

    cg = system[("compact", True)][0]
    band = cg.pre
    n = topo.n_nodes
    print(f"[compact] CG pre-gather: {band.n_narrow} of {band.n_tiles} tiles narrow, "
          f"{band.n_rows} outputs", flush=True)
    x = torch.rand(n, generator=gen, device=dev) * 2 - 1

    def requests(g):
        """Every request of a band plan as plain indices, pads at 0: the
        library call's index."""
        bases, lcols = g._narrow()
        idx = torch.where((lcols >= 0) & (lcols < g.K * 128),
                          bases.long()[:, None] * 128 + lcols.long(), 0).reshape(-1)
        if g.wide_cols is None:
            return idx
        return torch.cat([idx, g.wide_cols.long().clamp(min=0)])

    gidx, cgidx = requests(band), requests(cb)
    nreq, creq = band.n_rows, cb.n_rows
    # K2 as route (g) runs it: the CG operator's pre-gather x[uniq] (the
    # V-cycle's levels and transfers run it at smaller shapes; the count
    # is all of them)
    ucols = system[("compact", False)][0].pre.cols
    uidx = ucols[:, 0].long()
    records = [
        _kernel_record(
            "ell_gather_sum", "ell_gather.cu", "sparse/pallas_spmv.py:444",
            lambda: ell_gather_sum(ucols, x), lambda: ell_gather_sum_plain(ucols, x),
            lambda: x[uidx], (ucols.numel() * 8 + n * 4, 0),
            counts["g"]["ell_gather_sum"], list(ucols.shape), _equal),
        _kernel_record(
            "band_gather", "band_gather.cu", "sparse/band_gather.py:52",
            lambda: band(x),
            lambda: bg.banded_gather_plain(*band._narrow(), band.wide_cols, x, band.K),
            lambda: x[gidx], (nreq * 8 + n * 4, 0), counts["h"]["band_gather"],
            [band.n_narrow, band.n_tiles - band.n_narrow, 128], _equal),
        _kernel_record(
            "band_gather_batched (coords)", "band_gather.cu", "sparse/band_gather.py:109",
            lambda: cb.call_batched(coords.T),
            lambda: bg.banded_gather_batched_plain(*cb._narrow(), cb.wide_cols,
                                                   coords.T, cb.K),
            lambda: coords.index_select(0, cgidx), (creq * 16 + n * 12, 0),
            counts["i"]["band_gather_batched"],
            [cb.n_narrow, cb.n_tiles - cb.n_narrow, 128, 3], _equal),
    ]
    del asm_c, x, gidx, cgidx, uidx

    # no fallback: the diag SpMV raises on this (supernode-ordered) system
    try:
        solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32, penalty=1e12,
                         system=system, spmv="diag")
    except ValueError as e:
        print(f"[compact] --spmv diag on the 1.9M system raises: {e}", flush=True)
    else:
        _check(False, "--spmv diag ran on the 1.9M system, where plan_diag declines")
    return records


def _rcm_box(n: int, dev, gen):
    """The 80^3-style RCM box of the JAX tools/bench_spmv.py: W padded to 8,
    random f32 values on the valid slots."""
    import torch

    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh
    from arcanefem_tpu_torch.sparse.topology import build_topology
    from arcanefem_tpu_torch.utils.ordering import rcm_order, renumber_mesh

    mesh = box_tetra_mesh(n, n, n)
    t = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    mesh = renumber_mesh(mesh, rcm_order(mesh.n_nodes, t.row_ptr, t.csr_cols))
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    valid = torch.as_tensor(topo.ell_valid, device=dev)
    vals = torch.rand(valid.shape, generator=gen, device=dev) * valid
    return topo, vals


def diag_phase(dev, gen) -> list[dict]:
    """Phase j: the RCM sphere at 244k, ELL then diag on the same system;
    K10 there and on the 80^3 RCM box beside K1 and CSR torch.mv."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
    from arcanefem_tpu_torch.sparse.bell import BellMatrix
    from arcanefem_tpu_torch.sparse.diag_spmv import DiagEllMatrix, diag_spmv_plain
    from arcanefem_tpu_torch.sparse.ell_gather import ell_spmv_plain
    from arcanefem_tpu_torch.sparse.sell import SellLayout
    from arcanefem_tpu_torch.utils.timing import time_op

    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(5.0, 1, order="rcm")
    print(f"[diag] host set-up of the RCM sphere h=5 r=1 ({topo.n_nodes} nodes, "
          f"W={topo.width}) {time.perf_counter() - t0:.1f} s", flush=True)
    _reset_all()
    ell = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32, penalty=1e12,
                           timed=True, order="rcm")
    torch.cuda.synchronize()
    line = {"flags": {"order": "rcm"}, "iterations": ell["iterations"], "rel": ell["rel"],
            "true_residual": ell["true_residual"], "solve_s": ell["solve_s"],
            "ms_per_iter": ell["solve_s"] / ell["iterations"] * 1e3,
            "launches": {k: v for k, v in _counts_all().items() if v}}
    print(f"[diag] {json.dumps(line)}", flush=True)
    _check(ell["rel"] <= 1e-8 and ell["true_residual"] <= 1e-4, "[diag] ELL route residuals")
    r, counts = _route_run("diag", mesh, topo, dev, ell["system"], ell["iterations"],
                           order="rcm", spmv="diag")
    _check(r["spmv_path"] == "DiagEllMatrix" and counts["diag_spmv"] > 0,
           "[diag] K10 never ran on the diag route")
    A = ell["A"]
    t0 = time.perf_counter()
    btopo, bvals = _rcm_box(80, dev, gen)
    print(f"[diag] host set-up of the 80^3 RCM box {time.perf_counter() - t0:.1f} s",
          flush=True)
    blay = SellLayout.build(btopo.ell_cols, btopo.ell_valid, device=dev)
    records = []
    for label, K1, tp in (("sphere h=5 r=1 rcm", A, topo),
                          ("box 80^3 rcm", BellMatrix(blay.from_ell(bvals), blay), btopo)):
        vals = K1.ell_values()
        cols = torch.as_tensor(tp.ell_cols.astype("int32"), device=dev)
        n, W = vals.shape
        t0 = time.perf_counter()
        D = DiagEllMatrix(vals, tp.ell_cols)
        p = D.plan
        print(f"[diag] {label}: {n} x {W}, plan {time.perf_counter() - t0:.1f} s, "
              f"mean probes {float(p.scnt.mean()):.1f}, S {p.n_probes}, window "
              f"{p.window}", flush=True)
        x = torch.rand(n, generator=gen, device=dev) * 2 - 1
        scale = ell_spmv_plain(vals.abs(), cols, x.abs()).double()

        def held(yk, yp, scale=scale):
            e = _rel_err(yk, yp, scale)
            _check(e <= 1e-5, f"diag_spmv at {label}: {e:.2e}")
            return e

        crow = torch.as_tensor(tp.row_ptr, device=dev, dtype=torch.int64)
        csr = torch.sparse_csr_tensor(
            crow, torch.as_tensor(tp.csr_cols, device=dev, dtype=torch.int64),
            vals.reshape(-1)[torch.as_tensor(tp.csr_to_ell, device=dev,
                                             dtype=torch.int64)], size=(n, n))
        rec = _kernel_record(
            f"diag_spmv ({label})", "diag_spmv.cu", "sparse/pallas_spmv_diag.py:158",
            lambda: D.spmv(x),
            lambda: diag_spmv_plain(D.lo, D.c0, D.scnt, D.lcols, D.vals_tiled, x, W),
            lambda: torch.mv(csr, x), (n * W * 8 + n * 8, 2 * n * W),
            counts["diag_spmv"] if label.startswith("sphere") else 0, [n, W], held)
        rec["k1_ms"] = time_op(K1.spmv, x, reps=20, outer=3) * 1e3
        e1 = _rel_err(D.spmv(x), K1.spmv(x), scale)
        print(f"[diag] {label}: K10 {rec['ms']:.4f} ms, K1 on the same operator "
              f"{rec['k1_ms']:.4f} ms, CSR torch.mv {rec['library_ms']:.4f} ms; K10 vs "
              f"K1 {e1:.2e} of each row's sum |a x|", flush=True)
        _check(e1 <= 1e-5, f"K10 vs K1 at {label}")
        records.append(rec)
        del D, x, scale, csr, K1, vals, cols
    del ell, r, A, mesh, topo, btopo, bvals, blay
    return records


def probe_phase(dev) -> list[dict]:
    """The gather probes P1-P3: the probe tool's entry point at (K, G) =
    (160, 64) (P1 and P2 checked against numpy, P3 timed at K = 160 and
    1024) with its launch count, then each probe at K = 160 and 1024 held
    to its twin and timed (tools/probe_gather.py::measure)."""
    from arcanefem_tpu_torch.tools import probe_gather as pg

    pg.reset_launch_counts()
    pg.main(["160", "64"])
    launches = pg.launch_counts()["window_take"]
    print(f"[probe] the probe tool launched window_take {launches} times", flush=True)
    _check(launches > 0, "the probe tool never launched window_take")
    ok = [f(K, 64, dev) for K in (160, 1024) for f in (pg.probe_A, pg.probe_B)]
    _check(all(ok), f"gather probes against numpy: {ok}")
    records = []
    for K in (160, 1024):
        for name, line, mode, nb in (("P1 column take", 19, "column", 1),
                                     ("P2 flat take", 42, "flat", 1),
                                     ("P3 column take over 256 windows", 66, "column", 256)):
            m = pg.measure(mode, K, 64, nb, device=dev)
            _check(m["equal"], f"{name} K={K}: differs from its plain twin")
            win, idx = pg._inputs(nb, K, 64, mode, dev)
            m["device_ms"], m["device_events"] = _device_ms(
                lambda: pg.window_take(win, idx, mode), "window_gather.cu")
            print(f"[probe] {name} K={K} G=64 nb={nb}: {m['ms']:.4f} ms, device "
                  f"{_fmt_ms(m['device_ms'])}, "
                  f"{m['gelem_s']:.2f} Gelem/s, plain {m['plain_ms']:.4f} ms, library "
                  f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms; host "
                  f"{m['host_us']:.2f} us per call, torch.gather {m['gather_host_us']:.2f} "
                  f"us ({'shared memory' if K <= pg.SMEM_MAX_K else 'L1/L2'})", flush=True)
            records.append({
                "name": f"window_take ({name}, K={K})", "route": "cuda",
                "source": "arcanefem_tpu_torch/csrc/window_gather.cu",
                "replaces": f"arcanefem_tpu/tools/probe_gather.py:{line}",
                "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "device_ms": m["device_ms"], "device_events": m["device_events"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": m["library_ms"], "gelem_s": m["gelem_s"],
                "host_us": m["host_us"], "gather_host_us": m["gather_host_us"],
                "window_in": "shared memory" if K <= pg.SMEM_MAX_K else "L1/L2",
                "shape": [nb, K, 64], "dtype": "float32"})
    return records


def _structured_parity(dev, gen) -> None:
    """Phase 6: K4-K8 against their plain twins on the card."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.mesh.structured import StructuredBox
    from arcanefem_tpu_torch.sparse import dia_stencil as ds

    box = StructuredBox(*PARITY_BOX)
    nyp, nzp = ds._pads(box)
    real = torch.zeros((box.nx + 1, nyp, nzp), dtype=torch.bool, device=dev)
    real[:, 1 : box.ny + 2, 1 : box.nz + 2] = True

    def vec():
        return torch.where(real, torch.rand(real.shape, generator=gen,
                                            device=dev) * 2 - 1, 0.0)

    x, b, aux = vec(), vec(), vec()
    for band_major in (False, True):
        shape = (15, box.nx + 1, nyp, nzp) if band_major else (box.nx + 1, 15, nyp, nzp)
        for bdt in (torch.float32, torch.bfloat16):
            bands = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(bdt)
            kw = dict(band_major=band_major, ny=box.ny, nz=box.nz)
            scale = (ds.dia_stencil_plain("spmv", bands.abs(), x.abs(), **kw)
                     + b.abs() + x.abs())
            for mode, extra in (("spmv", {}),
                                ("jacobi", dict(b=b, aux=aux, omega=0.8)),
                                ("residual", dict(b=b, aux=aux))):
                y = ds.dia_stencil(mode, bands, x, **kw, **extra)
                torch.cuda.synchronize()
                e = _rel_err(y, ds.dia_stencil_plain(mode, bands, x, **kw, **extra),
                             scale)
                print(f"[parity] dia_stencil {mode} {str(bdt)[6:]} bands "
                      f"{'band' if band_major else 'x'}-major {box.shape}: {e:.2e} "
                      f"(rtol 1e-5 of sum |band x| + |b| + |x|)", flush=True)
                _check(e <= 1e-5, f"dia_stencil {mode} {bdt} {band_major}")
                _check(bool((y[~real] == 0).all()), f"dia_stencil {mode} pads")

    c3 = torch.as_tensor(box.grid_coords(np.float32, jitter=0.1), device=dev)
    mask = box.boundary_mask(("xmin", "xmax"))
    g = np.where(box.boundary_mask(("xmax",)), 1.0, 0.0)
    mask_p = torch.as_tensor(ds.pad_host_vec(box, mask), device=dev)
    pg_p = torch.as_tensor(ds.pad_host_vec(box, 1e12 * g * mask), device=dev)
    A, Ap = sa.assemble_stiffness_kernel(box, c3), sa.assemble_stiffness_plain(box, c3)
    e, tol = float((A.bands - Ap.bands).abs().max() / Ap.bands.abs().max()), _asm_tol(box)
    print(f"[parity] stencil_assembly stiffness {box.shape}: {e:.2e} of max|band| "
          f"(tol {tol:.2e})", flush=True)
    _check(e <= tol, "stencil assembly, stiffness")
    (Mk, rk), (Mp, rp) = (f(box, c3, mask_p, pg_p, 1e12, 1.0) for f in
                          (sa.assemble_system, sa.assemble_system_plain))
    torch.cuda.synchronize()
    free = torch.as_tensor(~mask, device=dev)
    eb = max(float((Mk.unpad_vec(Mk.bands_p[:, d]) - Mp.unpad_vec(Mp.bands_p[:, d]))[free]
                   .abs().max()) for d in range(15)) / float(Ap.bands.abs().max())
    er = float((Mk.unpad_vec(rk) - Mp.unpad_vec(rp))[free].abs().max()
               / Mp.unpad_vec(rp)[free].abs().max())
    print(f"[parity] stencil_assembly fused with BC {box.shape}: bands {eb:.2e}, "
          f"rhs {er:.2e} on free rows (tol {tol:.2e}); Dirichlet rows equal: "
          f"{torch.equal(Mk.bands_p[:, ds.D0][mask_p > 0], Mp.bands_p[:, ds.D0][mask_p > 0])}",
          flush=True)
    _check(eb <= tol and er <= tol, "stencil assembly, fused")
    _check(torch.equal(rk[mask_p > 0], rp[mask_p > 0]), "fused BC rhs rows")
    _check(bool((rk[~real] == 0).all()) and bool((Mk.bands_p.movedim(1, 0)[:, ~real] == 0).all()),
           "fused assembly pads")


def _asm_tol(box) -> float:
    """K4's tolerance against its plain twin, relative to the largest band
    entry: 4·eps32·n for n hexes along the finest axis.  A float32
    coordinate difference of size h = 1/n carries a relative rounding of
    eps32·n, and the kernel and its twin take the differences in different
    orders (1.1e-4 at n = 224)."""
    return 4 * 1.1920929e-07 * max(box.nx, box.ny, box.nz)


STRUCTURED_GROUPS = {
    "stencil_assembly": "stencil_assembly_kernel",
    "dia_stencil spmv": "dia_stencil_kernel<0,",
    "dia_stencil jacobi": "dia_stencil_kernel<1,",
    "dia_stencil residual (bf16)": "dia_stencil_kernel<2, __nv_bfloat16",
    "dia_stencil residual (f64 replacement)": "dia_stencil_kernel<2, float, double",
    "cat/stack copies": "CatArrayBatchedCopy", "reductions": "reduce_kernel"}
SPHERE_GROUPS = {
    "K1 sell_spmv": "sell_spmv_kernel<float, float>",
    "K1 sell_spmv, bf16 weights": "sell_spmv_kernel<__nv_bfloat16",
    "K2 ell_gather_sum": "ell_gather_kernel", "K9a band_gather": "band_gather_kernel",
    "tet_element": "tet_element_kernel", "slot_reduce": "slot_reduce_kernel",
    "K10 diag_spmv": "diag_spmv_kernel", "cat/stack copies": "CatArrayBatchedCopy",
    "bsr8_spmv": "bsr8_spmv_kernel", "reductions": "reduce_kernel"}


def _profile(fn, path: str, wall_s: float, top: int = 12,
             groups: dict = STRUCTURED_GROUPS) -> None:
    """Device time by kernel of one call of fn, from torch.profiler: the
    sum over kernel events, and its share of ``wall_s`` (one unprofiled
    call); the operator table goes to ``path``.  ``groups`` sums kernels by
    the first name fragment they contain."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.device_time_total
            t[1] += 1
    total = max(sum(t for t, _ in by_name.values()), 1e-9)
    print(f"[profile] kernel time of one solve {total / 1e3:.3f} ms in "
          f"{sum(n for _, n in by_name.values())} launches; unprofiled wall "
          f"{wall_s * 1e3:.3f} ms, busy share {total / 1e6 / wall_s:.3f} "
          f"(table: {path})", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile] {t / 1e3:9.3f} ms {t / total:6.1%} {n:5d}x {name[:100]}",
              flush=True)
    sums = {g: [0.0, 0] for g in (*groups, "other (elementwise, copies, fills)")}
    for name, (t, n) in by_name.items():
        g = next((g for g, key in groups.items() if key in name),
                 "other (elementwise, copies, fills)")
        sums[g][0] += t
        sums[g][1] += n
    for g, (t, n) in sums.items():
        print(f"[profile] group {g}: {t / 1e3:.3f} ms {t / total:.1%} {n}x", flush=True)


def structured_phases(dev, gen) -> list[dict]:
    """Phases 6-8; returns the records of K4-K8."""
    import torch

    from arcanefem_tpu_torch.bench_structured import (
        PENALTY, bench_line, box_system, solve_jacobi, solve_mg, solve_mg_flat,
        true_residual)
    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.sparse import dia_stencil as ds
    from arcanefem_tpu_torch.utils.timing import time_op

    _structured_parity(dev, gen)

    # 7. the structured path at 224^3
    t0 = time.perf_counter()
    s = box_system(BOX_N, dev)
    print(f"[box] host set-up (coordinates, mask planes) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ds.reset_launch_counts()
    sa.reset_launch_counts()
    res = solve_mg(s)
    torch.cuda.synchronize()
    counts = {**sa.launch_counts(), **ds.launch_counts()}
    line = bench_line(s, res, "mg")
    iters = res["iterations"]
    line["launches"] = counts
    print(f"[box] {json.dumps(line)}", flush=True)
    print(f"[box] launches per CG iteration: "
          + ", ".join(f"{k} {v / iters:.2f}" for k, v in counts.items()), flush=True)
    _check(res["rel"] <= 1e-8, f"box monitored residual {res['rel']:.3e}")
    _check(line["true_residual"] <= 1e-4, f"box true residual {line['true_residual']:.3e}")
    _check(bool(torch.isfinite(res["x"]).all()), "box: non-finite solution")
    if BOX_N == 224:
        _check(abs(iters - 13) <= 1, f"box iterations {iters}, JAX 13 (BENCH_r05)")
    for k in ("stencil_assembly", "dia_spmv_p", "dia_jacobi_p", "dia_residual_p"):
        _check(counts[k] > 0, f"kernel {k} never ran on the structured path")
    r0 = solve_mg(s, replace_every=0)
    print(f"[box] without residual replacement: {r0['iterations']} iterations, "
          f"rel {r0['rel']:.3e}, true residual {true_residual(s, r0):.3e}", flush=True)
    del r0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_mg(s)
    torch.cuda.synchronize()
    _profile(lambda: solve_mg(s), os.path.join("build", "profile", "structured.txt"),
             time.perf_counter() - t0)

    variants = {}
    for name, solve in (("jacobi", solve_jacobi), ("mg_flat", solve_mg_flat)):
        ds.reset_launch_counts()
        sa.reset_launch_counts()
        r = solve(s)
        torch.cuda.synchronize()
        variants[name] = {**sa.launch_counts(), **ds.launch_counts()}
        vline = bench_line(s, r, name)  # raises on a failed residual check
        print(f"[box] {json.dumps({**vline, 'launches': variants[name]})}", flush=True)
        S = r["A"]
        del r
    jcounts, fcounts = variants["jacobi"], variants["mg_flat"]
    _check(jcounts["dia_spmv"] > 0, "K8a never ran on the Jacobi path")
    _check(fcounts["dia_spmv"] > 0 and fcounts["dia_sweep"] > 0,
           "K8a or K8b never ran on the flat MG path")

    # each kernel at the path's shapes
    box, N = s.box, s.box.n_nodes
    A, M = res["A"], res["M"]
    A1 = M.mats[0]  # the fine level in bf16
    mm, invd = M.maskmul_p[0], M.inv_diags_p[0]
    invd_bm = ds._inv_nonzero(S.bands_p[ds.D0])  # band-major fine level
    real = A.pad_vec(torch.ones(N, device=dev)) > 0

    def vec():
        return torch.where(real, torch.rand(real.shape, generator=gen, device=dev), 0.0)

    xr, br = vec(), vec()
    bands_dia = A.bands_p.movedim(1, 0)[:, :, 1 : box.ny + 2, 1 : box.nz + 2].reshape(15, -1)
    rows = torch.arange(N, device=dev)
    offs = torch.tensor(box.offsets, device=dev)
    cols = rows[None, :] + offs[:, None]
    keep = (cols >= 0) & (cols < N) & (bands_dia != 0)
    order = torch.argsort(rows.expand(15, N)[keep], stable=True)
    csr_rows = rows.expand(15, N)[keep][order]
    csr = torch.sparse_csr_tensor(
        torch.searchsorted(csr_rows, torch.arange(N + 1, device=dev)),
        cols[keep][order], bands_dia[keep][order], size=(N, N))
    del cols, keep, order, csr_rows, rows
    xflat = A.unpad_vec(xr)
    y_csr = csr @ xflat
    print(f"[kernel] CSR library SpMV of the {box.shape} operator vs K5: max_abs_err "
          f"{float((y_csr - A.unpad_vec(A.spmv(xr))).abs().max()):.3e}", flush=True)
    del y_csr

    def stencil(mode, bands, band_major, **extra):
        """(kernel, plain twin, error check) of one stencil-kernel call on
        xr.  The check holds it to 1e-5 of the magnitude its sums run over,
        per node: s = sum |band x| + |b|, and then s for spmv, |x| +
        omega |aux| s for jacobi, |aux| s for residual."""
        geo = dict(band_major=band_major, ny=box.ny, nz=box.nz)
        kw = {**geo, **extra}
        sums = ds.dia_stencil_plain("spmv", bands.abs(), xr.abs(), **geo)
        if mode == "jacobi":
            scale = xr.abs() + extra["omega"] * extra["aux"].abs() * (sums + extra["b"].abs())
        elif mode == "residual":
            scale = extra["aux"].abs() * (sums + extra["b"].abs())
        else:
            scale = sums

        def check(y, yp):
            e = _rel_err(y, yp, scale)
            _check(e <= 1e-5 and bool((y[~real] == 0).all()),
                   f"dia_stencil {mode} at {box.shape}: {e:.2e} of the sums' "
                   "magnitude, or a non-zero pad")
            return e
        return (lambda x: ds.dia_stencil(mode, bands, x, **kw),
                lambda x: ds.dia_stencil_plain(mode, bands, x, **kw), check)

    free = torch.as_tensor(~s.mask, device=dev)
    dir_p = s.mask_p > 0

    def check_assembly(out, want):
        """Fused K4 at the path's shape: bands and rhs on free rows to
        _asm_tol of their largest free-row value, Dirichlet rows equal and
        pads zero."""
        (Mk, rk), (Mp, rp) = out, want
        tol = _asm_tol(box)
        bk = torch.stack([Mk.unpad_vec(Mk.bands_p[:, d])[free] for d in range(15)])
        bp = torch.stack([Mp.unpad_vec(Mp.bands_p[:, d])[free] for d in range(15)])
        eb = float((bk - bp).abs().max() / bp.abs().max())
        fr = Mp.unpad_vec(rp)[free]
        er = float((Mk.unpad_vec(rk)[free] - fr).abs().max() / fr.abs().max())
        print(f"[kernel] stencil_assembly at {box.shape}: bands {eb:.2e}, rhs "
              f"{er:.2e} on free rows (tol {tol:.2e})", flush=True)
        _check(eb <= tol and er <= tol, f"stencil assembly at {box.shape}")
        _check(torch.equal(Mk.bands_p[:, ds.D0][dir_p], Mp.bands_p[:, ds.D0][dir_p])
               and torch.equal(rk[dir_p], rp[dir_p]), "fused BC rows at the path's shape")
        _check(bool((rk[~real] == 0).all())
               and bool((Mk.bands_p.movedim(1, 0)[:, ~real] == 0).all()),
               "fused assembly pads at the path's shape")
        return max(eb, er)

    n_tets = box.n_cells
    asm_args = (box, s.coords3d, s.mask_p, s.pg_p, PENALTY, 1.0)
    cases = [
        ("stencil_assembly", "stencil_assembly.cu", "mesh/pallas_stencil.py:168",
         (sa.assemble_system, sa.assemble_system_plain, check_assembly), asm_args,
         None, _bound(84 * N, 220 * n_tets), counts["stencil_assembly"], "float32"),
        ("dia_spmv_p", "dia_stencil.cu", "sparse/dia_pallas.py:307",
         stencil("spmv", A.bands_p, False), (xr,), (torch.mv, (csr, xflat)),
         _bound(68 * N, 30 * N), counts["dia_spmv_p"], "float32"),
        ("dia_jacobi_p", "dia_stencil.cu", "sparse/dia_pallas.py:330",
         stencil("jacobi", A1.bands_p, False, b=br, aux=invd, omega=0.8), (xr,),
         None, _bound(46 * N, 33 * N), counts["dia_jacobi_p"], "bfloat16 bands"),
        ("dia_residual_p", "dia_stencil.cu", "sparse/dia_pallas.py:354",
         stencil("residual", A1.bands_p, False, b=br, aux=mm), (xr,), None,
         _bound(46 * N, 32 * N), counts["dia_residual_p"], "bfloat16 bands"),
        ("dia_spmv", "dia_stencil.cu", "sparse/dia_pallas.py:69",
         stencil("spmv", S.bands_p, True), (xr,), (torch.mv, (csr, xflat)),
         _bound(68 * N, 30 * N), jcounts["dia_spmv"], "float32"),
        ("dia_sweep", "dia_stencil.cu", "sparse/dia_pallas.py:109",
         stencil("jacobi", S.bands_p, True, b=br, aux=invd_bm, omega=0.8), (xr,),
         None, _bound(76 * N, 33 * N), fcounts["dia_sweep"], "float32"),
    ]
    records = []
    for name, src, rep, (fk, fp, check), args, lib, (bms, bby), launches, dt in cases:
        yk, yp = fk(*args), fp(*args)
        torch.cuda.synchronize()
        rel = check(yk, yp)
        pairs = ([(yk[0].bands_p, yp[0].bands_p), (yk[1], yp[1])]
                 if isinstance(yk, tuple) else [(yk, yp)])
        err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
        del yp, pairs
        if name == "stencil_assembly":  # no atomics: the same bits every run
            y2 = fk(*args)
            same = torch.equal(yk[0].bands_p, y2[0].bands_p) and torch.equal(yk[1], y2[1])
            print(f"[kernel] stencil_assembly at {box.shape}: two fused assemblies "
                  f"equal bit for bit: {same}", flush=True)
            _check(same, "two fused assemblies differ")
            del y2
        del yk
        ms = time_op(fk, *args, reps=20, outer=3) * 1e3
        dms, events = _device_ms(lambda: fk(*args), src)
        pms = time_op(fp, *args, reps=3, outer=2) * 1e3
        lms = time_op(lib[0], *lib[1], reps=20, outer=3) * 1e3 if lib else None
        records.append({
            "name": name, "route": "cuda", "source": f"arcanefem_tpu_torch/csrc/{src}",
            "replaces": f"arcanefem_tpu/{rep}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dms, "device_events": events,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "library_ms": lms,
            "shape": [box.nx + 1] * 3, "dtype": dt})
        print(f"[kernel] {name} {box.shape}: {ms:.4f} ms, device {_fmt_ms(dms)} "
              f"({events[0]} of {events[1]} kernel events traced; bound "
              f"{bms:.4f} ms, {bby}), plain {pms:.3f} ms, library "
              f"{'n/a' if lms is None else f'{lms:.4f} ms'}, max_abs_err {err:.3e}, "
              f"held to its tolerance: {rel:.2e}", flush=True)
    del csr, S, res, A, M, A1, s
    torch.cuda.empty_cache()

    # 8. kernel path against the plain path and float64 on the CPU at 64^3
    systems = {"kernel": box_system(CHECK_N, dev),
               "plain_cpu_f32": box_system(CHECK_N, "cpu"),
               "cpu_f64": box_system(CHECK_N, "cpu", torch.float64)}
    out = {k: solve_mg(v) for k, v in systems.items()}
    xk = out["kernel"]["x"].double().cpu()
    for name, r in out.items():
        diff = float((xk - r["x"].double().cpu()).abs().max() / r["x"].double().abs().max().cpu())
        print(f"[box{CHECK_N}] {name}: {r['iterations']} iterations, rel {r['rel']:.2e}, "
              f"true residual {true_residual(systems[name], r):.2e}, max diff from "
              f"the kernel path {diff:.2e}", flush=True)
        _check(abs(r["iterations"] - out["kernel"]["iterations"]) <= 1,
               f"{CHECK_N}^3 iterations, {name}")
        _check(diff <= 1e-4, f"{CHECK_N}^3 solution, {name}")
    return records


if __name__ == "__main__":
    sys.exit(main())
