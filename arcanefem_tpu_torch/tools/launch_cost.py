"""Host cost per launch of every kernel wrapper, beside a PyTorch op.

    python arcanefem_tpu_torch/tools/launch_cost.py [--tree DIR] [--calls N]
    python arcanefem_tpu_torch/tools/launch_cost.py [--tree DIR] --k4-box N
    python arcanefem_tpu_torch/tools/launch_cost.py [--tree DIR] --bsr8-digest N
    python arcanefem_tpu_torch/tools/launch_cost.py [--tree DIR] --bsr-sphere H,R

Each wrapper (K1-K10, P1, the assembly's two kernels and the BSR-8
supernode SpMV) is called N times back to back (default 2000, after a
warm-up) at a size where the card is idle: 32 rows of width 8 for the
ELL, SELL and diag kernels (K10 through ``DiagEllMatrix.spmv``, whose plan
is checked once), one 128-request tile for the band gather's checked
entry points, one narrow and one wide tile over a 4096-entry table for a
whole band plan (``BandedGather.__call__``: in one launch since the fused
kernel, K9a then K2 and a concatenation before it), one window (nb = 1)
for the window take, a 4^3 box for the stencil kernels, 8 tetrahedra over
32 nodes and 128 entries into 32 slots for the assembly, and 4 block rows
of three 8x8 blocks (n = 32) for the BSR-8 supernode SpMV through
``SupernodeSpmv``.  The host clock is read after
the last call and before one final ``torch.cuda.synchronize()``, so the
figure is the host's cost of issuing a call; ``host_us`` is the best of 5
such blocks, since the host's clock moves with its other load.  Beside
it, ``torch_us`` is the same for one PyTorch op over as many elements
(``torch.gather``).  One JSON line per wrapper.

``--tree DIR`` imports the package from another checkout (``git archive``
of an earlier commit, unpacked into DIR), so two trees' launch paths go
through the same loop on one card.  K1 is timed through whichever form the
tree has (``sparse/sell.py::sell_spmv``, or the earlier row-major
``ell_spmv``), and K3b likewise (``sell_spmv_batched``, or
``ell_spmv_batched``).  It needs a CUDA card.

``--k4-box N`` times K4 instead, at the bench's N^3-hex box
(``bench_structured.box_system``): the fused assembly into the padded
plane layout with its mask and penalty planes (``assemble_system``, the
box pass's call) and the stiffness-only DiaMatrix layout
(``assemble_stiffness_kernel``), each the best of 5 blocks of 20
back-to-back calls on CUDA events, which at this size is the kernel's
device time.  One JSON line; with ``--tree`` run once per tree in one
call (parent, this tree, this tree, parent) it is the A/B of two K4
sources on one card.

``--bsr8-digest N`` runs the BSR-8 supernode SpMV instead, through the
tree's ``SupernodeSpmv``, on a seeded operator of N block rows of 0 to 44
random blocks (the 1.9M sphere's degrees, within 64 block columns of the
diagonal) with float32, float64 and
bfloat16 blocks, and prints the SHA-256 of each y: two trees whose
digests agree compute the same bits.

``--bsr-sphere H,R`` times the blocked scalar SpMV (``BlockedGather``, b
= 2 and b = 4, float32) on the CSR of the sphere_cut(H, R) operator with
seeded values, each the best of 5 blocks of 20 back-to-back calls on CUDA
events (the kernel's device time at this size).  One JSON line; with
``--tree`` run once per tree in one call (parent, this tree, this tree,
parent), with one ``AFEM_CACHE_DIR`` so the mesh is built once, it is the
A/B of two trees' blocked kernels on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def host_us(fn, calls: int, blocks: int = 5) -> float:
    """Host µs per call of fn: ``calls`` back to back, the clock read
    before the final synchronise, the best of ``blocks`` blocks."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


def _cases(dev):
    """(name, kernel call, its output element count) of every wrapper."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.mesh.structured import StructuredBox
    from arcanefem_tpu_torch.sparse import band_gather as bg
    from arcanefem_tpu_torch.sparse import dia_stencil as ds
    from arcanefem_tpu_torch.sparse import ell_gather as eg
    from arcanefem_tpu_torch.sparse.diag_spmv import DiagEllMatrix
    from arcanefem_tpu_torch.tools import probe_gather as pg

    rng = np.random.RandomState(0)
    n, W = 32, 8
    cols_np = np.sort(np.clip(np.arange(n)[:, None] + np.arange(-4, 4), 0, n - 1), 1)
    cols = torch.as_tensor(cols_np.astype(np.int32), device=dev)
    vals = torch.as_tensor(rng.rand(n, W).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.rand(n).astype(np.float32), device=dev)
    t3 = torch.as_tensor(rng.rand(n, 3).astype(np.float32), device=dev).T
    try:
        from arcanefem_tpu_torch.sparse.sell import SellLayout, sell_spmv
    except ImportError:  # a tree from before the SELL layout
        k1 = ("K1 ell_spmv", lambda: eg.ell_spmv(vals, cols, x), n)
    else:
        lay = SellLayout.build(cols_np, np.ones((n, W), bool), device=dev)
        sv = lay.from_ell(vals)
        k1 = ("K1 sell_spmv", lambda: sell_spmv(sv, lay, x), n)
    try:
        from arcanefem_tpu_torch.sparse.sell import sell_spmv_batched
    except ImportError:  # a tree from before K3b moved onto the SELL layout
        k3b = ("K3b ell_spmv_batched", lambda: eg.ell_spmv_batched(vals, cols, t3), 3 * n)
    else:
        k3b = ("K3b sell_spmv_batched", lambda: sell_spmv_batched(sv, lay, t3), 3 * n)
    bases = torch.zeros(1, dtype=torch.int32, device=dev)
    lcols = torch.as_tensor(rng.randint(0, n, (1, 128)).astype(np.int32), device=dev)
    D = DiagEllMatrix(vals, cols_np)
    # a whole band plan: one narrow tile (one table row) and one wide one
    # (32 rows apart) over a 4096-entry table
    plan, _ = bg.BandedGather.build(
        np.concatenate([np.arange(128), np.arange(128) * 32]), device=dev)
    xb = torch.as_tensor(rng.rand(4096).astype(np.float32), device=dev)
    cases = []
    try:  # trees from before the assembly kernels have neither
        from arcanefem_tpu_torch.ops.lane_assembly import tet_element
        from arcanefem_tpu_torch.sparse.slot_reduce import group_by_slot, slot_reduce
    except ImportError:
        pass
    else:
        corner = torch.as_tensor(rng.randint(0, n, 32).astype(np.int32), device=dev)
        ptr, ids = group_by_slot(torch.as_tensor(rng.randint(0, n, 128), device=dev), n)
        ke = torch.rand(128, device=dev)
        cases = [("tet_element", lambda: tet_element(t3.T, corner), 80),
                 ("slot_reduce", lambda: slot_reduce(ptr, ids, ke), n)]
    from arcanefem_tpu_torch.sparse import supernode

    if hasattr(supernode, "bsr8_spmv"):  # earlier trees ran K3a, products, K3a
        # 4 block rows of 3 blocks each (n = 32)
        sn = supernode.SupernodeSpmv.from_numpy(
            rng.rand(12, 8, 8), np.array([0, 1, 2, 0, 1, 3, 1, 2, 3, 0, 2, 3]),
            np.arange(0, 13, 3), np.repeat(np.arange(4), 3), n, device=dev)
        cases.append(("bsr8_spmv (SupernodeSpmv)", lambda: sn(x), n))
    box = StructuredBox(4, 4, 4)
    nyp, nzp = ds._pads(box)
    bands = torch.rand((box.nx + 1, 15, nyp, nzp), device=dev)
    xp = torch.rand((box.nx + 1, nyp, nzp), device=dev)
    c3 = torch.as_tensor(box.grid_coords(np.float32), device=dev)
    win, widx = pg._inputs(1, 160, 64, "column", dev)
    return [
        k1,
        ("K2 ell_gather_sum", lambda: eg.ell_gather_sum(cols, x), n),
        ("K3a ell_gather_sum_batched", lambda: eg.ell_gather_sum_batched(cols, t3), 3 * n),
        k3b,
        ("K4 stencil_assembly", lambda: sa.assemble_stiffness_kernel(box, c3),
         15 * box.n_nodes),
        ("K5-K8 dia_stencil", lambda: ds.dia_stencil(
            "spmv", bands, xp, band_major=False, ny=box.ny, nz=box.nz), xp.numel()),
        ("K9a band_gather", lambda: bg.band_gather(bases, lcols, x, 16), 128),
        ("K9b band_gather_batched", lambda: bg.band_gather_batched(bases, lcols, t3, 16),
         384),
        ("K9a BandedGather (narrow + wide tile)", lambda: plan(xb), 256),
        ("K10 diag_spmv", lambda: D.spmv(x), n),
        ("P1 window_take", lambda: pg.window_take(win, widx, "column"), widx.numel()),
        *cases,
    ]


def best_ms(fn, reps: int = 20, blocks: int = 5) -> float:
    """CUDA-event ms per call of fn: the best of ``blocks`` blocks of
    ``reps`` back-to-back calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(blocks):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def k4_ms(n: int) -> dict:
    """CUDA-event ms per call of the fused and the stiffness-only K4 at
    the bench's n^3-hex box: the best of 5 blocks of 20 calls."""
    import torch

    from arcanefem_tpu_torch.bench_structured import PENALTY, box_system
    from arcanefem_tpu_torch.mesh.stencil_assembly import (
        assemble_stiffness_kernel,
        assemble_system,
    )

    s = box_system(n, torch.device("cuda", torch.cuda.current_device()))
    return {"launch": "K4 stencil_assembly", "box": list(s.box.shape),
            "fused_ms": best_ms(lambda: assemble_system(
                s.box, s.coords3d, s.mask_p, s.pg_p, PENALTY, f=1.0)),
            "stiffness_ms": best_ms(lambda: assemble_stiffness_kernel(s.box, s.coords3d)),
            "gpu": torch.cuda.get_device_name(0)}


def bsr_sphere_ms(h: float, refine: int) -> dict:
    """CUDA-event ms per call of the tree's ``BlockedGather`` at b = 2 and
    b = 4, float32, on the CSR of the sphere_cut(h, refine) operator
    (bench_unstructured.sphere_cut_system, its npz caches) with seeded
    values, x seeded: the best of 5 blocks of 20 calls; with the build
    seconds of each operator and y's sum of |y| (equal up to rounding
    between two trees)."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
    from arcanefem_tpu_torch.sparse.blocked import BlockedGather

    dev = torch.device("cuda", torch.cuda.current_device())
    _, topo = sphere_cut_system(h, refine)
    n = topo.n_nodes
    rng = np.random.RandomState(11)
    data = (rng.rand(len(topo.csr_cols)) * 2 - 1).astype(np.float32)
    x = torch.as_tensor(rng.rand(n) * 2 - 1, device=dev).float()
    out = {"launch": "bsr_spmv sphere", "h": h, "refine": refine, "n": n}
    for b in (2, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = BlockedGather.build_csr(topo.csr_cols, topo.row_ptr, data, n, b=b, device=dev)
        torch.cuda.synchronize()
        out[f"b{b}_build_s"] = time.perf_counter() - t0
        out[f"b{b}_blocks"] = round(g.fill * g.nnz / (b * b))  # a name every tree has
        out[f"b{b}_ms"] = best_ms(lambda g=g: g(x))
        out[f"b{b}_abs_sum"] = float(g(x).double().abs().sum())
        del g
        torch.cuda.empty_cache()
    out["gpu"] = torch.cuda.get_device_name(0)
    return out


def bsr8_digest(n_sup: int) -> dict:
    """SHA-256 of the BSR-8 SpMV's y on a seeded operator of ``n_sup``
    block rows, per block type (see the module docstring)."""
    import hashlib

    import numpy as np
    import torch

    from arcanefem_tpu_torch.sparse.supernode import SupernodeSpmv

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.RandomState(7)
    deg = rng.randint(0, 45, n_sup)
    # each row's distinct columns within 64 block columns of its own, sorted
    bcol = np.concatenate([np.sort((i + rng.choice(128, d, replace=False) - 64) % n_sup)
                           for i, d in enumerate(deg)])
    blocks = rng.rand(len(bcol), 8, 8) * 2 - 1
    bptr = np.concatenate([[0], np.cumsum(deg)])
    n = 8 * n_sup - 3
    x = rng.rand(n) * 2 - 1
    out = {"launch": "bsr8_spmv digest", "n_sup": n_sup, "blocks": len(bcol)}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64),
                        ("bf16", torch.bfloat16)):
        sn = SupernodeSpmv.from_numpy(blocks, bcol, bptr, np.repeat(np.arange(n_sup), deg),
                                      n, device=dev, dtype=dtype)
        xd = torch.as_tensor(x, device=dev).to(torch.float32 if name == "bf16" else dtype)
        y = sn(xd).cpu().numpy()
        out[name] = hashlib.sha256(y.tobytes()).hexdigest()
    out["gpu"] = torch.cuda.get_device_name(0)
    return out


def measure_all(calls: int = 2000) -> list[dict]:
    """host_us of every wrapper and torch_us of a torch.gather of its
    output's size, on the current card."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for name, fn, m in _cases(dev):
        src = torch.rand(m, device=dev)
        idx = torch.randint(0, m, (m,), device=dev)
        out.append({"launch": name, "host_us": host_us(fn, calls),
                    "torch_us": host_us(lambda: torch.gather(src, 0, idx), calls),
                    "calls": calls})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="checkout whose arcanefem_tpu_torch to import "
                         "(default: the one this file is in)")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--k4-box", type=int, default=None, metavar="N",
                    help="time K4 at the bench's N^3-hex box instead")
    ap.add_argument("--bsr8-digest", type=int, default=None, metavar="N",
                    help="digest the BSR-8 SpMV's y on N seeded block rows instead")
    ap.add_argument("--bsr-sphere", default=None, metavar="H,R",
                    help="time BlockedGather b = 2 and 4 on the sphere_cut(H, R) CSR instead")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("launch_cost measures a CUDA card; none is available")
    import arcanefem_tpu_torch

    pkg = os.path.dirname(arcanefem_tpu_torch.__file__)
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"imported {pkg}, not the tree {tree}")
    if args.bsr8_digest:
        recs = [bsr8_digest(args.bsr8_digest)]
    elif args.bsr_sphere:
        h, r = args.bsr_sphere.split(",")
        recs = [bsr_sphere_ms(float(h), int(r))]
    elif args.k4_box:
        recs = [k4_ms(args.k4_box)]
    else:
        recs = measure_all(args.calls)
    for rec in recs:
        print(json.dumps({**rec, "tree": tree}), flush=True)


if __name__ == "__main__":
    main()
