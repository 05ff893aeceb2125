"""Host cost per launch of every kernel wrapper, beside a PyTorch op.

    python arcanefem_tpu_torch/tools/launch_cost.py [--tree DIR] [--calls N]

Each wrapper (K1-K10, P1 and the assembly's two kernels) is called N
times back to back (default 2000, after a warm-up) at a size where the
card is idle: 32 rows of width 8 for the ELL, SELL and diag kernels, one
128-request tile for the band gather, one window (nb = 1) for the window
take, a 4^3 box for the stencil kernels, 8 tetrahedra over 32 nodes and
128 entries into 32 slots for the assembly.  The host clock is read after
the last call and before one final ``torch.cuda.synchronize()``, so the
figure is the host's cost of issuing a call; ``host_us`` is the best of 5
such blocks, since the host's clock moves with its other load.  Beside
it, ``torch_us`` is the same for one PyTorch op over as many elements
(``torch.gather``).  One JSON line per wrapper.

``--tree DIR`` imports the package from another checkout (``git archive``
of an earlier commit, unpacked into DIR), so two trees' launch paths go
through the same loop on one card.  K1 is timed through whichever form the
tree has (``sparse/sell.py::sell_spmv``, or the earlier row-major
``ell_spmv``).  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _host_us(fn, calls: int, blocks: int = 5) -> float:
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
    bases = torch.zeros(1, dtype=torch.int32, device=dev)
    lcols = torch.as_tensor(rng.randint(0, n, (1, 128)).astype(np.int32), device=dev)
    D = DiagEllMatrix(vals, cols_np)
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
        ("K3b ell_spmv_batched", lambda: eg.ell_spmv_batched(vals, cols, t3), 3 * n),
        ("K4 stencil_assembly", lambda: sa.assemble_stiffness_kernel(box, c3),
         15 * box.n_nodes),
        ("K5-K8 dia_stencil", lambda: ds.dia_stencil(
            "spmv", bands, xp, band_major=False, ny=box.ny, nz=box.nz), xp.numel()),
        ("K9a band_gather", lambda: bg.band_gather(bases, lcols, x, 16), 128),
        ("K9b band_gather_batched", lambda: bg.band_gather_batched(bases, lcols, t3, 16),
         384),
        ("K10 diag_spmv", lambda: D.spmv(x), n),
        ("P1 window_take", lambda: pg.window_take(win, widx, "column"), widx.numel()),
        *cases,
    ]


def measure_all(calls: int = 2000) -> list[dict]:
    """host_us of every wrapper and torch_us of a torch.gather of its
    output's size, on the current card."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for name, fn, m in _cases(dev):
        src = torch.rand(m, device=dev)
        idx = torch.randint(0, m, (m,), device=dev)
        out.append({"launch": name, "host_us": _host_us(fn, calls),
                    "torch_us": _host_us(lambda: torch.gather(src, 0, idx), calls),
                    "calls": calls})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="checkout whose arcanefem_tpu_torch to import "
                         "(default: the one this file is in)")
    ap.add_argument("--calls", type=int, default=2000)
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
    for rec in measure_all(args.calls):
        print(json.dumps({**rec, "tree": tree}), flush=True)


if __name__ == "__main__":
    main()
