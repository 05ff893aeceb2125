"""Sharded geometric multigrid over the x-slab decomposition.

The counterpart of ``arcanefem_tpu/parallel/structured_mg.py``: the
x-slab structured path (``structured_sharded.py``) with multigrid-
preconditioned CG, the multi-rank form of the structured solve
(``solver/multigrid.py``, the reference's BoomerAMG+PCG role,
femutils/HypreDoFLinearSystem.cc:686-742).

Per level, everything stays slab-local except three plane exchanges:

* SpMV / smoothing / residual: the two plane swaps of
  ``structured_sharded._halo_spmv``;
* restriction: one swap (the left neighbour's last interior fine plane
  feeds coarse plane 0 of each slab);
* prolongation: one swap (the right neighbour's plane 0 refreshes the
  shared coarse tail plane).

The hierarchy coarsens all three axes 2x per level while the per-rank
plane count stays even, so every level keeps the same disjoint plane
ownership (the shared tail plane belongs to the right neighbour and is
held at zero on non-owners — ``Comm.ppermute``'s zero fill for a rank no
pair sends to doubles as the global-boundary zero pad of the transfer
stencils).  Coarse coordinates and masks are sliced on the host per level;
coarse operators are re-discretisations on the coarsened slabs.  The y and
z transfers are ``solver/multigrid.py``'s; the slabs are plain PyTorch, as
the JAX module is XLA and not Pallas.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.structured import StructuredBox
from ..solver.multigrid import _prolong_axis, _restrict_axis
from .comm import Comm
from .structured_sharded import (
    SlabPlan,
    _halo_spmv,
    _local_assemble,
    owned_rows,
    pcg_slabs,
    plan_slabs,
    slab_coords,
    slab_mask_values,
)


@dataclass
class MGSlabPlan:
    levels: list  # of SlabPlan, fine -> coarse

    @property
    def fine(self) -> SlabPlan:
        return self.levels[0]


def plan_mg_slabs(box: StructuredBox, n_dev: int, min_size: int = 2) -> MGSlabPlan:
    """Coarsen 2x per axis while the grid AND the per-rank slab allow it."""
    levels = [plan_slabs(box, n_dev)]
    b = box
    while not (
        b.nx % 2 or b.ny % 2 or b.nz % 2
        or (b.nx // 2) % n_dev
        or min(b.nx, b.ny, b.nz) // 2 < min_size
    ):
        b = StructuredBox(b.nx // 2, b.ny // 2, b.nz // 2, b.lx, b.ly, b.lz)
        levels.append(plan_slabs(b, n_dev))
    return MGSlabPlan(levels=levels)


def mg_slab_coords(plan: MGSlabPlan, coords3d: np.ndarray) -> list:
    """Per-level ghosted coordinate slabs (host-side 2x decimation)."""
    out = []
    c = np.asarray(coords3d)
    for lv in plan.levels:
        out.append(slab_coords(lv, c))
        c = c[::2, ::2, ::2]
    return out


def mg_slab_masks(plan: MGSlabPlan, bc_planes=("xmin", "xmax")) -> list:
    """Per-level Dirichlet mask slabs as float (1.0 on Dirichlet rows)."""
    out = []
    for lv in plan.levels:
        m = lv.box.boundary_mask(bc_planes).astype(np.float64)
        ms, _ = slab_mask_values(lv, m, np.zeros_like(m))
        out.append(ms)
    return out


def _restrict_x_slab(comm: Comm, f3: torch.Tensor, pxc: int, n_dev: int) -> torch.Tensor:
    """Full-weighting along x on a slab: out[j] = f[2j] + 0.5(f[2j-1]+f[2j+1]).

    f3: (pxf+1, ...) local fine planes.  The left halo plane comes from the
    left neighbour; rank 0 receives the zero fill = the global boundary
    zero pad.  The returned tail plane (j = pxc) is only correct on the
    last rank — callers mask it with the ownership/maskmul plane."""
    left = comm.ppermute(f3[-2], [(i, i + 1) for i in range(n_dev - 1)])
    fx = torch.cat([left[None], f3], dim=0)  # fine plane p at fx[p+1]
    hi = torch.cat([fx[2::2], torch.zeros_like(fx[:1])], dim=0)
    return fx[1::2] + 0.5 * (fx[0::2] + hi)


def _prolong_x_slab(comm: Comm, c3: torch.Tensor, pxc: int, n_dev: int) -> torch.Tensor:
    """Linear interpolation along x on a slab: (pxc+1, ...) -> (2·pxc+1, ...).

    The shared coarse tail plane is refreshed from its owner (right
    neighbour's plane 0) before interpolating."""
    tail_sync = comm.ppermute(c3[0], [(i, i - 1) for i in range(1, n_dev)])
    tail = c3[pxc] if comm.rank == n_dev - 1 else tail_sync
    ce = torch.cat([c3[:pxc], tail[None]], dim=0)
    mid = 0.5 * (ce[:-1] + ce[1:])
    body = torch.stack([ce[:-1], mid], dim=1).reshape((2 * pxc,) + tuple(c3.shape[1:]))
    return torch.cat([body, ce[-1:]], dim=0)


def make_structured_mg_step(plan: MGSlabPlan, comm: Comm, rtol: float = 1e-8,
                            max_iter: int = 500, penalty: float = 1e12, nu: int = 1,
                            omega: float = 0.8, coarse_iters: int = 40):
    """The sharded MG-PCG step.

    fn(cslabs_per_level, masks_per_level, gvals, f) -> (x (own_planes*plane,),
    iters, res): the (D, ...) stacked host slabs of :func:`mg_slab_coords`,
    :func:`mg_slab_masks` and the level-0 Dirichlet values of
    ``slab_mask_values``; the rank takes its own rows."""
    levels = plan.levels
    D = levels[0].n_dev
    nlev = len(levels)

    def step(cslabs, masks, gvals, f):
        dev, me = comm.device, comm.rank
        cs = [torch.as_tensor(np.asarray(c)[me], device=dev) for c in cslabs]
        dtype = cs[0].dtype
        ms = [torch.as_tensor(np.asarray(m)[me], device=dev).to(dtype) for m in masks]
        gvals = torch.as_tensor(np.asarray(gvals)[me], device=dev).to(dtype)
        is_last = me == D - 1
        bands_l, inv_l, maskmul_l, shapes_l = [], [], [], []
        rhs0 = mask0 = None
        for l, lv in enumerate(levels):
            box, px = lv.box, lv.px
            d0 = box.offsets.index(0)
            bands, rhs = _local_assemble(box, px, cs[l], f)
            # ownership: the shared tail plane is the right neighbour's
            # plane 0 — zero its rows everywhere but on the last rank
            valid = owned_rows(px, lv.plane, is_last, dtype, dev)
            bands = bands * valid[None, :]
            mask = ms[l]
            bands[d0] = torch.where(mask > 0.5, torch.full_like(bands[d0], penalty),
                                    bands[d0])
            diag = bands[d0]
            inv = torch.where(diag != 0, 1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
            bands_l.append(bands)
            inv_l.append(inv)
            maskmul_l.append((1.0 - mask) * valid)
            shapes_l.append((px + 1, box.ny + 1, box.nz + 1))
            if l == 0:
                rhs0, mask0 = rhs * valid, mask

        def spmv(l, x):
            return _halo_spmv(comm, levels[l].box, levels[l].px, bands_l[l], x, D)

        def smooth0(l, b, sweeps):
            x = omega * inv_l[l] * b
            for _ in range(sweeps - 1):
                x = x + omega * inv_l[l] * (b - spmv(l, x))
            return x

        def restrict(l, r):
            r3 = _restrict_axis(_restrict_axis(r.reshape(shapes_l[l]), 1), 2)
            return _restrict_x_slab(comm, r3, levels[l + 1].px, D).reshape(-1)

        def prolong(l, xc):
            f3 = _prolong_x_slab(comm, xc.reshape(shapes_l[l + 1]), levels[l + 1].px, D)
            return _prolong_axis(_prolong_axis(f3, 1), 2).reshape(-1)

        def vcycle(l, b):
            if l == nlev - 1:
                return smooth0(l, b, coarse_iters)
            x = smooth0(l, b, nu)
            r = (b - spmv(l, x)) * maskmul_l[l]
            rc = restrict(l, r) * maskmul_l[l + 1]
            xc = vcycle(l + 1, rc) * maskmul_l[l + 1]
            x = x + prolong(l, xc)
            for _ in range(nu):
                x = x + omega * inv_l[l] * (b - spmv(l, x))
            return x

        def M_apply(r):
            z = vcycle(0, r * maskmul_l[0])
            return torch.where(mask0 > 0.5, r * inv_l[0], z)

        # penalty Dirichlet on the fine rhs + warm start
        rhs = torch.where(mask0 > 0.5, penalty * gvals, rhs0)
        x0 = torch.where(mask0 > 0.5, gvals, 0.0)
        return pcg_slabs(comm, lambda x: spmv(0, x), M_apply, rhs, x0, rtol, max_iter,
                         free=(mask0 < 0.5) & (maskmul_l[0] > 0))

    return step
