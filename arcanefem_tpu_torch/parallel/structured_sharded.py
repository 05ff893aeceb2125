"""Sharded structured-box solver: x-slab domain decomposition over
torch.distributed.

The counterpart of ``arcanefem_tpu/parallel/structured_sharded.py``, the
multi-rank form of the structured path (``mesh/structured.py``): node
planes are split into contiguous x-slabs, one per rank.  All 15 stencil
offsets reach at most one x-plane, so

* assembly is fully local — each rank holds its coordinate slab plus one
  ghost hex plane per side (the recompute-overlap discipline, zero
  communication);
* SpMV halo exchange is two plane swaps per SpMV (``Comm.ppermute``, the
  ``synchronize()`` role);
* CG dot products are the local dot and one ``all_reduce``.

Plane ownership is disjoint (rank d owns node planes [d·px, (d+1)·px),
the last rank also owns the final plane), so reductions need no masking
beyond the padded tail plane whose rows are all-zero.  The slab arithmetic
is plain PyTorch, as the JAX module is XLA and not Pallas.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.structured import _HEX_CORNERS, _TETS, StructuredBox
from ..ops.geometry import tetra4_gradients
from .comm import Comm
from .sharded import record_solve


@dataclass
class SlabPlan:
    box: StructuredBox
    n_dev: int
    px: int  # hex planes per rank (nx/D)
    own_planes: int  # px + 1 (last plane valid only on the last rank)

    @property
    def plane(self) -> int:  # nodes per plane
        return (self.box.ny + 1) * (self.box.nz + 1)


def plan_slabs(box: StructuredBox, n_dev: int) -> SlabPlan:
    if box.nx % n_dev:
        raise ValueError(f"nx={box.nx} must divide by {n_dev} devices")
    return SlabPlan(box=box, n_dev=n_dev, px=box.nx // n_dev,
                    own_planes=box.nx // n_dev + 1)


def slab_coords(plan: SlabPlan, coords3d: np.ndarray) -> np.ndarray:
    """(D, px+3, ny+1, nz+1, 3) coordinate slabs with one ghost plane per
    side (edge-duplicated at the domain boundary -> degenerate ghost hexes)."""
    D, px = plan.n_dev, plan.px
    cp = np.pad(np.asarray(coords3d), ((1, 1), (0, 0), (0, 0), (0, 0)),
                mode="edge")
    return np.stack([cp[d * px : d * px + px + 3] for d in range(D)])


def slab_mask_values(plan: SlabPlan, mask: np.ndarray, values: np.ndarray):
    """Split global (n_nodes,) arrays into (D, own_planes*plane) slabs.

    The shared tail plane belongs to the NEXT rank; on ranks other than
    the last it is a pad plane (mask False, value 0, matrix rows zero)."""
    box, D, px = plan.box, plan.n_dev, plan.px
    pl = plan.plane
    m3 = np.asarray(mask).reshape(box.nx + 1, pl)
    v3 = np.asarray(values).reshape(box.nx + 1, pl)
    ms, vs = [], []
    for d in range(D):
        lo = d * px
        m = np.zeros((px + 1, pl), m3.dtype)
        v = np.zeros((px + 1, pl), v3.dtype)
        n_own = px + 1 if d == D - 1 else px
        m[:n_own] = m3[lo : lo + n_own]
        v[:n_own] = v3[lo : lo + n_own]
        ms.append(m.reshape(-1))
        vs.append(v.reshape(-1))
    return np.stack(ms), np.stack(vs)


def gather_global(plan: SlabPlan, x_shards: np.ndarray) -> np.ndarray:
    """(D, own_planes*plane) -> (n_nodes,)."""
    box, D, px = plan.box, plan.n_dev, plan.px
    pl = plan.plane
    out = np.zeros((box.nx + 1) * pl, x_shards.dtype)
    x3 = np.asarray(x_shards).reshape(D, px + 1, pl)
    for d in range(D):
        n_own = px + 1 if d == D - 1 else px
        out[d * px * pl : (d * px + n_own) * pl] = x3[d, :n_own].reshape(-1)
    return out


def _local_assemble(box: StructuredBox, px: int, cslab: torch.Tensor, f):
    """Bands + source rhs for the rank's px+1 node planes from its
    (px+3, ny+1, nz+1, 3) ghosted coordinate slab.  Ghost hexes at the
    domain edges are degenerate (zero volume) and contribute zero."""
    ny, nz = box.ny, box.nz
    nhx = px + 2  # hex planes covered by the slab (incl. ghosts)
    kw = dict(dtype=cslab.dtype, device=cslab.device)
    bands = {d: torch.zeros((px + 1, ny + 1, nz + 1), **kw) for d in box.offsets}
    rhs = torch.zeros((px + 1, ny + 1, nz + 1), **kw)
    eye = torch.eye(3, **kw)

    def corner(c):
        di, dj, dk = _HEX_CORNERS[c]
        return cslab[di : di + nhx, dj : dj + ny, dk : dk + nz].reshape(-1, 3)

    for tet in _TETS:
        xyz = torch.stack([corner(c) for c in tet], dim=1)
        v6 = torch.abs(torch.einsum(
            "ni,ni->n", xyz[:, 1] - xyz[:, 0],
            torch.linalg.cross(xyz[:, 2] - xyz[:, 0], xyz[:, 3] - xyz[:, 0])))
        vol = v6 / 6.0
        # guarded gradients: degenerate ghost hexes get a unit tet whose
        # contribution is zeroed by vol == 0
        unit = xyz.clone()
        unit[:, 1:] = xyz[:, :1] + eye[None]
        gx, gy, gz = tetra4_gradients(torch.where((v6 > 1e-30)[:, None, None], xyz, unit))
        for a, ca in enumerate(tet):
            dia, dja, dka = _HEX_CORNERS[ca]
            la = box._lin(_HEX_CORNERS[ca])
            # hex plane h contributes to node plane h-1+dia of the slab
            # (hex plane 0 is the left ghost); keep planes [0, px+1)
            lo_hex = 1 - dia
            for b, cb in enumerate(tet):
                d = box._lin(_HEX_CORNERS[cb]) - la
                contrib = (vol * (gx[:, a] * gx[:, b] + gy[:, a] * gy[:, b]
                                  + gz[:, a] * gz[:, b])).reshape(nhx, ny, nz)
                bands[d][:, dja : dja + ny, dka : dka + nz] += \
                    contrib[lo_hex : lo_hex + px + 1]
            contrib_r = (f * vol / 4.0).reshape(nhx, ny, nz)
            rhs[:, dja : dja + ny, dka : dka + nz] += contrib_r[lo_hex : lo_hex + px + 1]
    stacked = torch.stack([bands[d].reshape(-1) for d in box.offsets])
    return stacked, rhs.reshape(-1)


def _halo_spmv(comm: Comm, box: StructuredBox, px: int, bands: torch.Tensor,
               x: torch.Tensor, n_dev: int) -> torch.Tensor:
    """y = A x with two plane swaps.

    Each rank's local vector covers node planes [d·px, d·px+px]; the tail
    plane is owned by the right neighbour (its plane 0), so it is refreshed
    from there each SpMV, and one extra left-halo plane (the left
    neighbour's plane px−1) prepends the window.  Offsets that reach past
    the window wrap round (``torch.roll``, as JAX's ``jnp.roll``) onto
    positions whose band values are zero (neighbours outside the y/z
    domain or beyond the box), so those products stay zero."""
    pl = (box.ny + 1) * (box.nz + 1)
    x2 = x.reshape(px + 1, pl)
    # refresh the shared tail plane from its owner (right neighbour plane 0)
    tail_sync = comm.ppermute(x2[0], [(i, i - 1) for i in range(1, n_dev)])
    tail = x2[px] if comm.rank == n_dev - 1 else tail_sync
    left_halo = comm.ppermute(x2[px - 1], [(i, i + 1) for i in range(n_dev - 1)])
    x_ext = torch.cat([left_halo[None], x2[:px], tail[None]], dim=0).reshape(-1)
    # (px+2) planes; local plane p sits at ext plane p+1
    y = None
    for k, off in enumerate(box.offsets):
        t = bands[k] * torch.roll(x_ext, -off)[pl : pl + (px + 1) * pl]
        y = t if y is None else y + t
    return y


def pcg_slabs(comm: Comm, spmv, apply_M, rhs, x0, rtol: float, max_iter: int,
              free=None):
    """The slab solves' PCG (the JAX modules' inline ``while_loop``): the
    stopping test read after every iteration; the solve is recorded with
    its ``free`` rows (``sharded.record_solve``).  Returns (x, iters, rel)."""
    def pdot(a, b):
        return comm.pdot(a, b)

    t0 = time.perf_counter()
    r = rhs - spmv(x0)
    z = apply_M(r)
    rz0 = pdot(r, z)
    tol2 = rtol * rtol * abs(float(rz0))
    x, p, rz, k = x0, z, rz0, 0
    while abs(float(rz)) > tol2 and k < max_iter:
        Ap = spmv(p)
        alpha = rz / pdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = pdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    record_solve(spmv, rhs, free, time.perf_counter() - t0, k)
    return x, k, math.sqrt(abs(float(rz)) / max(abs(float(rz0)), 1e-300))


def owned_rows(px: int, pl: int, is_last: bool, dtype, device) -> torch.Tensor:
    """(own_planes*plane,) 1 on the rank's rows, 0 on the shared tail plane
    of a rank that is not the last."""
    valid = torch.ones((px + 1, pl), dtype=dtype, device=device)
    if not is_last:
        valid[px] = 0.0
    return valid.reshape(-1)


def make_structured_step(plan: SlabPlan, comm: Comm, rtol=1e-7, max_iter=500,
                         penalty=1e12):
    """The sharded step: local assembly + penalty BC + halo-CG.

    fn(cslabs, mask, gvals, f) -> (x (own_planes*plane,), iters, res) with
    the (D, ...) stacked host slabs of :func:`slab_coords` and
    :func:`slab_mask_values`; the rank takes its own row."""
    box, D, px = plan.box, plan.n_dev, plan.px
    d0 = box.offsets.index(0)

    def step(cslabs, mask, gvals, f):
        dev = comm.device
        cslab = torch.as_tensor(np.asarray(cslabs)[comm.rank], device=dev)
        dtype = cslab.dtype
        mask = torch.as_tensor(np.asarray(mask)[comm.rank], device=dev).bool()
        gvals = torch.as_tensor(np.asarray(gvals)[comm.rank], device=dev).to(dtype)
        bands, rhs = _local_assemble(box, px, cslab, f)
        # the shared plane is owned by the right neighbour: zero its rows on
        # all but the last rank so dot products stay unduplicated
        valid = owned_rows(px, plan.plane, comm.rank == D - 1, dtype, dev)
        bands = bands * valid[None, :]
        rhs = rhs * valid
        bands[d0] = torch.where(mask, torch.full_like(bands[d0], penalty), bands[d0])
        rhs = torch.where(mask, penalty * gvals, rhs)
        diag = bands[d0]
        inv = torch.where(diag != 0, 1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
        x0 = torch.where(mask, gvals, 0.0)

        def spmv(x):
            return _halo_spmv(comm, box, px, bands, x, D)

        return pcg_slabs(comm, spmv, lambda r: inv * r, rhs, x0, rtol, max_iter,
                         free=~mask & (valid > 0))

    return step
