"""Geometric multigrid preconditioner for the structured Kuhn box.

The counterpart of ``arcanefem_tpu/solver/multigrid.py``.  The hierarchy
coarsens the node grid 2x per axis while every axis stays even and at
least ``min_size`` hexes long, and rediscretises each level on the strided
coordinates.  Dirichlet (penalty) rows are masked: the V-cycle acts on the
free rows' residual and a penalty row gets the exact Jacobi action 1/P.

* ``MGPrecond`` / ``build_mg``: the V-cycle over flat vectors, with
  ``DiaMatrix`` levels (plain rolls) or ``DiaStencilMatrix`` levels (the
  stencil kernel, K8).
* ``MGPrecondP`` / ``build_mg_padded``: the V-cycle of the structured
  bench, over padded plane vectors (``sparse/dia_stencil.py``): the first
  sweep from x = 0 is the elementwise ω·D⁻¹·b, later sweeps are the fused
  Jacobi kernel (K6), the masked residual is the fused residual kernel
  (K7); only the transfers touch the real layout.  Levels are assembled by
  the fused stencil-assembly kernel (K4), or with ``fused=False`` by its
  stiffness-only mode, and may hold bf16 bands.
* ``mg_from_numpy``: a JAX ``MGPrecondP``'s arrays, as numpy, in the port.

``prolong3`` and ``restrict3`` are trilinear interpolation and its
adjoint, written per axis with stack/reshape/cat as in the JAX package,
so both give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.stencil_assembly import assemble_stiffness_kernel, assemble_system
from ..mesh.structured import StructuredBox
from ..sparse.dia_stencil import (
    D0,
    DiaPlaneMatrixP,
    _inv_nonzero,
    pad_host_vec,
    to_plane_matrix,
    to_stencil_matrix,
)
from ..sparse.dia import DiaMatrix

# --- per-axis transfers -----------------------------------------------------


def _sl(a: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * a.dim()
    idx[axis] = sl
    return a[tuple(idx)]


def _prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D linear interpolation along ``axis``: (n+1) -> (2n+1)."""
    lo = _sl(c, axis, slice(None, -1))
    hi = _sl(c, axis, slice(1, None))
    mid = 0.5 * (lo + hi)
    body = torch.stack([lo, mid], dim=axis + 1)
    new_shape = c.shape[:axis] + (2 * (c.shape[axis] - 1),) + c.shape[axis + 1:]
    body = body.reshape(new_shape)
    return torch.cat([body, _sl(c, axis, slice(-1, None))], dim=axis)


def _restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Adjoint of _prolong_axis: out[i] = f[2i] + 0.5(f[2i-1] + f[2i+1])."""
    even = _sl(f, axis, slice(None, None, 2))
    odd = _sl(f, axis, slice(1, None, 2))
    zeros = torch.zeros_like(_sl(odd, axis, slice(0, 1)))
    return even + 0.5 * (torch.cat([zeros, odd], dim=axis)
                         + torch.cat([odd, zeros], dim=axis))


def prolong3(xc: torch.Tensor, cshape, fshape) -> torch.Tensor:
    x = xc.reshape(cshape)
    for ax in range(3):
        x = _prolong_axis(x, ax)
    return x.reshape(-1)


def restrict3(xf: torch.Tensor, fshape, cshape) -> torch.Tensor:
    x = xf.reshape(fshape)
    for ax in range(3):
        x = _restrict_axis(x, ax)
    return x.reshape(-1)


def _levels(box: StructuredBox, mask: np.ndarray, bc_planes, min_size: int):
    """(box, Dirichlet mask) of every level, finest first: halve every axis
    while all are even and the halves keep at least min_size hexes."""
    b, m = box, np.asarray(mask)
    while True:
        yield b, m
        if b.nx % 2 or b.ny % 2 or b.nz % 2 or min(b.nx, b.ny, b.nz) // 2 < min_size:
            return
        b = b.coarsened()
        m = b.boundary_mask(bc_planes)


# --- the V-cycle over flat vectors -------------------------------------------


class MGPrecond:
    """V-cycle over flat vectors.  mats: per-level penalised operators,
    ``DiaMatrix`` or ``DiaStencilMatrix``; inv_diags, masks (bool,
    Dirichlet rows) and shapes (nx+1, ny+1, nz+1) per level."""

    def __init__(self, mats, inv_diags, masks, shapes, nu: int = 2,
                 omega: float = 0.8, coarse_iters: int = 40):
        self.mats, self.inv_diags = tuple(mats), tuple(inv_diags)
        self.masks, self.shapes = tuple(masks), tuple(shapes)
        self.nu, self.omega, self.coarse_iters = nu, omega, coarse_iters

    def _smooth(self, l: int, x, b, sweeps: int):
        A, d = self.mats[l], self.inv_diags[l]
        if hasattr(A, "jacobi_sweep"):
            for _ in range(sweeps):
                x = A.jacobi_sweep(x, b, self.omega)
            return x
        for _ in range(sweeps):
            x = x + self.omega * d * (b - A.spmv(x))
        return x

    def _vcycle(self, l: int, b):
        if l == len(self.mats) - 1:
            return self._smooth(l, torch.zeros_like(b), b, self.coarse_iters)
        x = self._smooth(l, torch.zeros_like(b), b, self.nu)
        A0 = self.mats[l]
        r = A0.residual(b, x) if hasattr(A0, "residual") else b - A0.spmv(x)
        r = torch.where(self.masks[l], 0.0, r)
        rc = restrict3(r, self.shapes[l], self.shapes[l + 1])
        rc = torch.where(self.masks[l + 1], 0.0, rc)
        xc = self._vcycle(l + 1, rc)
        xc = torch.where(self.masks[l + 1], 0.0, xc)
        x = x + prolong3(xc, self.shapes[l + 1], self.shapes[l])
        return self._smooth(l, x, b, self.nu)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """M⁻¹ r: V-cycle on free rows + exact Jacobi on penalty rows."""
        rz = torch.where(self.masks[0], 0.0, r)
        z = self._vcycle(0, rz)
        return torch.where(self.masks[0], r * self.inv_diags[0], z)


def _penalised_stiffness(box: StructuredBox, c3: torch.Tensor,
                         mask: torch.Tensor, penalty: float) -> DiaMatrix:
    """The level's stiffness (K4 on the card) with ``penalty`` written on
    the diagonal of its Dirichlet rows ``mask``."""
    A = assemble_stiffness_kernel(box, c3.contiguous())
    bands = A.bands.clone()
    bands[D0] = torch.where(mask, torch.full_like(bands[D0], penalty), bands[D0])
    return A.with_bands(bands)


def build_mg(box: StructuredBox, coords3d: torch.Tensor,
             dirichlet_mask: np.ndarray, penalty: float,
             bc_planes: tuple = ("xmin", "xmax"), min_size: int = 8,
             nu: int = 2, omega: float = 0.8,
             use_stencil_spmv: bool = False) -> MGPrecond:
    """The flat-vector hierarchy: each level assembled (K4 on the card),
    penalised on its box planes; ``use_stencil_spmv`` wraps each level in
    the stencil kernel (K8) instead of the plain roll SpMV."""
    mats, inv_diags, masks, shapes = [], [], [], []
    c3 = coords3d
    for b, mask in _levels(box, dirichlet_mask, bc_planes, min_size):
        m = torch.as_tensor(mask, device=coords3d.device)
        Ap = _penalised_stiffness(b, c3, m, penalty)
        c3 = c3[::2, ::2, ::2]
        inv_diags.append(_inv_nonzero(Ap.bands[D0]))
        mats.append(to_stencil_matrix(Ap, b) if use_stencil_spmv else Ap)
        masks.append(m)
        shapes.append(b.shape)
    return MGPrecond(mats, inv_diags, masks, shapes, nu=nu, omega=omega)


# --- the V-cycle over padded plane vectors -------------------------------------


class MGPrecondP:
    """V-cycle over padded plane vectors (``DiaPlaneMatrixP`` levels).

    inv_diags_p: per-level inverse diagonals from the full-precision bands;
    maskmul_p: 1 on free rows, 0 on Dirichlet rows, 1 on pads (which only
    ever multiply exact zeros); masks_p: bool Dirichlet rows; shapes: real
    (nx+1, ny+1, nz+1).  ``omegas`` (length nu), when given, are Chebyshev
    root weights: the pre-smoother applies them in order and the
    post-smoother in reverse, which keeps M symmetric."""

    def __init__(self, mats, inv_diags_p, maskmul_p, masks_p, shapes,
                 nu: int = 2, omega: float = 0.8, coarse_iters: int = 40,
                 omegas: tuple = ()):
        self.mats, self.inv_diags_p = tuple(mats), tuple(inv_diags_p)
        self.maskmul_p, self.masks_p = tuple(maskmul_p), tuple(masks_p)
        self.shapes = tuple(shapes)
        self.nu, self.omega, self.coarse_iters = nu, omega, coarse_iters
        self.omegas = tuple(omegas)

    def _sweep_omega(self, k: int, reverse: bool) -> float:
        if not self.omegas:
            return self.omega
        return self.omegas[::-1][k] if reverse else self.omegas[k]

    def _smooth0(self, l: int, bp, sweeps: int):
        """``sweeps`` damped-Jacobi (or Chebyshev) sweeps from x = 0."""
        seq = self.omegas if (self.omegas and sweeps == self.nu) else None
        x = (seq[0] if seq else self.omega) * self.inv_diags_p[l] * bp
        for k in range(1, sweeps):
            om = seq[k] if seq else self.omega
            x = self.mats[l].jacobi_sweep(x, bp, self.inv_diags_p[l], om)
        return x

    def _restrict(self, l: int, rp):
        r = self.mats[l].unpad_vec(rp)
        return self.mats[l + 1].pad_vec(restrict3(r, self.shapes[l], self.shapes[l + 1]))

    def _prolong(self, l: int, xcp):
        xc = self.mats[l + 1].unpad_vec(xcp)
        return self.mats[l].pad_vec(prolong3(xc, self.shapes[l + 1], self.shapes[l]))

    def _vcycle(self, l: int, bp):
        if l == len(self.mats) - 1:
            return self._smooth0(l, bp, self.coarse_iters)
        A, invd = self.mats[l], self.inv_diags_p[l]
        x = self._smooth0(l, bp, self.nu)
        r = A.residual(bp, x, self.maskmul_p[l])
        rc = self._restrict(l, r) * self.maskmul_p[l + 1]
        xc = self._vcycle(l + 1, rc) * self.maskmul_p[l + 1]
        x = x + self._prolong(l, xc)
        for k in range(self.nu):
            x = A.jacobi_sweep(x, bp, invd, self._sweep_omega(k, reverse=True))
        return x

    def apply(self, rp: torch.Tensor) -> torch.Tensor:
        """M⁻¹ r on padded vectors: V-cycle on free rows + exact Jacobi on
        penalty rows."""
        z = self._vcycle(0, rp * self.maskmul_p[0])
        return torch.where(self.masks_p[0], rp * self.inv_diags_p[0], z)


def chebyshev_omegas(nu: int) -> tuple:
    """Degree-nu Chebyshev root weights on [0.3ρ, 1.05ρ], ρ = 2 (the
    Gershgorin bound of D⁻¹A for a zero-row-sum Laplacian stiffness)."""
    a, bnd = 0.3 * 2.0, 1.05 * 2.0
    return tuple(
        1.0 / ((a + bnd) / 2 + (bnd - a) / 2 * np.cos(np.pi * (2 * k - 1) / (2 * nu)))
        for k in range(1, nu + 1))


def level_masks_p(box: StructuredBox, dirichlet_mask: np.ndarray, *, device,
                  bc_planes: tuple = ("xmin", "xmax"), min_size: int = 8,
                  dtype=torch.float32) -> list[torch.Tensor]:
    """The padded mask plane of every level (1.0 on Dirichlet rows): the
    constants of ``build_mg_padded``, which a timed caller builds once."""
    return [torch.as_tensor(pad_host_vec(b, m, np.float32), device=device).to(dtype)
            for b, m in _levels(box, dirichlet_mask, bc_planes, min_size)]


def build_mg_padded(box: StructuredBox, coords3d: torch.Tensor,
                    dirichlet_mask: np.ndarray, penalty: float,
                    bc_planes: tuple = ("xmin", "xmax"), min_size: int = 8,
                    nu: int = 2, omega: float = 0.8, coarse_iters: int = 40,
                    fine: DiaPlaneMatrixP | None = None, fused: bool = True,
                    cheb: bool = False, band_dtype=None,
                    masks_p: list | None = None) -> MGPrecondP:
    """The padded-layout hierarchy.  Every level is assembled and penalised
    by the fused stencil assembly (K4 on the card), unless ``fine`` (an
    already penalised operator, e.g. the solve's own) is given for level 0.
    ``fused=False`` re-discretises each level by the stiffness-only
    assembly (K4's DiaMatrix mode on the card), writes the penalty on its
    Dirichlet diagonal and moves it to the plane layout (``to_plane_matrix``),
    as the JAX ``fused=False`` branch.  ``band_dtype`` (e.g. torch.bfloat16)
    stores the hierarchy's bands at that width; each inverse diagonal is
    taken before the cast.  ``masks_p``: the levels' padded mask planes
    (``level_masks_p``), else built here."""
    if masks_p is None:
        masks_p = level_masks_p(box, dirichlet_mask, device=coords3d.device,
                                bc_planes=bc_planes, min_size=min_size,
                                dtype=coords3d.dtype)
    mats, inv_diags, maskmuls, masks, shapes = [], [], [], [], []
    levels = _levels(box, dirichlet_mask, bc_planes, min_size)
    c3 = coords3d
    for (b, mask), mask_p in zip(levels, masks_p, strict=True):
        if fine is not None and not mats:
            Ap = fine
        elif not fused:
            m = torch.as_tensor(mask, device=coords3d.device)
            Ap = to_plane_matrix(_penalised_stiffness(b, c3, m, penalty), b)
        else:
            Ap, _ = assemble_system(b, c3.contiguous(), mask_p,
                                    torch.zeros_like(mask_p), penalty)
        c3 = c3[::2, ::2, ::2]
        inv_diags.append(Ap.inv_diagonal_p())
        if band_dtype is not None:
            Ap = Ap.astype_bands(band_dtype)
        mats.append(Ap)
        maskmuls.append(1.0 - mask_p)
        masks.append(mask_p > 0.5)
        shapes.append(b.shape)
    return MGPrecondP(mats, inv_diags, maskmuls, masks, shapes, nu=nu,
                      omega=omega, coarse_iters=coarse_iters,
                      omegas=chebyshev_omegas(nu) if cheb else ())


def mg_from_numpy(bands_p, inv_diags_p, maskmul_p, masks_p, shapes, *,
                  device, nu: int, omega: float, coarse_iters: int,
                  omegas=()) -> MGPrecondP:
    """A JAX ``MGPrecondP`` in the port: its per-level ``mats[l].bands_p``,
    ``inv_diags_p``, ``maskmul_p`` and ``masks_p`` as numpy (the padded
    layouts are the same), its ``shapes`` and its scalars."""
    mats = []
    for bp, shape in zip(bands_p, shapes, strict=True):
        box = StructuredBox(*(s - 1 for s in shape))
        mats.append(DiaPlaneMatrixP.from_jax_numpy(np.asarray(bp), box, device))

    def dev(arrs):
        return [torch.tensor(np.asarray(a), device=device) for a in arrs]

    return MGPrecondP(mats, dev(inv_diags_p), dev(maskmul_p), dev(masks_p),
                      [tuple(int(v) for v in s) for s in shapes], nu=nu,
                      omega=omega, coarse_iters=coarse_iters, omegas=omegas)
