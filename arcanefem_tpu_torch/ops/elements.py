"""Batched element matrices in torch.

The counterpart of ``arcanefem_tpu/ops/elements.py``: each function maps
stacked cell vertex coordinates ``(nc, npc, 3)`` (plus physics parameters)
to stacked element matrices ``(nc, npc, npc)`` or ``(nc, npc, npc, b,
b)``, the batched form of the reference's per-cell
``_computeElementMatrix*`` kernels.  These are plain elementwise torch (no
Pallas kernel in the JAX package either); the CPU tests hold each to the
JAX function on random cells.

Every other element of the zoo (the quadratic ones and hexa8, penta6,
pyramid5) goes through the isoparametric path, ``stiffness_iso`` over
``ops/quadrature.py``.
"""

from __future__ import annotations

import torch

from .geometry import (
    edge2_length,
    quad4_area,
    quad4_gradients,
    tetra4_gradients,
    tetra4_volume,
    tria3_area,
    tria3_gradients,
)

from .quadrature import REF_DIM, iso_geometry


def stiffness_tria3(xyz: torch.Tensor) -> torch.Tensor:
    """∫ ∇u·∇v over P1 triangles: area·(dx⊗dx + dy⊗dy)
    (modules/poisson/FemModule.h:126-134)."""
    area = tria3_area(xyz)
    dx, dy = tria3_gradients(xyz)
    return area[:, None, None] * (
        dx[:, :, None] * dx[:, None, :] + dy[:, :, None] * dy[:, None, :]
    )


def stiffness_tetra4(xyz: torch.Tensor) -> torch.Tensor:
    """∫ ∇u·∇v over P1 tets: V·(dx⊗dx + dy⊗dy + dz⊗dz)
    (modules/poisson/FemModule.h:163-172)."""
    vol = tetra4_volume(xyz)
    dx, dy, dz = tetra4_gradients(xyz)
    return vol[:, None, None] * (
        dx[:, :, None] * dx[:, None, :]
        + dy[:, :, None] * dy[:, None, :]
        + dz[:, :, None] * dz[:, None, :]
    )


def stiffness_quad4(xyz: torch.Tensor) -> torch.Tensor:
    """One-point quad4 Laplacian: area·(dx⊗dx + dy⊗dy)
    (modules/fourier/FemModule.cc:237-245)."""
    area = quad4_area(xyz)
    dx, dy = quad4_gradients(xyz)
    return area[:, None, None] * (
        dx[:, :, None] * dx[:, None, :] + dy[:, :, None] * dy[:, None, :]
    )


def stiffness_iso(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    """Scalar Laplace stiffness Σ_g w·|detJ|·∇N_i·∇N_j through the
    isoparametric path: any zoo element, quadratic ones included (the
    CellFEMDispatcher role, femutils/ArcaneFemFunctions.h:1224-2342)."""
    _, grads, wdet = iso_geometry(cell_type, xyz, REF_DIM[cell_type])
    return torch.einsum("gc,gcid,gcjd->cij", wdet, grads, grads)


def stiffness(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    if cell_type == "tria3":
        return stiffness_tria3(xyz)
    if cell_type == "tetra4":
        return stiffness_tetra4(xyz)
    if cell_type == "quad4":
        return stiffness_quad4(xyz)
    if cell_type in REF_DIM and not cell_type.startswith("line"):
        return stiffness_iso(cell_type, xyz)
    raise ValueError(f"no stiffness kernel for cell type '{cell_type}'")


def mass_tria3(xyz: torch.Tensor) -> torch.Tensor:
    """∫ u·v over P1 triangles: area·[[1/6,1/12,1/12],...]
    (computeUVTria3, ArcaneFemFunctions.h:648-660 scaled by area)."""
    area = tria3_area(xyz)
    aii, aij = 1.0 / 6.0, 1.0 / 12.0
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    m = torch.full((3, 3), aij, dtype=xyz.dtype, device=xyz.device) + (aii - aij) * eye
    return area[:, None, None] * m[None]


def mass_tetra4(xyz: torch.Tensor) -> torch.Tensor:
    """∫ u·v over P1 tets: V/20·(1+δij)."""
    vol = tetra4_volume(xyz)
    m = (torch.ones((4, 4), dtype=xyz.dtype, device=xyz.device)
         + torch.eye(4, dtype=xyz.dtype, device=xyz.device)) / 20.0
    return vol[:, None, None] * m[None]


def mass(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    if cell_type == "tria3":
        return mass_tria3(xyz)
    if cell_type == "tetra4":
        return mass_tetra4(xyz)
    raise ValueError(f"no mass kernel for cell type '{cell_type}'")


def gradients(cell_type: str, xyz: torch.Tensor):
    """Per-cell shape gradients (tuple of (nc, npc) tensors, one per axis)."""
    if cell_type == "tria3":
        return tria3_gradients(xyz)
    if cell_type == "quad4":
        return quad4_gradients(xyz)
    if cell_type == "tetra4":
        return tetra4_gradients(xyz)
    raise ValueError(f"no gradient kernel for cell type '{cell_type}'")


def measure(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    """Cell measure: area (2D) or volume (3D)."""
    if cell_type == "tria3":
        return tria3_area(xyz)
    if cell_type == "tetra4":
        return tetra4_volume(xyz)
    if cell_type == "quad4":
        return quad4_area(xyz)
    raise ValueError(f"no measure kernel for cell type '{cell_type}'")


def _grad_stack(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    """(nc, npc, d) stacked shape gradients."""
    return torch.stack(gradients(cell_type, xyz), dim=-1)


def divdiv(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    """Unit-coefficient ∫(div u)(div v) vector blocks (nc,npc,npc,d,d):
    D[i,j,a,b] = meas · g[i,a] g[j,b] (the λ-part of the elasticity
    operator)."""
    g = _grad_stack(cell_type, xyz)
    m = measure(cell_type, xyz)
    return m[:, None, None, None, None] * torch.einsum("nia,njb->nijab", g, g)


def epseps(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    """Unit-coefficient ∫ε(u):ε(v) vector blocks (nc,npc,npc,d,d):
    E[i,j,a,b] = meas/2 · (g[i,b] g[j,a] + δ_ab g_i·g_j) (the 2μ-part)."""
    g = _grad_stack(cell_type, xyz)
    m = measure(cell_type, xyz)
    d = g.shape[-1]
    t1 = torch.einsum("nib,nja->nijab", g, g)
    dot = torch.einsum("nic,njc->nij", g, g)
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    return 0.5 * m[:, None, None, None, None] * (
        t1 + dot[:, :, :, None, None] * eye[None, None, None]
    )


def mass_blocks(cell_type: str, xyz: torch.Tensor, ndof: int) -> torch.Tensor:
    """Consistent mass as vector blocks m_ij · I_ndof (nc,npc,npc,b,b)."""
    m = mass(cell_type, xyz)
    eye = torch.eye(ndof, dtype=xyz.dtype, device=xyz.device)
    return m[:, :, :, None, None] * eye[None, None, None]


def edge2_mass(xyz: torch.Tensor) -> torch.Tensor:
    """Boundary-edge mass L/6·(1+δij) (nf,2,2): the convection matrix core
    (reference modules/heat/FemModule.cc:629-673, scaled there by h)."""
    L = edge2_length(xyz)
    m = (torch.ones((2, 2), dtype=xyz.dtype, device=xyz.device)
         + torch.eye(2, dtype=xyz.dtype, device=xyz.device)) / 6.0
    return L[:, None, None] * m[None]


def elasticity_tria3(
    xyz: torch.Tensor, lam, mu2
) -> torch.Tensor:
    """Plane-strain linear elasticity 2-dof element blocks (nc, 3, 3, 2,
    2): K = λ (div u)(div v) + 2μ ε(u):ε(v) over the triangle
    (modules/elasticity/FemModule.h:112-143); lam, mu2 = 2μ broadcast over
    cells."""
    area = tria3_area(xyz)
    dx, dy = tria3_gradients(xyz)  # (nc, 3)
    mu = mu2 / 2.0
    a = area[:, None, None]
    dxi, dxj = dx[:, :, None], dx[:, None, :]
    dyi, dyj = dy[:, :, None], dy[:, None, :]

    kxx = a * ((lam + mu2) * dxi * dxj + mu * dyi * dyj)
    kyy = a * ((lam + mu2) * dyi * dyj + mu * dxi * dxj)
    kxy = a * (lam * dxi * dyj + mu * dyi * dxj)
    kyx = a * (lam * dyi * dxj + mu * dxi * dyj)

    return torch.stack(
        [torch.stack([kxx, kxy], dim=-1), torch.stack([kyx, kyy], dim=-1)],
        dim=-2,
    )  # (nc, 3, 3, 2, 2)


def elasticity_tetra4(
    xyz: torch.Tensor, lam, mu2
) -> torch.Tensor:
    """3D linear elasticity 3-dof element blocks: (nc, 4, 4, 3, 3)."""
    vol = tetra4_volume(xyz)
    dx, dy, dz = tetra4_gradients(xyz)
    mu = mu2 / 2.0
    g = torch.stack([dx, dy, dz], dim=-1)  # (nc, 4, 3)
    # K[i,j,a,b] = V (λ g[i,a] g[j,b] + μ g[i,b] g[j,a] + μ δ_ab (g_i·g_j))
    v = vol[:, None, None, None, None]
    term1 = lam * torch.einsum("nia,njb->nijab", g, g)
    term2 = mu * torch.einsum("nib,nja->nijab", g, g)
    dot_ij = torch.einsum("nic,njc->nij", g, g)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    term3 = mu * dot_ij[:, :, :, None, None] * eye[None, None, None]
    return v * (term1 + term2 + term3)
