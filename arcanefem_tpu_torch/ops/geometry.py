"""Batched element geometry in torch, vectorised over cells.

The counterpart of ``arcanefem_tpu/ops/geometry.py`` (the reference's
per-cell geometry helpers, femutils/ArcaneFemFunctions.h:40-432 and
:449-816): every function takes the stacked vertex coordinates of all
cells of a bucket, shape ``(nc, npc, 3)``, and returns per-cell tensors,
in the coordinates' dtype and on their device.  These are elementwise
formulas, plain torch on every device; the CPU tests hold each to the JAX
function on random cells.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def tria3_area(xyz: torch.Tensor) -> torch.Tensor:
    """Unsigned triangle area; (nc, 3, 3) -> (nc,), by the 3D cross
    product (computeAreaTria3, ArcaneFemFunctions.h:84-95)."""
    v = _cross(xyz[:, 1] - xyz[:, 0], xyz[:, 2] - xyz[:, 0])
    return 0.5 * _norm(v)


def tria3_area2_signed(xyz: torch.Tensor) -> torch.Tensor:
    """Twice the signed (z=0 planar) area: the 2A determinant of the P1
    gradient formulas (ArcaneFemFunctions.h:514-520)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (
        x[:, 2] - x[:, 0]
    ) * (y[:, 1] - y[:, 0])


def tetra4_volume6_signed(xyz: torch.Tensor) -> torch.Tensor:
    """6x signed tetra volume (scalar triple product)."""
    v0 = xyz[:, 1] - xyz[:, 0]
    v1 = xyz[:, 2] - xyz[:, 0]
    v2 = xyz[:, 3] - xyz[:, 0]
    return (v0 * _cross(v1, v2)).sum(dim=-1)


def tetra4_volume(xyz: torch.Tensor) -> torch.Tensor:
    """Unsigned tetra volume (ArcaneFemFunctions.h:60-72)."""
    return torch.abs(tetra4_volume6_signed(xyz)) / 6.0


def tria3_gradients(xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P1 shape-function gradients of planar triangles: (dx, dy), each
    (nc, 3) (computeGradientX/YTria3, ArcaneFemFunctions.h:536-570)."""
    x, y = xyz[..., 0], xyz[..., 1]
    a2 = tria3_area2_signed(xyz)[:, None]
    dx = torch.stack(
        [y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], dim=1
    ) / a2
    dy = torch.stack(
        [x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], dim=1
    ) / a2
    return dx, dy


def quad4_area2_signed(xyz: torch.Tensor) -> torch.Tensor:
    """The 2A shoelace determinant of the quad4 gradient formulas
    (ArcaneFemFunctions.h:585-612)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return (
        x[:, 1] * y[:, 2]
        + x[:, 2] * y[:, 3]
        + x[:, 3] * y[:, 0]
        + x[:, 0] * y[:, 1]
    ) - (
        x[:, 2] * y[:, 1]
        + x[:, 3] * y[:, 2]
        + x[:, 0] * y[:, 3]
        + x[:, 1] * y[:, 0]
    )


def quad4_area(xyz: torch.Tensor) -> torch.Tensor:
    """Unsigned quad area (computeAreaQuad4)."""
    return 0.5 * torch.abs(quad4_area2_signed(xyz))


def quad4_gradients(xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-point quad4 gradient vectors (ArcaneFemFunctions.h:585-640)."""
    x, y = xyz[..., 0], xyz[..., 1]
    a2 = quad4_area2_signed(xyz)[:, None]
    dx = torch.stack(
        [
            y[:, 2] - y[:, 3],
            y[:, 3] - y[:, 0],
            y[:, 0] - y[:, 1],
            y[:, 1] - y[:, 2],
        ],
        dim=1,
    ) / a2
    dy = torch.stack(
        [
            x[:, 3] - x[:, 2],
            x[:, 0] - x[:, 3],
            x[:, 1] - x[:, 0],
            x[:, 2] - x[:, 1],
        ],
        dim=1,
    ) / a2
    return dx, dy


def tetra4_gradients(
    xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P1 tetra shape-function gradients, (nc, 4, 3) -> 3 x (nc, 4)
    (computeGradientX/Y/ZTetra4, ArcaneFemFunctions.h:690-816), with the
    reference's unsigned 6V denominator."""
    v6 = torch.abs(tetra4_volume6_signed(xyz))[:, None]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    def comp(u, w):
        # rows of the cofactor pattern used by the reference
        c0 = u[:, 1] * (w[:, 3] - w[:, 2]) + u[:, 2] * (w[:, 1] - w[:, 3]) + u[:, 3] * (w[:, 2] - w[:, 1])
        c1 = u[:, 0] * (w[:, 2] - w[:, 3]) + u[:, 2] * (w[:, 3] - w[:, 0]) + u[:, 3] * (w[:, 0] - w[:, 2])
        c2 = u[:, 0] * (w[:, 3] - w[:, 1]) + u[:, 1] * (w[:, 0] - w[:, 3]) + u[:, 3] * (w[:, 1] - w[:, 0])
        c3 = u[:, 0] * (w[:, 1] - w[:, 2]) + u[:, 1] * (w[:, 2] - w[:, 0]) + u[:, 2] * (w[:, 0] - w[:, 1])
        return torch.stack([c0, c1, c2, c3], dim=1)

    dx = comp(y, z) / v6
    dy = comp(z, x) / v6
    dz = comp(x, y) / v6
    return dx, dy, dz


def edge2_length(xyz: torch.Tensor) -> torch.Tensor:
    """(nf, 2, 3) -> (nf,) edge lengths (computeLengthEdge2)."""
    return _norm(xyz[:, 1] - xyz[:, 0])


def edge2_normal(xyz: torch.Tensor) -> torch.Tensor:
    """Unit normal of boundary edges, (nf, 2, 3) -> (nf, 2): n = (dy, -dx)/L
    in the stored face orientation (computeNormalEdge2)."""
    d = xyz[:, 1] - xyz[:, 0]
    L = _norm(d[:, :2], keepdim=True)
    return torch.stack([d[:, 1], -d[:, 0]], dim=1) / L[:, 0][:, None]


def tria3_normal(xyz: torch.Tensor) -> torch.Tensor:
    """Unit normal of boundary triangles, (nf, 3, 3) -> (nf, 3)."""
    v = _cross(xyz[:, 1] - xyz[:, 0], xyz[:, 2] - xyz[:, 0])
    return v / _norm(v, keepdim=True)


def barycenter(xyz: torch.Tensor) -> torch.Tensor:
    """(nc, npc, 3) -> (nc, 3)."""
    return torch.mean(xyz, dim=1)
