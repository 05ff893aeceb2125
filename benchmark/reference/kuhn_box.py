"""P1 Poisson on a box of hexahedra, each cut into the 6 Kuhn tetrahedra,
in float64.

The Kuhn (Freudenthal) cut of a unit hex: one tetrahedron per order of
the three axes, the path (0,0,0) → +e_a → +e_b → +e_c = (1,1,1); all six
share the main diagonal.  The matrix is kept as a 27-point stencil:
``S[o][i, j, k]`` is the entry of row (i, j, k) and column
(i, j, k) + offset o, o = (dx, dy, dz) in {-1, 0, 1}³, index
(dx+1)·9 + (dy+1)·3 + (dz+1); entries that leave the box are 0.
"""

from __future__ import annotations

import itertools

import torch

from .p1_tetra import element_geometry

OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))
SLAB = 16  # hex planes along x per block


def offset_index(d) -> int:
    return (d[0] + 1) * 9 + (d[1] + 1) * 3 + (d[2] + 1)


def kuhn_tets() -> list[list[tuple[int, int, int]]]:
    """The 6 tetrahedra of the unit hex as lists of 4 corner deltas."""
    out = []
    for order in itertools.permutations(range(3)):
        cur = [0, 0, 0]
        path = [tuple(cur)]
        for ax in order:
            cur[ax] += 1
            path.append(tuple(cur))
        out.append(path)
    return out


def assemble(c3: torch.Tensor, f: float = 1.0):
    """(S, load): the stiffness stencil (27, X, Y, Z) and the load vector
    (X, Y, Z) of the constant source ``f``, for node coordinates ``c3``
    (X, Y, Z, 3), X = nx + 1 and so on."""
    c3 = c3.to(torch.float64)
    X, Y, Z, _ = c3.shape
    nx, ny, nz = X - 1, Y - 1, Z - 1
    S = torch.zeros((27, X, Y, Z), dtype=torch.float64, device=c3.device)
    load = torch.zeros((X, Y, Z), dtype=torch.float64, device=c3.device)
    for i0 in range(0, nx, SLAB):
        i1 = min(i0 + SLAB, nx)
        for tet in kuhn_tets():
            p = torch.stack([c3[i0 + d[0] : i1 + d[0], d[1] : d[1] + ny,
                                d[2] : d[2] + nz] for d in tet], dim=-2)
            vol, g = element_geometry(p)  # (s, ny, nz), (s, ny, nz, 4, 3)
            k = vol[..., None, None] * (g @ g.transpose(-1, -2))
            for a, da in enumerate(tet):
                sl = (slice(i0 + da[0], i1 + da[0]), slice(da[1], da[1] + ny),
                      slice(da[2], da[2] + nz))
                load[sl] += f * vol / 4.0
                for b, db in enumerate(tet):
                    o = offset_index(tuple(q - r for q, r in zip(db, da)))
                    S[(o,) + sl] += k[..., a, b]
    return S, load


def apply(S: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """y = A x on the (X, Y, Z) grid, float64."""
    X, Y, Z = x3.shape
    xp = torch.nn.functional.pad(x3.to(torch.float64), (1, 1, 1, 1, 1, 1))
    y = torch.zeros_like(xp[1:-1, 1:-1, 1:-1])
    for o, (dx, dy, dz) in enumerate(OFFSETS):
        y += S[o] * xp[1 + dx : 1 + dx + X, 1 + dy : 1 + dy + Y, 1 + dz : 1 + dz + Z]
    return y


def row_max(S: torch.Tensor) -> torch.Tensor:
    """max over the stencil of |A_ij|, per row (X, Y, Z)."""
    return S.abs().amax(0)
