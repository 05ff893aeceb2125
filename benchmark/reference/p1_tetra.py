"""P1 Poisson on an unstructured tetrahedral mesh, straight from the
definitions, in float64.

For a tetrahedron with corners p0..p3 and volume V the barycentric
gradients are the rows of inv([p1-p0; p2-p0; p3-p0])^T (for corners 1-3)
and minus their sum (corner 0); the stiffness entry is K_ab = V ∇φa·∇φb
and the load f·V/4 per corner.  Entries are summed into a sparse matrix
keyed by ``row * n + col``, in ascending key order.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 21  # tetrahedra per block


def element_geometry(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(V, G) of tetrahedra with corners ``p`` (..., 4, 3), float64:
    volumes (...,) and barycentric gradients (..., 4, 3)."""
    m = p[..., 1:, :] - p[..., :1, :]
    g3 = torch.linalg.inv(m).transpose(-1, -2)  # row k: ∇λ_{k+1}
    grads = torch.cat([-g3.sum(-2, keepdim=True), g3], dim=-2)
    vol = torch.linalg.det(m).abs() / 6.0
    return vol, grads


def stiffness(coords: torch.Tensor, tets: torch.Tensor, block: int = BLOCK):
    """(keys, values): the assembled stiffness as ascending unique keys
    ``row * n + col`` (int64) and their float64 sums."""
    n = coords.shape[0]
    coords = coords.to(torch.float64)
    keys, vals = [], []
    for s in range(0, tets.shape[0], block):
        t = tets[s : s + block].long()
        vol, g = element_geometry(coords[t])
        k = vol[:, None, None] * (g @ g.transpose(-1, -2))  # (b, 4, 4)
        keys.append((t[:, :, None] * n + t[:, None, :]).reshape(-1))
        vals.append(k.reshape(-1))
    keys, inv = torch.unique(torch.cat(keys), sorted=True, return_inverse=True)
    out = torch.zeros(keys.shape[0], dtype=torch.float64, device=coords.device)
    out.index_add_(0, inv, torch.cat(vals))
    return keys, out


def lumped_load(coords: torch.Tensor, tets: torch.Tensor, f: float,
                block: int = BLOCK) -> torch.Tensor:
    """The load vector of a constant source f: f·V/4 to each corner."""
    n = coords.shape[0]
    coords = coords.to(torch.float64)
    b = torch.zeros(n, dtype=torch.float64, device=coords.device)
    for s in range(0, tets.shape[0], block):
        t = tets[s : s + block].long()
        vol, _ = element_geometry(coords[t])
        b.index_add_(0, t.reshape(-1), (f * vol / 4.0).repeat_interleave(4))
    return b


def spmv(keys: torch.Tensor, vals: torch.Tensor, n: int, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the matrix (keys, vals), float64."""
    rows, cols = keys // n, keys % n
    y = torch.zeros(n, dtype=torch.float64, device=vals.device)
    y.index_add_(0, rows, vals * x.to(torch.float64)[cols])
    return y


def row_max(keys: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """max_j |A_ij| of every row i."""
    out = torch.zeros(n, dtype=torch.float64, device=vals.device)
    return out.scatter_reduce(0, keys // n, vals.abs(), "amax")
