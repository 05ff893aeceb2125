"""Persistent per-Gauss-point state: the GaussDoFsOnCells role.

The counterpart of ``arcanefem_tpu/ops/gauss_state.py`` (reference
femutils/GaussDoFsOnCells.h:63-69: per-Gauss-point weight, shape values,
shape derivatives and Jacobian determinant stored once per cell and
reused every time step, modules/passmo/ElastodynamicModule.cc:188-253).
Per cell bucket, (ng, nc, npc, dim) physical gradients and (ng, nc)
w·|detJ| tensors on the coordinates' device, built once; the block
matrices and the Gauss-point strain and stress are contractions of them
(plain torch ``einsum``, as the JAX module's ``jnp.einsum``).

The build and the block matrices run in chunks of ``chunk`` cells into
one preallocated output, so a mesh of 11M tetrahedra holds one
(nc, npc, npc, d, d) table and the temporaries of one chunk; a cell's
values do not depend on the chunking.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import quadrature as Q

CHUNK_CELLS = 1 << 20  # cells per chunk of the build and the block tables


def _chunks(nc: int, chunk: int):
    for c0 in range(0, nc, chunk):
        yield c0, min(nc, c0 + chunk)


def _cells(v, c0: int, c1: int):
    """The cells [c0, c1) of a per-cell value ((nc,) or (1, nc)); a scalar
    as it is."""
    if isinstance(v, (int, float)) or np.ndim(v) == 0:
        return v
    return v[..., c0:c1]


@dataclass
class CellGaussState:
    """One cell bucket's persistent Gauss data: N (ng, npc) shared by the
    bucket, grads (ng, nc, npc, dim), wdet (ng, nc)."""

    cell_type: str
    N: torch.Tensor  # (ng, npc) shape values at the Gauss points
    grads: torch.Tensor  # (ng, nc, npc, dim) physical shape gradients
    wdet: torch.Tensor  # (ng, nc) w_g * |det J|
    ninteg: int
    dim: int

    @property
    def n_gauss(self) -> int:
        return self.N.shape[0]


class GaussState:
    """Per-bucket persistent Gauss state of a whole mesh."""

    def __init__(self, buckets: dict[str, CellGaussState], ninteg: int, dim: int,
                 chunk: int = CHUNK_CELLS):
        self.buckets = buckets
        self.ninteg = ninteg
        self.dim = dim
        self.chunk = chunk

    @staticmethod
    def build(mesh, coords: torch.Tensor, ninteg: int = 2, dim: int | None = None,
              chunk: int = CHUNK_CELLS) -> "GaussState":
        """grads/wdet of every cell bucket, once per mesh; ``coords``
        (n_nodes, 3) on the state's device in its dtype."""
        dim = dim if dim is not None else mesh.dim
        buckets = {}
        for ct, conn in mesh.cells.items():
            nc, npc = conn.shape
            N, _dN = Q.shape_tables(ct, ninteg)
            ng = N.shape[0]
            grads = torch.empty((ng, nc, npc, dim), dtype=coords.dtype, device=coords.device)
            wdet = torch.empty((ng, nc), dtype=coords.dtype, device=coords.device)
            for c0, c1 in _chunks(nc, chunk):
                xyz = coords[torch.as_tensor(np.asarray(conn[c0:c1], np.int64),
                                             device=coords.device)]
                _, grads[:, c0:c1], wdet[:, c0:c1] = Q.iso_geometry(ct, xyz, dim, ninteg)
            buckets[ct] = CellGaussState(
                cell_type=ct, N=torch.as_tensor(N, dtype=coords.dtype, device=coords.device),
                grads=grads, wdet=wdet, ninteg=ninteg, dim=dim)
        return GaussState(buckets, ninteg, dim, chunk)

    # -- assembly from stored state (no geometry recomputation) ------------

    def _blocks(self, ct: str, fn) -> torch.Tensor:
        st = self.buckets[ct]
        nc, npc = st.grads.shape[1], st.grads.shape[2]
        d = st.dim
        out = torch.empty((nc, npc, npc, d, d), dtype=st.wdet.dtype, device=st.wdet.device)
        for c0, c1 in _chunks(nc, self.chunk):
            out[c0:c1] = fn(st, c0, c1)
        return out

    def stiffness_blocks(self, ct: str, lam, mu) -> torch.Tensor:
        """Elasticity blocks (nc, npc, npc, d, d) from the stored gradients;
        the contraction of quadrature.stiffness_blocks_iso.  lam/mu:
        scalars or per-cell ((nc,) or (1, nc))."""
        return self._blocks(ct, lambda st, c0, c1: Q.elastic_blocks(
            st.grads[:, c0:c1], st.wdet[:, c0:c1], _cells(lam, c0, c1), _cells(mu, c0, c1)))

    def mass_blocks(self, ct: str, rho) -> torch.Tensor:
        """Consistent mass blocks (nc, npc, npc, d, d), ρ scalar or
        per-cell."""
        return self._blocks(ct, lambda st, c0, c1: Q.mass_blocks_from(
            st.N, st.wdet[:, c0:c1], _cells(rho, c0, c1), st.dim))

    # -- per-Gauss-point field recovery -------------------------------------

    def strain(self, ct: str, conn: np.ndarray, u: torch.Tensor) -> torch.Tensor:
        """Small-strain tensor at every Gauss point, (ng, nc, d, d), of the
        (n_nodes·d,) displacement ``u``."""
        st = self.buckets[ct]
        d = st.dim
        idx = torch.as_tensor(np.asarray(conn, np.int64), device=u.device)
        ue = u.reshape(-1, d)[idx]  # (nc, npc, d)
        gradu = torch.einsum("gcnr,cnd->gcdr", st.grads, ue)  # (g, nc, d, d)
        return 0.5 * (gradu + gradu.transpose(-1, -2))

    def stress(self, ct: str, conn: np.ndarray, u: torch.Tensor, lam, mu) -> torch.Tensor:
        """Linear-elastic Cauchy stress at every Gauss point."""
        eps = self.strain(ct, conn, u)
        d = self.buckets[ct].dim
        tr = eps.diagonal(dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(d, dtype=eps.dtype, device=eps.device)
        lamg = torch.as_tensor(lam, dtype=eps.dtype, device=eps.device)
        mug = torch.as_tensor(mu, dtype=eps.dtype, device=eps.device)
        if lamg.ndim:  # per-cell -> broadcast over (g, c)
            lamg = lamg.reshape(-1)[None, :, None, None]
            mug = mug.reshape(-1)[None, :, None, None]
        return lamg * tr[..., None, None] * eye + 2.0 * mug * eps
