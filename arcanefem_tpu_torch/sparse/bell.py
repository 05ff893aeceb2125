"""BELL (padded fixed-width row) sparse matrix, scalar blocks.

The counterpart of ``arcanefem_tpu/sparse/bell.py`` for block size 1, the
only block size on the port's main path.  ``values`` and ``cols`` are
(N, W): row r holds its nonzeros in its first slots, and a padding slot
keeps its own row as the column with value 0 (``sparse/topology.py``), so
every gather stays in bounds and padding adds nothing.  SpMV is the ELL
gather-reduce kernel (``ell_spmv``), or its plain twin on any device when
the matrix is built with ``plain=True`` (the comparison path that runs the
same solve without the kernels).
"""

from __future__ import annotations

import numpy as np
import torch

from .ell_gather import ell_spmv, ell_spmv_plain


def check_cols(cols: np.ndarray, n_cols: int, what: str) -> None:
    """Host-side range check of an ELL column array (the kernels do not
    check bounds)."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= n_cols):
        raise ValueError(f"{what}: column outside [0, {n_cols})")


class BellMatrix:
    """y = A @ x for a scalar BELL matrix held on one device."""

    def __init__(self, values: torch.Tensor, cols: torch.Tensor,
                 diag_slot: torch.Tensor | None = None, *,
                 plain: bool = False):
        if values.shape != cols.shape or values.dim() != 2:
            raise ValueError(f"values {tuple(values.shape)} and cols "
                             f"{tuple(cols.shape)} must be the same (N, W)")
        self.values = values
        self.cols = cols
        self.diag_slot = diag_slot
        self.plain = plain

    @classmethod
    def from_numpy(cls, values: np.ndarray, cols: np.ndarray,
                   diag_slot: np.ndarray | None = None, *,
                   device: torch.device | str, dtype: torch.dtype,
                   plain: bool = False) -> "BellMatrix":
        """Build from host arrays: values (N, W) or (N, W, 1, 1), int cols
        (N, W) in [0, N), and optionally the flat slot of each diagonal."""
        n = cols.shape[0]
        values = np.asarray(values).reshape(cols.shape)
        check_cols(cols, n, "BellMatrix.from_numpy")
        d = None
        if diag_slot is not None:
            d = torch.as_tensor(np.asarray(diag_slot, np.int64), device=device)
        # torch.tensor copies: the host arrays may be read-only views
        return cls(
            torch.tensor(values, device=device, dtype=dtype),
            torch.tensor(np.asarray(cols, np.int32), device=device),
            d,
            plain=plain,
        )

    @property
    def n_nodes(self) -> int:
        return self.values.shape[0]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        spmv = ell_spmv_plain if self.plain else ell_spmv
        return spmv(self.values, self.cols, x)

    def diagonal(self) -> torch.Tensor:
        if self.diag_slot is None:
            raise ValueError("BellMatrix built without diag_slot")
        return self.values.reshape(-1)[self.diag_slot]


def assemble_bell(topo, element_matrices: dict[str, torch.Tensor], *,
                  device: torch.device | str,
                  dtype: torch.dtype | None = None) -> BellMatrix:
    """Sum per-cell (nc, npc, npc) element matrices into the BELL matrix
    of ``topo`` (a ``sparse.topology.Topology``): one
    ``index_add_`` per cell bucket over its slot map, the counterpart of
    the JAX package's segment-sum."""
    acc = None
    for name, ke in element_matrices.items():
        slots = torch.as_tensor(
            np.asarray(topo.slot_maps[name], np.int64).reshape(-1),
            device=device)
        if acc is None:
            acc = torch.zeros(topo.n_slots, dtype=ke.dtype, device=device)
        acc.index_add_(0, slots, ke.reshape(-1))
    if dtype is not None:
        acc = acc.to(dtype)
    return BellMatrix(
        acc.reshape(topo.n_nodes, topo.width),
        torch.as_tensor(np.asarray(topo.ell_cols, np.int32), device=device),
        torch.as_tensor(np.asarray(topo.diag_slot, np.int64), device=device),
    )
