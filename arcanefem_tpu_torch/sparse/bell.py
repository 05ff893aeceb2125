"""BELL sparse matrix, scalar blocks, held in sliced ELL (SELL-32-σ) storage.

The counterpart of ``arcanefem_tpu/sparse/bell.py`` for block size 1, the
only block size on the port's main path.  The JAX class holds (N, W)
padded rows; here the rows are the ``sparse/sell.py`` layout built from
the same (N, W) column array: ``values`` is the (n_slots,) SELL vector,
``layout`` its :class:`~.sell.SellLayout` and ``diag_slot`` the SELL slot
of each diagonal.  The matrix may be rectangular (the AMG transfers P and
P^T).  SpMV is K1 (``sell_spmv``), or its plain twin on any device when
the matrix is built with ``plain=True`` (the comparison path that runs the
same solve without the kernels).  :meth:`BellMatrix.ell_values` gives the
(N, W) values back, for readers off the timed path.
"""

from __future__ import annotations

import numpy as np
import torch

from .sell import SellLayout, sell_spmv, sell_spmv_plain


def check_cols(cols: np.ndarray, n_cols: int, what: str) -> None:
    """Host-side range check of an ELL column array (the kernels do not
    check bounds)."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= n_cols):
        raise ValueError(f"{what}: column outside [0, {n_cols})")


class BellMatrix:
    """y = A @ x for a scalar sparse matrix in SELL storage on one device."""

    def __init__(self, values: torch.Tensor, layout: SellLayout,
                 diag_slot: torch.Tensor | None = None, *,
                 plain: bool = False):
        if values.shape != (layout.n_slots,):
            raise ValueError(f"values {tuple(values.shape)}, expected the "
                             f"layout's ({layout.n_slots},)")
        self.values = values
        self.layout = layout
        self.diag_slot = diag_slot
        self.plain = plain

    @classmethod
    def from_numpy(cls, values: np.ndarray, cols: np.ndarray,
                   diag_slot: np.ndarray | None = None, *,
                   device: torch.device | str, dtype: torch.dtype,
                   n_cols: int | None = None,
                   plain: bool = False) -> "BellMatrix":
        """Build from host arrays: values (N, W) or (N, W, 1, 1), int cols
        (N, W) in [0, n_cols) (default N), and optionally the flat (N·W)
        slot of each diagonal.  The non-zero values are stored (the JAX rule
        for level operators), and each diagonal slot."""
        values = np.asarray(values).reshape(np.shape(cols))
        real = values != 0
        if diag_slot is not None:
            diag_slot = np.asarray(diag_slot, np.int64)
            real.reshape(-1)[diag_slot] = True
        layout = SellLayout.build(cols, real, device=device, n_cols=n_cols)
        d = None
        if diag_slot is not None:
            d = torch.as_tensor(layout.ell_to_sell[diag_slot], device=device)
        return cls(layout.from_ell(values).to(dtype), layout, d, plain=plain)

    @property
    def n_nodes(self) -> int:
        """Rows."""
        return self.layout.n_rows

    @property
    def width(self) -> int:
        """The (N, W) form's row width."""
        return self.layout.width

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        spmv = sell_spmv_plain if self.plain else sell_spmv
        return spmv(self.values, self.layout, x)

    def diagonal(self) -> torch.Tensor:
        if self.diag_slot is None:
            raise ValueError("BellMatrix built without diag_slot")
        return self.values[self.diag_slot]

    def with_values(self, values: torch.Tensor) -> "BellMatrix":
        """The same layout and diagonal slots with other SELL values (a
        dtype cast, |A|, ...)."""
        return BellMatrix(values, self.layout, self.diag_slot, plain=self.plain)

    def ell_values(self) -> torch.Tensor:
        """The (N, W) values, 0 on dropped slots (a device scatter)."""
        return self.layout.to_ell(self.values)


def fine_layout(topo, device: torch.device | str) -> SellLayout:
    """The SELL layout of a mesh's assembled operator: ``topo.ell_cols``
    with the topology's real slots ``ell_valid``."""
    return SellLayout.build(topo.ell_cols, topo.ell_valid, device=device)


def assemble_bell(topo, element_matrices: dict[str, torch.Tensor], *,
                  device: torch.device | str,
                  dtype: torch.dtype | None = None) -> BellMatrix:
    """Sum per-cell (nc, npc, npc) element matrices into the BELL matrix
    of ``topo`` (a ``sparse.topology.Topology``): one ``index_add_`` per
    cell bucket over its slot map, remapped once on the host into the SELL
    slots of :func:`fine_layout`, the counterpart of the JAX package's
    segment-sum."""
    layout = fine_layout(topo, device)
    e2s = layout.ell_to_sell
    acc = None
    for name, ke in element_matrices.items():
        slots = torch.as_tensor(
            e2s[np.asarray(topo.slot_maps[name], np.int64).reshape(-1)],
            device=device)
        if acc is None:
            acc = torch.zeros(layout.n_slots, dtype=ke.dtype, device=device)
        acc.index_add_(0, slots, ke.reshape(-1))
    if dtype is not None:
        acc = acc.to(dtype)
    diag = torch.as_tensor(e2s[np.asarray(topo.diag_slot, np.int64)], device=device)
    return BellMatrix(acc, layout, diag)
