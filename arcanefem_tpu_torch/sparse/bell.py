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
from .slot_reduce import group_by_slot, slot_reduce


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

    def todense(self) -> torch.Tensor:
        """The dense (N, n_cols) matrix on the values' device: each (N, W)
        slot added at (row, ell_cols), as the JAX ``todense`` (small systems
        and the dense direct solve only)."""
        lay = self.layout
        ev = self.ell_values()
        dev = ev.device
        rows = torch.arange(lay.n_rows, device=dev).repeat_interleave(lay.width)
        cols = torch.as_tensor(lay.ell_cols.reshape(-1), device=dev, dtype=torch.int64)
        dense = torch.zeros((lay.n_rows, lay.n_cols), dtype=ev.dtype, device=dev)
        return dense.index_put_((rows, cols), ev.reshape(-1), accumulate=True)


def fine_layout(topo, device: torch.device | str) -> SellLayout:
    """The SELL layout of a mesh's assembled operator: ``topo.ell_cols``
    with the topology's real slots ``ell_valid``."""
    return SellLayout.build(topo.ell_cols, topo.ell_valid, device=device)


def slot_contributors(topo, names, layout: SellLayout) -> tuple[torch.Tensor, torch.Tensor]:
    """(ptr, ids) of ``group_by_slot`` on ``layout``'s device: the entries
    ``base + c·npc² + i·npc + j`` of the buckets ``names`` (in that order,
    their element matrices concatenated) that sum into each SELL slot of
    ``layout`` (:func:`fine_layout` of ``topo``), in entry order."""
    e2s = layout.ell_to_sell
    slots = np.concatenate([e2s[np.asarray(topo.slot_maps[name], np.int64).reshape(-1)]
                            for name in names])
    return group_by_slot(torch.as_tensor(slots, device=layout.device), layout.n_slots)


def assemble_bell(topo, element_matrices: dict[str, torch.Tensor], *,
                  device: torch.device | str,
                  dtype: torch.dtype | None = None,
                  layout: SellLayout | None = None) -> BellMatrix:
    """Sum per-cell (nc, npc, npc) element matrices into the BELL matrix
    of ``topo`` (a ``sparse.topology.Topology``), the counterpart of the
    JAX package's segment-sum: the buckets' slot maps, remapped on the host
    into the SELL slots of ``layout`` (default: :func:`fine_layout`, built
    here), are grouped by slot (:func:`slot_contributors`), and each slot
    sums its entries of the concatenated matrices in entry order
    (``slot_reduce``, one launch; no atomics)."""
    if layout is None:
        layout = fine_layout(topo, device)
    ptr, ids = slot_contributors(topo, list(element_matrices), layout)
    table = torch.cat([ke.reshape(-1) for ke in element_matrices.values()])
    acc = slot_reduce(ptr, ids, table.to(device).contiguous())
    del ptr, ids
    if dtype is not None:
        acc = acc.to(dtype)
    diag = torch.as_tensor(layout.ell_to_sell[np.asarray(topo.diag_slot, np.int64)],
                           device=device)
    return BellMatrix(acc, layout, diag)
