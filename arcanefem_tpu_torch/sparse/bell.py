"""BELL sparse matrix held in sliced ELL (SELL-32-σ) storage.

The counterpart of ``arcanefem_tpu/sparse/bell.py``.  The JAX class holds
(N, W) padded rows of b×b blocks; here the rows are the ``sparse/sell.py``
layout built from the same (N, W) column array: ``values`` is the
(n_slots,) SELL vector, ``layout`` its :class:`~.sell.SellLayout` and
``diag_slot`` the SELL slot of each diagonal.

Block matrices (b = 2, 3: the vector systems) are stored as their scalar
expansion, dof = node·b + comp, as the JAX ``build_amg`` expands them:
row node·b + a holds, in ELL slot w·b + c, the entry (a, c) of the node
block in node slot w (:func:`block_layout`, built by
:class:`BlockAssembly` with the contributor lists).  Every entry of each real
node block is stored, zeros included (the JAX values keep them, and the
AMG strength pattern reads them).  ``block`` is b and ``dblock_slot`` the
(N, b, b) SELL slots of the diagonal blocks.  K1 then serves the block
SpMV unchanged, and the boundary conditions, Jacobi and the AMG fine
level work on dof rows.  The matrix may be rectangular (the AMG transfers P and
P^T).  SpMV is K1 (``sell_spmv``), or its plain twin on any device when
the matrix is built with ``plain=True`` (the comparison path that runs the
same solve without the kernels).  :meth:`BellMatrix.ell_values` gives the
(N, W) values back, for readers off the timed path.
"""

from __future__ import annotations

import numpy as np
import torch

from .sell import SellLayout, sell_spmv, sell_spmv_plain
from .slot_reduce import SlotSum, block_slot_reduce, group_by_slot, slot_reduce


def expanded_slot(node, w, a, c, *, b: int, width: int):
    """The flat ELL slot, in the scalar expansion of a b×b block operator
    whose node rows are ``width`` wide, of entry (a, c) of node slot
    (node, w): row node·b + a, slot w·b + c (numpy integers broadcast)."""
    return (node * b + a) * (width * b) + w * b + c


def check_cols(cols: np.ndarray, n_cols: int, what: str) -> None:
    """Host-side range check of an ELL column array (the kernels do not
    check bounds)."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= n_cols):
        raise ValueError(f"{what}: column outside [0, {n_cols})")


class BellMatrix:
    """y = A @ x for a sparse matrix in SELL storage on one device: scalar,
    or the scalar expansion of b×b blocks (``block`` b, ``dblock_slot``
    the (N, b, b) SELL slots of the diagonal blocks)."""

    def __init__(self, values: torch.Tensor, layout: SellLayout,
                 diag_slot: torch.Tensor | None = None, *,
                 plain: bool = False, block: int = 1,
                 dblock_slot: torch.Tensor | None = None):
        if values.shape != (layout.n_slots,):
            raise ValueError(f"values {tuple(values.shape)}, expected the "
                             f"layout's ({layout.n_slots},)")
        if layout.n_rows % block:
            raise ValueError(f"{layout.n_rows} rows are not nodes of {block} dofs")
        self.values = values
        self.layout = layout
        self.diag_slot = diag_slot
        self.plain = plain
        self.block = block
        self.dblock_slot = dblock_slot

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
    def n_dofs(self) -> int:
        """Rows (scalar dofs)."""
        return self.layout.n_rows

    @property
    def n_nodes(self) -> int:
        """Rows of nodes: the dofs over the block size."""
        return self.layout.n_rows // self.block

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

    def diag_blocks(self) -> torch.Tensor:
        """(N, b, b) diagonal blocks (for block-Jacobi); (N, 1, 1) for a
        scalar matrix."""
        if self.block == 1:
            return self.diagonal()[:, None, None]
        if self.dblock_slot is None:
            raise ValueError("block BellMatrix built without dblock_slot")
        return self.values[self.dblock_slot]

    def with_values(self, values: torch.Tensor, *,
                    plain: bool | None = None) -> "BellMatrix":
        """The same layout, block size and diagonal slots with other SELL
        values (a dtype cast, |A|, ...), and ``plain`` if given."""
        return BellMatrix(values, self.layout, self.diag_slot,
                          plain=self.plain if plain is None else plain,
                          block=self.block, dblock_slot=self.dblock_slot)

    def ell_values(self) -> torch.Tensor:
        """The (N, W) values, 0 on dropped slots (a device scatter)."""
        return self.layout.to_ell(self.values)

    def block_ell(self) -> tuple[np.ndarray, np.ndarray]:
        """The JAX BellMatrix's host arrays: (N, W, b, b) values and (N, W)
        node columns, from the (N·b, W·b) scalar expansion."""
        b = self.block
        ev = self.ell_values().cpu().numpy()
        n, wb = ev.shape
        return (ev.reshape(n // b, b, wb // b, b).transpose(0, 2, 1, 3),
                self.layout.ell_cols[::b, ::b] // b)

    def todense(self) -> torch.Tensor:
        """The dense (N, n_cols) matrix on the values' device (for a block
        matrix, (n_dofs, n_dofs)): each stored SELL slot added at (row,
        column), as the JAX ``todense`` (small systems and the dense direct
        solve only).  Slots that meet in one entry are summed in slot
        order by a ``SlotSum`` (its lists built here), so the matrix is
        the same in every run."""
        lay = self.layout
        dev = self.values.device
        real = torch.as_tensor(lay.real, device=dev)
        rows = lay.slot_rows(dev).long()[real]
        cols = lay.cols.to(dev).long()[real]
        flat, inv = torch.unique(rows * lay.n_cols + cols, return_inverse=True)
        dense = torch.zeros(lay.n_rows * lay.n_cols, dtype=self.values.dtype, device=dev)
        dense[flat] = SlotSum(inv, flat.numel(), dev)(self.values[real])
        return dense.view(lay.n_rows, lay.n_cols)


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
                  layout: SellLayout | None = None, block: int = 1,
                  block_asm: BlockAssembly | None = None) -> BellMatrix:
    """Sum per-cell (nc, npc, npc) element matrices into the BELL matrix
    of ``topo`` (a ``sparse.topology.Topology``), the counterpart of the
    JAX package's segment-sum: the buckets' slot maps, remapped on the host
    into the SELL slots of ``layout`` (default: :func:`fine_layout`, built
    here), are grouped by slot (:func:`slot_contributors`), and each slot
    sums its entries of the concatenated matrices in entry order
    (``slot_reduce``, one launch; no atomics).

    ``block`` b > 1: (nc, npc, npc, b, b) element blocks summed into the
    expanded layout of ``block_asm`` (a :class:`BlockAssembly` of these
    buckets, built here if not given) by ``block_slot_reduce``, one
    launch."""
    if block > 1:
        if block_asm is None:
            block_asm = BlockAssembly(topo, list(element_matrices), block, device)
        if list(element_matrices) != block_asm.names or block_asm.block != block:
            raise ValueError(f"assemble_bell: buckets {list(element_matrices)} of "
                             f"{block}x{block} blocks, the contributor lists were built "
                             f"for {block_asm.names} of {block_asm.block}")
        parts = [ke.reshape(-1) for ke in element_matrices.values()]
        table = parts[0] if len(parts) == 1 else torch.cat(parts)
        del parts
        acc = block_asm.reduce(table.to(device).contiguous())
        del table
        if dtype is not None:
            acc = acc.to(dtype)
        return BellMatrix(acc, block_asm.layout, block_asm.diag_slot, block=block,
                          dblock_slot=block_asm.dblock_slot)
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


def block_layout(topo, b: int, device: torch.device | str
                 ) -> tuple[SellLayout, torch.Tensor, torch.Tensor]:
    """The SELL layout of the scalar expansion of a mesh's b×b block
    operator, with the SELL slot of each dof's diagonal (n_dofs,) and of
    each diagonal block's entries (N, b, b): row n·b + a, ELL slot w·b + c
    stands for entry (a, c) of node slot (n, w), of column
    ``ell_cols[n, w]·b + c``; every entry of a real node slot is stored."""
    if b < 2:
        raise ValueError(f"block_layout: block size {b}; scalar operators use "
                         "fine_layout")
    N, W = topo.n_nodes, topo.width
    comp = np.arange(b, dtype=np.int32)
    cols = (topo.ell_cols.astype(np.int32)[:, None, :, None] * b
            + comp[None, None, None, :])  # (N, 1, W, b)
    cols = np.broadcast_to(cols, (N, b, W, b)).reshape(N * b, W * b)
    real = np.broadcast_to(topo.ell_valid[:, None, :, None], (N, b, W, b))
    lay = SellLayout.build(cols, real.reshape(N * b, W * b), device=device)
    dw = np.asarray(topo.diag_slot, np.int64) - np.arange(N, dtype=np.int64) * W
    node = np.arange(N, dtype=np.int64)[:, None, None]
    a = np.arange(b, dtype=np.int64)[None, :, None]
    c = np.arange(b, dtype=np.int64)[None, None, :]
    dblk = lay.ell_to_sell[expanded_slot(node, dw[:, None, None], a, c, b=b, width=W)]
    dblock_slot = torch.as_tensor(dblk, device=device)
    diag_slot = torch.as_tensor(np.einsum("naa->na", dblk).reshape(-1).copy(),
                                device=device)
    return lay, diag_slot, dblock_slot


class BlockAssembly:
    """The b×b block operator's SELL layout and what assembling into it
    needs, built once per problem on ``device``: ``layout``,
    ``diag_slot`` and ``dblock_slot`` (:func:`block_layout`); the
    node-level contributor lists ``ptr``, ``ids`` (:func:`group_by_slot`
    over the node-pair slots, in CSR order, of the entries ``c·npc² +
    i·npc + j`` of the buckets ``names``, concatenated); and the node CSR's
    ``row_ptr`` (N + 1,) int32, from which ``block_slot_reduce`` finds
    each node slot's expanded SELL slots.  That needs the topology's CSR
    entries to be the leading ELL slots of their rows, in order (both
    topology builders make them so); a topology that breaks it is
    refused."""

    def __init__(self, topo, names, b: int, device: torch.device | str):
        N, W = topo.n_nodes, topo.width
        row_ptr = np.asarray(topo.row_ptr, np.int64)
        csr_to_ell = np.asarray(topo.csr_to_ell, np.int64)
        lead = np.arange(len(csr_to_ell), dtype=np.int64) + np.repeat(
            np.arange(N, dtype=np.int64) * W - row_ptr[:-1], np.diff(row_ptr))
        if not np.array_equal(csr_to_ell, lead):
            raise ValueError("BlockAssembly: the topology's CSR entries are not the "
                             "leading ELL slots of their rows, in order")
        del lead
        self.layout, self.diag_slot, self.dblock_slot = block_layout(topo, b, device)
        layout = self.layout
        ell_to_csr = np.full(N * W, -1, np.int64)
        ell_to_csr[csr_to_ell] = np.arange(len(csr_to_ell))
        slots = np.concatenate([ell_to_csr[np.asarray(topo.slot_maps[name],
                                                      np.int64).reshape(-1)]
                                for name in names])
        self.names = list(names)
        self.block = b
        self.ptr, self.ids = group_by_slot(torch.as_tensor(slots, device=layout.device),
                                           len(csr_to_ell))
        del slots
        self.row_ptr = torch.as_tensor(row_ptr.astype(np.int32), device=layout.device)

    def reduce(self, table: torch.Tensor) -> torch.Tensor:
        """The (n_slots,) SELL values of the (E·b²,) table of element
        blocks (``block_slot_reduce``, one launch)."""
        return block_slot_reduce(self.ptr, self.ids, table, self.row_ptr, self.layout,
                                 self.block)
