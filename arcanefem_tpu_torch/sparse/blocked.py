"""Blocked (b×b) SpMV for SCALAR sparse operators: BSR-b, b in 2 and 4.

The counterpart of ``arcanefem_tpu/sparse/blocked.py::BlockedGather``, an
opt-in alternative that no default path runs (the JAX package retired its
``AFEM_SPMV=blockN`` routing as a measured negative).  There a scalar CSR
operator is regrouped into b×b blocks so that one gather index serves b²
entries of the window sweep: a stage-0 pre-gather of the distinct block
columns, the main sweep (K3a, ``_products_b_unit``), a channel
contraction and a stage-3 sum of each block row's subrows.  On this card
that operator is a BSR-b SpMV, and it is written as one: a kernel
(``csrc/bsr8_spmv.cu`` at b = 4, ``csrc/bsr2_slice_spmv.cu`` at b = 2)
reads each stored block and its column once, multiplies it with x's b
values of its block column and sums the products of a block row in
float64; one launch per product, nothing else.

    y[b·I + r] = sum_{e = bptr[I]}^{bptr[I+1]-1}  sum_j  blocks[e, r, j] x[b·bcol[e] + j]

The blocks are built once, on the device, from the CSR arrays (a sort of
the block keys): absent scalar entries inside a stored block are exact
zeros, so the map is the scalar operator's.  The operator may be
rectangular (a transfer); columns past ``n_cols`` read 0 and rows past
``n_rows`` are not written.  Blocks are float32 (as the JAX class bakes
them) or float64, with x of the same type, or bfloat16
(:meth:`BlockedGather.with_weights_dtype`) with float32 x rounded to
bfloat16 first, as the bf16 supernode blocks take it.  ``fill`` is the
stored entries (blocks × b²) over the nonzeros.

At b = 4 the operator holds the BSR arrays and the kernel is the
supernode kernel's template (one warp per block row).  At b = 2 it holds
the blocks only as :class:`BlockSlices`, K1's SELL-32-σ
(``sparse/sell.py``) over 2×2 blocks, and ``bsr2_slice_kernel`` gives one
thread to one block row; ``slots_per_block`` is that layout's stored
slots over the blocks.  :func:`csr_to_bsr` gives the BSR arrays of a CSR,
for a caller that wants the definition (:func:`bsr_spmv_plain`) or a
library call beside the operator.

On a CUDA tensor the call launches the kernel or raises; on a CPU tensor
it runs the kernel's twin, :func:`bsr2_slices_plain` on the slices at
b = 2 and :func:`bsr_spmv_plain` at b = 4.  ``launch_counts()`` counts the
launches, bf16 blocks apart as ``bsr_spmv_bf16``.  The JAX class's
``emulate`` (numpy emulation of the TPU plan) and its pytree registration
are TPU machinery with no counterpart here.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import kernels, tracing
from .sell import C, choose_sigma, slice_rows

BLOCKS = (2, 4)
_NAMES = ((torch.float32, "f32"), (torch.float64, "f64"), (torch.bfloat16, "bf16_f32"))
_ENTRY = {t: f"afem_bsr_spmv_b4_{n}" for t, n in _NAMES}
_SLICE_ENTRY = {t: f"afem_bsr2_slice_spmv_{n}" for t, n in _NAMES}
_LAUNCHES = tracing.counters("bsr_spmv", "bsr_spmv_bf16")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def _block_products_plain(blocks, cols, rows, n_brows, x, n_rows) -> torch.Tensor:
    """y of the blocks (m, b, b) at block columns ``cols`` summed into block
    rows ``rows`` (row ``n_brows`` is dropped): x's b-value segments
    gathered by block column (zeros past its end), each block's products
    summed over j, then summed per block row with ``index_add_``, all in
    float64; the result (n_rows,) in x's dtype.  bfloat16 blocks take x
    rounded to bfloat16."""
    b = blocks.shape[1]
    ncb = -(-x.shape[0] // b)
    xv = x.to(torch.bfloat16) if blocks.dtype == torch.bfloat16 else x
    xb = torch.zeros(ncb * b, dtype=torch.float64, device=x.device)
    xb[: x.shape[0]] = xv.double()
    yp = (blocks.double() * xb.view(ncb, b)[cols.long()].unsqueeze(1)).sum(dim=2)
    yb = torch.zeros((n_brows + 1, b), dtype=torch.float64, device=x.device)
    return yb.index_add_(0, rows, yp)[:n_brows].reshape(-1)[:n_rows].to(x.dtype)


def bsr_spmv_plain(blocks: torch.Tensor, bcol: torch.Tensor, bptr: torch.Tensor,
                   x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain twin of the BSR-b kernel (b = 4), and the definition of the
    product at any b, on the BSR arrays."""
    nb = bptr.numel() - 1
    brow = torch.repeat_interleave(torch.arange(nb, device=x.device), bptr.long().diff(),
                                   output_size=bcol.numel())
    return _block_products_plain(blocks, bcol, brow, nb, x, n_rows)


def csr_to_bsr(indices, indptr, data, n_cols: int | None = None, b: int = 4, *,
               device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32):
    """Scalar CSR (indices/indptr/data, numpy arrays or tensors, each row's
    columns distinct) -> ``(blocks, bcol, bptr, n_cols)`` on ``device``:
    the b×b ``blocks`` (nnzb, b, b) of ``dtype``, their int32 block
    columns and block row pointers, built by a sort of the block keys."""
    if b not in BLOCKS:
        raise ValueError(f"BlockedGather: b must be one of {BLOCKS}, got {b}")
    indptr = torch.as_tensor(indptr, device=device).long()
    indices = torch.as_tensor(indices, device=device).long()
    data = torch.as_tensor(data, device=device).to(dtype)
    n, nnz = indptr.numel() - 1, indices.numel()
    if n_cols is None:
        n_cols = int(indices.max()) + 1 if nnz else n
    if nnz and (int(indices.min()) < 0 or int(indices.max()) >= n_cols):
        raise ValueError(f"BlockedGather: a column outside [0, {n_cols})")
    nb, ncb = -(-n // b), -(-n_cols // b)
    rows = torch.repeat_interleave(torch.arange(n, device=indices.device),
                                   indptr.diff(), output_size=nnz)
    key = torch.div(rows, b, rounding_mode="floor") * ncb + torch.div(
        indices, b, rounding_mode="floor")
    uk, inv = torch.unique(key, return_inverse=True)
    del key
    blocks = torch.zeros((uk.numel(), b, b), dtype=dtype, device=indices.device)
    blocks[inv, rows % b, indices % b] = data
    del inv
    brow = torch.div(uk, ncb, rounding_mode="floor")
    bptr = torch.zeros(nb + 1, dtype=torch.int64, device=indices.device)
    torch.cumsum(torch.bincount(brow, minlength=nb), 0, out=bptr[1:])
    if int(bptr[-1]) >= 2**31:
        raise ValueError("BlockedGather: more blocks than int32 indexes")
    return blocks, (uk % ncb).to(torch.int32), bptr.to(torch.int32), n_cols


class BlockSlices:
    """BSR-2 blocks in SELL-32-σ slices on their device (the b = 2
    kernel's layout).  Block rows are sorted by block count inside windows
    of σ rows (σ by :func:`sparse.sell.choose_sigma`, counting a slot as a
    block and its column), cut into slices of C = 32 block rows and stored
    slot-major: block k of the block row at sorted position p is slot
    ``slice_ptr[p // 32] + 32·k + p % 32`` of ``blocks`` (n_slots, 2, 2)
    and of the int32 ``cols`` (n_slots,).  Each slice is padded to its own
    longest block row; a padding slot holds a zero block and an in-range
    column (its block row's last, 0 in an empty one).  ``perm`` (int32, or
    None at σ = 1) is the block row at each position; ``slice_width`` (host)
    the slots of each slice."""

    def __init__(self, blocks: torch.Tensor, cols: torch.Tensor,
                 slice_ptr: torch.Tensor, perm: torch.Tensor | None, sigma: int,
                 slice_width: np.ndarray, n_brows: int):
        self.blocks, self.cols, self.slice_ptr, self.perm = blocks, cols, slice_ptr, perm
        self.sigma, self.slice_width, self.n_brows = sigma, slice_width, n_brows
        self.n_slots, self.n_slices = blocks.shape[0], len(slice_width)
        self._rows = None  # the plain twin's slot -> block row index

    @classmethod
    def build(cls, blocks: torch.Tensor, bcol: torch.Tensor,
              bptr: torch.Tensor) -> "BlockSlices":
        """The slices of BSR-2 ``blocks``/``bcol``/``bptr``, on their device
        (σ from the block counts, on the host)."""
        dev, nb, nnzb = blocks.device, bptr.numel() - 1, bcol.numel()
        ptr = bptr.long()
        lens = ptr.diff()
        lens_h = lens.cpu().numpy()
        sigma = choose_sigma(lens_h, 4 * blocks.element_size() + 4)
        perm, _, width, sptr = slice_rows(lens_h, sigma)
        pos = torch.arange(nb, device=dev)  # each block row's sorted position
        if perm is not None:
            pos[torch.as_tensor(perm, device=dev)] = torch.arange(nb, device=dev)
        sptr_d = torch.as_tensor(sptr, device=dev)
        # the slot of every stored block
        brow = torch.repeat_interleave(torch.arange(nb, device=dev), lens, output_size=nnzb)
        p = pos[brow]
        q = sptr_d[p // C] + C * (torch.arange(nnzb, device=dev) - ptr[brow]) + p % C
        del brow, p
        # padding takes its block row's last column (0 in an empty row)
        last = torch.zeros(len(width) * C, dtype=torch.int32, device=dev)
        full = lens > 0
        last[pos[full]] = bcol[ptr[1:][full] - 1]
        cols = last[cls._positions(sptr_d, width)]
        cols[q] = bcol
        sblocks = torch.zeros((int(sptr[-1]), 2, 2), dtype=blocks.dtype, device=dev)
        sblocks[q] = blocks
        return cls(sblocks, cols, sptr_d,
                   None if perm is None else torch.as_tensor(perm.astype(np.int32), device=dev),
                   sigma, width, nb)

    @staticmethod
    def _positions(slice_ptr: torch.Tensor, width: np.ndarray) -> torch.Tensor:
        """(n_slots,) int64: the block row position of each slot."""
        dev = slice_ptr.device
        s = torch.repeat_interleave(torch.arange(len(width), device=dev),
                                    torch.as_tensor(width * C, device=dev),
                                    output_size=int(slice_ptr[-1]))
        return s * C + (torch.arange(s.numel(), device=dev) - slice_ptr[s]) % C

    def slot_rows(self) -> torch.Tensor:
        """(n_slots,) int64 block row of each slot (``n_brows`` for lanes
        past the last block row), built at first use."""
        if self._rows is None:
            dev = self.cols.device
            row_of = torch.full((self.n_slices * C,), self.n_brows, dtype=torch.int64,
                                device=dev)
            row_of[: self.n_brows] = (torch.arange(self.n_brows, device=dev)
                                      if self.perm is None else self.perm.long())
            self._rows = row_of[self._positions(self.slice_ptr, self.slice_width)]
        return self._rows

    def astype(self, dtype: torch.dtype) -> "BlockSlices":
        """The same slices with the blocks cast to ``dtype``."""
        out = BlockSlices(self.blocks.to(dtype).contiguous(), self.cols, self.slice_ptr,
                          self.perm, self.sigma, self.slice_width, self.n_brows)
        out._rows = self._rows
        return out


def bsr2_slices_plain(sl: BlockSlices, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain twin of the b = 2 kernel, on its slices: each slot's f64
    products (its row's two added), summed per block row in slot order."""
    return _block_products_plain(sl.blocks, sl.cols, sl.slot_rows(), sl.n_brows, x, n_rows)


class BlockedGather:
    """y = A @ x for a scalar CSR A stored as b×b blocks on one device,
    from the BSR arrays ``blocks`` (nnzb, b, b), int32 ``bcol`` (nnzb,)
    and ``bptr`` (n_brows + 1,).  At b = 4 it holds those arrays; at b = 2
    only their :class:`BlockSlices` ``slices`` (``blocks``, ``bcol`` and
    ``bptr`` are then None).  Build with :meth:`build_csr`."""

    def __init__(self, blocks: torch.Tensor, bcol: torch.Tensor, bptr: torch.Tensor,
                 n_rows: int, n_cols: int, nnz: int):
        b = blocks.shape[1]
        if b not in BLOCKS or blocks.dim() != 3 or blocks.shape[2] != b:
            raise ValueError(f"BlockedGather: blocks must be (nnzb, b, b), b in {BLOCKS}, "
                             f"got {tuple(blocks.shape)}")
        if blocks.dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise TypeError(f"BlockedGather: blocks must be float32, float64 or "
                            f"bfloat16, got {blocks.dtype}")
        if bcol.dtype != torch.int32 or bptr.dtype != torch.int32:
            raise TypeError("BlockedGather: bcol and bptr must be int32")
        if (bcol.shape != (blocks.shape[0],) or bptr.numel() != -(-n_rows // b) + 1
                or n_rows < 1 or n_cols < 1):
            raise ValueError("BlockedGather: bcol (nnzb,) and bptr (ceil(n_rows/b) + 1,) "
                             "for n_rows, n_cols >= 1")
        if blocks.is_cuda and (not blocks.is_contiguous() or blocks.data_ptr() % 16):
            raise ValueError("BlockedGather: the CUDA kernel takes contiguous, "
                             "16-byte aligned blocks")
        self.b, self.n_rows, self.n_cols, self.nnz = b, n_rows, n_cols, nnz
        self.n_blocks = blocks.shape[0]
        self._xdtype = torch.float32 if blocks.dtype == torch.bfloat16 else blocks.dtype
        self.blocks = self.bcol = self.bptr = self.slices = None
        if b == 2:
            self.slices = BlockSlices.build(blocks, bcol.contiguous(), bptr.contiguous())
        else:
            self.blocks, self.bcol, self.bptr = blocks, bcol.contiguous(), bptr.contiguous()

    @staticmethod
    def build_csr(indices, indptr, data, n_cols: int | None = None, b: int = 4, *,
                  device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> "BlockedGather":
        """Scalar CSR (indices/indptr/data, numpy arrays or tensors, each
        row's columns distinct) -> the blocked operator on ``device``,
        blocks of ``dtype``; ``b`` is the block size (rows and columns)."""
        blocks, bcol, bptr, n_cols = csr_to_bsr(indices, indptr, data, n_cols, b,
                                                device=device, dtype=dtype)
        return BlockedGather(blocks, bcol, bptr, len(indptr) - 1, n_cols, len(indices))

    @property
    def dtype(self) -> torch.dtype:
        """The stored blocks' dtype."""
        return (self.blocks if self.slices is None else self.slices.blocks).dtype

    @property
    def fill(self) -> float:
        """Stored entries (blocks × b²) per nonzero."""
        return self.n_blocks * self.b * self.b / max(self.nnz, 1)

    @property
    def slots_per_block(self) -> float:
        """Stored slots of the b = 2 slices per block (1.0 at b = 4)."""
        if self.slices is None:
            return 1.0
        return self.slices.n_slots / max(self.n_blocks, 1)

    @property
    def nbytes(self) -> int:
        """Bytes of the stored blocks (the slices' slots at b = 2)."""
        t = self.blocks if self.slices is None else self.slices.blocks
        return t.numel() * t.element_size()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in x's dtype (x is cast to the blocks' x type first, as
        the JAX class casts to float32)."""
        if x.dim() != 1 or x.shape[0] != self.n_cols:
            raise ValueError(f"BlockedGather: x must be ({self.n_cols},), got "
                             f"{tuple(x.shape)}")
        sl = self.slices
        if x.device != (self.blocks if sl is None else sl.blocks).device:
            raise ValueError("BlockedGather: x and the blocks lie on different devices")
        xin = x.to(self._xdtype).contiguous()
        if not xin.is_cuda:
            if xin.device.type != "cpu":
                raise ValueError(f"BlockedGather: no kernel for device {xin.device}")
            if sl is not None:
                return bsr2_slices_plain(sl, xin, self.n_rows).to(x.dtype)
            return bsr_spmv_plain(self.blocks, self.bcol, self.bptr, xin,
                                  self.n_rows).to(x.dtype)
        y = xin.new_empty(self.n_rows)
        if sl is not None:
            kernels.launch(_SLICE_ENTRY[sl.blocks.dtype], xin.device, sl.blocks.data_ptr(),
                           sl.cols.data_ptr(), sl.slice_ptr.data_ptr(),
                           None if sl.perm is None else sl.perm.data_ptr(), xin.data_ptr(),
                           y.data_ptr(), self.n_rows, self.n_cols, sl.n_slices)
        else:
            kernels.launch(_ENTRY[self.blocks.dtype], xin.device, self.blocks.data_ptr(),
                           self.bcol.data_ptr(), self.bptr.data_ptr(), xin.data_ptr(),
                           y.data_ptr(), self.n_rows, self.n_cols, self.bptr.numel() - 1)
        tracing.count("bsr_spmv_bf16" if self.dtype == torch.bfloat16 else "bsr_spmv")
        return y.to(x.dtype)

    def with_weights_dtype(self, dtype) -> "BlockedGather":
        """The same blocks cast to ``dtype`` (bfloat16 halves their bytes;
        the kernel widens them and sums in float64)."""
        out = copy.copy(self)
        if self.slices is None:
            out.blocks = self.blocks.to(dtype).contiguous()
        else:
            out.slices = self.slices.astype(dtype)
        out._xdtype = torch.float32 if dtype == torch.bfloat16 else dtype
        return out
