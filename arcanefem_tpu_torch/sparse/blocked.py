"""Blocked (b×b) SpMV for SCALAR sparse operators: BSR-b, b in 2 and 4.

The counterpart of ``arcanefem_tpu/sparse/blocked.py::BlockedGather``, an
opt-in alternative that no default path runs (the JAX package retired its
``AFEM_SPMV=blockN`` routing as a measured negative).  There a scalar CSR
operator is regrouped into b×b blocks so that one gather index serves b²
entries of the window sweep: a stage-0 pre-gather of the distinct block
columns, the main sweep (K3a, ``_products_b_unit``), a channel
contraction and a stage-3 sum of each block row's subrows.  On this card
that operator is a BSR-b SpMV, and it is written as one: the kernel of
``csrc/bsr8_spmv.cu`` (the supernode kernel, templated on the block size)
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

On a CUDA tensor the call launches the kernel or raises; on a CPU tensor
it runs :func:`bsr_spmv_plain`, the kernel's twin.  ``launch_counts()``
counts the launches, bf16 blocks apart as ``bsr_spmv_bf16``.  The JAX
class's ``emulate`` (numpy emulation of the TPU plan) and its pytree
registration are TPU machinery with no counterpart here.
"""

from __future__ import annotations

import torch

from ..utils import kernels

BLOCKS = (2, 4)
_ENTRY = {(b, t): f"afem_bsr_spmv_b{b}_{n}" for b in BLOCKS
          for t, n in ((torch.float32, "f32"), (torch.float64, "f64"),
                       (torch.bfloat16, "bf16_f32"))}
_LAUNCHES = {"bsr_spmv": 0, "bsr_spmv_bf16": 0}


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def bsr_spmv_plain(blocks: torch.Tensor, bcol: torch.Tensor, bptr: torch.Tensor,
                   x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain twin of the BSR-b kernel: x's b-value segments gathered by
    block column (zeros past its end), each block's products summed over
    j, then summed per block row with ``index_add_``, all in float64; the
    result (n_rows,) in x's dtype.  bfloat16 blocks take x rounded to
    bfloat16."""
    b, nb = blocks.shape[1], bptr.numel() - 1
    ncb = -(-x.shape[0] // b)
    xv = x.to(torch.bfloat16) if blocks.dtype == torch.bfloat16 else x
    xb = torch.zeros(ncb * b, dtype=torch.float64, device=x.device)
    xb[: x.shape[0]] = xv.double()
    yp = (blocks.double() * xb.view(ncb, b)[bcol.long()].unsqueeze(1)).sum(dim=2)
    brow = torch.repeat_interleave(torch.arange(nb, device=x.device), bptr.long().diff(),
                                   output_size=bcol.numel())
    yb = torch.zeros((nb, b), dtype=torch.float64, device=x.device)
    return yb.index_add_(0, brow, yp).reshape(-1)[:n_rows].to(x.dtype)


class BlockedGather:
    """y = A @ x for a scalar CSR A stored as b×b blocks (BSR-b) on one
    device: ``blocks`` (nnzb, b, b), int32 ``bcol`` (nnzb,) and ``bptr``
    (n_brows + 1,).  Build with :meth:`build_csr`."""

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
        self.blocks, self.bcol, self.bptr = blocks, bcol.contiguous(), bptr.contiguous()
        self.b, self.n_rows, self.n_cols, self.nnz = b, n_rows, n_cols, nnz
        self._xdtype = torch.float32 if blocks.dtype == torch.bfloat16 else blocks.dtype

    @staticmethod
    def build_csr(indices, indptr, data, n_cols: int | None = None, b: int = 4, *,
                  device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> "BlockedGather":
        """Scalar CSR (indices/indptr/data, numpy arrays or tensors, each
        row's columns distinct) -> the blocked operator on ``device``,
        blocks of ``dtype``; ``b`` is the block size (rows and columns)."""
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
        return BlockedGather(blocks, (uk % ncb).to(torch.int32), bptr.to(torch.int32),
                             n, n_cols, nnz)

    @property
    def fill(self) -> float:
        """Stored entries (blocks × b²) per nonzero."""
        return self.blocks.shape[0] * self.b * self.b / max(self.nnz, 1)

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in x's dtype (x is cast to the blocks' x type first, as
        the JAX class casts to float32)."""
        if x.dim() != 1 or x.shape[0] != self.n_cols:
            raise ValueError(f"BlockedGather: x must be ({self.n_cols},), got "
                             f"{tuple(x.shape)}")
        if x.device != self.blocks.device:
            raise ValueError("BlockedGather: x and the blocks lie on different devices")
        xin = x.to(self._xdtype).contiguous()
        if not xin.is_cuda:
            if xin.device.type != "cpu":
                raise ValueError(f"BlockedGather: no kernel for device {xin.device}")
            return bsr_spmv_plain(self.blocks, self.bcol, self.bptr, xin,
                                  self.n_rows).to(x.dtype)
        y = xin.new_empty(self.n_rows)
        kernels.launch(_ENTRY[self.b, self.blocks.dtype], xin.device,
                       self.blocks.data_ptr(), self.bcol.data_ptr(), self.bptr.data_ptr(),
                       xin.data_ptr(), y.data_ptr(), self.n_rows, self.n_cols,
                       self.bptr.numel() - 1)
        _LAUNCHES["bsr_spmv_bf16" if self.blocks.dtype == torch.bfloat16
                  else "bsr_spmv"] += 1
        return y.to(x.dtype)

    def with_weights_dtype(self, dtype) -> "BlockedGather":
        """The same blocks cast to ``dtype`` (bfloat16 halves their bytes;
        the kernel widens them and sums in float64)."""
        return BlockedGather(self.blocks.to(dtype).contiguous(), self.bcol, self.bptr,
                             self.n_rows, self.n_cols, self.nnz)
