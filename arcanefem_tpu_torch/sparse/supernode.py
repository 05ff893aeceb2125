"""Supernode-blocked SpMV: y = A x with A re-blocked into 8x8 blocks.

The counterpart of ``SupernodeSpmv`` and ``SupernodeMatrix`` in
``arcanefem_tpu/sparse/supernode.py`` (the JAX module imports jax, so the
numpy body of its host build is copied here).  The nodes must already be in
supernode order (``sparse/ordering.py::supernode_order``): supernode i owns
nodes [8i, 8i + 8), so the blocked x and y are plain reshapes, and the last
supernode is padded with zero rows and columns.

The JAX package runs one SpMV as three steps: a column gather of x into
an (nnzb, 8) buffer (K3a), the 8x8 block products (an XLA einsum) and a
row reduce of the products into (n_sup, 8) (K3a again).  The port runs it
as one hand-written kernel, ``bsr8_spmv`` (``csrc/bsr8_spmv.cu``): one
warp per block row reads each block once, multiplies it with x's 8 values
of its block column and sums the products in float64, so no padded x, no
gathered buffer and no product temporary exist.  The block columns and
the block-row pointer live on the device as int32, checked once when the
operator is built; a call checks x and launches.

    y[8i + r] = sum_{e = bptr[i]}^{bptr[i+1]-1}  sum_j  blocks[e, r, j] x[8 bcol[e] + j]

bfloat16 blocks take x rounded to bfloat16, as the JAX einsum
(``xg.astype(blocks.dtype)``); their products are exact in float32 and,
like every product here, are summed in float64.  ``bsr8_spmv_plain`` is
the three steps written in PyTorch, summed in float64: the kernel's plain
twin (CPU tensors, and the oracle on the card).

``block_products`` stays for the block-Jacobi apply of
``solver/amg.py``: an elementwise product and a sum over the 8 columns,
which cannot run in TF32 whatever the process-wide setting.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import kernels, tracing

BS = 8  # supernode size
_ENTRY = {torch.float32: "afem_bsr8_spmv_f32", torch.float64: "afem_bsr8_spmv_f64",
          torch.bfloat16: "afem_bsr8_spmv_bf16_f32"}
# launches by block type: float32/float64 blocks, bfloat16 blocks
_LAUNCHES = tracing.counters("bsr8_spmv", "bsr8_spmv_bf16")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def block_products(blocks: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[e, i] = sum_j blocks[e, i, j] v[e, j] in v's dtype, as an
    elementwise product and a sum over j (no matrix unit, so no TF32).

    bfloat16 blocks take v rounded to bfloat16 and sum the exact products
    in float32, as the JAX einsum with ``preferred_element_type=float32``
    does; other blocks are promoted to v's dtype."""
    if blocks.dtype == torch.bfloat16:
        a, b = blocks.float(), v.to(torch.bfloat16).float()
    else:
        a, b = blocks.to(v.dtype), v
    return (a * b.unsqueeze(1)).sum(dim=2).to(v.dtype)


def bsr8_spmv_plain(blocks: torch.Tensor, bcol: torch.Tensor,
                    bptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`bsr8_spmv`: x's 8-value segments gathered by
    block column (zeros past n), the 8x8 products summed over j, then the
    products summed per block row with ``index_add_``, all in float64;
    the result in x's dtype."""
    n_sup, n = bptr.numel() - 1, x.shape[0]
    xv = x.to(torch.bfloat16) if blocks.dtype == torch.bfloat16 else x
    xb = torch.zeros(n_sup * BS, dtype=torch.float64, device=x.device)
    xb[:n] = xv.double()
    yp = (blocks.double() * xb.view(n_sup, BS)[bcol.long()].unsqueeze(1)).sum(dim=2)
    brow = torch.repeat_interleave(torch.arange(n_sup, device=x.device),
                                   bptr.long().diff())
    yb = torch.zeros((n_sup, BS), dtype=torch.float64, device=x.device)
    return yb.index_add_(0, brow, yp).reshape(-1)[:n].to(x.dtype)


def _check_plan(blocks: torch.Tensor, bcol: torch.Tensor,
                bptr: torch.Tensor) -> None:
    """Raise on a block array or index array the kernel does not take:
    (nnzb, 8, 8) float32, float64 or bfloat16 blocks, contiguous and
    16-byte aligned on a card; int32 (nnzb,) bcol and (n_sup + 1,) bptr
    on the blocks' device, contiguous."""
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (BS, BS):
        raise ValueError(f"bsr8_spmv: blocks must be (nnzb, {BS}, {BS}), got "
                         f"{tuple(blocks.shape)}")
    if blocks.dtype not in _ENTRY:
        raise TypeError(f"bsr8_spmv: blocks must be float32, float64 or "
                        f"bfloat16, got {blocks.dtype}")
    nnzb = blocks.shape[0]
    if bcol.dtype != torch.int32 or bptr.dtype != torch.int32:
        raise TypeError("bsr8_spmv: bcol and bptr must be int32")
    if bcol.shape != (nnzb,) or bptr.dim() != 1 or bptr.numel() < 2:
        raise ValueError(f"bsr8_spmv: bcol ({nnzb},) and bptr (n_sup + 1,), got "
                         f"{tuple(bcol.shape)} and {tuple(bptr.shape)}")
    dev = blocks.device
    if bcol.device != dev or bptr.device != dev:
        raise ValueError("bsr8_spmv: blocks, bcol and bptr lie on different devices")
    if dev.type == "cuda":
        if not (blocks.is_contiguous() and bcol.is_contiguous()
                and bptr.is_contiguous()) or blocks.data_ptr() % 16:
            raise ValueError("bsr8_spmv: the CUDA kernel takes contiguous "
                             "operands and 16-byte aligned blocks")
    elif dev.type != "cpu":
        raise ValueError(f"bsr8_spmv: no kernel for device {dev}")


def _check_x(blocks: torch.Tensor, n_sup: int, x: torch.Tensor) -> None:
    """Raise on an x the kernel does not take with these blocks."""
    if x.dim() != 1 or not BS * (n_sup - 1) < x.shape[0] <= BS * n_sup:
        raise ValueError(f"bsr8_spmv: x must be 1-D of length in "
                         f"({BS * (n_sup - 1)}, {BS * n_sup}], got {tuple(x.shape)}")
    want = torch.float32 if blocks.dtype == torch.bfloat16 else blocks.dtype
    if x.dtype != want:
        raise TypeError(f"bsr8_spmv: {blocks.dtype} blocks take {want} x, got "
                        f"{x.dtype}")
    if x.device != blocks.device:
        raise ValueError("bsr8_spmv: x and the blocks lie on different devices")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError("bsr8_spmv: the CUDA kernel takes a contiguous x")


def bsr8_spmv(blocks: torch.Tensor, bcol: torch.Tensor, bptr: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """y = A x for A in BSR-8 form: blocks (nnzb, 8, 8), int32 block columns
    bcol (nnzb,) and block-row pointer bptr (n_sup + 1,), x of length n
    with 8 (n_sup - 1) < n <= 8 n_sup (the last supernode's columns past n
    read 0).  On a CUDA tensor the kernel of ``csrc/bsr8_spmv.cu``, on a
    CPU tensor its plain twin.  The block columns are not range-checked
    here: :class:`SupernodeSpmv` checks them once on the host."""
    _check_plan(blocks, bcol, bptr)
    _check_x(blocks, bptr.shape[0] - 1, x)
    if not x.is_cuda:
        return bsr8_spmv_plain(blocks, bcol, bptr, x)
    if int(bptr[-1]) != blocks.shape[0]:
        raise ValueError("bsr8_spmv: bptr[-1] differs from the number of blocks")
    y = x.new_empty(x.shape[0])
    kernels.launch(_ENTRY[blocks.dtype], x.device, blocks.data_ptr(),
                   bcol.data_ptr(), bptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                   x.shape[0], bptr.shape[0] - 1)
    tracing.count("bsr8_spmv_bf16" if blocks.dtype == torch.bfloat16 else "bsr8_spmv")
    return y


def build_blocks(values: np.ndarray, topo, bs: int = BS):
    """Host blocks of the scalar BELL values (N, W) on ``topo``, as the JAX
    ``SupernodeSpmv.build``: returns (blocks (nnzb, bs, bs), bcol, bptr,
    brow) with int64 index arrays, block rows sorted.

    The blocks keep the values' dtype.  The JAX build always rounds them to
    float32: the same for the float32 main path, but a float64 system then
    gets a float32 operator, whose 1e30 penalty rows (1.0000000150e30)
    disagree with the rhs's 1e30, the penalty-rounding fault of bench.py's
    CPU path; float64 blocks keep the float64 system exact."""
    n = topo.n_nodes
    n_sup = -(-n // bs)
    rp, cc = topo.row_ptr.astype(np.int64), topo.csr_cols.astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(rp))
    bkey = (rows // bs) * np.int64(n_sup) + cc // bs
    ub = np.unique(bkey)
    nnzb = len(ub)
    brow = (ub // n_sup).astype(np.int64)
    bcol = (ub % n_sup).astype(np.int64)
    bptr = np.zeros(n_sup + 1, np.int64)
    np.add.at(bptr, brow + 1, 1)
    np.cumsum(bptr, out=bptr)

    # block values: one host pass over the real BELL entries
    vals = np.asarray(values).reshape(n, topo.width)
    valid = np.asarray(topo.ell_valid, bool).reshape(-1)
    er = np.repeat(np.arange(n), topo.width)[valid]
    ec = np.asarray(topo.ell_cols, np.int64).reshape(-1)[valid]
    ev = vals.reshape(-1)[valid]
    blocks = np.zeros((nnzb, bs, bs), vals.dtype)
    eb = np.searchsorted(ub, (er // bs) * np.int64(n_sup) + ec // bs)
    blocks[eb, er % bs, ec % bs] = ev
    return blocks, bcol, bptr, brow


class SupernodeSpmv:
    """y = A x through 8x8 supernode blocks on one device.

    ``blocks`` (nnzb, bs, bs) is a device tensor; ``bcol``, ``bptr`` and
    ``brow`` stay on the host (numpy, int64) for the smoother's set-up, and
    ``cols``/``ptr`` are their int32 device copies the kernel reads.
    ``plain=True`` runs the kernel's plain twin on any device."""

    def __init__(self, n: int, blocks: torch.Tensor, bcol: np.ndarray,
                 bptr: np.ndarray, brow: np.ndarray, *, plain: bool = False):
        nnzb, bs, bs2 = blocks.shape
        n_sup = len(bptr) - 1
        if bs != BS or bs2 != BS or n_sup != -(-n // bs) or len(bcol) != nnzb \
                or len(brow) != nnzb or int(bptr[-1]) != nnzb:
            raise ValueError("SupernodeSpmv: blocks, bcol, bptr and brow "
                             f"disagree (n={n}, blocks {tuple(blocks.shape)})")
        if nnzb and (bcol.min() < 0 or bcol.max() >= n_sup):
            raise ValueError("SupernodeSpmv: bcol outside [0, n_sup)")
        if nnzb >= 2**31:
            raise ValueError("SupernodeSpmv: more blocks than int32 indexes")
        deg = np.diff(bptr)
        if np.any(deg < 0) or not np.array_equal(
                np.repeat(np.arange(n_sup), deg), brow):
            raise ValueError("SupernodeSpmv: brow and bptr disagree")
        self.n, self.n_sup, self.bs = n, n_sup, bs
        self.bcol, self.bptr, self.brow = bcol, bptr, brow
        self.plain = plain
        dev = blocks.device
        self.cols = torch.as_tensor(bcol.astype(np.int32), device=dev)
        self.ptr = torch.as_tensor(bptr.astype(np.int32), device=dev)
        self._bind(blocks.contiguous())

    def _bind(self, blocks: torch.Tensor) -> None:
        """Take ``blocks``, check the plan once and keep what a call on the
        card needs: the entry point, x's dtype and device, the pointers."""
        _check_plan(blocks, self.cols, self.ptr)
        self.blocks = blocks
        self._entry = _ENTRY[blocks.dtype]
        self._xdtype = torch.float32 if blocks.dtype == torch.bfloat16 else blocks.dtype
        self._dev = blocks.get_device()
        self._args = (blocks.data_ptr(), self.cols.data_ptr(), self.ptr.data_ptr())
        self._count = "bsr8_spmv_bf16" if blocks.dtype == torch.bfloat16 else "bsr8_spmv"

    @classmethod
    def from_numpy(cls, blocks: np.ndarray, bcol: np.ndarray, bptr: np.ndarray,
                   brow: np.ndarray, n: int, *, device: torch.device | str,
                   dtype: torch.dtype = torch.float32,
                   plain: bool = False) -> "SupernodeSpmv":
        """From host fields laid out as the JAX ``SupernodeSpmv``'s
        (``blocks``, ``_bcol``, ``_bptr``, ``_brow``, ``n``)."""
        return cls(n, torch.tensor(np.asarray(blocks), device=device, dtype=dtype),
                   np.asarray(bcol, np.int64), np.asarray(bptr, np.int64),
                   np.asarray(brow, np.int64), plain=plain)

    @classmethod
    def build(cls, A, topo, bs: int = BS) -> "SupernodeSpmv":
        """From a scalar BellMatrix ``A`` whose node order is a supernode
        order, on A's device and in its dtype."""
        blocks, bcol, bptr, brow = build_blocks(
            A.ell_values().cpu().numpy(), topo, bs)
        return cls.from_numpy(blocks, bcol, bptr, brow, topo.n_nodes,
                              device=A.values.device, dtype=A.values.dtype,
                              plain=A.plain)

    def as_bf16(self) -> "SupernodeSpmv":
        """Preconditioner-grade copy with bfloat16 blocks (exact products,
        float64 sums, float32 x and y) and the same index arrays.  For the
        V-cycle only: the CG operator defines the solution and keeps its
        float32 blocks."""
        out = copy.copy(self)
        out._bind(self.blocks.to(torch.bfloat16))
        return out

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: on the card one bsr8_spmv launch (x checked against
        what the plan's check kept), else the plain twin."""
        if x.shape != (self.n,):
            raise ValueError(f"SupernodeSpmv: x must be ({self.n},), got "
                             f"{tuple(x.shape)}")
        if self.plain or not x.is_cuda:
            return bsr8_spmv_plain(self.blocks, self.cols, self.ptr, x)
        if x.dtype != self._xdtype or x.get_device() != self._dev \
                or not x.is_contiguous():
            _check_x(self.blocks, self.n_sup, x)  # raises with the reason
        y = x.new_empty(self.n)
        kernels.launch(self._entry, x.device, *self._args, x.data_ptr(),
                       y.data_ptr(), self.n, self.n_sup)
        tracing.count(self._count)
        return y

    spmv = __call__


class SupernodeMatrix:
    """BellMatrix-shaped adapter: ``spmv`` through the supernode blocks,
    ``diagonal`` from the original matrix (for the smoothers)."""

    def __init__(self, sn: SupernodeSpmv, diag: torch.Tensor):
        self.sn = sn
        self.diag = diag

    @property
    def n_nodes(self) -> int:
        return self.sn.n

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return self.sn(x)

    def diagonal(self) -> torch.Tensor:
        return self.diag
