"""Supernode-blocked SpMV: y = A x with A re-blocked into 8x8 blocks.

The counterpart of ``SupernodeSpmv`` and ``SupernodeMatrix`` in
``arcanefem_tpu/sparse/supernode.py`` (the JAX module imports jax, so the
numpy body of its host build is copied here).  The nodes must already be in
supernode order (``sparse/ordering.py::supernode_order``): supernode i owns
nodes [8i, 8i + 8), so the blocked x and y are plain reshapes, and the last
supernode is padded with zero rows and columns.

One SpMV is three steps, as in the JAX package:

    xg = x[bcol]                   (nnzb, 8)  column gather, K3a at W=1
    yp = blocks @ xg               (nnzb, 8)  8x8 block products, torch
    y  = sum of yp over block rows (n_sup, 8) row reduce, K3a at W = max
                                              block-row degree

The TPU's window plans become plain index arrays: the column gather is
``bcol`` as an (nnzb, 1) ELL, the row reduce an (n_sup, Wb) ELL of block
ids with -1 pads.  Both gathers run on the 8 channels of the (n, 8)
row-major arrays in place (``ell_gather_sum_batched``); the row reduce
sums in float64.  The block products stay PyTorch ops, as they are an XLA
einsum outside Pallas in the JAX package: an elementwise product and a sum
over the 8 columns, which cannot run in TF32 whatever the process-wide
setting (the JAX einsum carries no ``precision=HIGHEST``, so on the TPU it
ran with bf16 operands), and which ran faster than ``torch.bmm`` of the
same on an H100 at the 1.9M-DoF sphere's shapes (PERF.md).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .ell_gather import ell_gather_sum_batched, ell_gather_sum_batched_plain

BS = 8  # supernode size


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
    ``brow`` stay on the host (numpy, int64) for the smoother's set-up.
    ``plain=True`` runs the kernels' plain twins on any device."""

    def __init__(self, n: int, blocks: torch.Tensor, bcol: np.ndarray,
                 bptr: np.ndarray, brow: np.ndarray, *, plain: bool = False):
        nnzb, bs, bs2 = blocks.shape
        n_sup = len(bptr) - 1
        if bs != bs2 or n_sup != -(-n // bs) or len(bcol) != nnzb \
                or len(brow) != nnzb or int(bptr[-1]) != nnzb:
            raise ValueError("SupernodeSpmv: blocks, bcol, bptr and brow "
                             f"disagree (n={n}, blocks {tuple(blocks.shape)})")
        if nnzb and (bcol.min() < 0 or bcol.max() >= n_sup):
            raise ValueError("SupernodeSpmv: bcol outside [0, n_sup)")
        deg = np.diff(bptr)
        if np.any(deg < 0) or not np.array_equal(
                np.repeat(np.arange(n_sup), deg), brow):
            raise ValueError("SupernodeSpmv: brow and bptr disagree")
        self.n, self.n_sup, self.bs = n, n_sup, bs
        self.blocks = blocks
        self.bcol, self.bptr, self.brow = bcol, bptr, brow
        self.plain = plain
        dev = blocks.device
        # (nnzb, 1) int32 block columns
        self.cols = torch.as_tensor(bcol.astype(np.int32).reshape(-1, 1),
                                    device=dev)
        # row reduce: block-row i sums blocks bptr[i] .. bptr[i+1]-1, as an
        # (n_sup, Wb) int32 ELL of block ids with -1 pads
        rb = np.full((n_sup, max(int(deg.max()), 1) if n_sup else 1), -1,
                     np.int32)
        rb[brow, np.arange(nnzb) - np.repeat(bptr[:-1], deg)] = np.arange(
            nnzb, dtype=np.int32)
        self.row_blocks = torch.as_tensor(rb, device=dev)

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
        """Preconditioner-grade copy with bfloat16 blocks (float32 sums in
        the products) and the same index arrays.  For the V-cycle only:
        the CG operator defines the solution and keeps its float32 blocks."""
        out = copy.copy(self)
        out.blocks = self.blocks.to(torch.bfloat16)
        return out

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()

    def _gather(self, cols: torch.Tensor, tables: torch.Tensor,
                out: torch.Tensor) -> None:
        if self.plain:
            out.copy_(ell_gather_sum_batched_plain(cols, tables))
        else:
            ell_gather_sum_batched(cols, tables, out=out)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        nnzb, n_sup, bs = self.blocks.shape[0], self.n_sup, self.bs
        xb = torch.nn.functional.pad(x, (0, n_sup * bs - self.n)).view(n_sup, bs)
        # the 8 channels of the (rows, 8) arrays, read and written in place
        xg = torch.empty((nnzb, bs), dtype=x.dtype, device=x.device)
        self._gather(self.cols, xb.T, xg.T)
        yp = block_products(self.blocks, xg)
        yb = torch.empty((n_sup, bs), dtype=x.dtype, device=x.device)
        self._gather(self.row_blocks, yp.T, yb.T)
        return yb.reshape(-1)[: self.n]

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
