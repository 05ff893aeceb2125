"""Compact two-stage ELL gather: a per-block distinct-column pre-gather,
then the ELL kernel over block-local indices (``AFEM_SPMV=compact`` and
``AFEM_ASM_COMPACT=1`` in the JAX package).

The counterpart of ``arcanefem_tpu/sparse/pallas_spmv.py::_compact_columns``
(its numpy path, :910-951) and ``CompactBellSpmv`` (:1271-1349).  The rows
are cut into blocks of R; ``uniq`` is the concatenation of each block's
sorted distinct real columns, and ``remap`` (n, W) holds each entry's index
into xc = x[uniq], so that y = A x is the same products over xc: every
entry multiplies the same x value, routed through xc.  Entries that are
not real (zero weight) point at their block's first compact slot.  A
:class:`CompactMatrix` keeps its BellMatrix's SELL values and layout, and
carries the remap into that layout (``SellLayout.with_cols``: the same
slices, permutation and values), so its second stage is K1 on the SELL
remap and equals the BellMatrix's own product bit for bit.  The
pre-gather xc = pre(x) is K2 over ``uniq`` (:class:`UnitGather`) or, with
``band_pre`` (``AFEM_BAND_PRE=1``), the banded tile gather
(``sparse/band_gather.py``: one K9a launch over its narrow and wide
tiles), whose narrow/wide tile permutation is baked into ``remap`` here.
The unit forms (the assembly's coordinate gather) run K2 then K2, or over
a stack of tables K3a (or the batched K9b) then K3a.

The port splits no rows (K1 takes the full width), so R is
``adaptive_block_rows(W)``, the block size ``CompactBellSpmv`` uses; the
JAX package's wide-row subrow split is not ported.  On the TPU the
compaction shrinks the window each block sweeps; on this card a gather is
a load through L2, so the route costs a second gather per product and is
kept for what it is: the JAX package's default route, run and timed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .band_gather import LANE, BandedGather
from .bell import BellMatrix
from .ell_gather import (
    ell_gather_sum,
    ell_gather_sum_batched,
    ell_gather_sum_batched_plain,
    ell_gather_sum_plain,
)


def adaptive_block_rows(W: int, target_g: int = 128, cap: int = 16384) -> int:
    """Largest R <= cap with R·W ≡ 0 (mod 128) and R·W/128 ≲ target_g: a
    copy of ``pallas_spmv.py::_adaptive_block_rows`` (640 at W=25, 16384
    at W=1)."""
    base = 128 // math.gcd(W, 128)
    r = (target_g * 128 // max(W, 1)) // base * base
    return int(max(base, min(cap, r)))


class UnitGather:
    """y[i] = x[cols[i]] over an (m, 1) int32 request list, -1 pads giving
    0: K2 for one table, K3a for a stack (``plain=True``: their twins on
    any device)."""

    def __init__(self, cols: torch.Tensor, *, plain: bool = False):
        self.cols = cols
        self.plain = plain

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (ell_gather_sum_plain if self.plain else ell_gather_sum)(self.cols, x)

    def call_batched(self, tables: torch.Tensor) -> torch.Tensor:
        return (ell_gather_sum_batched_plain if self.plain
                else ell_gather_sum_batched)(self.cols, tables)


def compact_columns(cols: np.ndarray, real: np.ndarray, R: int,
                    band_pre: bool, *, device: torch.device | str,
                    plain: bool = False):
    """(pre, remap): the pre-gather and the (n, W) int32 host remap of an
    ELL column array ``cols`` (n, W) with the mask ``real`` of entries that
    carry weight, in blocks of ``R`` rows.  ``pre`` is a
    :class:`~.band_gather.BandedGather` when ``band_pre`` and the banded
    plan builds (then ``remap`` is permuted by its ``tile_perm``), else a
    :class:`UnitGather` of ``uniq``."""
    cols = np.asarray(cols)
    n, W = cols.shape
    nb = -(-n // R)
    if int(cols.max(initial=0)) >= 2**31:
        raise ValueError("compact_columns: the kernels take int32 columns")
    idt = np.int32
    cp = np.full((nb * R, W), -1, idt)
    cp[:n] = np.where(real, cols, -1)
    uniqs, off = [], 0
    remap = np.empty((nb * R, W), idt)
    for b in range(nb):
        blk = cp[b * R : (b + 1) * R]
        m = blk >= 0
        if not m.any():
            uniqs.append(np.zeros(1, idt))
            remap[b * R : (b + 1) * R] = off
            off += 1
            continue
        u, inv = np.unique(blk[m], return_inverse=True)
        rm = np.full(blk.shape, off, idt)
        rm[m] = (off + inv).astype(idt)
        remap[b * R : (b + 1) * R] = rm
        uniqs.append(u)
        off += len(u)
    del cp
    uniq = np.concatenate(uniqs)
    pre = None
    if band_pre:
        pre, perm = BandedGather.build(uniq, device=device, plain=plain)
        if pre is not None:
            remap = perm[remap // LANE] * LANE + remap % LANE
    if pre is None:
        pre = UnitGather(torch.tensor(uniq.astype(np.int32)[:, None], device=device),
                         plain=plain)
    return pre, remap[:n]


class CompactGather:
    """The unit (assembly coordinate) form of the two stages over one
    column structure: ``pre`` (x -> xc) and the (n, W) int32 ``remap``
    into xc, -1 on entries that are not real, on one device.
    ``plain=True`` runs every stage's plain twin, on any device."""

    def __init__(self, pre, remap: torch.Tensor, *, plain: bool = False):
        self.pre = pre
        self.remap = remap
        self.plain = plain

    @classmethod
    def build(cls, cols: np.ndarray, real: np.ndarray, *, band_pre: bool,
              device: torch.device | str, R: int | None = None,
              plain: bool = False) -> "CompactGather":
        """From host ``cols`` and ``real`` (n, W); R defaults to
        :func:`adaptive_block_rows` of the width."""
        R = R or adaptive_block_rows(np.shape(cols)[1])
        pre, remap = compact_columns(cols, real, R, band_pre, device=device,
                                     plain=plain)
        remap = np.where(real, remap, -1)
        return cls(pre, torch.tensor(remap.astype(np.int32), device=device),
                   plain=plain)

    @property
    def band(self) -> bool:
        return isinstance(self.pre, BandedGather)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """y[r] = sum_w x[cols[r, w]] over the real entries (at W=1 the
        plain gather y[r] = x[cols[r, 0]])."""
        return (ell_gather_sum_plain if self.plain else ell_gather_sum)(
            self.remap, self.pre(x))

    def gather_batched(self, tables: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` over a (B, n_t) stack of tables of any strides."""
        xc = self.pre.call_batched(tables)
        fn = ell_gather_sum_batched_plain if self.plain else ell_gather_sum_batched
        return fn(self.remap, xc)


class CompactMatrix:
    """y = A @ x through the compact two stages: ``pre`` (x -> xc), then K1
    on ``op``, A's SELL values over the remap.  The BellMatrix interface the
    solver uses (``spmv``, ``diagonal``, ``n_nodes``), for the CG operator,
    the V-cycle's levels and its transfers."""

    def __init__(self, pre, op: BellMatrix):
        self.pre = pre
        self.op = op

    @classmethod
    def from_bell(cls, A: BellMatrix, *, band_pre: bool,
                  real: np.ndarray | None = None) -> "CompactMatrix":
        """The compact form of a BellMatrix ``A`` on its own device; the
        real entries are ``real`` (the topology's ``ell_valid``) or, by
        default, A's non-zero values (the JAX rule for level operators)."""
        lay = A.layout
        if real is None:
            real = A.ell_values().cpu().numpy() != 0
        pre, remap = compact_columns(
            lay.ell_cols, real, adaptive_block_rows(lay.width), band_pre,
            device=A.values.device, plain=A.plain)
        op = BellMatrix(A.values, lay.with_cols(remap, pre.n_rows), A.diag_slot,
                        plain=A.plain)
        return cls(pre, op)

    def with_values(self, values: torch.Tensor) -> "CompactMatrix":
        """The same two stages over other SELL values of A's layout."""
        return CompactMatrix(self.pre, self.op.with_values(values))

    @property
    def band(self) -> bool:
        return isinstance(self.pre, BandedGather)

    @property
    def n_nodes(self) -> int:
        return self.op.n_nodes

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.spmv(self.pre(x))

    def diagonal(self) -> torch.Tensor:
        return self.op.diagonal()
