"""Compact two-stage ELL gather: a per-block distinct-column pre-gather,
then the ELL kernel over block-local indices (``AFEM_SPMV=compact`` and
``AFEM_ASM_COMPACT=1`` in the JAX package).

The counterpart of ``arcanefem_tpu/sparse/pallas_spmv.py::_compact_columns``
(its numpy path, :910-951) and ``CompactBellSpmv`` (:1271-1349).  The rows
are cut into blocks of R; ``uniq`` is the concatenation of each block's
sorted distinct real columns, and ``remap`` (n, W) holds each entry's index
into xc = x[uniq], so that

    y = ell_spmv(vals, remap, xc)     (K1 on the card)

is the same linear map as ``ell_spmv(vals, cols, x)``: every entry
multiplies the same x value, routed through xc.  Entries that are not
real (zero weight) point at their block's first compact slot.  The
pre-gather xc = pre(x) is K2 over ``uniq`` or, with ``band_pre``
(``AFEM_BAND_PRE=1``), the banded tile gather (``sparse/band_gather.py``:
K9a on the narrow tiles, K2 on the wide ones), whose narrow/wide tile
permutation is baked into ``remap`` here.  The unit forms (the assembly's
coordinate gather) run K2, or the batched K9b and K3a over a stack of
tables.

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

from .band_gather import LANE, BandedGather, UnitGather
from .ell_gather import (
    ell_gather_sum,
    ell_gather_sum_batched,
    ell_gather_sum_batched_plain,
    ell_gather_sum_plain,
    ell_spmv,
    ell_spmv_plain,
)


def adaptive_block_rows(W: int, target_g: int = 128, cap: int = 16384) -> int:
    """Largest R <= cap with R·W ≡ 0 (mod 128) and R·W/128 ≲ target_g: a
    copy of ``pallas_spmv.py::_adaptive_block_rows`` (640 at W=25, 16384
    at W=1)."""
    base = 128 // math.gcd(W, 128)
    r = (target_g * 128 // max(W, 1)) // base * base
    return int(max(base, min(cap, r)))


def compact_columns(cols: np.ndarray, real: np.ndarray, R: int,
                    band_pre: bool, *, device: torch.device | str,
                    plain: bool = False):
    """(pre, remap): the pre-gather and the (n, W) int32 host remap of an
    ELL column array ``cols`` (n, W) with the mask ``real`` of entries that
    carry weight, in blocks of ``R`` rows.  ``pre`` is a
    :class:`~.band_gather.BandedGather` when ``band_pre`` and the banded
    plan builds (then ``remap`` is permuted by its ``tile_perm``), else a
    :class:`~.band_gather.UnitGather` of ``uniq``."""
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
    """The two stages over one column structure: ``pre`` (x -> xc) and the
    (n, W) int32 ``remap`` into xc, on one device.  ``plain=True`` runs
    every stage's plain twin, on any device."""

    def __init__(self, pre, remap: torch.Tensor, *, plain: bool = False):
        self.pre = pre
        self.remap = remap
        self.plain = plain

    @classmethod
    def build(cls, cols: np.ndarray, real: np.ndarray, *, band_pre: bool,
              device: torch.device | str, R: int | None = None,
              unit: bool = False, plain: bool = False) -> "CompactGather":
        """From host ``cols`` and ``real`` (n, W); R defaults to
        :func:`adaptive_block_rows` of the width.  ``unit=True`` builds
        for the unit forms: entries that are not real get remap -1 and
        add 0 (the weighted form points them at a real slot instead, where
        their zero weight cancels them)."""
        R = R or adaptive_block_rows(np.shape(cols)[1])
        pre, remap = compact_columns(cols, real, R, band_pre, device=device,
                                     plain=plain)
        if unit:
            remap = np.where(real, remap, -1)
        return cls(pre, torch.tensor(remap.astype(np.int32), device=device),
                   plain=plain)

    @property
    def band(self) -> bool:
        return isinstance(self.pre, BandedGather)

    def spmv(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y[r] = sum_w vals[r, w] * x[cols[r, w]]."""
        return (ell_spmv_plain if self.plain else ell_spmv)(vals, self.remap, self.pre(x))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """y[r] = sum_w x[cols[r, w]] over the real entries (at W=1 the
        plain gather y[r] = x[cols[r, 0]]); built with ``unit=True``."""
        return (ell_gather_sum_plain if self.plain else ell_gather_sum)(
            self.remap, self.pre(x))

    def gather_batched(self, tables: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` over a (B, n_t) stack of tables of any strides."""
        xc = self.pre.call_batched(tables)
        fn = ell_gather_sum_batched_plain if self.plain else ell_gather_sum_batched
        return fn(self.remap, xc)


class CompactMatrix:
    """y = A @ x through a :class:`CompactGather`: the BellMatrix interface
    the solver uses (``spmv``, ``diagonal``, ``n_nodes``), for the CG
    operator, the V-cycle's levels and its transfers."""

    def __init__(self, values: torch.Tensor, cg: CompactGather,
                 diag_slot: torch.Tensor | None = None):
        if values.shape != cg.remap.shape:
            raise ValueError(f"values {tuple(values.shape)} and remap "
                             f"{tuple(cg.remap.shape)} differ in shape")
        self.values = values
        self.cg = cg
        self.diag_slot = diag_slot

    @classmethod
    def from_bell(cls, A, *, band_pre: bool,
                  real: np.ndarray | None = None) -> "CompactMatrix":
        """The compact form of a BellMatrix ``A`` on its own device; the
        real entries are ``real`` (the topology's ``ell_valid``) or, by
        default, A's non-zero values (the JAX rule for level operators)."""
        if real is None:
            real = A.values.cpu().numpy() != 0
        cg = CompactGather.build(A.cols.cpu().numpy(), real, band_pre=band_pre,
                                 device=A.values.device, plain=A.plain)
        return cls(A.values, cg, A.diag_slot)

    @property
    def n_nodes(self) -> int:
        return self.values.shape[0]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return self.cg.spmv(self.values, x)

    def diagonal(self) -> torch.Tensor:
        if self.diag_slot is None:
            raise ValueError("CompactMatrix built without diag_slot")
        return self.values.reshape(-1)[self.diag_slot]
