"""Slot-major ("diagonal-coherent") ELL SpMV (``AFEM_SPMV=diag`` in the JAX
package).

The counterpart of ``arcanefem_tpu/sparse/pallas_spmv_diag.py``.  ELL rows
store their columns sorted, and after RCM the w-th neighbour of
consecutive rows advances with the row index.  ``plan_diag`` (a numpy copy
of the JAX planner, with the same gates) tiles the (n, W) columns
slot-major in blocks of R rows: tile g = w·qn + q of a block holds slot w
of its rows q·1024 .. q·1024+1023 as (8, 128), and stores per entry the
"diagonalised" offset lcols = col − 128·sublane − (lo − 8)·128, per block
the window start lo (shifted by +8 for the TPU layout's 8·128 leading
zeros), and per tile the probe base c0 and count scnt.

    diag_spmv(lo, c0, scnt, lcols, vals_tiled, x, W)

rebuilds each column from (lo, sublane, lcols), counts an entry only if
lcols >> 7 lies in [c0, c0 + scnt), and sums each row over its W slots in
float64: on a CUDA tensor the hand-written kernel of ``csrc/diag_spmv.cu``
(K10), on a CPU tensor its plain twin.  ``launch_counts()`` counts the
launches.

``diag_spmv`` checks every plan array on every call.  ``DiagEllMatrix``
has the BellMatrix interface the solver uses.  It tiles the values
slot-major and checks the plan once, at construction (the JAX class
re-tiles them on every call), so that its ``spmv`` checks only x; and it
raises when ``plan_diag`` declines: there is no fallback to another
kernel (the JAX ``_cached_spmv`` silently runs the window kernel then).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import kernels, tracing

LANE = 128
SUB = 8
TILE_ROWS = SUB * LANE  # 1024 rows per (8, 128) tile

_ENTRY = {torch.float32: "afem_diag_spmv_f32", torch.float64: "afem_diag_spmv_f64"}
_LAUNCHES = tracing.counters("diag_spmv")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


@dataclass
class DiagPlan:
    """Host-side slot-major blocking plan for one column array."""

    n_nodes: int
    width: int
    block_rows: int  # R (multiple of 1024)
    window: int  # V (multiple of 8*128 window entries)
    n_blocks: int
    n_probes: int  # S (static max)
    lo: np.ndarray  # (nb,) int32 window start (in 128-entry rows), +SUB
    c0: np.ndarray  # (nb, G) int32 per-tile probe base
    scnt: np.ndarray  # (nb, G) int32 per-tile needed probes (<= S)
    lcols: np.ndarray  # (nb, G, 8, 128) int32 diagonalised offsets


def plan_diag(cols_in: np.ndarray, pad_target: int, block_rows: int = 4096,
              max_window: int = 512 * 1024,
              max_probes: int = 48) -> DiagPlan | None:
    """A copy of ``pallas_spmv_diag.py::plan_diag``: None if the mean
    per-tile probe count exceeds ``max_probes``, a window exceeds
    ``max_window`` or R is not a multiple of 1024."""
    n, W = cols_in.shape
    R = block_rows
    if R % TILE_ROWS:
        return None
    nb = -(-n // R)
    n_pad = nb * R
    cols = np.empty((n_pad, W), np.int64)
    cols[:n] = cols_in
    # pad rows: keep the diagonal drift going (col = row index, capped)
    if n_pad > n:
        cols[n:] = np.minimum(np.arange(n, n_pad), pad_target)[:, None]

    qn = R // TILE_ROWS
    G = W * qn
    t = cols.reshape(nb, qn, SUB, LANE, W).transpose(0, 4, 1, 2, 3)
    # probe t's sublane s is window chunk c0+t+s: the window starts at the
    # min of the diagonalised columns col - 128·s
    diag = t - (np.arange(SUB) * LANE)[None, None, None, :, None]
    lo = diag.reshape(nb, -1).min(axis=1) // LANE  # (nb,) may be < 0
    d = diag - lo[:, None, None, None, None] * LANE
    dmin = d.min(axis=(3, 4))
    dmax = d.max(axis=(3, 4))
    c0 = dmin // LANE
    scnt = (dmax // LANE - c0) + 1
    S = int(scnt.max())
    if float(scnt.mean()) > max_probes:
        return None
    v128 = int((c0 + S).max()) + SUB - 1
    v128 = -(-v128 // SUB) * SUB
    if v128 * LANE > max_window:
        return None
    return DiagPlan(
        n_nodes=n, width=W, block_rows=R, window=v128 * LANE, n_blocks=nb,
        n_probes=S,
        lo=(lo + SUB).astype(np.int32),
        c0=c0.reshape(nb, G).astype(np.int32),
        scnt=scnt.reshape(nb, G).astype(np.int32),
        lcols=d.reshape(nb, G, SUB, LANE).astype(np.int32),
    )


def tile_values(values: torch.Tensor, block_rows: int) -> torch.Tensor:
    """(n, W) values -> the plan's slot-major tiles (nb, W·qn, 8, 128),
    zero rows padding the last block."""
    n, W = values.shape
    nb, qn = -(-n // block_rows), block_rows // TILE_ROWS
    v = torch.nn.functional.pad(values, (0, 0, 0, nb * block_rows - n))
    v = v.reshape(nb, qn, SUB, LANE, W).permute(0, 4, 1, 2, 3)
    return v.reshape(nb, W * qn, SUB, LANE).contiguous()


def diag_spmv_plain(lo: torch.Tensor, c0: torch.Tensor, scnt: torch.Tensor,
                    lcols: torch.Tensor, vals_tiled: torch.Tensor,
                    x: torch.Tensor, W: int) -> torch.Tensor:
    """Plain twin of :func:`diag_spmv`."""
    nb, G = c0.shape
    n = x.shape[0]
    lc = lcols.long()
    col = ((lo.long() - SUB) * LANE)[:, None, None, None] \
        + (torch.arange(SUB, device=x.device) * LANE)[None, None, :, None] + lc
    hi = lc >> 7
    reach = (hi >= c0[..., None, None]) & (hi < (c0 + scnt)[..., None, None])
    prods = torch.where(reach, vals_tiled.double()
                        * x[torch.where(reach, col, 0)].double(), 0.0)
    y = prods.reshape(nb, W, -1).sum(dim=1).reshape(-1)
    return y[:n].to(x.dtype)


def _check_plan(name: str, lo: torch.Tensor, c0: torch.Tensor, scnt: torch.Tensor,
                lcols: torch.Tensor, vals_tiled: torch.Tensor, W: int) -> int:
    """Raise on plan arrays the kernel does not take (one attribute read per
    test); return the rows the plan covers."""
    nb, G = c0.shape
    ls = lcols.shape
    if W <= 0 or G % W or ls != (nb, G, SUB, LANE) or vals_tiled.shape != ls \
            or lo.shape != (nb,) or scnt.shape != c0.shape:
        raise ValueError(f"{name}: plan arrays of mismatched shapes")
    i32 = torch.int32
    if lo.dtype != i32 or c0.dtype != i32 or scnt.dtype != i32 or lcols.dtype != i32:
        raise TypeError(f"{name}: lo, c0, scnt and lcols must be int32")
    if vals_tiled.dtype not in _ENTRY:
        raise TypeError(f"{name}: vals must be float32 or float64, got "
                        f"{vals_tiled.dtype}")
    dev = vals_tiled.device
    if lo.device != dev or c0.device != dev or scnt.device != dev \
            or lcols.device != dev:
        raise ValueError(f"{name}: operands lie on different devices")
    if dev.type == "cuda" and not (
            lo.is_contiguous() and c0.is_contiguous() and scnt.is_contiguous()
            and lcols.is_contiguous() and vals_tiled.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous operands")
    return nb * (G // W) * TILE_ROWS


def _check_x(name: str, x: torch.Tensor, dtype: torch.dtype, dev: int,
             rows: int) -> bool:
    """Raise on an x the plan does not take; True for a CUDA x (launch the
    kernel), False for a CPU one (run the twin)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: vals {dtype} and x {x.dtype} differ")
    if x.dim() != 1 or not 0 < x.size(0) <= rows:
        raise ValueError(f"{name}: x must be 1-D with at most the plan's {rows} "
                         f"rows, got {tuple(x.shape)}")
    if x.get_device() != dev:
        raise ValueError(f"{name}: operands lie on different devices")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"{name}: no kernel for device {x.device}")
        return False
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous x")
    return True


def diag_spmv(lo: torch.Tensor, c0: torch.Tensor, scnt: torch.Tensor,
              lcols: torch.Tensor, vals_tiled: torch.Tensor, x: torch.Tensor,
              W: int) -> torch.Tensor:
    """y = A @ x over a ``plan_diag`` plan (lo (nb,), c0 and scnt (nb, G),
    lcols and vals_tiled (nb, G, 8, 128), G = W·qn) and x (n,): K10 on the
    card.  The rows past n (the last block's padding) are not computed.
    Every operand is checked on every call; :class:`DiagEllMatrix` checks
    its plan once."""
    rows = _check_plan("diag_spmv", lo, c0, scnt, lcols, vals_tiled, W)
    if not _check_x("diag_spmv", x, vals_tiled.dtype, vals_tiled.get_device(), rows):
        return diag_spmv_plain(lo, c0, scnt, lcols, vals_tiled, x, W)
    y = x.new_empty(x.size(0))
    kernels.launch(_ENTRY[x.dtype], x.device, lo.data_ptr(), c0.data_ptr(),
                   scnt.data_ptr(), lcols.data_ptr(), vals_tiled.data_ptr(),
                   x.data_ptr(), y.data_ptr(), x.size(0), W, c0.size(1) // W)
    tracing.count("diag_spmv")
    return y


class DiagEllMatrix:
    """y = A @ x through K10: the BellMatrix interface the solver uses
    (``spmv``, ``diagonal``, ``n_nodes``).  The plan's arrays are built and
    checked once, here, and their data pointers kept, so that ``spmv``
    checks only x and launches once.  ``plain=True`` runs the plain twin on
    any device."""

    def __init__(self, values: torch.Tensor, cols: np.ndarray,
                 diag_slot: torch.Tensor | None = None, *,
                 block_rows: int = 4096, plain: bool = False):
        """values (n, W) on the device; cols the host (n, W) column array
        with sorted rows.  Raises ValueError when ``plan_diag`` declines."""
        if np.shape(cols) != tuple(values.shape):
            raise ValueError(f"DiagEllMatrix: values {tuple(values.shape)} and "
                             f"cols {np.shape(cols)} differ in shape")
        n, W = values.shape
        plan = plan_diag(np.asarray(cols), n - 1, block_rows)
        if plan is None:
            raise ValueError(
                "plan_diag declines this column structure (mean probes per "
                "tile above 48, or a window above 512K entries): the diag "
                "SpMV needs an RCM-like order")
        dev = values.device
        self.plan = plan
        self.lo, self.c0, self.scnt, self.lcols = (
            torch.tensor(a, device=dev) for a in (plan.lo, plan.c0, plan.scnt,
                                                  plan.lcols))
        self.vals_tiled = tile_values(values, block_rows)
        self._rows = _check_plan("DiagEllMatrix", self.lo, self.c0, self.scnt,
                                 self.lcols, self.vals_tiled, W)
        self.values = values
        self.diag_slot = diag_slot
        self.plain = plain
        self._entry = _ENTRY[values.dtype]
        self._dev = values.get_device()
        self._ptrs = tuple(a.data_ptr() for a in (self.lo, self.c0, self.scnt,
                                                  self.lcols, self.vals_tiled))
        self._qn = self.c0.size(1) // W

    @property
    def n_nodes(self) -> int:
        return self.values.shape[0]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        W = self.plan.width
        if not _check_x("DiagEllMatrix.spmv", x, self.values.dtype, self._dev,
                        self._rows) or self.plain:
            return diag_spmv_plain(self.lo, self.c0, self.scnt, self.lcols,
                                   self.vals_tiled, x, W)
        y = x.new_empty(x.size(0))
        kernels.launch(self._entry, x.device, *self._ptrs, x.data_ptr(),
                       y.data_ptr(), x.size(0), W, self._qn)
        tracing.count("diag_spmv")
        return y

    def diagonal(self) -> torch.Tensor:
        if self.diag_slot is None:
            raise ValueError("DiagEllMatrix built without diag_slot")
        return self.values.reshape(-1)[self.diag_slot]
