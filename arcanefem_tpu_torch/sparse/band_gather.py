"""Banded tile gather: the compact SpMV's pre-gather for sorted request
streams (``AFEM_BAND_PRE=1`` in the JAX package).

The counterpart of ``arcanefem_tpu/sparse/band_gather.py``.  A sorted
request stream (the concatenated per-block distinct columns of
``sparse/compact.py``) is cut into tiles of 128 requests.  A tile whose
requests span at most K table rows of 128 from an 8-aligned base is
NARROW: it keeps its base row and tile-local indices lrow·128 + lane.
Every other tile is WIDE and keeps its requests as they are.  The output
is [narrow tiles; wide tiles] in tile units of 128, and ``tile_perm[t]`` is
the output position of original tile t, which the caller bakes into its
downstream indices.

    band_gather(bases, lcols, x, K)             K9a: one table
    band_gather_batched(bases, lcols, T, K)     K9b: B <= 8 tables, any strides

compute ``out[t*128 + l] = x[bases[t]*128 + lcols[t, l]]`` over narrow
tiles t, with 0 where lcols lies outside [0, K*128) (the plan's pads,
``UNIT_PAD``) or the index lies past the table's end; they check every
operand on every call.  :class:`BandedGather` runs a whole plan, narrow
and wide tiles, as ONE launch of the same kernel into one output (counted
under the same two names): its plan arrays are checked once, at
construction, and a call checks only the table.  A wide request is a
plain index, -1 for a pad, and gives 0 on a pad or past the table's end.
On a CUDA tensor they launch the hand-written kernel of
``csrc/band_gather.cu`` or raise; on a CPU tensor they run the plain twin.
``launch_counts()`` counts the launches.

``BandedGather.build`` is a numpy copy of the JAX build (the CPU tests
hold it to the original exactly); its arrays keep the JAX layouts, bases
(nb, 1, G) and lcols (nb, G, 128).  The JAX wide remainder is a window
plan; here it is the request list itself, ``wide_cols`` (n_wide·128,)
int32 with -1 pads.  ``BandedRowSum`` is the JAX split plans' stage 2 (a
band gather followed by W2-wide row sums); the port splits no rows, so
nothing on its paths calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels, tracing
from .ell_gather import MAX_TABLES

LANE = 128
UNIT_PAD = 1 << 28  # pallas_spmv.py::_UNIT_PAD
DEF_K = 16

_ENTRY = {torch.float32: "afem_band_gather_f32", torch.float64: "afem_band_gather_f64"}
_LAUNCHES = tracing.counters("band_gather", "band_gather_batched")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def band_gather_batched_plain(bases: torch.Tensor, lcols: torch.Tensor,
                              tables: torch.Tensor, K: int) -> torch.Tensor:
    """Plain twin of :func:`band_gather_batched`, (B, n_tiles*128)."""
    lc = lcols.reshape(-1, LANE).long()
    src = bases.reshape(-1)[: lc.shape[0]].long()[:, None] * LANE + lc
    ok = (lc >= 0) & (lc < K * LANE) & (src < tables.shape[1])
    g = tables[:, torch.where(ok, src, 0).reshape(-1)]
    return torch.where(ok.reshape(-1), g, 0.0).to(tables.dtype)


def band_gather_plain(bases: torch.Tensor, lcols: torch.Tensor,
                      x: torch.Tensor, K: int) -> torch.Tensor:
    """Plain twin of :func:`band_gather`."""
    return band_gather_batched_plain(bases, lcols, x[None], K)[0]


def banded_gather_batched_plain(bases: torch.Tensor, lcols: torch.Tensor,
                                wide_cols: torch.Tensor | None,
                                tables: torch.Tensor, K: int) -> torch.Tensor:
    """Plain twin of :meth:`BandedGather.call_batched`: the narrow tiles'
    band gather (``bases``, ``lcols`` of the narrow tiles only), then the
    wide tiles' requests (0 on a -1 pad or past the table's end), (B,
    n_tiles*128)."""
    nar = band_gather_batched_plain(bases, lcols, tables, K)
    if wide_cols is None:
        return nar
    w = wide_cols.long()
    ok = (w >= 0) & (w < tables.shape[1])
    wid = torch.where(ok, tables[:, torch.where(ok, w, 0)], 0.0).to(tables.dtype)
    return torch.cat([nar, wid], dim=1)


def banded_gather_plain(bases: torch.Tensor, lcols: torch.Tensor,
                        wide_cols: torch.Tensor | None, x: torch.Tensor,
                        K: int) -> torch.Tensor:
    """Plain twin of :meth:`BandedGather.__call__`."""
    return banded_gather_batched_plain(bases, lcols, wide_cols, x[None], K)[0]


def _check(name: str, bases: torch.Tensor, lcols: torch.Tensor,
           t: torch.Tensor, batched: bool) -> int:
    """Check the operands (one attribute read each, to keep a call's host
    cost near a PyTorch op's); return the tile count."""
    if lcols.dtype != torch.int32 or bases.dtype != torch.int32:
        raise TypeError(f"{name}: bases and lcols must be int32")
    n_tiles = lcols.numel() // LANE
    if lcols.size(-1) != LANE or n_tiles > bases.numel():
        raise ValueError(f"{name}: lcols must be (..., {LANE}) with one base "
                         f"per tile, got {tuple(lcols.shape)} and "
                         f"{bases.numel()} bases")
    if batched:
        if t.dim() != 2 or not 1 <= t.size(0) <= MAX_TABLES:
            raise ValueError(f"{name}: tables must be (B, n) with 1 <= B <= "
                             f"{MAX_TABLES}, got {tuple(t.shape)}")
    elif t.dim() != 1:
        raise ValueError(f"{name}: x must be 1-D, got {tuple(t.shape)}")
    if t.dtype not in _ENTRY:
        raise TypeError(f"{name}: the table must be float32 or float64")
    dev = t.get_device()
    if bases.get_device() != dev or lcols.get_device() != dev:
        raise ValueError(f"{name}: operands lie on different devices")
    if t.is_cuda:
        if not (bases.is_contiguous() and lcols.is_contiguous()):
            raise ValueError(f"{name}: the CUDA kernel takes contiguous bases "
                             "and lcols")
        if batched and min(t.stride()) < 0:
            raise ValueError(f"{name}: negative table strides")
        if not batched and not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes a contiguous x")
    elif t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return n_tiles


def _launch(name: str, ptrs: tuple[int, int, int], t, out, n_tiles: int,
            n_narrow: int, K: int, B: int, n_t: int, ts_r: int, ts_b: int,
            os_r: int, os_b: int) -> None:
    """One launch over ``n_tiles`` tiles, the first ``n_narrow`` narrow;
    ``ptrs`` are the data pointers of bases, lcols and the wide requests
    (0 when every tile is narrow)."""
    kernels.launch(_ENTRY[t.dtype], t.device, *ptrs, t.data_ptr(), out.data_ptr(),
                   n_tiles, n_narrow, K, B, n_t, ts_r, ts_b, os_r, os_b)
    tracing.count(name)


def band_gather(bases: torch.Tensor, lcols: torch.Tensor, x: torch.Tensor,
                K: int) -> torch.Tensor:
    """out[t*128 + l] = x[bases[t]*128 + lcols[t, l]], 0 on pads (K9a on
    the card)."""
    n_tiles = _check("band_gather", bases, lcols, x, batched=False)
    if not x.is_cuda:
        return band_gather_plain(bases, lcols, x, K)
    out = x.new_empty(n_tiles * LANE)
    if n_tiles:
        _launch("band_gather", (bases.data_ptr(), lcols.data_ptr(), 0), x, out,
                n_tiles, n_tiles, K, 1, x.size(0), 1, 0, 1, 0)
    return out


def band_gather_batched(bases: torch.Tensor, lcols: torch.Tensor,
                        tables: torch.Tensor, K: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`band_gather` over B <= 8 tables (B, n) of any strides, into a
    new (B, n_tiles*128) tensor or ``out`` of any strides (K9b on the
    card)."""
    n_tiles = _check("band_gather_batched", bases, lcols, tables, batched=True)
    shape = (tables.size(0), n_tiles * LANE)
    if out is None:
        out = tables.new_empty(shape)
    elif out.shape != shape or out.dtype != tables.dtype \
            or out.device != tables.device or min(out.stride()) < 0:
        raise ValueError(f"band_gather_batched: out must be {shape} "
                         f"{tables.dtype} on {tables.device}")
    if not tables.is_cuda:
        return out.copy_(band_gather_batched_plain(bases, lcols, tables, K))
    if n_tiles:
        (ts_b, ts_r), (os_b, os_r) = tables.stride(), out.stride()
        _launch("band_gather_batched", (bases.data_ptr(), lcols.data_ptr(), 0),
                tables, out, n_tiles, n_tiles, K, shape[0], tables.size(1), ts_r,
                ts_b, os_r, os_b)
    return out


class BandedGather:
    """W=1 unit gather over a sorted-run request stream: narrow tiles on
    their bands, wide tiles by their requests, outputs [narrow; wide] in
    tile units of 128 (``n_rows`` = n_tiles·128), in one launch.

    The plan's arrays are checked once, here (dtype, shape, device,
    contiguity), and their data pointers kept, so that a call checks only
    its table and launches once."""

    def __init__(self, bases: torch.Tensor, lcols: torch.Tensor, K: int, G: int,
                 wide_cols: torch.Tensor | None, n_tiles: int, n_narrow: int,
                 need_rows: int, tile_perm: np.ndarray, *, plain: bool = False):
        nb, n_wide = -(-n_narrow // G), n_tiles - n_narrow
        i32 = torch.int32
        if bases.dtype != i32 or lcols.dtype != i32 or (
                wide_cols is not None and wide_cols.dtype != i32):
            raise TypeError("BandedGather: bases, lcols and wide_cols must be int32")
        if K <= 0 or K % 8 or n_wide < 0 or bases.shape != (nb, 1, G) \
                or lcols.shape != (nb, G, LANE):
            raise ValueError(
                f"BandedGather: {n_narrow} narrow tiles in groups of G={G} need "
                f"bases ({nb}, 1, {G}) and lcols ({nb}, {G}, {LANE}) with K a "
                f"positive multiple of 8, got {tuple(bases.shape)}, "
                f"{tuple(lcols.shape)}, K={K} and {n_tiles} tiles")
        if (wide_cols is None) != (n_wide == 0) or (
                wide_cols is not None and wide_cols.shape != (n_wide * LANE,)):
            raise ValueError(f"BandedGather: {n_wide} wide tiles need wide_cols "
                             f"({n_wide * LANE},), or None when there are none")
        self.device = bases.device
        if self.device.type not in ("cpu", "cuda") or lcols.device != self.device \
                or (wide_cols is not None and wide_cols.device != self.device):
            raise ValueError("BandedGather: the plan's arrays must lie on one "
                             "CPU or CUDA device")
        if not (bases.is_contiguous() and lcols.is_contiguous()
                and (wide_cols is None or wide_cols.is_contiguous())):
            raise ValueError("BandedGather: the plan's arrays must be contiguous")
        self.bases = bases  # (nb, 1, G) int32
        self.lcols = lcols  # (nb, G, 128) int32
        self.wide_cols = wide_cols  # (n_wide*128,) int32, -1 pads, or None
        self.K, self.G = K, G
        self.n_tiles = n_tiles
        self.n_narrow = n_narrow
        self.n_rows = n_tiles * LANE
        self.need_rows = need_rows  # table rows the narrow bands reach
        self.tile_perm = tile_perm  # (n_tiles,) int64, host
        self.plain = plain
        self._dev = bases.get_device()
        self._ptrs = (bases.data_ptr(), lcols.data_ptr(),
                      0 if wide_cols is None else wide_cols.data_ptr())

    @staticmethod
    def build(requests: np.ndarray, *, device: torch.device | str,
              K: int = DEF_K, G: int = 8, min_narrow_frac: float = 0.25,
              valid: np.ndarray | None = None, plain: bool = False):
        """requests: (m,) concatenated sorted runs; ``valid`` (m,) bool
        marks requests that must contribute (the others give an exact 0);
        invalid requests are forward-filled so that they never widen a
        band.  Returns (gather, tile_perm), or (None, None) when fewer than
        ``min_narrow_frac`` of the tiles are narrow (banding is then
        pointless) or there is nothing to fetch."""
        if K % 8:
            raise ValueError("K must be a multiple of 8")
        m = len(requests)
        if m == 0:
            return None, None
        requests = np.asarray(requests, np.int64)
        if valid is not None:
            valid = np.asarray(valid, bool)
            if not valid.any():
                return None, None
            idx = np.where(valid, np.arange(m), -1)
            np.maximum.accumulate(idx, out=idx)
            if idx[0] < 0:
                idx[idx < 0] = np.flatnonzero(valid)[0]
            requests = requests[idx]
        T = -(-m // LANE)
        req = np.empty(T * LANE, np.int64)
        req[:m] = requests
        req[m:] = requests[-1]
        pad_mask = np.zeros(T * LANE, bool)
        pad_mask[m:] = True
        if valid is not None:
            pad_mask[:m] |= ~valid
        tiles = req.reshape(T, LANE)
        rows_t = tiles >> 7
        base8 = (rows_t.min(axis=1) // 8) * 8
        span = rows_t.max(axis=1) - base8 + 1
        narrow = span <= K
        n_nar = int(narrow.sum())
        if n_nar < min_narrow_frac * T:
            return None, None
        nar_ids = np.flatnonzero(narrow)
        wid_ids = np.flatnonzero(~narrow)
        tile_perm = np.empty(T, np.int64)
        tile_perm[nar_ids] = np.arange(n_nar)
        tile_perm[wid_ids] = n_nar + np.arange(T - n_nar)

        nb = -(-n_nar // G)
        bases = np.zeros((nb, 1, G), np.int32)
        lcols = np.full((nb * G, LANE), UNIT_PAD, np.int32)
        nt = tiles[nar_ids]
        nb8 = base8[nar_ids]
        lrow = (nt >> 7) - nb8[:, None]
        lv = (lrow * LANE + (nt & (LANE - 1))).astype(np.int32)
        lv[pad_mask.reshape(T, LANE)[nar_ids]] = UNIT_PAD
        lcols[:n_nar] = lv
        bases.reshape(nb * G)[:n_nar] = nb8.astype(np.int32)
        need_rows = int((nb8.max() if n_nar else 0) + K)

        wide = None
        if len(wid_ids):
            wreq = tiles[wid_ids].reshape(-1)
            wpad = pad_mask.reshape(T, LANE)[wid_ids].reshape(-1)
            wide = torch.tensor(np.where(wpad, -1, wreq).astype(np.int32),
                                device=device)
        g = BandedGather(
            torch.tensor(bases, device=device),
            torch.tensor(lcols.reshape(nb, G, LANE), device=device),
            K, G, wide, T, n_nar, need_rows, tile_perm, plain=plain)
        return g, tile_perm

    def _narrow(self):
        """The narrow tiles' bases and lcols, (n_narrow,) and (n_narrow, 128)."""
        return (self.bases.reshape(-1)[: self.n_narrow],
                self.lcols.reshape(-1, LANE)[: self.n_narrow])

    def _check_table(self, name: str, t: torch.Tensor, batched: bool) -> str | None:
        """Check a table (one attribute read per test); its kernel's entry
        point, or None to run the plain twin (a CPU table, or ``plain``)."""
        entry = _ENTRY.get(t.dtype)
        if entry is None:
            raise TypeError(f"BandedGather.{name}: the table must be float32 or "
                            f"float64, got {t.dtype}")
        if batched:
            if t.dim() != 2 or not 1 <= t.size(0) <= MAX_TABLES:
                raise ValueError(f"BandedGather.{name}: tables must be (B, n) with "
                                 f"1 <= B <= {MAX_TABLES}, got {tuple(t.shape)}")
        elif t.dim() != 1:
            raise ValueError(f"BandedGather.{name}: x must be 1-D, got "
                             f"{tuple(t.shape)}")
        if t.get_device() != self._dev:
            raise ValueError(f"BandedGather.{name}: the table lies on {t.device}, "
                             f"the plan on {self.device}")
        if not t.is_cuda:
            if t.device.type != "cpu":
                raise ValueError(f"BandedGather.{name}: no kernel for device {t.device}")
            return None
        if self.plain:
            return None
        if batched and min(t.stride()) < 0:
            raise ValueError(f"BandedGather.{name}: negative table strides")
        if not (batched or t.is_contiguous()):
            raise ValueError(f"BandedGather.{name}: the CUDA kernel takes a "
                             "contiguous x")
        return entry

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) table -> (n_rows,): K9a over narrow and wide tiles."""
        if self._check_table("__call__", x, batched=False) is None:
            return banded_gather_plain(*self._narrow(), self.wide_cols, x, self.K)
        out = x.new_empty(self.n_rows)
        _launch("band_gather", self._ptrs, x, out, self.n_tiles, self.n_narrow,
                self.K, 1, x.size(0), 1, 0, 1, 0)
        return out

    def call_batched(self, tables: torch.Tensor) -> torch.Tensor:
        """(B, n) tables of any strides -> (B, n_rows) contiguous: K9b over
        narrow and wide tiles."""
        if self._check_table("call_batched", tables, batched=True) is None:
            return banded_gather_batched_plain(*self._narrow(), self.wide_cols,
                                               tables, self.K)
        B = tables.size(0)
        out = tables.new_empty((B, self.n_rows))
        ts_b, ts_r = tables.stride()
        _launch("band_gather_batched", self._ptrs, tables, out, self.n_tiles,
                self.n_narrow, self.K, B, tables.size(1), ts_r, ts_b, 1, self.n_rows)
        return out


class BandedRowSum:
    """A band gather followed by W2-wide row sums: the JAX split plans'
    stage 2 (``_split_stage2`` under ``AFEM_BAND_PRE=1``), which sums each
    row's W2 consecutive subrow ids.  The stream must be all narrow and W2
    must divide 128, so no row straddles a tile.  The sums run in float64
    and round to the table's dtype."""

    def __init__(self, band: BandedGather, W2: int, n_rows: int):
        if band.wide_cols is not None:
            raise ValueError("BandedRowSum: the stream must be all narrow")
        if LANE % W2:
            raise ValueError("BandedRowSum: W2 must divide 128")
        self.band = band
        self.W2 = W2
        self.n_rows = n_rows

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        y = self.band(table).double().reshape(-1, self.W2).sum(dim=1)
        return y[: self.n_rows].to(table.dtype)

    def call_batched(self, tables: torch.Tensor) -> torch.Tensor:
        y = self.band.call_batched(tables).double()
        y = y.reshape(tables.shape[0], -1, self.W2).sum(dim=2)
        return y[:, : self.n_rows].to(tables.dtype)
