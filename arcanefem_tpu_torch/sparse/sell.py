"""Sliced ELL storage (SELL-32-σ), K1 (the weighted SpMV kernel) and K3b
(the same product over a stack of tables).

    sell_spmv(values, layout, x)    y[r] = sum over r's stored slots q of
                                           values[q] * x[layout.cols[q]]
    sell_spmv_batched(values, layout, T)
                                    Y[b, r] = the same over T[b], b < B <= 8

A :class:`SellLayout` is built once per column structure, on the host,
from an (N, W) ELL column array and the mask of its real slots (the
topology's ``ell_valid`` for the fine operator; a level's or a transfer's
non-zero values, the JAX rule that ``CompactMatrix.from_bell`` follows).
Rows may be sorted by their count of real slots inside windows of σ
consecutive rows; they are then cut into slices of C = 32 rows, one warp,
each padded only to its own longest row and stored slot-major: slot k of
the slice's 32 rows is 32 consecutive values and 32 consecutive int32
columns.  ``slice_ptr[s]`` is the first slot of slice s; the slot of real
entry k of the row at sorted position i is ``slice_ptr[i // 32] + 32·k +
i % 32``.  A slice's padding holds value 0 and an in-range column (its
row's last real column), so it adds nothing.

σ is chosen per operator from the host's stored-slot counts: 1 (no
permutation) unless sorting inside windows of ``SIGMA`` rows saves more
slot bytes (8 per slot: an f32 value and a column) than the permutation's
4 bytes per row cost.  ``describe()`` reports the choice and the stored
slots per nonzero.

The map back to the (N, W) form is kept on the host: ``src[q]`` is the flat
ELL slot of SELL slot q (for padding, the slot whose column it copies) and
``ell_to_sell`` the SELL slot of each ELL slot, -1 for dropped padding.
:meth:`SellLayout.to_ell` is the one way back to (N, W) values (a device
scatter), for readers off the timed path.

On a CUDA tensor :func:`sell_spmv` launches the hand-written kernel of
``csrc/sell_spmv.cu`` or raises; on a CPU tensor it runs the plain twin
below (an f64 product per slot, an ``index_add_`` onto rows, a cast),
which is also the kernel's test oracle.  Values are float32 or float64
with x of the same type, or bfloat16 with float32 x (the bf16 V-cycle
copies); every row sum accumulates in float64.  ``launch_counts()`` counts
the launches, bf16-weight ones apart as ``sell_spmv_bf16`` and the batched
form's as ``sell_spmv_batched``.

:func:`sell_spmv_batched` is the counterpart of the weighted
``PlannedGather.call_batched`` (K3b): the tables ``T`` are (B, n_cols) of
any strides (an (n_cols, B) row-major array is passed as ``a.T`` and read
in place) and the result is a new contiguous (B, n_rows) tensor, or is
written into a given ``out`` of any strides.  Table b's sum is K1's on
``T[b]``, in the same order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels, tracing

C = 32  # rows per slice: one warp
SIGMA = 1024  # the sorting window, where sorting pays
_SLOT_BYTES = 8  # an f32 value and an int32 column
_PERM_BYTES = 4  # one int32 row index per row

_ENTRY = {(torch.float32, torch.float32): "afem_sell_spmv_f32",
          (torch.float64, torch.float64): "afem_sell_spmv_f64",
          (torch.bfloat16, torch.float32): "afem_sell_spmv_bf16_f32"}
_BATCHED_ENTRY = {k: v.replace("sell_spmv", "sell_spmv_batched") for k, v in _ENTRY.items()}
MAX_TABLES = 8
_LAUNCHES = tracing.counters("sell_spmv", "sell_spmv_bf16", "sell_spmv_batched")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def slice_rows(lens: np.ndarray, sigma: int):
    """(perm or None, per-position lengths padded to whole slices, slice
    widths, slice_ptr) of rows with ``lens`` real slots; also the layout
    of ``sparse/blocked.py``'s 2×2-block slices."""
    n = lens.shape[0]
    perm = None
    if sigma > 1:
        perm = np.lexsort((-lens, np.arange(n) // sigma))  # stable
    ns = -(-n // C)
    plens = np.zeros(ns * C, np.int64)
    plens[:n] = lens if perm is None else lens[perm]
    width = plens.reshape(ns, C).max(axis=1)
    ptr = np.zeros(ns + 1, np.int64)
    np.cumsum(width * C, out=ptr[1:])
    return perm, plens, width, ptr


def stored_slots(lens: np.ndarray, sigma: int) -> int:
    """SELL-32-σ slots of rows with ``lens`` real slots."""
    return int(slice_rows(np.asarray(lens, np.int64), sigma)[3][-1])


def choose_sigma(lens: np.ndarray, slot_bytes: int = _SLOT_BYTES) -> int:
    """1, or SIGMA where sorting saves more slot bytes (``slot_bytes``
    each) than the permutation costs."""
    saved = stored_slots(lens, 1) - stored_slots(lens, SIGMA)
    return SIGMA if saved * slot_bytes > _PERM_BYTES * len(lens) else 1


class SellLayout:
    """The SELL-32-σ structure of one (N, W) ELL column array on one
    device: ``cols`` (n_slots,) int32, ``slice_ptr`` (n_slices+1,) int64
    and ``perm`` ((N,) int32 or None) there, and on the host ``ell_cols``,
    ``src``, ``real`` (n_slots,) bool, ``slice_width`` and ``sigma``.
    :meth:`to_arrays` and :meth:`from_arrays` carry a layout through a
    host cache; ``SellLayout.builds`` counts the calls of :meth:`build`."""

    builds = 0
    _FIELDS = ("ell_cols", "n_cols", "sigma", "src", "real", "slot_row",
               "slice_ptr", "slice_width", "perm", "cols")

    def __init__(self, ell_cols: np.ndarray, n_cols: int, sigma: int,
                 src: np.ndarray, real: np.ndarray, slot_row: np.ndarray,
                 slice_ptr: np.ndarray, slice_width: np.ndarray,
                 perm: np.ndarray | None, cols: torch.Tensor,
                 device: torch.device | str):
        self.ell_cols = ell_cols
        self.n_rows, self.width = ell_cols.shape
        self.n_cols = n_cols
        self.sigma = sigma
        self.src, self.real, self._slot_row = src, real, slot_row
        self._rows_on: dict = {}  # device -> slot_rows there
        self.slice_width = slice_width
        self.n_slots = int(slice_ptr[-1])
        self.n_slices = len(slice_width)
        self.nnz = int(real.sum())
        self.slice_ptr = torch.as_tensor(slice_ptr, device=device)
        self.perm = (None if perm is None else
                     torch.as_tensor(perm.astype(np.int32), device=device))
        self._set_cols(cols)

    def _set_cols(self, cols: torch.Tensor) -> None:
        """The device columns, and what the launch reads of the layout at
        each call, once: the shapes it takes, its device and pointers."""
        self.cols = cols
        self.device = cols.device
        self.device_index = cols.get_device()
        self.values_shape = torch.Size((self.n_slots,))
        self.x_shape = torch.Size((self.n_cols,))
        self.cols_ptr = cols.data_ptr()
        self.slice_ptr_ptr = self.slice_ptr.data_ptr()
        self.perm_ptr = None if self.perm is None else self.perm.data_ptr()

    @classmethod
    def build(cls, ell_cols: np.ndarray, real: np.ndarray, *,
              device: torch.device | str, n_cols: int | None = None,
              sigma: int | None = None) -> "SellLayout":
        """From host (N, W) ``ell_cols`` in [0, n_cols) (n_cols defaults to
        N) and the (N, W) mask ``real`` of the slots to keep; ``sigma``
        defaults to :func:`choose_sigma`."""
        SellLayout.builds += 1
        ell_cols = np.asarray(ell_cols)
        real = np.asarray(real, bool)
        if ell_cols.ndim != 2 or real.shape != ell_cols.shape:
            raise ValueError(f"SellLayout: cols {ell_cols.shape} and real "
                             f"{real.shape} must be the same (N, W)")
        n, W = ell_cols.shape
        n_cols = n if n_cols is None else int(n_cols)
        if ell_cols.size and (int(ell_cols.min()) < 0
                              or int(ell_cols.max()) >= n_cols):
            raise ValueError(f"SellLayout: column outside [0, {n_cols})")
        lens = real.sum(axis=1, dtype=np.int64)
        sigma = choose_sigma(lens) if sigma is None else int(sigma)
        if sigma < 1:
            raise ValueError(f"SellLayout: sigma must be >= 1, got {sigma}")
        perm, plens, width, ptr = slice_rows(lens, sigma)
        n_slots = int(ptr[-1])
        # every SELL slot q: its slice, lane, slot k, row position, row
        q = np.arange(n_slots, dtype=np.int64)
        s = np.repeat(np.arange(len(width), dtype=np.int64), width * C)
        off = q - ptr[s]
        pos = s * C + off % C
        k = off // C
        row = np.full(n_slots, n, np.int64)  # lanes past N: row N
        inside = pos < n
        row[inside] = pos[inside] if perm is None else perm[pos[inside]]
        keep = k < plens[pos]
        # ELL slot of each real entry: the k-th real slot of its row
        flat_nz = np.flatnonzero(real)
        start = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=start[1:])
        src = np.zeros(n_slots, np.int64)  # lanes past N copy slot 0
        src[keep] = flat_nz[start[row[keep]] + k[keep]]
        # padding copies its row's last real slot (slot 0 of an empty row)
        pad = ~keep & inside
        pr = row[pad]
        src[pad] = np.where(lens[pr] > 0,
                            flat_nz[np.maximum(start[pr + 1] - 1, 0)] if len(flat_nz)
                            else 0, pr * W)
        cols = torch.as_tensor(ell_cols.reshape(-1)[src].astype(np.int32),
                               device=device)
        return cls(ell_cols, n_cols, sigma, src, keep, row.astype(np.int32),
                   ptr, width.astype(np.int32), perm, cols, device)

    def to_arrays(self) -> dict[str, np.ndarray]:
        """The layout as host numpy arrays (``perm`` empty when σ = 1),
        which :meth:`from_arrays` takes back."""
        return {"ell_cols": self.ell_cols, "n_cols": np.int64(self.n_cols),
                "sigma": np.int64(self.sigma), "src": self.src,
                "real": self.real, "slot_row": self._slot_row,
                "slice_ptr": self.slice_ptr.cpu().numpy(),
                "slice_width": self.slice_width,
                "perm": (np.zeros(0, np.int32) if self.perm is None
                         else self.perm.cpu().numpy()),
                "cols": self.cols.cpu().numpy()}

    @classmethod
    def from_arrays(cls, arrays: dict, *, device: torch.device | str) -> "SellLayout":
        """The layout of :meth:`to_arrays`' ``arrays`` on ``device``: the
        arrays are moved, nothing is rebuilt."""
        missing = [k for k in cls._FIELDS if k not in arrays]
        if missing:
            raise KeyError(f"SellLayout.from_arrays: missing {missing}")
        a = arrays
        sigma = int(a["sigma"])
        ell_cols = np.asarray(a["ell_cols"])
        n_slots = int(a["slice_ptr"][-1])
        if (ell_cols.ndim != 2 or a["src"].shape != (n_slots,)
                or a["real"].shape != (n_slots,) or a["cols"].shape != (n_slots,)
                or a["slot_row"].shape != (n_slots,)
                or len(a["slice_width"]) + 1 != len(a["slice_ptr"])
                or (sigma > 1 and a["perm"].shape != (ell_cols.shape[0],))):
            raise ValueError("SellLayout.from_arrays: inconsistent array shapes")
        return cls(ell_cols, int(a["n_cols"]), sigma, a["src"], a["real"],
                   a["slot_row"], a["slice_ptr"], a["slice_width"],
                   a["perm"] if sigma > 1 else None,
                   torch.as_tensor(a["cols"], device=device), device)

    def with_cols(self, ell_cols: np.ndarray, n_cols: int) -> "SellLayout":
        """The same slices, permutation and slot map over another (N, W)
        column array in [0, n_cols) (the compact route's remap): every SELL
        slot takes the column of the ELL slot it stands for, padding its
        row's last."""
        ell_cols = np.asarray(ell_cols)
        if ell_cols.shape != self.ell_cols.shape:
            raise ValueError(f"with_cols: {ell_cols.shape}, expected "
                             f"{self.ell_cols.shape}")
        if ell_cols.size and (int(ell_cols.min()) < 0
                              or int(ell_cols.max()) >= n_cols):
            raise ValueError(f"with_cols: column outside [0, {n_cols})")
        out = object.__new__(SellLayout)
        out.__dict__.update(self.__dict__)
        out.ell_cols = ell_cols
        out.n_cols = int(n_cols)
        out._set_cols(torch.as_tensor(ell_cols.reshape(-1)[self.src].astype(np.int32),
                                      device=self.device))
        return out

    @functools.cached_property
    def ell_to_sell(self) -> np.ndarray:
        """(N·W,) int64: the SELL slot of each ELL slot, -1 where dropped."""
        e2s = np.full(self.n_rows * self.width, -1, np.int64)
        e2s[self.src[self.real]] = np.flatnonzero(self.real)
        return e2s

    def from_ell(self, values) -> torch.Tensor:
        """(n_slots,) SELL values of (N, W) values (numpy or a tensor, kept
        on its device; numpy lands on the layout's device); padding 0."""
        if isinstance(values, np.ndarray):
            flat = values.reshape(-1)[self.src]
            return torch.as_tensor(np.where(self.real, flat, 0).astype(flat.dtype),
                                   device=self.device)
        dev = values.device
        flat = values.reshape(-1)[torch.as_tensor(self.src, device=dev)]
        return torch.where(torch.as_tensor(self.real, device=dev), flat,
                           torch.zeros((), dtype=flat.dtype, device=dev))

    def to_ell(self, values: torch.Tensor) -> torch.Tensor:
        """(N, W) values of SELL ``values``, a scatter on their device;
        dropped slots 0."""
        e2s = torch.as_tensor(self.ell_to_sell, device=values.device)
        keep = e2s >= 0
        out = torch.zeros(e2s.shape, dtype=values.dtype, device=values.device)
        out[keep] = values[e2s[keep]]
        return out.reshape(self.n_rows, self.width)

    def slot_rows(self, device) -> torch.Tensor:
        """(n_slots,) int32 row of each slot (N for lanes past the last
        row), on ``device``; the plain twin's index."""
        key = str(torch.device(device))
        if key not in self._rows_on:
            self._rows_on[key] = torch.as_tensor(self._slot_row, device=device)
        return self._rows_on[key]

    def describe(self) -> dict:
        """σ, rows, nonzeros, stored slots and their ratio, the widest
        slice, and the device bytes of the index (columns, slice pointers,
        permutation): the ``[sell]`` line's fields."""
        perm = 0 if self.perm is None else 4 * self.n_rows
        return {"sigma": self.sigma, "rows": self.n_rows, "nnz": self.nnz,
                "slots": self.n_slots, "ell_slots": self.n_rows * self.width,
                "slots_per_nnz": self.n_slots / max(self.nnz, 1),
                "max_slice_width": int(self.slice_width.max(initial=0)),
                "index_bytes": 4 * self.n_slots + 8 * (self.n_slices + 1) + perm}


def sell_spmv_plain(values: torch.Tensor, layout: SellLayout,
                    x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`sell_spmv`."""
    prods = values.double() * x[layout.cols.to(x.device)].double()
    y = torch.zeros(layout.n_rows + 1, dtype=torch.float64, device=x.device)
    y.index_add_(0, layout.slot_rows(x.device), prods)
    return y[: layout.n_rows].to(x.dtype)


def sell_spmv(values: torch.Tensor, layout: SellLayout,
              x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for the SELL matrix (``values``, ``layout``) (K1 on the
    card)."""
    entry = _ENTRY.get((values.dtype, x.dtype))
    if entry is None:
        raise TypeError(f"sell_spmv: no kernel for values {values.dtype} "
                        f"and x {x.dtype}")
    if values.shape != layout.values_shape or x.shape != layout.x_shape:
        raise ValueError(f"sell_spmv: values {tuple(values.shape)} and x "
                         f"{tuple(x.shape)}, expected ({layout.n_slots},) and "
                         f"({layout.n_cols},)")
    dev = x.get_device()
    if values.get_device() != dev:
        raise ValueError("sell_spmv: values and x lie on different devices")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"sell_spmv: no kernel for device {x.device}")
        return sell_spmv_plain(values, layout, x)
    if layout.device_index != dev:
        raise ValueError(f"sell_spmv: x on {x.device}, the layout on {layout.device}")
    if not (values.is_contiguous() and x.is_contiguous()):
        raise ValueError("sell_spmv: the CUDA kernel takes contiguous values and x")
    y = x.new_empty(layout.n_rows)
    if layout.n_rows:
        kernels.launch(entry, layout.device, values.data_ptr(), layout.cols_ptr,
                       layout.slice_ptr_ptr, layout.perm_ptr, x.data_ptr(),
                       y.data_ptr(), layout.n_rows, layout.n_slices)
        tracing.count("sell_spmv_bf16" if values.dtype == torch.bfloat16
                      else "sell_spmv")
    return y


def sell_spmv_batched_plain(values: torch.Tensor, layout: SellLayout,
                            tables: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`sell_spmv_batched`, (B, n_rows) contiguous:
    :func:`sell_spmv_plain` of each table."""
    return torch.stack([sell_spmv_plain(values, layout, t) for t in tables])


def sell_spmv_batched(values: torch.Tensor, layout: SellLayout,
                      tables: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Y[b] = A @ T[b] for the SELL matrix (``values``, ``layout``) and
    (B, n_cols) tables ``T`` of any strides, 1 <= B <= 8 (K3b on the
    card)."""
    entry = _BATCHED_ENTRY.get((values.dtype, tables.dtype))
    if entry is None:
        raise TypeError(f"sell_spmv_batched: no kernel for values {values.dtype} "
                        f"and tables {tables.dtype}")
    if (values.shape != layout.values_shape or tables.dim() != 2
            or tables.shape[1] != layout.n_cols
            or not 1 <= tables.shape[0] <= MAX_TABLES):
        raise ValueError(f"sell_spmv_batched: values {tuple(values.shape)} and tables "
                         f"{tuple(tables.shape)}, expected ({layout.n_slots},) and "
                         f"(B, {layout.n_cols}) with 1 <= B <= {MAX_TABLES}")
    dev = tables.get_device()
    if values.get_device() != dev:
        raise ValueError("sell_spmv_batched: values and tables lie on different devices")
    B = tables.shape[0]
    if out is None:
        out = tables.new_empty((B, layout.n_rows))
    elif (out.shape != (B, layout.n_rows) or out.dtype != tables.dtype
          or out.get_device() != dev):
        raise ValueError(f"sell_spmv_batched: out must be ({B}, {layout.n_rows}) "
                         f"{tables.dtype} on {tables.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if not tables.is_cuda:
        if tables.device.type != "cpu":
            raise ValueError(f"sell_spmv_batched: no kernel for device {tables.device}")
        return out.copy_(sell_spmv_batched_plain(values, layout, tables))
    if layout.device_index != dev:
        raise ValueError(f"sell_spmv_batched: tables on {tables.device}, the layout "
                         f"on {layout.device}")
    if not values.is_contiguous():
        raise ValueError("sell_spmv_batched: the CUDA kernel takes contiguous values")
    if min(tables.stride()) < 0 or min(out.stride()) < 0:
        raise ValueError("sell_spmv_batched: negative table or output strides")
    if layout.n_rows:
        (ts_b, ts_r), (ys_b, ys_r) = tables.stride(), out.stride()
        kernels.launch(entry, layout.device, values.data_ptr(), layout.cols_ptr,
                       layout.slice_ptr_ptr, layout.perm_ptr, tables.data_ptr(),
                       out.data_ptr(), layout.n_rows, layout.n_slices, B,
                       ts_r, ts_b, ys_r, ys_b)
        tracing.count("sell_spmv_batched")
    return out
