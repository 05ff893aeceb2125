"""Window gather probes on the card.

    python -m arcanefem_tpu_torch.tools.probe_gather [K] [G]

The counterpart of the JAX package's ``tools/probe_gather.py``, which asked
which in-VMEM gather forms Mosaic compiles on the TPU.  Over windows win
(nb, K, 128) float32 and indices (nb, G, 128) int32:

    window_take(win, idx, "column")   out[b,g,l] = win[b, idx[b,g,l], l]   (P1, P3)
    window_take(win, idx, "flat")     out[b,g,l] = win[b].flat[idx[b,g,l]] (P2)

On a CUDA tensor the hand-written kernel of ``csrc/window_gather.cu``
runs (``launch_counts()`` counts it): a window of K <= ``SMEM_MAX_K``
rows is staged in shared memory by one bulk asynchronous copy and every
take is served from there, as the TPU probes take from VMEM; a larger one
is read through L1/L2.  On a CPU tensor its plain twin runs.  Indices
outside the window give 0.

``probe_A`` (P1) and ``probe_B`` (P2) check one window (nb = 1) against
numpy's ``take_along_axis`` and flat indexing; ``bench_A`` (P3) times the
column take over nb = 256 windows with CUDA events, beside its plain twin
and the library call ``torch.gather``, and reports Gelem/s.  The script
runs both probes at (K, G) (default 160, 64) and ``bench_A`` at (K, G) and
(1024, G), as the JAX script does; it needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..utils import kernels, tracing

LANE = 128
MODES = {"column": 0, "flat": 1}
# the largest K whose (K, 128) float32 window the kernel stages in a block's
# shared memory (csrc/window_gather.cu); larger windows are read through L1/L2
SMEM_MAX_K = 448
_LAUNCHES = tracing.counters("window_take")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def window_take_plain(win: torch.Tensor, idx: torch.Tensor,
                      mode: str) -> torch.Tensor:
    """Plain twin of :func:`window_take`."""
    nb, K, _ = win.shape
    j = idx.long()
    if mode == "column":
        ok = (j >= 0) & (j < K)
        got = torch.gather(win, 1, torch.where(ok, j, 0))
    else:
        ok = (j >= 0) & (j < K * LANE)
        got = torch.gather(win.reshape(nb, K * LANE), 1,
                           torch.where(ok, j, 0).reshape(nb, -1)).reshape(j.shape)
    return torch.where(ok, got, 0.0)


def window_take(win: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """The column or flat take of each window (P1-P3 on the card).  The
    wrapper checks what the kernel needs (shapes, types, one device,
    contiguity), allocates the output and makes one ctypes call."""
    m = MODES.get(mode)
    if m is None:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    ws, xs = win.shape, idx.shape
    if len(ws) != 3 or len(xs) != 3 or ws[2] != LANE or xs[2] != LANE \
            or xs[0] != ws[0]:
        raise ValueError(f"window_take: win (nb, K, {LANE}) and idx (nb, G, "
                         f"{LANE}), got {tuple(ws)} and {tuple(xs)}")
    if win.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("window_take: win must be float32 and idx int32")
    dev = win.get_device()
    if idx.get_device() != dev:
        raise ValueError("window_take: operands lie on different devices")
    if dev < 0:
        if win.device.type != "cpu":
            raise ValueError(f"window_take: no kernel for device {win.device}")
        return window_take_plain(win, idx, mode)
    if not (win.is_contiguous() and idx.is_contiguous()):
        raise ValueError("window_take: the CUDA kernel takes contiguous operands")
    out = win.new_empty(xs)
    if ws[0] and xs[1]:
        kernels.launch("afem_window_take_f32", win.device, win.data_ptr(),
                       idx.data_ptr(), out.data_ptr(), ws[0], ws[1], xs[1], m)
        tracing.count("window_take")
    return out


def _inputs(nb: int, K: int, G: int, mode: str, device, seed: int = 0):
    rng = np.random.RandomState(seed)
    win = torch.as_tensor(rng.rand(nb, K, LANE).astype(np.float32), device=device)
    hi = K if mode == "column" else K * LANE
    idx = torch.as_tensor(rng.randint(0, hi, (nb, G, LANE)).astype(np.int32),
                          device=device)
    return win, idx


def probe_A(K: int, G: int, device) -> bool:
    """P1: the column take on one window equals numpy's take_along_axis."""
    win, hi = _inputs(1, K, G, "column", device)
    want = np.take_along_axis(win[0].cpu().numpy(), hi[0].cpu().numpy(), axis=0)
    return bool(np.array_equal(window_take(win, hi, "column")[0].cpu().numpy(), want))


def probe_B(K: int, G: int, device) -> bool:
    """P2: the flat take on one window equals numpy's flat indexing."""
    win, idx = _inputs(1, K, G, "flat", device)
    want = win[0].cpu().numpy().reshape(-1)[idx[0].cpu().numpy()]
    return bool(np.array_equal(window_take(win, idx, "flat")[0].cpu().numpy(), want))


def measure(mode: str, K: int, G: int, nb: int, reps: int = 20,
            outer: int = 3, device="cuda", calls: int = 2000) -> dict:
    """One take over nb windows on the card, checked against its plain
    twin and timed (CUDA events, best of ``outer`` × ``reps`` calls) beside
    the twin and the library call (``torch.gather`` for the column take,
    flat indexing for the flat take); the byte bound at 3.35 TB/s: 4 bytes
    of index and 4 of output per element, and the windows read once, or
    one 32-byte sector per element where that is less (a K = 1024 take
    touches a few percent of its window).  ``host_us`` is the host's cost
    per call (``tools/launch_cost.py``, ``calls`` back to back, best of 5
    blocks) and ``gather_host_us`` the same for ``torch.gather`` over the
    same windows and indices (on the flattened windows for the flat take);
    where the card is the slower side, both read its time instead."""
    from ..utils.timing import time_op
    from .launch_cost import host_us

    win, idx = _inputs(nb, K, G, mode, device)
    y, yp = window_take(win, idx, mode), window_take_plain(win, idx, mode)
    if mode == "column":
        lib, largs = torch.gather, (win, 1, idx.long())
    else:
        flat = (idx.long() + (torch.arange(nb, device=device) * K * LANE)[:, None, None])
        lib, largs = win.reshape(-1).__getitem__, (flat,)
    ms = time_op(window_take, win, idx, mode, reps=reps, outer=outer) * 1e3
    n_el = nb * G * LANE
    gwin, gidx = ((win, idx.long()) if mode == "column" else
                  (win.reshape(nb, -1), idx.reshape(nb, -1).long()))
    return {"mode": mode, "K": K, "G": G, "nb": nb, "equal": bool(torch.equal(y, yp)),
            "max_abs_err": float((y - yp).abs().max()), "ms": ms,
            "gelem_s": n_el / (ms * 1e-3) / 1e9,
            "plain_ms": time_op(window_take_plain, win, idx, mode, reps=reps,
                                outer=outer) * 1e3,
            "library_ms": time_op(lib, *largs, reps=reps, outer=outer) * 1e3,
            "host_us": host_us(lambda: window_take(win, idx, mode), calls),
            "gather_host_us": host_us(lambda: torch.gather(gwin, 1, gidx), calls),
            "bound_ms": (min(win.numel() * 4, n_el * 32) + n_el * 8) / 3.35e12 * 1e3}


def bench_A(K: int, G: int, nb: int = 256, device="cuda") -> dict:
    """P3: the column take over nb windows, timed (:func:`measure`)."""
    return measure("column", K, G, nb, device=device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    K = int(argv[0]) if len(argv) > 0 else 160
    G = int(argv[1]) if len(argv) > 1 else 64
    if not torch.cuda.is_available():
        raise RuntimeError("probe_gather measures a CUDA card; none is available")
    for name, fn in (("A column take", probe_A), ("B flat take", probe_B)):
        ok = fn(K, G, "cuda")
        print(f"{name}: K={K} G={G}: equal to numpy: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"probe {name} differs from numpy")
    for k in (K, 1024):
        print(json.dumps({"bench": "A", **bench_A(k, G)}), flush=True)


if __name__ == "__main__":
    main()
