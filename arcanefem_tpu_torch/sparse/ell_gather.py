"""ELL gather-reduce: the gathers of the unstructured paths.

    ell_gather_sum(cols, x)      y[r] = sum_w x[cols[r, w]]  (cols < 0 add 0)
    ell_gather_sum_batched(cols, T)      Y[b, r] = sum_w T[b, cols[r, w]]

``vals`` and ``cols`` are (n, W) row-major; ``cols`` is int32.  At W=1
``ell_gather_sum`` is the plain gather y[e] = x[cols[e]] (the assembly
coordinate fetch).  Padding of a BellMatrix row keeps its own row as the
column with value 0; padding of an AMG transfer row has column 0 and value
0; padding of a unit-weight gather has a negative column.

The batched form applies one index array to B <= 8 tables at once: ``T`` is (B, n_t) and the result (B, n).  Both may have any
strides, so an (n_t, B) row-major array is passed as its transpose
``a.T`` and read in place; the result is a new contiguous (B, n) tensor,
or is written into a given ``out`` of any strides (``torch.empty((n, B)).T``
for an (n, B) row-major result).  It is the counterpart of the unit
``PlannedGather.call_batched`` (K3a).

Inputs and outputs are float32 or float64; every row sum accumulates in
float64 (in the kernels and in the twins alike), which keeps the
cancellation error of Poisson rows out of the float32 CG recurrence.

The weighted products, K1 and its batched form K3b, run on the sliced
layout of ``sparse/sell.py``; ``ell_spmv_plain`` and
``ell_spmv_batched_plain`` below stay as the definitions over an (n, W)
pair that the tests hold the SELL kernels to.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/ell_gather.cu``, which replaces the Pallas window kernels of
``arcanefem_tpu/sparse/pallas_spmv.py``) or raises; on a CPU tensor it runs
the plain PyTorch twin below, which is also the kernel's test oracle.
``launch_counts()`` counts the kernel launches by wrapper.

The wrappers check device, dtype, shape and contiguity, not the range of
``cols``: the host code that builds the column arrays
(``SellLayout.build``, ``TetraAssembler``, ``compact_columns``) checks
or constructs them in range once.
"""

from __future__ import annotations

import torch

from ..utils import kernels, tracing

_FLOATS = (torch.float32, torch.float64)
MAX_TABLES = 8
_ENTRY = {(name, dt): f"afem_{name}_{'f32' if dt == torch.float32 else 'f64'}"
          for name in ("ell_gather_sum", "ell_gather_sum_batched") for dt in _FLOATS}

_LAUNCHES = tracing.counters("ell_gather_sum", "ell_gather_sum_batched")


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_w vals[r, w] * x[cols[r, w]] over an (n, W) pair, summed
    in float64: the definition K1 (``sparse/sell.py``) is held to."""
    return (vals.double() * x[cols].double()).sum(dim=1).to(x.dtype)


def ell_gather_sum_plain(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`ell_gather_sum`."""
    g = x[cols.clamp(min=0)].double()
    return torch.where(cols >= 0, g, 0.0).sum(dim=1).to(x.dtype)


def ell_spmv_batched_plain(vals: torch.Tensor, cols: torch.Tensor,
                           tables: torch.Tensor) -> torch.Tensor:
    """Y[b, r] = sum_w vals[r, w] * T[b, cols[r, w]] over an (n, W) pair,
    (B, n) contiguous, summed in float64: the definition K3b
    (``sparse/sell.py::sell_spmv_batched``) is held to."""
    return (vals.double() * tables[:, cols].double()).sum(dim=2).to(tables.dtype)


def ell_gather_sum_batched_plain(cols: torch.Tensor,
                                 tables: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`ell_gather_sum_batched`, (B, n) contiguous."""
    g = tables[:, cols.clamp(min=0)].double()
    return torch.where(cols >= 0, g, 0.0).sum(dim=2).to(tables.dtype)


def _check(name: str, cols: torch.Tensor, x: torch.Tensor,
           batched: bool = False) -> bool:
    """Raise on an operand the kernel does not take; True for a CUDA x
    (launch the kernel), False for a CPU one (run the twin).  Each test is
    one attribute read, so that a call's host cost stays near a PyTorch
    op's."""
    if cols.dim() != 2:
        raise ValueError(f"{name}: cols must be (n, W), got {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32, got {cols.dtype}")
    if batched:
        if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_TABLES:
            raise ValueError(f"{name}: tables must be (B, n) with 1 <= B <= "
                             f"{MAX_TABLES}, got {tuple(x.shape)}")
    elif x.dim() != 1:
        raise ValueError(f"{name}: x must be 1-D, got {tuple(x.shape)}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"{name}: x must be float32 or float64, got {x.dtype}")
    if cols.get_device() != x.get_device():
        raise ValueError(f"{name}: operands lie on different devices")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"{name}: no kernel for device {x.device}")
        return False
    # the tables of a batched call may be strided; nothing else
    if not cols.is_contiguous() or not (batched or x.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                         "index and vector operands")
    if batched and min(x.stride()) < 0:
        raise ValueError(f"{name}: negative table strides")
    return True


def ell_gather_sum(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_w x[cols[r, w]], negative columns add 0 (K2 on the card)."""
    if not _check("ell_gather_sum", cols, x):
        return ell_gather_sum_plain(cols, x)
    n, W = cols.shape
    y = x.new_empty(n)
    if n == 0:
        return y
    kernels.launch(_ENTRY["ell_gather_sum", x.dtype], x.device,
                   cols.data_ptr(), x.data_ptr(), y.data_ptr(), n, W)
    tracing.count("ell_gather_sum")
    return y


def ell_gather_sum_batched(cols: torch.Tensor, tables: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Y[b, r] = sum_w T[b, cols[r, w]], negative columns add 0, for
    (B, n_t) tables ``T`` of any strides (K3a on the card)."""
    cuda = _check("ell_gather_sum_batched", cols, tables, batched=True)
    B, n = tables.shape[0], cols.shape[0]
    if out is None:
        y = tables.new_empty((B, n))
    elif out.shape != (B, n) or out.dtype != tables.dtype or out.device != tables.device:
        raise ValueError(f"ell_gather_sum_batched: out must be ({B}, {n}) "
                         f"{tables.dtype} on {tables.device}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    elif min(out.stride()) < 0:
        raise ValueError("ell_gather_sum_batched: negative output strides")
    else:
        y = out
    if not cuda:
        return y.copy_(ell_gather_sum_batched_plain(cols, tables))
    if n:
        W = cols.shape[1]
        (ts_b, ts_r), (ys_b, ys_r) = tables.stride(), y.stride()
        kernels.launch(_ENTRY["ell_gather_sum_batched", tables.dtype], tables.device,
                       cols.data_ptr(), tables.data_ptr(), y.data_ptr(), n, W,
                       tables.size(0), tables.size(1), ts_r, ts_b, ys_r, ys_b)
        tracing.count("ell_gather_sum_batched")
    return y

