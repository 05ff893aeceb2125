"""ELL gather-reduce: the one sparse kernel of the unstructured main path.

    ell_spmv(vals, cols, x)      y[r] = sum_w vals[r, w] * x[cols[r, w]]
    ell_gather_sum(cols, x)      y[r] = sum_w x[cols[r, w]]  (cols < 0 add 0)

``vals`` and ``cols`` are (n, W) row-major; ``cols`` is int32.  At W=1
``ell_gather_sum`` is the plain gather y[e] = x[cols[e]] (the assembly
coordinate fetch).  Padding of a BellMatrix row keeps its own row as the
column with value 0; padding of an AMG transfer row has column 0 and value
0; padding of a unit-weight gather has a negative column.

Inputs and outputs are float32 or float64; every row sum accumulates in
float64 (in the kernels and in the twins alike), which keeps the
cancellation error of Poisson rows out of the float32 CG recurrence.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/ell_gather.cu``, which replaces the Pallas window kernels of
``arcanefem_tpu/sparse/pallas_spmv.py``) or raises; on a CPU tensor it runs
the plain PyTorch twin below, which is also the kernel's test oracle.
Each wrapper counts its kernel launches in ``.launches``.

The wrappers check device, dtype, shape and contiguity, not the range of
``cols``: the constructors that build the column arrays on the host
(``BellMatrix.from_numpy``, ``amg_from_numpy``) check that once.
"""

from __future__ import annotations

import torch

from ..utils import kernels

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`ell_spmv`."""
    return (vals.double() * x[cols].double()).sum(dim=1).to(x.dtype)


def ell_gather_sum_plain(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`ell_gather_sum`."""
    g = x[cols.clamp(min=0)].double()
    return torch.where(cols >= 0, g, 0.0).sum(dim=1).to(x.dtype)


def _check(name: str, cols: torch.Tensor, x: torch.Tensor,
           vals: torch.Tensor | None = None) -> None:
    if cols.dim() != 2:
        raise ValueError(f"{name}: cols must be (n, W), got {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32, got {cols.dtype}")
    if x.dim() != 1:
        raise ValueError(f"{name}: x must be 1-D, got {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: x must be float32 or float64, got {x.dtype}")
    tensors = [cols, x]
    if vals is not None:
        if vals.shape != cols.shape:
            raise ValueError(f"{name}: vals {tuple(vals.shape)} and cols "
                             f"{tuple(cols.shape)} differ in shape")
        if vals.dtype != x.dtype:
            raise TypeError(f"{name}: vals {vals.dtype} and x {x.dtype} differ")
        tensors.append(vals)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: operands lie on different devices")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous operands")


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_w vals[r, w] * x[cols[r, w]] (K1 on the card)."""
    _check("ell_spmv", cols, x, vals)
    if x.device.type == "cpu":
        return ell_spmv_plain(vals, cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {x.device}")
    n, W = cols.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    kernels.launch(f"afem_ell_spmv_{_SUFFIX[x.dtype]}", x.device,
                   vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                   n, W)
    ell_spmv.launches += 1
    return y


def ell_gather_sum(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_w x[cols[r, w]], negative columns add 0 (K2 on the card)."""
    _check("ell_gather_sum", cols, x)
    if x.device.type == "cpu":
        return ell_gather_sum_plain(cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_gather_sum: no kernel for device {x.device}")
    n, W = cols.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    kernels.launch(f"afem_ell_gather_sum_{_SUFFIX[x.dtype]}", x.device,
                   cols.data_ptr(), x.data_ptr(), y.data_ptr(), n, W)
    ell_gather_sum.launches += 1
    return y


ell_spmv.launches = 0
ell_gather_sum.launches = 0
WRAPPERS = (ell_spmv, ell_gather_sum)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
