"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface, which ``ctypes`` loads.  The library lands in
``build/afem_kernels/`` at the repository root, under a name that carries a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is reused.  Nothing is built at import time: the first
kernel launch calls :func:`library`.  There is no fallback: a missing
``nvcc`` or a failed build raises :class:`KernelBuildError` with the
compiler's output.

:func:`launch` is the one way the wrappers call a kernel, and it is kept
short, because many of the kernels run for a few microseconds and the
host's cost per launch sets the pace of the solver's coarse levels: each C
function is resolved once into a dict, the device is switched only when
the tensor's device is not the current one, and the current stream's raw
handle is read at each call (so a ``torch.cuda.stream`` context or a CUDA
graph capture is honoured) without building a ``Stream`` object.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "afem_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_P, _I, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_DIA_STENCIL = [_I, _P, _I64, _I64, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F64, _P]
_STENCIL_ASSEMBLY = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I64, _I64,
                     _F64, _F64, _P]
_ELL_GATHER_SUM = [_P, _P, _P, _I64, _I, _P]
# B, n_t (table rows), ts_r, ts_b, ys_r, ys_b, stream
_BATCHED_STRIDES = [_I, _I64, _I64, _I64, _I64, _I64, _P]
# vals, cols, slice_ptr, perm, x, y, n_rows, n_slices, stream
_SELL_SPMV = [_P, _P, _P, _P, _P, _P, _I64, _I64, _P]
# vals, cols, slice_ptr, perm, t, y, n_rows, n_slices, B, ts_r, ts_b, ys_r,
# ys_b, stream
_SELL_SPMV_BATCHED = _SELL_SPMV[:-1] + [_I, _I64, _I64, _I64, _I64, _P]
# bases, lcols, wide, t, out, n_tiles, n_narrow, K, B, n_t, ts_r, ts_b, os_r,
# os_b, stream
_BAND_GATHER = [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I64, _I64, _I64, _I64,
                _I64, _P]
# lo, c0, scnt, lcols, vals, x, y, n, W, qn, stream
_DIAG_SPMV = [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P]
_SLOT_REDUCE = [_P, _P, _P, _P, _I64, _P]  # ptr, ids, table, out, n_slots, stream
# ptr, ids, table, row_ptr, slice_ptr, perm, out, n_rows, n_slices,
# max_slots, b, stream
_BLOCK_SLOT_REDUCE = [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P]
_BSR8_SPMV = [_P, _P, _P, _P, _P, _I64, _I64, _P]  # blocks, bcol, bptr, x, y, n, n_sup, stream
# blocks, bcol, bptr, x, y, n_rows, n_cols, n_brows, stream
_BSR_SPMV = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P]
# (name, argtypes) of every C entry point in csrc/; all return an int
# cudaError_t from cudaGetLastError() after the launch
_SIGNATURES = {
    "afem_sell_spmv_f32": _SELL_SPMV,
    "afem_sell_spmv_f64": _SELL_SPMV,
    "afem_sell_spmv_bf16_f32": _SELL_SPMV,
    "afem_sell_spmv_batched_f32": _SELL_SPMV_BATCHED,
    "afem_sell_spmv_batched_f64": _SELL_SPMV_BATCHED,
    "afem_sell_spmv_batched_bf16_f32": _SELL_SPMV_BATCHED,
    "afem_ell_gather_sum_f32": _ELL_GATHER_SUM,
    "afem_ell_gather_sum_f64": _ELL_GATHER_SUM,
    "afem_ell_gather_sum_batched_f32": _ELL_GATHER_SUM[:-1] + _BATCHED_STRIDES,
    "afem_ell_gather_sum_batched_f64": _ELL_GATHER_SUM[:-1] + _BATCHED_STRIDES,
    "afem_dia_stencil_f32_f32": _DIA_STENCIL,
    "afem_dia_stencil_bf16_f32": _DIA_STENCIL,
    "afem_dia_stencil_f32_f64": _DIA_STENCIL,
    "afem_dia_stencil_f64_f64": _DIA_STENCIL,
    "afem_stencil_assembly_f32": _STENCIL_ASSEMBLY,
    "afem_stencil_assembly_f64": _STENCIL_ASSEMBLY,
    "afem_band_gather_f32": _BAND_GATHER,
    "afem_band_gather_f64": _BAND_GATHER,
    "afem_diag_spmv_f32": _DIAG_SPMV,
    "afem_diag_spmv_f64": _DIAG_SPMV,
    # win, idx, out, nb, K, G, mode, stream
    "afem_window_take_f32": [_P, _P, _P, _I64, _I, _I, _I, _P],
    # cols, cx, cy, cz, stride, ke, nc, stream
    "afem_tet_element_f32": [_P, _P, _P, _P, _I64, _P, _I64, _P],
    "afem_slot_reduce_f32": _SLOT_REDUCE,
    "afem_slot_reduce_f64": _SLOT_REDUCE,
    "afem_block_slot_reduce_f32": _BLOCK_SLOT_REDUCE,
    "afem_block_slot_reduce_f64": _BLOCK_SLOT_REDUCE,
    "afem_bsr8_spmv_f32": _BSR8_SPMV,
    "afem_bsr8_spmv_f64": _BSR8_SPMV,
    "afem_bsr8_spmv_bf16_f32": _BSR8_SPMV,
    **{f"afem_bsr_spmv_b{b}_{t}": _BSR_SPMV for b in (2, 4)
       for t in ("f32", "f64", "bf16_f32")},
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it failed to build or load the kernel library."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "are built from source on first use")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libafem_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it is already
    built (one nvcc per source, in parallel, then one link); return its
    path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in _sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
              for src, obj in zip(_sources(), objs)])
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tag}.tmp", *objs]])
    for obj in objs:
        os.remove(obj)
    os.replace(f"{tag}.tmp", out)  # atomic: a concurrent loader never sees half a file
    return out


_ENTRIES: dict = {}  # C entry point name -> its ctypes function
# the current device's index and f(device index) -> the current stream's
# raw handle, read without building a torch.cuda.Stream; bound when the
# library loads (a torch build without the private bindings gets the
# public calls)
_current_device = _current_stream = None


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; its entry points
    are resolved once, into ``_ENTRIES``."""
    global _current_device, _current_stream
    path = build()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    _current_device = (getattr(torch._C, "_cuda_getDevice", None)
                       or torch.cuda.current_device)
    _current_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
                       or (lambda idx: torch.cuda.current_stream(idx).cuda_stream))
    return lib


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn_name(*args, stream)`` on ``device``'s
    current stream; raise if it reports a CUDA error."""
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        library()
        fn = _ENTRIES[fn_name]
    idx = device.index
    if idx == _current_device():
        rc = fn(*args, _current_stream(idx))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _current_stream(_current_device()))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error {rc}")
