"""ctypes binding to the port's host C++ library (topology and AMG set-up).

The port's copy of the entry points of ``arcanefem_tpu/utils/native.py``
that it calls: ``build_topology_native``, ``amg_strength_filter_native``
and ``amg_smooth_p_native``.  The sources are the port's own copies in
``arcanefem_tpu_torch/native/``.  ``g++`` builds them at first use into
``build/afem_native/`` at the repository root, under a name that carries a
hash of the sources and flags, for the host it runs on (no
``-march=native``, so a copied tree never loads a library built for
another CPU).  As in the JAX package, every entry point returns None when
the library cannot be built or loaded, and its callers keep their numpy
path where they have one.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "afem_native")

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_P = ctypes.c_void_p
_I64, _I32, _F64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
# (name, restype, argtypes) of the C entry points in native/
_SIGNATURES = {
    "afem_topo_build": (_P, [_I64, _I32, ctypes.POINTER(_P),
                             ctypes.POINTER(_I64), ctypes.POINTER(_I32), _I32]),
    "afem_topo_width": (_I32, [_P]),
    "afem_topo_nnz": (_I64, [_P]),
    "afem_topo_fill": (None, [_P] * 8),
    "afem_topo_free": (None, [_P]),
    "afem_amg_strength_filter": (_I64, [_I64, _P, _P, _P, _F64, _P, _P, _P, _P]),
    "afem_amg_smooth_p": (_I64, [_I64, _P, _P, _P, _P, _F64, _P, _I64, _I32,
                                 _F64, _I32, _P, _P, _P]),
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp")))


def library_path() -> str:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libafem_native_{h.hexdigest()[:16]}.so")


@functools.cache
def library() -> ctypes.CDLL | None:
    """The loaded library, built on first call; None if that fails."""
    out = library_path()
    if not os.path.exists(out):
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_sources()],
                              capture_output=True, timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def amg_strength_filter_native(indptr: np.ndarray, cols: np.ndarray,
                               data: np.ndarray, theta: float):
    """Fused strength graph + filtered operator (amg_setup.cpp).

    Returns (s_indptr i64, s_cols i32, af_data f64, ddf f64), or None when
    the library is unavailable or a row has no diagonal entry.  af_data has
    A's pattern with weak off-diagonals as exact zeros and their values
    lumped onto the diagonal entry."""
    lib = library()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    n = len(indptr) - 1
    nnz = len(cols)
    s_indptr = np.empty(n + 1, np.int64)
    s_cols = np.empty(nnz, np.int32)
    af_data = np.empty(nnz, np.float64)
    ddf = np.empty(n, np.float64)
    snnz = lib.afem_amg_strength_filter(
        n, _ptr(indptr), _ptr(cols), _ptr(data), theta, _ptr(s_indptr),
        _ptr(s_cols), _ptr(af_data), _ptr(ddf))
    if snnz < 0:
        return None
    return s_indptr, s_cols[:snnz].copy(), af_data, ddf


def amg_smooth_p_native(indptr: np.ndarray, cols: np.ndarray,
                        af_data: np.ndarray, ddf: np.ndarray, c: float,
                        agg: np.ndarray, na: int, kmax: int, rel: float,
                        rescale: bool):
    """Fused P = (I - c Dinv_f A_f) T + row truncation (amg_setup.cpp),
    scalar tentative T[i, agg[i]] = 1.  Returns (p_indptr i64, p_cols i32,
    p_data f64) or None."""
    lib = library()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    af_data = np.ascontiguousarray(af_data, np.float64)
    ddf = np.ascontiguousarray(ddf, np.float64)
    agg = np.ascontiguousarray(agg, np.int64)
    n = len(indptr) - 1
    cap = n * int(kmax)
    p_indptr = np.empty(n + 1, np.int64)
    p_cols = np.empty(cap, np.int32)
    p_data = np.empty(cap, np.float64)
    pnnz = lib.afem_amg_smooth_p(
        n, _ptr(indptr), _ptr(cols), _ptr(af_data), _ptr(ddf), c, _ptr(agg),
        na, kmax, rel, 1 if rescale else 0, _ptr(p_indptr), _ptr(p_cols),
        _ptr(p_data))
    return p_indptr, p_cols[:pnnz].copy(), p_data[:pnnz].copy()


def build_topology_native(n_nodes: int, buckets: dict, pad_width_to: int):
    """Native counterpart of ``sparse.topology.build_topology``: the same
    tuple of arrays, or None if the library is unavailable."""
    lib = library()
    if lib is None:
        return None
    names = list(buckets)
    conns = [np.ascontiguousarray(buckets[k], np.int32) for k in names]
    ptrs = (_P * len(conns))(*[_ptr(c) for c in conns])
    ncs = (_I64 * len(conns))(*[c.shape[0] for c in conns])
    npcs = (_I32 * len(conns))(*[c.shape[1] for c in conns])
    h = lib.afem_topo_build(n_nodes, len(conns), ptrs, ncs, npcs, pad_width_to)
    if not h:
        return None
    try:
        width = lib.afem_topo_width(h)
        nnz = lib.afem_topo_nnz(h)
        row_ptr = np.empty(n_nodes + 1, np.int64)
        csr_cols = np.empty(nnz, np.int32)
        csr_to_ell = np.empty(nnz, np.int32)
        diag_slot = np.empty(n_nodes, np.int32)
        ell_cols = np.empty((n_nodes, width), np.int32)
        ell_valid = np.empty((n_nodes, width), np.uint8)
        smaps = [np.empty((c.shape[0], c.shape[1], c.shape[1]), np.int32)
                 for c in conns]
        sm_ptrs = (_P * len(conns))(*[_ptr(m) for m in smaps])
        lib.afem_topo_fill(h, _ptr(row_ptr), _ptr(csr_cols), _ptr(csr_to_ell),
                           _ptr(diag_slot), _ptr(ell_cols), _ptr(ell_valid),
                           ctypes.cast(sm_ptrs, _P))
    finally:
        lib.afem_topo_free(h)
    return (width, row_ptr, csr_cols, csr_to_ell, diag_slot, ell_cols,
            ell_valid.astype(bool), dict(zip(names, smaps)))
