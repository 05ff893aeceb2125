"""The unstructured Poisson main path, end to end, on one CUDA card.

    python -m arcanefem_tpu_torch.bench_unstructured --h 5 --refine 2

builds the system of ``bench.py::bench_unstructured`` (the reference's
north-star problem): −Δu = 1 with P1 tetrahedra on the in-repo sphere_cut
mesh, reverse Cuthill-McKee then supernode-brick node order, BELL
assembly, penalty Dirichlet (Cut = 0, sphere = 1), and CG with compensated
dots preconditioned by a smoothed-aggregation AMG V-cycle (theta 0.03,
degree-2 Chebyshev smoother) to rtol 1e-8.  It prints one JSON line with
``bench.py``'s field names.  The flags ``--spmv {ell,supernode,compact,diag}``,
``--sn-block``, ``--sn-bf16``, ``--vcycle-bf16``, ``--asm-coords``,
``--asm-compact``, ``--band-pre``, ``--order``, ``--smoother``, ``--cheb-deg``
and ``--cycle`` select the routes of ``bench.py``'s knobs (see
:func:`solve_sphere_cut`).  ``--h 6 --refine 3`` is the 8.9M-DoF
north-star size, whose host set-up on a cold cache takes minutes;
``--prime`` builds and caches only that set-up, timed per stage.

The mesh and topology are cached as host numpy under
``utils.cache.CACHE_DIR``, in the same files ``bench.py`` uses; the fine
operator's SELL layout and the AMG hierarchy (with its levels' and
transfers' SELL layouts) beside them, checked against digests of their
inputs (``BENCH_NO_CACHE=1`` skips these two).  Assembly and solve are
timed with CUDA events; the AMG set-up (or its load) runs on the host and
is timed with the host clock.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .mesh.core import Mesh
from .mesh.unstructured import refine_tetra, sphere_cut_tetra_mesh
from .ops.lane_assembly import REDUCES, TetraAssembler
from .solver.amg import (
    amg_cached,
    with_bf16_vcycle,
    with_compact_vcycle,
    with_supernode_smoother,
)
from .solver.amg_setup import amg_setup, native_amg
from .solver.iterative import pcg
from .sparse.bell import BellMatrix, fine_layout
from .sparse.compact import CompactMatrix
from .sparse.diag_spmv import DiagEllMatrix
from .sparse.ordering import supernode_order
from .sparse.sell import SellLayout
from .sparse.supernode import SupernodeMatrix, SupernodeSpmv
from .sparse.topology import Topology, build_topology
from .utils.cache import CACHE_DIR, cache_enabled, digest, load_npz, save_npz
from .utils.ordering import rcm_order, renumber_mesh
from .utils.timing import time_op

RTOL = 1e-8
THETA = 0.03
CHEB_DEG = 2
PENALTY = 1e12  # the bench's Dirichlet penalty and dtype, as JAX's accelerator run
DTYPE = torch.float32

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _save_mesh(path: str, mesh: Mesh) -> None:
    np.savez(path, coords=mesh.coords, uids=mesh.node_uids,
             tets=mesh.cells["tetra4"],
             cut=mesh.face_groups["Cut"]["tria3"],
             sphere=mesh.face_groups["sphere"]["tria3"])


def _load_mesh(path: str) -> Mesh:
    z = np.load(path)
    return Mesh(coords=z["coords"], node_uids=z["uids"],
                cells={"tetra4": z["tets"]}, dim=3,
                face_groups={"Cut": {"tria3": z["cut"]},
                             "sphere": {"tria3": z["sphere"]}})


def _topology(mesh: Mesh, path: str | None) -> Topology:
    if path and os.path.exists(path):
        z = np.load(path)
        return Topology(
            n_nodes=int(z["n_nodes"]), width=int(z["width"]),
            ell_cols=z["ell_cols"], ell_valid=z["ell_valid"],
            row_ptr=z["row_ptr"], csr_cols=z["csr_cols"],
            csr_to_ell=z["csr_to_ell"], diag_slot=z["diag_slot"],
            slot_maps={"tetra4": z["slot_tetra4"]})
    topo = build_topology(mesh.n_nodes, mesh.cells)
    if path:
        np.savez(path, n_nodes=topo.n_nodes, width=topo.width,
                 ell_cols=topo.ell_cols, ell_valid=topo.ell_valid,
                 row_ptr=topo.row_ptr, csr_cols=topo.csr_cols,
                 csr_to_ell=topo.csr_to_ell, diag_slot=topo.diag_slot,
                 slot_tetra4=topo.slot_maps["tetra4"])
    return topo


ORDERS = ("sn", "rcm")


def mesh_key(h: float, refine: int, order: str = "sn") -> str:
    """The cache key of the sphere_cut system in ``order``, as
    ``bench.py`` forms it."""
    return f"sphere_cut_v3_h{h:g}_r{refine}" + ("_sn" if order == "sn" else "")


def mesh_files(key: str, order: str, cache_dir: str) -> dict[str, str]:
    """The npz files under ``cache_dir`` that :func:`sphere_cut_system` reads
    for the sphere of RCM key ``key`` (``mesh_key(h, refine, "rcm")``) in
    ``order`` once they exist: {"mesh": ..., "topology": ...}, in
    ``bench.py``'s file names."""
    sn = order == "sn"
    return {"mesh": os.path.join(cache_dir, f"{key}_snmesh.npz" if sn else f"{key}.npz"),
            "topology": os.path.join(cache_dir, f"topo_{key}{'_sn' if sn else ''}.npz")}


def sphere_cut_system(h: float, refine: int, cache: bool = True,
                      order: str = "sn") -> tuple[Mesh, Topology]:
    """The sphere_cut mesh in supernode order, and its topology.

    Order as ``bench.py``: Delaunay mesh, ``refine`` red refinements, RCM,
    then supernode bricks; ``order="rcm"`` stops before the bricks
    (``BENCH_UNSTR_ORDER=rcm``).  With ``cache`` each stage is kept as an
    npz under CACHE_DIR, in ``bench.py``'s file names."""
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
    key = mesh_key(h, refine, "rcm")
    files = {o: mesh_files(key, o, CACHE_DIR) if cache
             else {"mesh": None, "topology": None} for o in ORDERS}
    sn_path, rcm_path = files["sn"]["mesh"], files["rcm"]["mesh"]
    if order == "sn" and sn_path and os.path.exists(sn_path):
        mesh = _load_mesh(sn_path)
        return mesh, _topology(mesh, files["sn"]["topology"])
    if rcm_path and os.path.exists(rcm_path):
        mesh = _load_mesh(rcm_path)
    else:
        mesh = sphere_cut_tetra_mesh(h=h)
        for _ in range(refine):
            mesh = refine_tetra(mesh)
        topo = build_topology(mesh.n_nodes, mesh.cells)
        mesh = renumber_mesh(
            mesh, rcm_order(mesh.n_nodes, topo.row_ptr, topo.csr_cols))
        if rcm_path:
            _save_mesh(rcm_path, mesh)
    topo = _topology(mesh, files["rcm"]["topology"])
    if order == "rcm":
        return mesh, topo
    mesh = renumber_mesh(mesh, supernode_order(topo, mesh.coords))
    if sn_path:
        _save_mesh(sn_path, mesh)
    return mesh, _topology(mesh, files["sn"]["topology"])


def dirichlet_data(mesh: Mesh, penalty: float):
    """Host numpy (mask, g, rhs): Dirichlet rows (Cut and sphere faces),
    their values (sphere = 1), and the load vector of f = 1 with the
    penalty rows' entries set to penalty·g."""
    n = mesh.n_nodes
    cut = np.unique(mesh.face_groups["Cut"]["tria3"])
    sph = np.unique(mesh.face_groups["sphere"]["tria3"])
    mask = np.zeros(n, bool)
    mask[cut] = True
    mask[sph] = True
    g = np.zeros(n, np.float64)
    g[sph] = 1.0
    tets = mesh.cells["tetra4"]
    pc = mesh.coords[tets]
    vv = pc[:, 1:] - pc[:, :1]
    vols = np.abs(np.einsum("ij,ij->i", np.cross(vv[:, 0], vv[:, 1]),
                            vv[:, 2])) / 6.0
    rhs = np.zeros(n, np.float64)
    np.add.at(rhs, np.asarray(tets).reshape(-1), np.repeat(vols / 4.0, 4))
    return mask, g, np.where(mask, penalty * g, rhs)


def true_residual(A: BellMatrix, b: torch.Tensor, x: torch.Tensor,
                  interior: torch.Tensor) -> float:
    """‖(b − A x)_int‖ / ‖b_int‖ in float64 over the non-Dirichlet rows."""
    r = b.double() - A.with_values(A.values.double()).spmv(x.double())
    return float(torch.linalg.vector_norm(r[interior])
                 / torch.linalg.vector_norm(b.double()[interior]))


def sell_cache_key(cache: str) -> tuple[str, dict]:
    """(path, key fields of the meta record) of the fine SELL layout's
    cache file under the prefix ``cache``."""
    d, key = os.path.split(cache)
    return os.path.join(d, f"sell_{key}_v1.npz"), {"what": "fine SELL layout"}


def cached_fine_layout(topo: Topology, device, cache: str | None) -> SellLayout:
    """:func:`fine_layout`, kept under the cache prefix ``cache`` (see
    :func:`solve_sphere_cut`) when it is not None."""
    if not cache:
        return fine_layout(topo, device)
    path, meta = sell_cache_key(cache)
    meta.update(cols=digest(topo.ell_cols), valid=digest(topo.ell_valid))
    arrays = load_npz(path, meta, "fine SELL layout")
    if arrays is not None:
        return SellLayout.from_arrays(arrays, device=device)
    layout = fine_layout(topo, device)
    save_npz(path, layout.to_arrays(), meta)
    return layout


def amg_cache_key(cache: str, *, smoother: str, cheb_deg, penalty: float, device,
                  dtype: torch.dtype, theta: float = THETA,
                  env=os.environ) -> tuple[str, dict]:
    """(path, key fields of the meta record) of the AMG hierarchy's cache
    file under the prefix ``cache``: named as ``bench.py`` names its pickle
    (mesh, smoother, Chebyshev degree, build theta, platform, penalty) plus
    the dtype.  The name ignores ``AFEM_NATIVE_AMG`` as JAX's does; with
    ``AFEM_NATIVE_AMG=0`` in ``env`` the record holds ``"amg_setup":
    "scipy"``, so a hierarchy of one set-up branch is never loaded for the
    other."""
    d, key = os.path.split(cache)
    platform = torch.device(device).type
    dt = str(dtype).removeprefix("torch.")
    name = (f"amg_{key}_{smoother}{str(cheb_deg).replace(' ', '')}"
            f"_t{theta:g}_{platform}_p{penalty:g}_{dt}_v1.npz")
    meta = {"what": "AMG hierarchy", "mesh": key, "smoother": smoother,
            "cheb_deg": cheb_deg, "theta": theta, "platform": platform,
            "penalty": penalty, "dtype": dt}
    if not native_amg(env):
        meta["amg_setup"] = "scipy"
    return os.path.join(d, name), meta


def amg_cache_entry(cache: str, topo: Topology, flat: np.ndarray, **key) -> tuple[str, dict]:
    """(path, meta) of the AMG hierarchy's cache file: :func:`amg_cache_key`
    of ``key``, checked against the digests of the column structure and of
    the penalised values ``flat`` that ``amg_setup`` reads."""
    path, meta = amg_cache_key(cache, **key)
    meta.update(cols=digest(topo.ell_cols), values=digest(flat))
    return path, meta


SPMV_PATHS = ("ell", "supernode", "compact", "diag")
ASM_COORDS = ("split", "batched")


def _check_options(spmv, sn_block, sn_bf16, vcycle_bf16, asm_coords,
                   asm_compact, band_pre, order, smoother, cycle,
                   asm_reduce="window") -> None:
    """Raise for unknown values and for combinations the JAX bench never
    runs."""
    if spmv not in SPMV_PATHS:
        raise ValueError(f"spmv must be one of {SPMV_PATHS}, got {spmv!r}")
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    if sn_bf16 and spmv != "supernode":
        raise ValueError("sn_bf16 casts the supernode fine level: it needs "
                         "spmv='supernode'")
    if order == "rcm" and (spmv == "supernode" or sn_block):
        raise ValueError("the supernode operator and smoother need the "
                         "supernode order (bench.py forces it)")
    if spmv in ("compact", "diag") and sn_block:
        raise ValueError(f"spmv={spmv!r} does not go with the supernode "
                         "smoother: bench.py never combines them")
    if band_pre and not (spmv == "compact" or asm_compact):
        raise ValueError("band_pre bands the compact pre-gathers: it needs "
                         "spmv='compact' or asm_compact")
    if asm_reduce not in REDUCES:
        raise ValueError(f"asm_reduce must be one of {REDUCES}, got {asm_reduce!r}")
    if asm_coords not in ASM_COORDS:
        raise ValueError(f"asm_coords must be one of {ASM_COORDS}, got "
                         f"{asm_coords!r}")
    if smoother not in ("chebyshev", "jacobi"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if cycle not in ("V", "W"):
        raise ValueError(f"unknown cycle {cycle!r}")


def operator_self_check(op, A: BellMatrix) -> float:
    """max over rows of |op(x) − A x| / Σ_w |a·x| for a unit-scale random x
    (RandomState(0)), ``op`` a callable x -> y.  A unit-scale x keeps the
    1e12 penalty rows from hiding interior rows; the row scale holds each
    row to its own cancellation."""
    x = torch.as_tensor(np.random.RandomState(0).rand(A.n_nodes),
                        device=A.values.device).to(A.values.dtype)
    want = A.spmv(x).double()
    scale = A.with_values(A.values.abs()).spmv(x).double()
    err = (op(x).double() - want).abs() / scale.clamp(
        min=torch.finfo(torch.float64).tiny)
    return float(err.max())


def solve_sphere_cut(mesh: Mesh, topo: Topology, *, device, dtype,
                     penalty: float, plain: bool = False, timed: bool = False,
                     spmv: str = "ell", sn_block: bool = False,
                     sn_bf16: bool = False, vcycle_bf16: bool = False,
                     asm_coords: str = "split", asm_compact: bool = False,
                     band_pre: bool = False, asm_reduce: str = "window",
                     order: str = "sn", smoother: str = "chebyshev",
                     cheb_deg: int | tuple = CHEB_DEG, cycle: str = "V",
                     theta: float = THETA, cheb_apply: int | tuple | None = None,
                     rtol: float = RTOL, cache: str | None = None,
                     system: dict | None = None) -> dict:
    """Assemble, set up AMG and solve on ``device``.

    Returns the operator ``A`` (the BellMatrix), the CG operator ``op``
    of the route and the preconditioner ``M`` it ran, the solution ``x`` (device
    tensor), ``iterations``, the monitored ``rel`` residual, the float64
    ``true_residual``, the AMG ``levels``, ``spmv_path``, ``sell`` (the
    SELL layout of each operator K1 runs on, ``SellLayout.describe``),
    ``amg_setup_s`` (host clock: the set-up, or the cache's digest and
    load, and ``amg_from_numpy``), ``amg_setup_cached`` and, with
    ``timed``, ``assembly_s`` and ``solve_s`` (CUDA events).  ``plain=True``
    runs every kernel's plain twin instead of the kernel.  CG stops at
    ``rtol``.

    ``cache``: the system's cache prefix, ``os.path.join(CACHE_DIR,
    mesh_key(...))``, or None.  The fine operator's SELL layout and the AMG
    hierarchy (with its levels' and transfers' layouts) are then kept in
    npz files beside it (``sell_<key>_v1.npz``, ``amg_<key>_<smoother>
    <degree>_t<theta>_<platform>_p<penalty>_<dtype>_v1.npz``) and loaded,
    instead of built, when the digests of the column structure (and of the
    penalised values ``amg_setup`` reads) match; any mismatch or unreadable
    file rebuilds and rewrites it (``utils/cache.py``).

    The options are ``bench.py``'s knobs of the same names: ``spmv`` the
    CG operator and AMG fine level ("ell"; "supernode" for 8x8 supernode
    blocks, ``BENCH_UNSTR_SPMV``; "compact" for the compact two-stage SpMV
    on the CG operator and on the V-cycle's levels and transfers of at
    least 1500 rows, ``AFEM_SPMV=compact``; "diag" for the slot-major SpMV
    on the CG operator, ``AFEM_SPMV=diag``); ``sn_block`` supernode
    block-Jacobi as the fine smoother (``BENCH_SN_BLOCK``; with the ELL
    operator too); ``sn_bf16`` bfloat16 blocks on the V-cycle's supernode
    fine level (``BENCH_SN_BF16``); ``vcycle_bf16`` bfloat16 weights on
    the V-cycle's larger levels and transfers (``BENCH_UNSTR_BF16``);
    ``asm_coords`` the assembly's coordinate gather (``AFEM_ASM_COORDS``);
    ``asm_compact`` that gather through the compact two-stage gather
    (``AFEM_ASM_COMPACT=1``); ``band_pre`` the banded pre-gather of every
    compact gather (``AFEM_BAND_PRE=1``); ``asm_reduce`` the order of the
    assembly's contributor lists (``AFEM_UNSTR_ASM``: "window", "segsum" or
    "reorder", ``TetraAssembler``'s ``reduce``); ``order`` the node order ``mesh``
    and ``topo`` come in ("sn" or "rcm", ``BENCH_UNSTR_ORDER``: only
    checked against the other options here); ``smoother``, ``cheb_deg``
    (an int or per-level tuple) and ``cycle`` (``BENCH_AMG_SMOOTHER``,
    ``BENCH_AMG_CHEB_DEG``, ``BENCH_AMG_CYCLE``); ``theta`` the AMG set-up's
    strength threshold (``BENCH_AMG_THETA``, part of the cache key);
    ``cheb_apply`` a Chebyshev degree applied to the hierarchy built (or
    cached) at ``cheb_deg``, which stays its cache key
    (``BENCH_AMG_CHEB_APPLY``; the hierarchy does not depend on the
    degree).  Unlike ``bench.py``
    nothing falls back: a failed supernode, compact or diag self-check
    (:func:`operator_self_check` above 1e-5) raises, and so do
    ``spmv="diag"`` where the diagonal plan declines and ``band_pre`` where
    the banded plan declines the CG operator's or the coordinates' pre
    stream (the V-cycle's levels and transfers band where the plan builds,
    as in the JAX package; ``vcycle_band`` counts them).

    ``system``: the ``system`` entry of an earlier result on the same mesh,
    device, dtype and ``plain``.  Its AMG hierarchy is reused instead of
    set up again and, unless the coordinate gather differs from the one
    that built it, its operator too (``amg_setup_s`` and ``assembly_s`` are
    then those of the earlier run), and the supernode blocks and compact
    gathers of its column structure once built (``sn_setup_s`` then times
    the smoother alone, ``compact_setup_s`` the self-check alone)."""
    _check_options(spmv, sn_block, sn_bf16, vcycle_bf16, asm_coords,
                   asm_compact, band_pre, order, smoother, cycle, asm_reduce)
    out = {}
    if system is not None and (system["device"], system["dtype"], system["plain"],
                               system["theta"]) \
            != (torch.device(device), dtype, plain, theta):
        raise ValueError("system was built for another device, dtype, plain "
                         "or theta")
    asm_key = (asm_coords, asm_compact, band_pre and asm_compact, asm_reduce)
    if system is None or asm_key != system["asm_key"]:
        # one SELL layout per column structure: the assembly writes into it
        layout = (cached_fine_layout(topo, device, cache) if system is None
                  else system["A"].layout)
        asm = TetraAssembler(topo, mesh.cells["tetra4"], device=device,
                             plain=plain,
                             coords_batched=asm_coords == "batched",
                             coords_compact=asm_compact,
                             band_pre=band_pre and asm_compact, layout=layout,
                             reduce=asm_reduce)
        coords = torch.as_tensor(mesh.coords, device=device).to(torch.float32)
        vals = asm(coords)
        if timed:
            out["assembly_s"] = time_op(asm, coords, reps=3, outer=2)
        if band_pre and asm_compact and not asm.compact.band:
            raise RuntimeError("band_pre: the banded plan declines the "
                               "coordinate gather's pre stream")
        # its lists are dead now: on the card's default route the patch
        # lists (~2 bytes per contributor, 8 per cell computed), else the
        # contributor lists (16 int32 per cell)
        del asm

        mask, g, rhs = dirichlet_data(mesh, penalty)
        # penalty rows after the cast to the solve's dtype, so the matrix and
        # the rhs carry the same penalty value
        diag = torch.as_tensor(
            layout.ell_to_sell[np.asarray(topo.diag_slot, np.int64)], device=device)
        vals = vals.to(dtype)
        vals[diag[torch.as_tensor(mask, device=device)]] = penalty
        A = BellMatrix(vals, layout, diag, plain=plain)
        del vals
        b = torch.as_tensor(rhs, device=device).to(dtype)
        x0 = torch.as_tensor(np.where(mask, g, 0.0), device=device).to(dtype)
        interior = torch.as_tensor(~mask, device=device)
    else:
        A, b, x0, interior = (system[k] for k in ("A", "b", "x0", "interior"))
        if "assembly_s" in system:
            out["assembly_s"] = system["assembly_s"]
    if system is None:
        flat = A.ell_values().cpu().numpy()  # the AMG set-up's host copy
        t0 = time.perf_counter()
        path = meta = None
        if cache:
            path, meta = amg_cache_entry(cache, topo, flat, smoother=smoother,
                                         cheb_deg=cheb_deg, penalty=penalty,
                                         device=device, dtype=dtype, theta=theta)
        M0, cached = amg_cached(
            path, meta, lambda: amg_setup(flat, topo, theta=theta,
                                          smoother=smoother, cheb_deg=cheb_deg,
                                          dtype=_NP_DTYPE[dtype]),
            device, dtype, plain=plain)
        del flat
        system = {"device": torch.device(device), "dtype": dtype,
                  "plain": plain, "theta": theta, "asm_key": asm_key, "A": A, "b": b,
                  "x0": x0, "interior": interior, "M": M0,
                  "amg_setup_s": time.perf_counter() - t0,
                  "amg_setup_cached": cached,
                  **({"assembly_s": out["assembly_s"]} if timed else {})}
    out["amg_setup_s"] = system["amg_setup_s"]
    out["amg_setup_cached"] = system["amg_setup_cached"]
    deg = cheb_deg if cheb_apply is None else cheb_apply
    M = system["M"].replace(smoother=smoother, cheb_deg=deg, cycle=cycle)
    out["levels"] = [m.n_nodes for m in M.mats] + [M.coarse_inv.shape[0]]
    own = system["A"] is A  # structures built on A are kept for later runs

    Aop = A
    if spmv == "supernode" or sn_block:
        t0 = time.perf_counter()
        sn = system.get("sn") if own else None
        if sn is None:
            sn = SupernodeSpmv.build(A, topo)
            if own:
                system["sn"] = sn
        if spmv == "supernode":
            out["sn_check"] = operator_self_check(sn, A)
            if not out["sn_check"] <= 1e-5:
                raise RuntimeError(
                    f"supernode SpMV self-check failed: {out['sn_check']:.3e} "
                    "of the row scale > 1e-5")
            Aop = SupernodeMatrix(sn, A.diagonal())
            # the V-cycle's fine level too, optionally in bf16 blocks
            vsn = sn.as_bf16() if sn_bf16 else sn
            M = M.replace(mats=(SupernodeMatrix(vsn, A.diagonal()),) + M.mats[1:])
        if sn_block:
            M = with_supernode_smoother(M, A, sn)
        out["sn_setup_s"] = time.perf_counter() - t0
        out["sn_blocks"] = int(sn.blocks.shape[0])
        out["sn_bytes"] = sn.nbytes
    elif spmv == "compact":
        t0 = time.perf_counter()
        key = ("compact", band_pre)
        if key not in system:
            # one host build per column structure, kept with the hierarchy:
            # the CG operator's compact form is also the V-cycle's fine
            # level (the same operator as mats[0])
            cm0 = CompactMatrix.from_bell(system["A"], band_pre=band_pre,
                                          real=np.asarray(topo.ell_valid))
            same = np.array_equal(M.mats[0].layout.ell_cols, A.layout.ell_cols)
            system[key] = (cm0, with_compact_vcycle(
                system["M"], band_pre, l0=cm0 if same else None))
        cm0, Mc = system[key]
        cm = cm0.with_values(A.values)
        M = Mc.replace(smoother=smoother, cheb_deg=deg, cycle=cycle)
        out["compact_check"] = operator_self_check(cm.spmv, A)
        if not out["compact_check"] <= 1e-5:
            raise RuntimeError(
                f"compact SpMV self-check failed: {out['compact_check']:.3e} "
                "of the row scale > 1e-5")
        if band_pre and not cm.band:
            raise RuntimeError("band_pre: the banded plan declines the CG "
                               "operator's pre stream")
        Aop = cm
        ops = [op for op in M.vmats + M.p_apply + M.pt_apply if op is not None]
        out["vcycle_compact"] = len(ops)
        out["vcycle_band"] = sum(op.band for op in ops)
        out["compact_setup_s"] = time.perf_counter() - t0
    elif spmv == "diag":
        t0 = time.perf_counter()
        Aop = DiagEllMatrix(A.ell_values(), topo.ell_cols, torch.as_tensor(
            np.asarray(topo.diag_slot, np.int64), device=device), plain=plain)
        out["diag_setup_s"] = time.perf_counter() - t0
        out["diag_check"] = operator_self_check(Aop.spmv, A)
        if not out["diag_check"] <= 1e-5:
            raise RuntimeError(
                f"diag SpMV self-check failed: {out['diag_check']:.3e} of the "
                "row scale > 1e-5")
    if vcycle_bf16:
        M = with_bf16_vcycle(M)

    x, iters, rel = pcg(Aop, b, M, x0, rtol, 0.0, 1000, use_precise_dot=True)
    if timed:
        out["solve_s"] = time_op(
            pcg, Aop, b, M, x0, rtol, 0.0, 1000, True, reps=1, outer=2)
    out.update(A=A, op=Aop, M=M, x=x, iterations=iters, rel=rel,
               true_residual=true_residual(A, b, x, interior),
               spmv_path=type(Aop).__name__, system=system,
               sell=sell_layouts(Aop, M))
    return out


def sell_layouts(Aop, M) -> list[dict]:
    """``describe()`` of the SELL layout of the CG operator and of each
    level and transfer of M that K1 runs on, each with its ``op`` name."""
    def layout(op):
        op = getattr(op, "op", op)  # a CompactMatrix's SELL operator
        return getattr(op, "layout", None)

    named = [("A", Aop)] + [(f"L{l}", M._mat(l)) for l in range(len(M.mats))]
    for l in range(len(M.P)):
        named += [(f"P{l}", M.p_apply[l] if l < len(M.p_apply)
                   and M.p_apply[l] is not None else M.P[l]),
                  (f"Pt{l}", M.pt_apply[l] if l < len(M.pt_apply)
                   and M.pt_apply[l] is not None else M.Pt[l])]
    return [{"op": name, **layout(op).describe()} for name, op in named
            if layout(op) is not None]


def gpu_name_and_power() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def check_solution(res: dict, rtol: float = RTOL) -> None:
    """Raise unless the solve converged to ``rtol`` with a true interior
    residual <= 1e-4 and a finite solution."""
    if not res["rel"] <= rtol:
        raise RuntimeError(f"AMG-PCG did not converge: rel {res['rel']:.3e}")
    if not res["true_residual"] <= 1e-4:
        raise RuntimeError(
            f"true interior residual {res['true_residual']:.3e} > 1e-4")
    if not bool(torch.isfinite(res["x"]).all()):
        raise RuntimeError("non-finite solution")


# the kernel that carries the CG operator's SpMV on each route
SPMV_KERNELS = {"ell": "sell_spmv", "supernode": "bsr8_spmv",
                "compact": "sell_spmv", "diag": "diag_spmv"}


def _counted_modules():
    from .ops import lane_assembly
    from .sparse import (
        band_gather,
        blocked,
        diag_spmv,
        ell_gather,
        sell,
        slot_reduce,
        supernode,
    )

    return (ell_gather, sell, band_gather, diag_spmv, lane_assembly, slot_reduce,
            supernode, blocked)


def reset_launch_counts() -> None:
    """Zero the launch counts of every kernel the sphere's routes run."""
    for m in _counted_modules():
        m.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    """The launch counts of every kernel the sphere's routes run."""
    return {k: v for m in _counted_modules() for k, v in m.launch_counts().items()}


def bench_unstructured(h: float = 6, refine: int = 3, rtol: float = RTOL,
                       **options) -> dict:
    """The main path at mesh size (h, refine) on one CUDA card, in f32
    with penalty 1e12 as the JAX package runs it on its accelerator, CG to
    ``rtol``; ``options`` are :func:`solve_sphere_cut`'s route options.
    Unless ``BENCH_NO_CACHE=1`` the fine SELL layout and the AMG hierarchy
    come from, or go to, npz files under CACHE_DIR.
    ``launches`` counts the kernels of the whole run (nine assemblies and
    five solves, as :func:`solve_sphere_cut` times them, and its
    true-residual check); ``peak_mem_gb`` is the run's peak of
    ``torch.cuda.max_memory_allocated``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_unstructured measures a CUDA card; none "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    order = options.get("order", "sn")
    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(h, refine, order=order)
    host_s = time.perf_counter() - t0
    prefix = (os.path.join(CACHE_DIR, mesh_key(h, refine, order))
              if cache_enabled() else None)
    builds = SellLayout.builds
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = solve_sphere_cut(mesh, topo, device="cuda", dtype=DTYPE,
                           penalty=PENALTY, timed=True, rtol=rtol, cache=prefix,
                           **options)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_solution(res, rtol)
    n = topo.n_nodes
    iters = res["iterations"]
    asm_s, solve_s = res["assembly_s"], res["solve_s"]
    name, power = (s.strip() for s in gpu_name_and_power().split(",", 1))
    opt = {"spmv": "ell", "sn_block": False, "sn_bf16": False,
           "vcycle_bf16": False, "asm_coords": "split", "asm_compact": False,
           "band_pre": False, "asm_reduce": "window", "order": "sn",
           "smoother": "chebyshev", "cheb_deg": CHEB_DEG, "cycle": "V",
           "cheb_apply": None, **options}
    spmv_kernel = SPMV_KERNELS[opt["spmv"]]
    if opt["spmv"] == "compact":
        spmv_kernel = ("band_gather+sell_spmv" if opt["band_pre"]
                       else "ell_gather_sum+sell_spmv")
    return {
        "metric": (f"poisson3d_sphere_cut_{n/1e6:.1f}MDoF_"
                   f"assembly+amgpcg_to_{rtol:g}_s"),
        "value": round(asm_s + solve_s, 4),
        "assembly_s": round(asm_s, 4),
        "solve_s": round(solve_s, 4),
        "ms_per_iter": round(solve_s / max(iters, 1) * 1e3, 2),
        "assembly_mdofs": round(n / asm_s / 1e6, 1),
        "amg_setup_s": round(res["amg_setup_s"], 1),
        "amg_setup_cached": res["amg_setup_cached"],
        "sell_layout_builds": SellLayout.builds - builds,
        "host_setup_s": round(host_s, 1),
        "iterations": iters,
        "rel": res["rel"],
        "true_residual": res["true_residual"],
        "amg_levels": res["levels"],
        "n_dofs": int(n),
        "nnz_stored": int(topo.nnz),
        "sell_sigma": res["A"].layout.sigma,
        "sell_slots": res["A"].layout.n_slots,
        "sell_slots_per_nnz": res["A"].layout.describe()["slots_per_nnz"],
        "spmv_path": res["spmv_path"],
        "spmv_kernel": spmv_kernel,
        "order": opt["order"],
        "sn_block": opt["sn_block"],
        "sn_bf16": opt["sn_bf16"],
        "sn_blocks": res.get("sn_blocks"),
        "sn_bytes": res.get("sn_bytes"),
        "sn_setup_s": (round(res["sn_setup_s"], 1) if "sn_setup_s" in res
                       else None),
        "amg_compact": bool(res.get("vcycle_compact")),
        "band_pre": opt["band_pre"],
        "vcycle_compact": res.get("vcycle_compact"),
        "vcycle_band": res.get("vcycle_band"),
        "compact_setup_s": (round(res["compact_setup_s"], 1)
                            if "compact_setup_s" in res else None),
        "asm_mode": opt["asm_reduce"],  # the JAX names of the list orders
        "asm_compact": opt["asm_compact"],
        "asm_coords": opt["asm_coords"],
        "amg_smoother": opt["smoother"],
        "amg_cheb_deg": (opt["cheb_deg"] if opt["cheb_apply"] is None
                         else opt["cheb_apply"]),
        "amg_cycle": opt["cycle"],
        "vcycle_bf16": opt["vcycle_bf16"],
        "launches": {k: v for k, v in counts.items() if v},
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "platform": "cuda",
        "backend": "torch",
        "gpu": name,
        "power_limit": power,
    }


def prime_host(h: float, refine: int) -> dict:
    """Build (or load) and cache the host set-up of the sphere at (h,
    refine): the mesh, its refinements, RCM and the RCM topology, then the
    supernode order and its topology, each stage timed on the host clock.
    No card is needed; a cold 8.9M set-up takes minutes, longer than a
    bench budget gives it."""
    t0 = time.perf_counter()
    sphere_cut_system(h, refine, order="rcm")
    t1 = time.perf_counter()
    mesh, topo = sphere_cut_system(h, refine)
    t2 = time.perf_counter()
    return {"mesh_key": mesh_key(h, refine), "rcm_stage_s": round(t1 - t0, 1),
            "sn_stage_s": round(t2 - t1, 1), "n_dofs": int(topo.n_nodes),
            "n_cells": int(mesh.cells["tetra4"].shape[0]),
            "nnz_stored": int(topo.nnz), "width": int(topo.width)}


def _cheb_deg(text: str) -> int | tuple:
    """'2' -> 2, '2,4' -> (2, 4), as bench.py reads BENCH_AMG_CHEB_DEG."""
    return tuple(int(d) for d in text.split(",")) if "," in text else int(text)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=float, default=6.0,
                    help="Delaunay mesh size (6 with --refine 3: 8.9M DoF)")
    ap.add_argument("--refine", type=int, default=3,
                    help="uniform 1->8 refinements of the Delaunay mesh")
    ap.add_argument("--spmv", choices=SPMV_PATHS, default="ell",
                    help="CG operator and AMG fine level (BENCH_UNSTR_SPMV; "
                         "compact and diag: AFEM_SPMV)")
    ap.add_argument("--sn-block", action="store_true",
                    help="supernode block-Jacobi fine smoother (BENCH_SN_BLOCK=1)")
    ap.add_argument("--sn-bf16", action="store_true",
                    help="bf16 supernode blocks on the V-cycle's fine level "
                         "(BENCH_SN_BF16=1)")
    ap.add_argument("--vcycle-bf16", action="store_true",
                    help="bf16 V-cycle level and transfer weights "
                         "(BENCH_UNSTR_BF16=1)")
    ap.add_argument("--asm-coords", choices=ASM_COORDS, default="split",
                    help="assembly coordinate gather (AFEM_ASM_COORDS)")
    ap.add_argument("--asm-compact", action="store_true",
                    help="compact two-stage coordinate gather (AFEM_ASM_COMPACT=1)")
    ap.add_argument("--band-pre", action="store_true",
                    help="banded pre-gather of the compact gathers (AFEM_BAND_PRE=1)")
    ap.add_argument("--asm-reduce", choices=REDUCES, default="window",
                    help="order of the assembly's contributor lists (AFEM_UNSTR_ASM)")
    ap.add_argument("--order", choices=ORDERS, default="sn",
                    help="node order: supernode bricks or plain RCM "
                         "(BENCH_UNSTR_ORDER)")
    ap.add_argument("--smoother", choices=("chebyshev", "jacobi"),
                    default="chebyshev", help="AMG smoother (BENCH_AMG_SMOOTHER)")
    ap.add_argument("--cheb-deg", type=_cheb_deg, default=CHEB_DEG,
                    help="Chebyshev degree, or a comma list per level "
                         "(BENCH_AMG_CHEB_DEG)")
    ap.add_argument("--cycle", choices=("V", "W"), default="V",
                    help="AMG cycle (BENCH_AMG_CYCLE)")
    ap.add_argument("--prime", action="store_true",
                    help="only build and cache the host set-up (mesh, orders, "
                         "topologies), timed per stage; no card needed")
    args = ap.parse_args(argv)
    if args.prime:
        print(json.dumps(prime_host(args.h, args.refine)), flush=True)
        return
    print(json.dumps(bench_unstructured(
        args.h, args.refine, spmv=args.spmv, sn_block=args.sn_block,
        sn_bf16=args.sn_bf16, vcycle_bf16=args.vcycle_bf16,
        asm_coords=args.asm_coords, asm_compact=args.asm_compact,
        band_pre=args.band_pre, asm_reduce=args.asm_reduce, order=args.order,
        smoother=args.smoother,
        cheb_deg=args.cheb_deg, cycle=args.cycle)), flush=True)


if __name__ == "__main__":
    main()
