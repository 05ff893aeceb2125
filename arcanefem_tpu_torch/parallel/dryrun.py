"""The sharded paths end to end, one process per rank, each held to the
single-process solve.

    python -m arcanefem_tpu_torch.parallel --nproc P [--device cuda|cpu]
                                           [--sphere H,REFINE] [--f64]
                                           [--profile] [--timeout S]

The counterpart of ``__graft_entry__.dryrun_multichip``.  The parent
builds the kernels once (``utils/kernels.build()``, so P ranks do not run
nvcc side by side), then spawns P ranks over ``torch.distributed``: NCCL
with rank r on ``cuda:r`` (the default), or gloo on the CPU with
``--device cpu``.  Without CUDA, or with fewer cards than ranks, it exits 1
before any rank starts; nothing falls back to the CPU or shares a card.
Each rank runs the dryrun's paths on its shard:

    1  rcb         RCB Poisson, Jacobi-PCG        (sharded.make_poisson_step)
    2  slab        structured x-slab, Jacobi-PCG  (structured_sharded)
    3  mg          structured x-slab MG-PCG       (structured_mg)
    4  amg         unstructured AMG-PCG           (sharded_amg)
    4b window      the same, under the JAX window step's name (sharded_window)
    4v vcycle      one sharded V-cycle against the host AMGPrecond.apply
    5  elasticity  block elasticity, b = 3        (block_sharded)
    6  elastodyn   Newmark elastodynamics, b = 3  (block_sharded)

and ``--sphere H,REFINE`` adds ``sphere``: Poisson on the in-repo
sphere_cut mesh (``bench_unstructured.sphere_cut_system``) with the bench's
penalty Dirichlet rows (Cut = 0, sphere = 1), f = 1, through
``make_window_amg_step`` on the hierarchy of the bench's AMG set-up
(theta 0.03, degree-2 Chebyshev on the inner levels).

Rank 0 gathers each path's solution and holds it to the single-process
solve of the same problem (the port's models and solvers on one device)
with the dryrun's tolerances (float64: rtol 1e-6, atol 1e-9; float32:
2e-3, 1e-4; the sphere: 1e-6 of the largest value), and prints one line
per path: ``parallel(P): <what> ok — ...`` and a JSON record (iterations,
``rel``, the true residual of the free rows, the difference from the
single-process solve, the rank's K1 (``sell_spmv``), ``slot_reduce`` and
``block_slot_reduce`` launches, the collectives per iteration and the ms
per iteration of the CG loop).  Any failed check exits non-zero.
``--profile`` adds, for the sphere, one more solve under torch.profiler:
its wall time and the device time of the collectives' kernels and of all
kernels over it (every rank; the timed solve runs untraced).

:func:`run_rank` is the rank's body; the CPU tests call it through
:func:`spawn` with ``inputs`` (a pickled dict of host arrays that replace
the ones the rank would build, e.g. another package's AMG hierarchy) and
``out`` (an npz of rank 0's gathered solutions).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

PATHS = ("rcb", "slab", "mg", "amg", "window", "vcycle", "elasticity", "elastodyn")
PEN = 1.0e12  # the dryrun's penalty
E_EL, NU_EL = 21.0e4, 0.28  # path 5's material


def _tolerances(f64: bool) -> tuple[float, dict]:
    """(solver rtol, the comparison's rtol/atol), as the JAX dryrun."""
    if f64:
        return 1e-11, dict(rtol=1e-6, atol=1e-9)
    return 1e-6, dict(rtol=2e-3, atol=1e-4)


class _Clock:
    """Launch counts, collectives and the CG loop's time of one path, on
    this rank."""

    def __init__(self, comm):
        from ..sparse import sell, slot_reduce
        from . import comm as comm_mod, sharded

        self.comm = comm
        self._mods = (sell, slot_reduce, comm_mod, sharded)
        for m in (sell, slot_reduce):
            m.reset_launch_counts()
        comm_mod.reset_counts()
        sharded.reset_solve_clock()
        self._sync()
        self.t0 = time.perf_counter()

    def _sync(self):
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)

    def read(self) -> dict:
        self._sync()
        sell, slot_reduce, comm_mod, sharded = self._mods
        wall = time.perf_counter() - self.t0
        solve_s, iters = sharded.solve_clock()
        coll = comm_mod.counts()
        k = sell.launch_counts()
        s = slot_reduce.launch_counts()
        return {"wall_s": wall, "solve_s": solve_s,
                "ms_per_iter": solve_s / max(iters, 1) * 1e3,
                "launches": {"sell_spmv": k["sell_spmv"], "slot_reduce": s["slot_reduce"],
                             "block_slot_reduce": s["block_slot_reduce"]},
                "collectives": coll,
                "collectives_per_iter": {n: c / max(iters, 1) for n, c in coll.items()}}


def _diff(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got − ref| / max |ref|."""
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _report(comm, P, name, what, rec, ok: bool, out: dict, arrays: dict) -> None:
    if comm.rank == 0:
        print(f"parallel({P}): {what} {'ok' if ok else 'FAILED'} — {json.dumps(rec)}",
              flush=True)
    out[name] = rec
    for k, v in arrays.items():
        out.setdefault("_arrays", {})[f"{name}_{k}"] = v
    if not ok:
        raise RuntimeError(f"parallel({P}) {name}: the check against the "
                           f"single-process solve failed: {rec}")


def _compare(got, ref, cmp) -> bool:
    return bool(np.all(np.isfinite(got))
                and np.allclose(got, ref, rtol=cmp["rtol"], atol=cmp["atol"]))


def run_rank(comm, *, f64: bool, sphere: tuple | None = None,
             inputs: dict | None = None, profile: bool = False,
             run_dir: str | None = None) -> dict:
    """This rank's part of every path (and of the sphere, which
    passes its hierarchy through a file in ``run_dir``, a directory every
    rank reads); the records on every rank, the gathered solutions
    (``_arrays``) on rank 0."""
    from ..fem.bcs import BoundaryConditions, DirichletBC
    from ..mesh.generate import box_tetra_mesh
    from ..models.poisson import PoissonConfig, solve as poisson_solve
    from . import sharded
    from .partition import build_sharded
    from .sharded import all_gather_shards, make_poisson_step, put_sharded, stacked_node_mask
    from .sharded_amg import build_sharded_amg, make_poisson_amg_step, put_sharded_amg
    from .sharded_window import make_window_amg_step

    inputs = inputs or {}
    P, dev = comm.world, comm.device
    dtype = torch.float64 if f64 else torch.float32
    rtol_solve, cmp = _tolerances(f64)
    out: dict = {}
    me0 = comm.rank == 0

    mesh = box_tetra_mesh(6, 5, 4)
    sp = build_sharded(mesh, P)
    sh = put_sharded(sp, comm, dtype)
    xmin, xmax = mesh.group_nodes("xmin"), mesh.group_nodes("xmax")
    nodes = np.concatenate([xmin, xmax])
    vals = np.concatenate([np.zeros(len(xmin)), np.ones(len(xmax))])
    mask, val = stacked_node_mask(sp, nodes, vals)
    ref = None
    if me0:
        bcs = BoundaryConditions(dirichlet=[DirichletBC(surface="xmin", value=0.0),
                                            DirichletBC(surface="xmax", value=1.0)])
        ref = poisson_solve(mesh, PoissonConfig(f=1.0, bcs=bcs), dtype=dtype,
                            device=dev).u

    def finish(name, what, x, iters, res, clock, ref_u, extra=None):
        rec = {"nodes": mesh.n_nodes, "iterations": int(iters), "rel": float(res),
               **clock.read(), **(extra or {})}
        rec["true_residual"] = sharded.last_system_residual(comm, x)
        g = sp.scatter_global(all_gather_shards(comm, x))
        ok = True
        if me0:
            rec["max_diff"] = _diff(g, ref_u)
            ok = _compare(g, ref_u, cmp)
        _report(comm, P, name, what, rec, ok, out, {"x": g} if me0 else {})

    # 1) unstructured RCB Poisson (Jacobi-PCG)
    step = make_poisson_step(sp, comm, rtol=rtol_solve, max_iter=2000)
    clock = _Clock(comm)
    x, it, res = step(sh, 1.0, mask, val, PEN)
    finish("rcb", "unstructured RCB", x, it, res, clock, ref)

    # 2, 3) the structured x-slab paths
    _structured_paths(comm, f64, rtol_solve, cmp, out)

    # 4, 4b, 4v) distributed unstructured AMG-PCG
    amg = inputs.get("amg") or _host_amg(mesh, nodes, dtype)
    samg = build_sharded_amg(sp, amg)
    samg_arrs = put_sharded_amg(samg, comm, dtype)
    for name, make, what in (("amg", make_poisson_amg_step, "unstructured AMG-PCG"),
                             ("window", make_window_amg_step,
                              "window-step sharded AMG-PCG")):
        step = make(sp, comm, samg, rtol=rtol_solve, max_iter=200)
        clock = _Clock(comm)
        x, it, res = step(sh, samg_arrs, 1.0, mask, val, PEN)
        finish(name, what, x, it, res, clock, ref, {"levels": len(amg["mats"]) + 1})
    _vcycle_path(comm, f64, out, sp, sh, samg, samg_arrs, amg, mask, val)

    # 5, 6) block elasticity and the elastodynamics Newmark loop, b = 3
    _block_paths(comm, f64, rtol_solve, cmp, out, mesh, sp, sh)

    if sphere is not None:
        _sphere_path(comm, f64, sphere, out, profile, run_dir)
    return out


def _vcycle_path(comm, f64, out, sp, sh, samg, samg_arrs, amg, mask, val) -> None:
    """One sharded V-cycle (``sharded_amg.fine_vcycle`` on the penalised
    shard operator) of a seeded residual, against the host
    ``AMGPrecond.apply`` of the same hierarchy on one device (rel. 1e-10
    in float64, 1e-5 in float32)."""
    from ..solver.amg import amg_from_numpy
    from .sharded import all_gather_shards, penalised_poisson, shard_spmv
    from .sharded_amg import fine_vcycle

    P, dev = comm.world, comm.device
    dtype = torch.float64 if f64 else torch.float32
    r = np.random.RandomState(3).rand(sp.n_nodes)
    rloc = np.zeros(sp.n_own_max)
    k = sp.n_own[comm.rank]
    rloc[:k] = r[sp.owned_global[comm.rank, :k]]
    values, _, _, _ = penalised_poisson(sh, comm, 1.0, mask, val, PEN)

    def spmv(x):
        return shard_spmv(comm, values, sh.layout, x, sh.send_idx, sh.halo_src)

    clock = _Clock(comm)
    x = fine_vcycle(comm, spmv, samg_arrs, samg.omega0, samg.nu,
                    torch.as_tensor(rloc, device=dev).to(dtype))
    rec = {"nodes": sp.n_nodes, **clock.read()}
    g = sp.scatter_global(all_gather_shards(comm, x))
    ok = True
    if comm.rank == 0:
        want = amg_from_numpy(amg, dev, dtype).apply(
            torch.as_tensor(r, device=dev).to(dtype)).double().cpu().numpy()
        rec["max_diff"] = _diff(g, want)
        ok = bool(np.all(np.isfinite(g))) and rec["max_diff"] <= (1e-10 if f64 else 1e-5)
    _report(comm, P, "vcycle", "sharded V-cycle", rec, ok, out,
            {"x": g} if comm.rank == 0 else {})


def _host_amg(mesh, nodes, dtype) -> dict:
    """The dryrun's hierarchy: ``build_amg(A, coarse_size=30)``'s on the
    penalised global operator, set up on the host (the CPU assembles it)."""
    from ..fem.problem import FemProblem
    from ..solver.amg_setup import amg_setup

    prob = FemProblem(mesh, ndof=1, dtype=torch.float64, device="cpu")
    A = prob.stiffness_matrix()
    vals = A.values.clone()
    vals[A.diag_slot[torch.as_tensor(nodes, dtype=torch.int64)]] = PEN
    flat = A.with_values(vals).ell_values().numpy()
    return amg_setup(flat, prob.topo, theta=0.08, smoother="jacobi", cheb_deg=2,
                     dtype=np.float64 if dtype == torch.float64 else np.float32,
                     coarse_size=30)


def _structured_reference(box, c3d, bmask, gv, f, rtol, device, dtype):
    """The single-process Jacobi-PCG on the same penalised structured system."""
    from ..mesh.structured import apply_penalty_dirichlet
    from ..solver.iterative import Precond, pcg

    c3 = torch.as_tensor(c3d, device=device).to(dtype)
    A = box.assemble_stiffness(c3)
    rhs = box.source_rhs(c3, f)
    A, rhs = apply_penalty_dirichlet(A, rhs, torch.as_tensor(bmask, device=device),
                                     torch.as_tensor(gv, device=device).to(dtype), PEN)
    d = A.diagonal()
    M = Precond("jacobi", torch.where(d != 0, 1 / torch.where(d == 0, 1.0, d), 0.0))
    x0 = torch.as_tensor(np.where(bmask, gv, 0.0), device=device).to(dtype)
    x, _, _ = pcg(A, rhs, M, x0, rtol, 0.0, 3000)
    return x.cpu().numpy()


def _structured_paths(comm, f64, rtol_solve, cmp, out) -> None:
    """Paths 2 and 3: the x-slab Jacobi-PCG and MG-PCG, each against the
    single-process Jacobi-PCG of the same penalised box."""
    from ..mesh.structured import StructuredBox
    from . import sharded
    from .sharded import all_gather_shards
    from .structured_mg import make_structured_mg_step, mg_slab_coords, mg_slab_masks, \
        plan_mg_slabs
    from .structured_sharded import gather_global, make_structured_step, plan_slabs, \
        slab_coords, slab_mask_values

    P, dev = comm.world, comm.device
    dtype = torch.float64 if f64 else torch.float32
    npdt = np.float64 if f64 else np.float32
    me0 = comm.rank == 0
    cases = (("slab", StructuredBox(2 * P, 6, 5), "structured x-slab"),
             ("mg", StructuredBox(4 * P, 6, 4), "sharded multigrid"))
    for name, box, what in cases:
        c3d = box.grid_coords(npdt, jitter=0.1)
        bmask = box.boundary_mask(("xmin", "xmax"))
        gv = np.zeros(box.n_nodes, npdt)
        gv[box.boundary_mask(("xmax",))] = 1.0
        extra = {}
        if name == "slab":
            plan = plan_slabs(box, P)
            ms, vs = slab_mask_values(plan, bmask, gv)
            step = make_structured_step(plan, comm, rtol=rtol_solve, max_iter=3000)
            clock = _Clock(comm)
            x, it, res = step(slab_coords(plan, c3d), ms, vs, 1.0)
        else:
            mplan = plan_mg_slabs(box, P)
            if len(mplan.levels) < 2:
                raise RuntimeError("the dryrun's hierarchy must coarsen")
            plan = mplan.fine
            _, vs = slab_mask_values(plan, bmask, gv)
            step = make_structured_mg_step(mplan, comm, rtol=rtol_solve, max_iter=200)
            clock = _Clock(comm)
            x, it, res = step(mg_slab_coords(mplan, c3d),
                              [m.astype(npdt) for m in mg_slab_masks(mplan)], vs, 1.0)
            extra["levels"] = len(mplan.levels)
        rec = {"nodes": box.n_nodes, "iterations": int(it), "rel": float(res),
               **clock.read(), **extra}
        rec["true_residual"] = sharded.last_system_residual(comm, x)
        g = gather_global(plan, all_gather_shards(comm, x))
        ok = True
        if me0:
            ref = _structured_reference(box, c3d, bmask, gv, 1.0, rtol_solve, dev, dtype)
            rec["max_diff"] = _diff(g, ref)
            ok = _compare(g, ref, cmp)
        _report(comm, P, name, what, rec, ok, out, {"x": g} if me0 else {})


def _block_paths(comm, f64, rtol_solve, cmp, out, mesh, sp, sh) -> None:
    """Paths 5 and 6: block elasticity on the dryrun mesh's shards and the
    elastodynamics Newmark loop, b = 3, each against its model's solve."""
    from ..fem.bcs import BoundaryConditions, DirichletBC
    from ..mesh.generate import box_tetra_mesh
    from ..models.elasticity import ElasticityConfig, lame, solve as elasticity_solve
    from ..models.elastodynamics import ElastodynamicsConfig, newmark_coefficients
    from ..models.elastodynamics import solve as elastodyn_solve
    from . import sharded
    from .block_sharded import make_elastodynamics_loop, make_elasticity_step, \
        stacked_dof_mask
    from .partition import build_sharded
    from .sharded import all_gather_shards, put_sharded

    P, dev = comm.world, comm.device
    dtype = torch.float64 if f64 else torch.float32
    me0 = comm.rank == 0
    b = 3
    f = np.array([0.0, 0.0, -1.0])
    # 5) block elasticity
    lam_l, mu2 = lame(E_EL, NU_EL)
    clamp = mesh.group_nodes("xmin")
    bmask, bval = stacked_dof_mask(sp, b, [(clamp, c, 0.0) for c in range(b)])
    step = make_elasticity_step(sp, comm, lam_l, mu2, rtol=rtol_solve,
                                max_iter=4000, ndof=b)
    clock = _Clock(comm)
    x, it, res = step(sh, f, bmask, bval, PEN)
    rec = {"nodes": mesh.n_nodes, "b": b, "iterations": int(it), "rel": float(res),
           **clock.read()}
    rec["true_residual"] = sharded.last_system_residual(comm, x)
    g = sp.scatter_global(all_gather_shards(comm, x))
    ok = True
    if me0:
        ecfg = ElasticityConfig(
            E=E_EL, nu=NU_EL, f=tuple(f),
            bcs=BoundaryConditions(dirichlet=[DirichletBC(surface="xmin",
                                                          values=(0.0, 0.0, 0.0))]))
        ecfg.solver.rtol = rtol_solve
        ecfg.solver.max_iter = 4000
        eref = elasticity_solve(mesh, ecfg, dtype=dtype, device=dev).u
        rec["max_diff"] = _diff(g, eref)
        ok = _compare(g, eref, cmp)
    _report(comm, P, "elasticity", "sharded block elasticity", rec, ok, out,
            {"x": g} if me0 else {})

    # 6) the Newmark loop on a smaller box
    tmesh = box_tetra_mesh(4, 3, 3)
    tsp = build_sharded(tmesh, P)
    tsh = put_sharded(tsp, comm, dtype)
    tcfg = ElastodynamicsConfig(
        tmax=0.3, dt=0.1, rho=1.0, E=2.0, nu=0.3, f=tuple(f),
        bcs=BoundaryConditions(dirichlet=[DirichletBC(surface="xmin",
                                                      values=(0.0, 0.0, 0.0))]),
        penalty=PEN)
    tcfg.solver.rtol = rtol_solve
    tcfg.solver.max_iter = 4000
    mu_t = tcfg.E / (2 * (1 + tcfg.nu))
    lam_t = tcfg.E * tcfg.nu / ((1 + tcfg.nu) * (1 - 2 * tcfg.nu))
    cc, gamma_t, beta_t = newmark_coefficients(tcfg, lam_t, mu_t)
    n_steps = int(round(tcfg.tmax / tcfg.dt))
    tclamp = tmesh.group_nodes("xmin")
    tmask, tval = stacked_dof_mask(tsp, b, [(tclamp, c, 0.0) for c in range(b)])
    trun = make_elastodynamics_loop(tsp, comm, cc, gamma_t, beta_t, tcfg.dt,
                                    n_steps=n_steps, rtol=rtol_solve,
                                    max_iter=4000, ndof=b)
    clock = _Clock(comm)
    U, V, _A, it = trun(tsh, f, tmask, tval, PEN)
    rec = {"nodes": tmesh.n_nodes, "b": b, "steps": n_steps, "iterations": int(it),
           **clock.read()}
    rec["true_residual"] = sharded.last_system_residual(comm, U)
    gU = tsp.scatter_global(all_gather_shards(comm, U))
    gV = tsp.scatter_global(all_gather_shards(comm, V))
    ok = True
    if me0:
        tref = elastodyn_solve(tmesh, tcfg, dtype=dtype, device=dev)
        if tref.steps != n_steps:
            raise RuntimeError(f"the model ran {tref.steps} steps, the loop {n_steps}")
        rec["max_diff"] = max(_diff(gU, tref.u), _diff(gV, tref.v))
        ok = _compare(gU, tref.u, cmp) and _compare(gV, tref.v, cmp)
    _report(comm, P, "elastodyn", "sharded transient elastodynamics", rec, ok, out,
            {"U": gU, "V": gV} if me0 else {})


def _sphere_path(comm, f64: bool, sphere: tuple, out: dict, profile: bool,
                 run_dir: str | None) -> None:
    """Poisson on the sphere_cut mesh with the bench's penalty rows through
    ``make_window_amg_step``, held to the single-process solve (rank 0:
    the same f64 operator assembled on one device, the bench's AMG set-up,
    CG with compensated dots)."""
    from ..bench_unstructured import CHEB_DEG, THETA, dirichlet_data, sphere_cut_system
    from ..fem.problem import FemProblem
    from ..solver.amg import amg_from_numpy
    from ..solver.amg_setup import amg_setup
    from ..solver.iterative import pcg
    from . import sharded
    from .partition import build_sharded
    from .sharded import all_gather_shards, put_sharded, stacked_node_mask
    from .sharded_amg import build_sharded_amg, put_sharded_amg
    from .sharded_window import make_window_amg_step

    P, dev = comm.world, comm.device
    dtype = torch.float64 if f64 else torch.float32
    rtol = 1e-8 if f64 else 1e-6
    h, refine = sphere
    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(h, refine)
    mask_g, g, _ = dirichlet_data(mesh, PEN)
    host = {"mesh_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    sp = build_sharded(mesh, P, topo=topo)
    del topo
    host["build_sharded_s"] = time.perf_counter() - t0
    rec: dict = {"nodes": mesh.n_nodes, "cells": int(mesh.cells["tetra4"].shape[0]),
                 "n_own_max": sp.n_own_max, "h_max": sp.h_max, "width": sp.width,
                 "rtol": rtol, "dtype": str(dtype).removeprefix("torch.")}
    if run_dir is None:
        raise ValueError("the sphere path needs a run_dir that every rank reads")
    path = os.path.join(run_dir, "sphere_amg.pkl")
    ref = None
    if comm.rank == 0:
        # the single-process solve, whose hierarchy every rank then shards
        t0 = time.perf_counter()
        prob = FemProblem(mesh, ndof=1, dtype=torch.float64, device=dev)
        A = prob.stiffness_matrix()
        m = torch.as_tensor(mask_g, device=dev)
        vals = A.values.clone()
        vals[A.diag_slot[m]] = PEN
        A = A.with_values(vals)
        amg = amg_setup(A.ell_values().cpu().numpy(), prob.topo, theta=THETA,
                        smoother="chebyshev", cheb_deg=CHEB_DEG,
                        dtype=np.float64 if f64 else np.float32)
        host["ref_setup_s"] = time.perf_counter() - t0
        gt = torch.as_tensor(g, device=dev)
        b = torch.where(m, PEN * gt, prob.constant_source_rhs(1.0).to(torch.float64))
        M = amg_from_numpy(amg, dev, dtype)
        A_op = A.with_values(A.values.to(dtype))
        x0 = torch.where(m, gt, 0.0).to(dtype)
        t0 = time.perf_counter()
        xr, it_r, rel_r = pcg(A_op, b.to(dtype), M, x0, rtol, 0.0, 1000,
                              use_precise_dot=True)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        rec["single"] = {"iterations": int(it_r), "rel": float(rel_r),
                         "solve_s": time.perf_counter() - t0,
                         "levels": [np.shape(v)[0] for v, _ in amg["mats"]]
                         + [np.shape(amg["coarse_inv"])[0]]}
        ref = xr.double().cpu().numpy()
        del prob, A, A_op, M, xr, b, vals
        with open(path + ".tmp", "wb") as fh:
            pickle.dump({k: v for k, v in amg.items() if k not in ("nullspaces",)}, fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
        del amg
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    comm.barrier()
    with open(path, "rb") as fh:
        amg = pickle.load(fh)
    t0 = time.perf_counter()
    samg = build_sharded_amg(sp, amg)
    del amg
    sh = put_sharded(sp, comm, dtype)
    samg_arrs = put_sharded_amg(samg, comm, dtype)
    mask, val = stacked_node_mask(sp, np.flatnonzero(mask_g), g[mask_g])
    host["shard_setup_s"] = time.perf_counter() - t0
    step = make_window_amg_step(sp, comm, samg, rtol=rtol, max_iter=1000)
    step(sh, samg_arrs, 1.0, mask, val, PEN)  # warm: every kernel built and loaded
    clock = _Clock(comm)
    x, it, res = step(sh, samg_arrs, 1.0, mask, val, PEN)
    rec.update(iterations=int(it), rel=float(res), **clock.read(), host_s=host)
    rec["true_residual"] = sharded.last_system_residual(comm, x)
    gx = sp.scatter_global(all_gather_shards(comm, x))
    if profile:  # one more solve, traced
        rec["profile"] = _profiled(comm, lambda: step(sh, samg_arrs, 1.0, mask, val, PEN))
    ok = True
    if comm.rank == 0:
        rec["max_diff"] = _diff(gx, ref)
        ok = bool(np.all(np.isfinite(gx)) and rec["max_diff"] <= 1e-6
                  and abs(rec["iterations"]) > 0)
    _report(comm, P, "sphere", f"sphere_cut h={h:g} refine={refine} AMG-PCG", rec, ok,
            out, {})


def _profiled(comm, solve) -> dict:
    """One ``solve`` under torch.profiler (the device's activity on the
    card): its wall time and :func:`_collective_share` of it."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    dev = comm.device
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    comm.barrier()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return {"wall_s": wall, **_collective_share(prof, wall)}


def _collective_share(prof, solve_s: float) -> dict:
    """The device time of the collectives' kernels (names with ``nccl``)
    and of every kernel, over the solve's wall time ``solve_s``."""
    from torch.autograd import DeviceType

    tot = coll = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot += e.device_time_total
            if "nccl" in e.name.lower():
                coll += e.device_time_total
    wall_us = max(solve_s, 1e-12) * 1e6
    return {"device_us": tot, "collective_us": coll,
            "collective_share_of_wall": coll / wall_us,
            "device_share_of_wall": tot / wall_us}


# --- the ranks ---------------------------------------------------------------


def _rank_main(rank: int, world: int, device: str, run_dir: str, body, kwargs: dict,
               inputs_path, out_path) -> None:
    from . import comm as comm_mod

    if device == "cpu":
        torch.set_num_threads(1)
    comm = comm_mod.init(rank, world, device=device,
                         store_path=os.path.join(run_dir, "store"))
    try:
        comm.warm_up()
        inputs = None
        if inputs_path:
            with open(inputs_path, "rb") as fh:
                inputs = pickle.load(fh)
        out = body(comm, inputs=inputs, run_dir=run_dir, **kwargs)
        if rank == 0 and out_path:
            arrays = out.pop("_arrays", {})
            np.savez(out_path, records=json.dumps(out), **arrays)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        comm_mod.shutdown()


def spawn(nproc: int, *, device: str = "cuda", body=None, inputs: dict | None = None,
          out: str | None = None, timeout_s: float = 3000.0,
          run_dir: str | None = None, **kwargs) -> int:
    """Run ``nproc`` ranks to their end, or kill them all after
    ``timeout_s``; 0 if every rank finished, 1 otherwise.  Each rank runs
    ``body(comm, inputs=..., run_dir=..., **kwargs)`` (a module-level
    function; :func:`run_rank`, every dryrun path, when None, whose
    ``f64``, ``sphere`` and ``profile`` come in ``kwargs``); rank 0 writes
    the dict it returns to the npz ``out``, its ``_arrays`` as arrays and
    the rest as ``records``.  The ranks meet through a ``FileStore`` in
    ``run_dir`` (a new temporary directory, removed at the end, when
    None)."""
    import torch.multiprocessing as mp

    if body is None:
        body = run_rank
        kwargs.setdefault("f64", False)
    own_dir = run_dir is None
    if own_dir:
        run_dir = tempfile.mkdtemp(prefix="afem_parallel_")
    try:
        inputs_path = None
        if inputs is not None:
            inputs_path = os.path.join(run_dir, "inputs.pkl")
            with open(inputs_path, "wb") as fh:
                pickle.dump(inputs, fh, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(
            _rank_main, nprocs=nproc, join=False, start_method="spawn",
            args=(nproc, device, run_dir, body, kwargs, inputs_path, out))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    print(f"parallel({nproc}): the ranks did not finish within "
                          f"{timeout_s:g} s; killed", file=sys.stderr, flush=True)
                    return 1
        except Exception as e:  # a rank failed; join has ended the others
            print(f"parallel({nproc}): {type(e).__name__}: {e}", file=sys.stderr,
                  flush=True)
            return 1
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return 0
    finally:
        if own_dir:
            shutil.rmtree(run_dir, ignore_errors=True)


def _sphere_arg(text: str) -> tuple[float, int]:
    h, refine = text.split(",")
    return float(h), int(refine)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m arcanefem_tpu_torch.parallel",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, required=True, help="ranks (one per card)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--sphere", type=_sphere_arg, default=None, metavar="H,REFINE",
                   help="add the sphere_cut path at this size (e.g. 5,2: 1.9M DoF)")
    p.add_argument("--f64", action="store_true", help="float64 (default float32)")
    p.add_argument("--profile", action="store_true",
                   help="the sphere solve's collective share, from torch.profiler")
    p.add_argument("--timeout", type=float, default=3000.0,
                   help="seconds before every rank is killed")
    args = p.parse_args(argv)
    from .comm import check_devices

    try:
        check_devices(args.device, args.nproc)
    except (RuntimeError, ValueError) as e:
        print(f"parallel: {e}", file=sys.stderr)
        return 1
    if args.device == "cuda":
        from ..utils import kernels

        t0 = time.perf_counter()
        kernels.build()
        print(f"parallel({args.nproc}): kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if args.sphere is not None:
        from ..bench_unstructured import sphere_cut_system

        t0 = time.perf_counter()
        sphere_cut_system(*args.sphere)  # cached once, read by every rank
        print(f"parallel({args.nproc}): sphere_cut h={args.sphere[0]:g} refine="
              f"{args.sphere[1]} set up in {time.perf_counter() - t0:.1f} s", flush=True)
    return spawn(args.nproc, device=args.device, f64=args.f64,
                 sphere=args.sphere, profile=args.profile, timeout_s=args.timeout)
