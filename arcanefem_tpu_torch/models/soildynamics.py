"""Soil dynamics: seismic wave propagation with paraxial absorbing
boundaries and a double-couple source.

The counterpart of ``arcanefem_tpu/models/soildynamics.py`` (reference
modules/soildynamics): the Newmark-β scheme with its own c0..c9 set
(FemModule.cc:283-301), paraxial EDGE2 boundary terms with wave speeds
cp = √((λ+2μ)/ρ), cs = √(μ/ρ) (FemModule.cc:258-272): the LHS edge matrix
diag(c7(nx²cp+ny²cs), c7(ny²cp+nx²cs))·edge-mass and the RHS
(c7·U − c8·V − c9·A) through the full directional matrix
P(n) = cp·n⊗n + cs·t⊗t (FemModule.cc:870-937), transient tractions by
CaseTable, and the force-based double-couple source that *sets* RHS values
at its four node groups (FemModule.cc:946-1000).

As in JAX, M, D and E are assembled once (one ``block_slot_reduce`` launch
each), the paraxial edge blocks are added by ``add_face_matrix`` (one
fixed-order ``slot_reduce`` per face bucket), the BCs are frozen once, and
each step rebuilds only the RHS: one ``sell_spmv``, the paraxial sum
through a ``SlotSum`` whose lists are built once per face bucket, and the
timed tractions through ``FemProblem.traction_rhs``'s cached lists.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.casetable import CaseTable, read_case_table
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..fem.transient import anchor_atol, free_residual, freeze_bcs
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements, geometry
from ..solver.amg_setup import rigid_body_modes
from ..solver.iterative import make_precond
from ..solver.linear_system import SolverOptions, solve_finalized
from .elastodynamics import TractionTBC


@dataclass
class DoubleCouple:
    north: str
    south: str
    east: str
    west: str
    table: CaseTable
    method: str = "force-based"


@dataclass
class SoildynamicsConfig:
    tmax: float = 1.0
    dt: float = 0.1
    rho: float = 1.0
    lam: float | None = None
    mu: float | None = None
    E: float = 1.0
    nu: float = 0.3
    cp: float | None = None
    cs: float | None = None
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    tractions: list[TractionTBC] = field(default_factory=list)
    paraxial: list[str] = field(default_factory=list)  # surface names
    double_couple: DoubleCouple | None = None
    penalty: float = 1.0e30
    method: str = "Penalty"
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-3
    result_min_value_rel: float = 2.0e-5


@dataclass
class SoildynamicsResult:
    u: np.ndarray
    v: np.ndarray
    a: np.ndarray
    steps: int
    problem: FemProblem
    # Krylov iterations over every step's solve, and each step's
    iterations: int = 0
    step_iterations: list = field(default_factory=list)
    residual: float = 0.0  # the last step's monitored residual
    solve_s: float = 0.0  # the steps' solve seconds (the card synchronised)
    info: dict = field(default_factory=dict)  # the last step's solver info


def coefficients(cfg, lam, mu):
    """Newmark-β set, FemModule.cc:283-301."""
    dt, rho = cfg.dt, cfg.rho
    gamma = 0.5
    beta = 0.25 * (gamma + 0.5) ** 2
    return dict(
        c0=rho / (beta * dt * dt),
        c1=lam,
        c2=2 * mu,
        c3=rho / (beta * dt),
        c4=rho * (0.5 / beta - 1.0),
        c7=rho * gamma / beta / dt,
        c8=rho * (1.0 - gamma / beta),
        c9=rho * dt * (1.0 - gamma / (2.0 * beta)),
    ), gamma, beta


def materials(cfg: SoildynamicsConfig) -> tuple[float, float, float, float]:
    """(λ, μ, cp, cs) in the precedence of FemModule.cc:261-278: E/ν ->
    λ, μ, cs, cp; explicit λ, μ -> cs, cp; explicit cp, cs -> λ, μ."""
    mu = cfg.E / (2 * (1 + cfg.nu))
    lam = cfg.E * cfg.nu / ((1 + cfg.nu) * (1 - 2 * cfg.nu))
    if cfg.mu is not None and cfg.lam is not None:
        mu, lam = cfg.mu, cfg.lam
    cs = float(np.sqrt(mu / cfg.rho))
    cp = float(np.sqrt((lam + 2 * mu) / cfg.rho))
    if cfg.cp is not None and cfg.cs is not None:
        cp, cs = cfg.cp, cfg.cs
        mu = cs * cs * cfg.rho
        lam = cp * cp * cfg.rho - 2 * mu
    return lam, mu, cp, cs


def solve(mesh: Mesh, cfg: SoildynamicsConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> SoildynamicsResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    ndof = 2
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype, device=device)
        prob.block_assembly  # the layout and contributor lists, once

    lam, mu, cp, cs = materials(cfg)
    c, gamma, beta = coefficients(cfg, lam, mu)
    dt = cfg.dt

    with timer.phase("lhs-matrix-assembly"):
        Mm = prob.assemble_matrix(lambda ct, xyz: elements.mass_blocks(ct, xyz, ndof))
        Dm = prob.assemble_matrix(lambda ct, xyz: elements.divdiv(ct, xyz))
        Em = prob.assemble_matrix(lambda ct, xyz: elements.epseps(ct, xyz))
        A = Mm.with_values(c["c0"] * Mm.values + c["c1"] * Dm.values
                           + c["c2"] * Em.values)
        del Dm, Em

        # paraxial LHS edge blocks (FemModule.cc EDGE2 matrix):
        # diag(c7(nx²cp+ny²cs), c7(ny²cp+nx²cs)) × edge mass
        def edge_blocks(ft, xyz):
            em = elements.edge2_mass(xyz)  # (nf, 2, 2)
            n = geometry.edge2_normal(xyz)  # (nf, 2)
            dxx = c["c7"] * (n[:, 0] ** 2 * cp + n[:, 1] ** 2 * cs)
            dyy = c["c7"] * (n[:, 1] ** 2 * cp + n[:, 0] ** 2 * cs)
            diag = torch.stack([dxx, dyy], dim=-1)  # (nf, 2)
            eye = torch.eye(2, dtype=xyz.dtype, device=xyz.device)
            return em[:, :, :, None, None] * (diag[:, None, None, :, None]
                                              * eye[None, None, None])

        for surf in cfg.paraxial:
            A = prob.add_face_matrix(A, surf, edge_blocks)

    # Dirichlet (u1/u2 style) frozen once
    pen = dtype_safe_penalty(cfg.penalty, np_dtype)
    system = prob.new_system(A, cfg.solver)
    dir_mask = np.zeros(prob.n_dofs, bool)
    dir_gval = np.zeros(prob.n_dofs, np.float64)
    for bc in cfg.bcs.dirichlet:
        nodes = mesh.group_nodes(bc.surface)
        for comp, v in enumerate(bc.values or ()):
            if v is None or comp >= ndof:
                continue
            dofs = prob.dof_ids(nodes, comp)
            prob.apply_dirichlet(system, dofs, v, bc.method or cfg.method, pen)
            dir_mask[dofs] = True
            dir_gval[dofs] = v
    fbc = freeze_bcs(system)
    del system, A
    ns = rigid_body_modes(mesh.coords, ndof) if cfg.solver.preconditioner == "amg" else None
    M_pre = make_precond(fbc.A, cfg.solver.preconditioner, nullspace=ns)

    zeros = torch.zeros(prob.n_dofs, dtype=prob.dtype, device=prob.device)
    # constant tractions; timed ones interpolated per step
    const_tr = zeros
    timed_tr = []
    for tr in cfg.tractions:
        if tr.table is not None:
            timed_tr.append(tr)
        elif any(v is not None for v in tr.t):
            const_tr = prob.traction_rhs(const_tr, tr.surface, tr.t)

    # paraxial RHS data per face bucket: the faces, L/6, P(n) and the
    # fixed-order sum into their nodes' dofs
    parax = []
    for surf in cfg.paraxial:
        for ft, conn in mesh.face_groups[surf].items():
            xyz = prob.face_xyz(conn)
            L = geometry.edge2_length(xyz)
            n = geometry.edge2_normal(xyz).cpu().numpy()
            nx, ny = n[:, 0], n[:, 1]
            P = np.zeros((len(conn), 2, 2))
            P[:, 0, 0] = cp * nx * nx + cs * ny * ny
            P[:, 0, 1] = (cp - cs) * nx * ny
            P[:, 1, 0] = (cp - cs) * nx * ny
            P[:, 1, 1] = cp * ny * ny + cs * nx * nx
            parax.append((prob._index(conn), L / 6.0,
                          torch.as_tensor(P, dtype=prob.dtype, device=prob.device),
                          prob.node_sum(("paraxial", surf, ft), conn)))

    # double-couple dof indices
    dc = cfg.double_couple
    if dc is not None:
        dc_sets = [(prob._index(prob.dof_ids(mesh.group_nodes(g), comp)), sign)
                   for g, comp, sign in ((dc.north, 0, 1.0), (dc.south, 0, -1.0),
                                         (dc.east, 1, -1.0), (dc.west, 1, 1.0))]

    def step_rhs(U, V, Acc, rhs_t, dc_force):
        rhs = const_tr + rhs_t
        rhs = rhs + Mm.spmv(c["c0"] * U + c["c3"] * V + c["c4"] * Acc)
        # paraxial: (c7 U − c8 V − c9 A) through P(n), edge-mass weighted
        X = (c["c7"] * U - c["c8"] * V - c["c9"] * Acc).reshape(-1, 2)
        for conn, L6, P, psum in parax:
            xf = X[conn]  # (nf, 2 nodes, 2 comps)
            s = torch.sum(xf, dim=1, keepdim=True)  # (nf, 1, 2)
            contrib = torch.einsum("fab,fib->fia", P, s + xf) * L6[:, None, None]
            rhs = rhs + psum(contrib)
        rhs = fbc.apply(rhs)
        if dc is not None:
            for dofs, sign in dc_sets:
                rhs = rhs.index_fill(0, dofs, sign * dc_force)
        return rhs

    def newmark_update(dU, U, V, Acc):
        aloc = (dU - U - dt * V) / (beta * dt * dt) - (1 - 2 * beta) / (2 * beta) * Acc
        Vn = V + dt * ((1 - gamma) * Acc + gamma * aloc)
        return dU, Vn, aloc

    U = torch.as_tensor(np.where(dir_mask, dir_gval, 0.0).astype(np_dtype),
                        device=prob.device)
    V = zeros.clone()
    Acc = zeros.clone()

    t = dt
    steps = 0
    step_iters = []
    solve_s = 0.0
    info = {}
    with timer.phase("time-loop"):
        while t < cfg.tmax + 1e-12 * dt:
            rhs_t = zeros
            for tr in timed_tr:
                vec = np.asarray(tr.table.value(t))
                rhs_t = prob.traction_rhs(rhs_t, tr.surface,
                                          tuple(float(x) for x in vec[:ndof]))
            dcf = float(dc.table.value(t)[0]) if dc is not None else 0.0
            rhs = step_rhs(U, V, Acc, rhs_t, dcf)
            x0 = fbc.warm_start(U)
            if steps == 0:
                # later steps' absolute tolerance anchored at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(cfg.solver, atol=max(
                    cfg.solver.atol, anchor_atol(fbc.A, M_pre, rhs, x0, cfg.solver.rtol,
                                                 method=cfg.solver.method)))
            dU, info = solve_finalized(fbc.A, rhs, opts, x0=x0, precond=M_pre)
            step_iters.append(int(info["iterations"]))
            solve_s += info.get("solve_s", 0.0)
            U, V, Acc = newmark_update(dU.to(prob.dtype), U, V, Acc)
            t += dt
            steps += 1
    if steps:
        info["free_residual"] = free_residual(fbc.A, rhs, U, fbc.pen_mask | fbc.elim_mask)

    u = prob.node_values(U)
    res = SoildynamicsResult(u=u, v=prob.node_values(V), a=prob.node_values(Acc),
                             steps=steps, problem=prob, iterations=sum(step_iters),
                             step_iterations=step_iters,
                             residual=float(info.get("residual", 0.0)), solve_s=solve_s, info=info)
    if cfg.result_file:
        with timer.phase("result-validation"):
            check_node_results(mesh.node_uids, u, cfg.result_file, cfg.result_epsilon,
                               min_value_rel=cfg.result_min_value_rel)
    return res


def parse_config(case, check: bool = True) -> SoildynamicsConfig:
    """The .arc fields of the soildynamics module (<u1>/<u2> Dirichlet,
    <t1>/<t2> or <traction-input-file> tractions, paraxial surfaces, the
    <double-couple> block and the material)."""
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    fem = case.fem
    bcs = BoundaryConditions()
    method = opt_text(fem, "enforce-Dirichlet-method", "Penalty")
    for d in fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(DirichletBC(surface=opt_text(d, "surface"),
                                         values=(opt_float(d, "u1"), opt_float(d, "u2")),
                                         method=method))
    tractions = []
    for tr in fem.findall("traction-boundary-condition"):
        fn = opt_text(tr, "traction-input-file")
        table = read_case_table(os.path.join(case.base_dir, fn), 3) if fn else None
        tractions.append(TractionTBC(surface=opt_text(tr, "surface"),
                                     t=(opt_float(tr, "t1"), opt_float(tr, "t2")),
                                     input_file=fn, table=table))
    paraxial = [opt_text(p, "surface") for p in fem.findall("paraxial-boundary-condition")]
    dc = None
    dce = fem.find("double-couple")
    if dce is not None:
        dc = DoubleCouple(
            north=opt_text(dce, "north-node-name"),
            south=opt_text(dce, "south-node-name"),
            east=opt_text(dce, "east-node-name"),
            west=opt_text(dce, "west-node-name"),
            table=read_case_table(
                os.path.join(case.base_dir, opt_text(dce, "double-couple-input-file")), 1),
            method=opt_text(dce, "method", "force-based"),
        )
    return SoildynamicsConfig(
        tmax=opt_float(fem, "tmax", 1.0),
        dt=opt_float(fem, "dt", 0.1),
        rho=opt_float(fem, "rho", 1.0),
        lam=opt_float(fem, "lambda"),
        mu=opt_float(fem, "mu"),
        E=opt_float(fem, "E", 1.0),
        nu=opt_float(fem, "nu", 0.3),
        cp=opt_float(fem, "cp"),
        cs=opt_float(fem, "cs"),
        bcs=bcs,
        tractions=tractions,
        paraxial=paraxial,
        double_couple=dc,
        penalty=opt_float(fem, "penalty", 1.0e30),
        method=method,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    return solve(mesh, parse_config(case, check), dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Soildynamics")(_run_arc)


_register()
