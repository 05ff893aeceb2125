"""Transient elastodynamics: ρü + C(u̇) + K(u) = f, Newmark-β / Generalized-α.

The counterpart of ``arcanefem_tpu/models/elastodynamics.py`` (reference
modules/elastodynamics): the c0..c10 coefficient scheme
(FemModule.cc:251-296) with Rayleigh damping (etam, etak), consistent mass
and the divdiv/epseps operators, traction conditions (constant or a
CaseTable time series, FemModule.cc:305-320,872-905), body force, penalty
/ row / row-column Dirichlet, and the Newmark update of (U, V, A)
(FemModule.cc:429-459).

As in JAX, the three unit operators M (mass), D (divdiv) and E (epseps)
are assembled once on one layout (one ``block_slot_reduce`` launch each),
the LHS is c0·M + c1·D + c2·E with its boundary conditions frozen
(``fem/transient.py``), and each step rebuilds only the RHS with three
SpMVs (``sell_spmv``) and solves with the preconditioner built once.  The
JAX package's jitted step functions are plain tensor functions here.
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
from ..fem.transient import anchor_atol, freeze_bcs
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.amg_setup import rigid_body_modes
from ..solver.iterative import make_precond
from ..solver.linear_system import SolverOptions, solve_finalized


@dataclass
class TractionTBC:
    """Traction with optional per-component values or a time-series file."""

    surface: str
    t: tuple = (None, None, None)
    input_file: str | None = None
    table: CaseTable | None = None


@dataclass
class ElastodynamicsConfig:
    time_discretization: str = "Newmark-beta"  # | "Generalized-alpha"
    tmax: float = 1.0
    dt: float = 0.1
    rho: float = 1.0
    E: float = 1.0
    nu: float = 0.3
    lam: float | None = None  # overrides E/nu if given (FemModule.cc:242-246)
    mu: float | None = None
    etam: float = 0.0  # mass damping
    etak: float = 0.0  # stiffness damping
    alpm: float = 0.0  # Generalized-alpha params
    alpf: float = 0.0
    f: tuple = (None, None)  # body force
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    tractions: list[TractionTBC] = field(default_factory=list)
    penalty: float = 1.0e30
    method: str = "Penalty"
    # "stable": the textbook Rayleigh-damping Newmark RHS (A-term
    # coefficient dt(γ/2β − 1)); "reference": FemModule.cc:264/269 as
    # written (dt((1−2β)/2β − (1−γ))), unstable under stiffness damping
    # over long runs
    damping_formulation: str = "stable"
    # "zero" mirrors the reference (A starts at 0, Newmark then loses its
    # second order under a body force); "consistent" solves
    # ρM·A0 = F(0) − K·U0 first
    initial_acceleration: str = "zero"
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-3
    result_min_value_rel: float = 2.0e-5


@dataclass
class ElastodynamicsResult:
    u: np.ndarray  # (n_nodes, ndof) final displacement
    v: np.ndarray
    a: np.ndarray
    steps: int
    problem: FemProblem
    # Krylov iterations over every step's solve (the JAX result has none)
    iterations: int = 0


def newmark_coefficients(cfg: ElastodynamicsConfig, lam: float, mu: float):
    """c0..c10 exactly as FemModule.cc:251-296."""
    dt, rho, etam, etak = cfg.dt, cfg.rho, cfg.etam, cfg.etak
    mu2 = 2.0 * mu
    if cfg.time_discretization == "Newmark-beta":
        gamma = 0.5
        beta = 0.25 * (gamma + 0.5) ** 2
        gb = gamma / beta / dt
        c = dict(
            c0=rho / (beta * dt * dt) + etam * rho * gb,
            c1=lam + lam * etak * gb,
            c2=mu2 + mu2 * etak * gb,
            c3=rho / beta / dt - etam * rho * (1 - gamma / beta),
            c4=rho * ((1 - 2 * beta) / 2 / beta - etam * dt * (1 - gamma / 2 / beta)),
            c5=-lam * etak * gb,
            c6=-mu2 * etak * gb,
            c7=etak * lam * (gamma / beta - 1),
            c8=etak * lam * dt * ((1 - 2 * beta) / 2 / beta - (1 - gamma)),
            c9=etak * mu2 * (gamma / beta - 1),
            c10=etak * mu2 * dt * ((1 - 2 * beta) / 2 / beta - (1 - gamma)),
        )
        if cfg.damping_formulation == "stable":
            c["c8"] = etak * lam * dt * (gamma / 2 / beta - 1)
            c["c10"] = etak * mu2 * dt * (gamma / 2 / beta - 1)
    elif cfg.time_discretization == "Generalized-alpha":
        alpm, alpf = cfg.alpm, cfg.alpf
        gamma = 0.5 + alpf - alpm
        beta = 0.25 * (gamma + 0.5) ** 2
        gb = gamma * (1 - alpf) / beta  # the recurring γ(1−αf)/β factor
        c = dict(
            c0=rho * (1 - alpm) / (beta * dt * dt) + etam * rho * gb / dt,
            c1=lam * (1 - alpf) + lam * etak * gb / dt,
            c2=mu2 * (1 - alpf) + mu2 * etak * gb / dt,
            c3=rho * (1 - alpm) / beta / dt - etam * rho * (1 - gb),
            c4=rho * (
                (1 - alpm) * (1 - 2 * beta) / 2 / beta - alpm
                - etam * dt * (1 - alpf) * (1 - gamma / 2 / beta)
            ),
            c5=lam * alpf - lam * etak * gb / dt,
            c6=mu2 * alpf - mu2 * etak * gb / dt,
            c7=etak * lam * (gb - 1),
            c8=etak * lam * dt * (1 - alpf) * ((1 - 2 * beta) / 2 / beta - (1 - gamma)),
            c9=etak * mu2 * (gb - 1),
            c10=etak * mu2 * dt * (1 - alpf) * ((1 - 2 * beta) / 2 / beta - (1 - gamma)),
        )
        if cfg.damping_formulation == "stable":
            c["c8"] = etak * lam * dt * (1 - alpf) * (gamma / 2 / beta - 1)
            c["c10"] = etak * mu2 * dt * (1 - alpf) * (gamma / 2 / beta - 1)
    else:
        raise ValueError(
            "time-discretization must be Newmark-beta or Generalized-alpha"
        )
    return c, gamma, beta


def _traction_at(prob: FemProblem, rhs: torch.Tensor, timed, t: float) -> torch.Tensor:
    """rhs plus the CaseTable tractions ``timed`` at time t."""
    for tr in timed:
        vec = tr.table.value(t)
        rhs = prob.traction_rhs(rhs, tr.surface,
                                tuple(float(x) for x in vec[:prob.ndof]))
    return rhs


def solve(mesh: Mesh, cfg: ElastodynamicsConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> ElastodynamicsResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    ndof = 3 if mesh.dim == 3 else 2

    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype, device=device)
        prob.block_assembly  # the layout and contributor lists, once

    mu = cfg.mu if cfg.mu is not None else cfg.E / (2 * (1 + cfg.nu))
    lam = cfg.lam if cfg.lam is not None else cfg.E * cfg.nu / ((1 + cfg.nu) * (1 - 2 * cfg.nu))
    c, gamma, beta = newmark_coefficients(cfg, lam, mu)
    dt = cfg.dt

    with timer.phase("lhs-matrix-assembly"):
        Mm = prob.assemble_matrix(lambda ct, xyz: elements.mass_blocks(ct, xyz, ndof))
        Dm = prob.assemble_matrix(lambda ct, xyz: elements.divdiv(ct, xyz))
        Em = prob.assemble_matrix(lambda ct, xyz: elements.epseps(ct, xyz))
        A = Mm.with_values(c["c0"] * Mm.values + c["c1"] * Dm.values
                           + c["c2"] * Em.values)

    # Dirichlet: (dofs, values) frozen into the matrix once
    pen = dtype_safe_penalty(cfg.penalty, np_dtype)
    system = prob.new_system(A, cfg.solver)
    dir_mask = np.zeros(prob.n_dofs, bool)
    dir_gval = np.zeros(prob.n_dofs, np.float64)
    groups = ([(bc, mesh.group_nodes(bc.surface)) for bc in cfg.bcs.dirichlet]
              + [(bc, mesh.group_nodes(bc.node_group)) for bc in cfg.bcs.dirichlet_point])
    for bc, nodes in groups:
        for comp, v in enumerate(bc.values or ()):
            if v is None or comp >= ndof:
                continue
            dofs = prob.dof_ids(nodes, comp)
            prob.apply_dirichlet(system, dofs, v, bc.method or cfg.method, pen)
            dir_mask[dofs] = True
            dir_gval[dofs] = v

    fbc = freeze_bcs(system)
    A_bc = fbc.A
    ns = rigid_body_modes(mesh.coords, ndof) if cfg.solver.preconditioner == "amg" else None
    M_pre = make_precond(A_bc, cfg.solver.preconditioner, nullspace=ns)

    # constant rhs pieces
    zeros = torch.zeros(prob.n_dofs, dtype=prob.dtype, device=prob.device)
    rhs_body = zeros
    if any(v is not None for v in cfg.f):
        rhs_body = prob.vector_source_rhs(rhs_body, cfg.f)
    const_tr = zeros
    timed_tr = []
    for tr in cfg.tractions:
        if tr.table is not None:
            timed_tr.append(tr)
        elif any(v is not None for v in tr.t):
            const_tr = prob.traction_rhs(const_tr, tr.surface, tr.t)
    rhs_static = rhs_body + const_tr

    mass_c = (c["c0"], c["c3"], c["c4"])
    div_c = (-c["c5"], c["c7"], c["c8"])
    eps_c = (-c["c6"], c["c9"], c["c10"])

    def step_rhs(U, V, Acc, rhs_t):
        rhs = rhs_static + rhs_t
        rhs = rhs + Mm.spmv(mass_c[0] * U + mass_c[1] * V + mass_c[2] * Acc)
        rhs = rhs + Dm.spmv(div_c[0] * U + div_c[1] * V + div_c[2] * Acc)
        rhs = rhs + Em.spmv(eps_c[0] * U + eps_c[1] * V + eps_c[2] * Acc)
        return fbc.apply(rhs)

    def newmark_update(dU, U, V, Acc):
        """FemModule.cc:429-459."""
        aloc = (dU - U - dt * V) / (beta * dt * dt) - (1 - 2 * beta) / (2 * beta) * Acc
        Vn = V + dt * ((1 - gamma) * Acc + gamma * aloc)
        return dU, Vn, aloc

    # initial state: U starts at the Dirichlet values (FemModule.cc:323-420)
    U = torch.as_tensor(np.where(dir_mask, dir_gval, 0.0).astype(np_dtype),
                        device=prob.device)
    V = zeros.clone()
    Acc = zeros.clone()
    iterations = 0
    if cfg.initial_acceleration == "consistent":
        # the semi-discrete equation at t = 0 with V0 = 0 (no damping
        # terms): ρM·A0 = F(0) − (λD + 2μE)·U0, Dirichlet dofs held at 0
        rhs0 = _traction_at(prob, rhs_static, timed_tr, 0.0)
        rhs0 = rhs0 - lam * Dm.spmv(U) - 2.0 * mu * Em.spmv(U)
        msys = prob.new_system(Mm.with_values(cfg.rho * Mm.values), cfg.solver)
        ddofs = np.nonzero(dir_mask)[0]
        if len(ddofs):
            prob.apply_dirichlet(msys, ddofs, 0.0, "Penalty", pen)
        mfbc = freeze_bcs(msys)
        Acc, info = solve_finalized(
            mfbc.A, mfbc.apply(rhs0), replace(cfg.solver, preconditioner="jacobi"),
            x0=Acc, precond=make_precond(mfbc.A, "jacobi"))
        Acc = Acc.to(prob.dtype)
        iterations += int(info["iterations"])
    elif cfg.initial_acceleration != "zero":
        raise ValueError("initial_acceleration must be zero|consistent, "
                         f"got {cfg.initial_acceleration!r}")

    t = dt  # FemModule startInit: t = dt
    steps = 0
    with timer.phase("time-loop"):
        while t < cfg.tmax + 1e-12 * cfg.dt:
            rhs = step_rhs(U, V, Acc, _traction_at(prob, zeros, timed_tr, t))
            x0 = fbc.warm_start(U)
            if steps == 0:
                # later steps' absolute tolerance anchored at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(cfg.solver, atol=max(
                    cfg.solver.atol, anchor_atol(A_bc, M_pre, rhs, x0, cfg.solver.rtol,
                                                 method=cfg.solver.method)))
            dU, info = solve_finalized(A_bc, rhs, opts, x0=x0, precond=M_pre)
            iterations += int(info["iterations"])
            U, V, Acc = newmark_update(dU.to(prob.dtype), U, V, Acc)
            t += dt
            steps += 1

    u = prob.node_values(U)
    res = ElastodynamicsResult(u=u, v=prob.node_values(V), a=prob.node_values(Acc),
                               steps=steps, problem=prob, iterations=iterations)
    if cfg.result_file:
        with timer.phase("result-validation"):
            check_node_results(mesh.node_uids, u, cfg.result_file, cfg.result_epsilon,
                               min_value_rel=cfg.result_min_value_rel)
    return res


def parse_config(case, data_dir: str) -> ElastodynamicsConfig:
    """The .arc fields of the elastodynamics family (<u1>/<u2>/<u3>
    Dirichlet, <t1>/<t2>/<t3> or <traction-input-file> tractions, the time
    scheme and the material)."""
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC, DirichletPointBC

    fem = case.fem
    bcs = BoundaryConditions()
    method = opt_text(fem, "enforce-Dirichlet-method", "Penalty")
    for d in fem.findall("dirichlet-boundary-condition"):
        u1, u2, u3 = (opt_float(d, k) for k in ("u1", "u2", "u3"))
        bcs.dirichlet.append(DirichletBC(surface=opt_text(d, "surface"),
                                         values=(u1, u2, u3), method=method))
    for d in fem.findall("dirichlet-point-condition"):
        u1, u2, u3 = (opt_float(d, k) for k in ("u1", "u2", "u3"))
        bcs.dirichlet_point.append(DirichletPointBC(node_group=opt_text(d, "node"),
                                                    values=(u1, u2, u3), method=method))
    tractions = []
    for tr in fem.findall("traction-boundary-condition"):
        fn = opt_text(tr, "traction-input-file")
        table = read_case_table(os.path.join(data_dir, fn), 3) if fn else None
        tractions.append(TractionTBC(
            surface=opt_text(tr, "surface"),
            t=(opt_float(tr, "t1"), opt_float(tr, "t2"), opt_float(tr, "t3")),
            input_file=fn, table=table))
    return ElastodynamicsConfig(
        time_discretization=opt_text(fem, "time-discretization", "Newmark-beta"),
        tmax=opt_float(fem, "tmax", 1.0),
        dt=opt_float(fem, "dt", 0.1),
        rho=opt_float(fem, "rho", 1.0),
        E=opt_float(fem, "E", 1.0),
        nu=opt_float(fem, "nu", 0.3),
        lam=opt_float(fem, "lambda"),
        mu=opt_float(fem, "mu"),
        etam=opt_float(fem, "etam", 0.0),
        etak=opt_float(fem, "etak", 0.0),
        alpm=opt_float(fem, "alpm", 0.0),
        alpf=opt_float(fem, "alpf", 0.0),
        f=(opt_float(fem, "f1"), opt_float(fem, "f2")),
        bcs=bcs,
        tractions=tractions,
        penalty=opt_float(fem, "penalty", 1.0e30),
        method=method,
        solver=case.solver,
        result_file=case.result_file,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    cfg = parse_config(case, data_dir=case.base_dir)
    if not check:
        cfg.result_file = None
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Elastodynamics")(_run_arc)


_register()
