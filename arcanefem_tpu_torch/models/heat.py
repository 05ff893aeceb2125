"""Transient heat conduction: ∂T/∂t − λΔT = qdot, implicit Euler.

The counterpart of ``arcanefem_tpu/models/heat.py`` (reference
modules/heat): element matrix λS + M/dt (FemModule.cc:679-770), the
convection boundary matrix h·(edge mass) (FemModule.cc:629-673), a
per-step RHS with the *lumped* T_old/dt (FemModule.cc:487-493) or, with
``mass_rhs="consistent"``, M·T_old/dt, the convection flux h·Text·L/2 and
the Neumann flux, and the time loop until t ≥ tmax (FemModule.cc:114-119).

As in JAX, the matrix is assembled (one ``slot_reduce`` launch, the
convection faces one more through ``add_face_matrix``) and BC-finalized
once (``fem/transient.py``), and each step rebuilds only the RHS and
solves with the preconditioner built once, its absolute tolerance anchored
at step one's initial residual.  The manufactured source (a callable
``qdot(x, y, z, t)``, at cell barycenters) is summed each step by a
``SlotSum`` whose lists are built once; the lumped nodal measure is host
numpy, as in JAX.  ``T0`` restarts a run from a saved field
(``fem/checkpoint.py``); ``keep_history`` keeps a (t, T) snapshot per
step, which ``run_case(output_dir=...)`` writes as one temporal VTKHDF
file.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..fem.transient import anchor_atol, free_residual, freeze_bcs
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.iterative import make_precond
from ..solver.linear_system import SolverOptions, solve_finalized


@dataclass
class ConvectionBC:
    surface: str
    h: float
    Text: float


@dataclass
class HeatConfig:
    lam: float = 1.0
    # constant source, or a manufactured source q(x, y, z, t) at cell
    # barycenters each step (torch tensors in, a tensor out)
    qdot: float | object | None = None
    Tinit: float = 0.0
    dt: float = 0.1
    tmax: float = 1.0
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    convection: list[ConvectionBC] = field(default_factory=list)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4
    # "lumped" mirrors the reference's RHS (lumped T_old/dt against a
    # consistent M/dt in the LHS); "consistent" uses M·T_old/dt
    mass_rhs: str = "lumped"


@dataclass
class HeatResult:
    T: np.ndarray  # final temperature (host, the system's dtype)
    history: list  # [(t, T) snapshots], empty unless keep_history
    steps: int
    problem: FemProblem
    flux: dict = None  # cell type -> (nc, dim) heat flux −λ∇T
    # Krylov iterations over every step's solve, and each step's
    iterations: int = 0
    step_iterations: list = field(default_factory=list)
    residual: float = 0.0  # the last step's monitored residual
    solve_s: float = 0.0  # the steps' solve seconds (the card synchronised)
    info: dict = field(default_factory=dict)  # the last step's solver info


def solve(mesh: Mesh, config: HeatConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None, keep_history: bool = False,
          T0: np.ndarray | None = None,
          device: torch.device | str = "cuda") -> HeatResult:
    """T0: optional restart temperature field (fem/checkpoint.py)."""
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)
        prob.layout  # the SELL layout, once

    dt = config.dt
    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(
            lambda ct, xyz: config.lam * elements.stiffness(ct, xyz)
            + elements.mass(ct, xyz) / dt
        )
        for cv in config.convection:
            A = prob.add_face_matrix(
                A, cv.surface,
                lambda ft, xyz, h=cv.h: h * elements.edge2_mass(xyz),
            )

    system = prob.new_system(A, config.solver)
    for bc in config.bcs.dirichlet:
        pen = dtype_safe_penalty(bc.penalty, np_dtype)
        prob.apply_dirichlet(system, prob.group_dofs(bc.surface), bc.value, bc.method, pen)
    fbc = freeze_bcs(system)
    A_bc = fbc.A
    M = make_precond(A_bc, config.solver.preconditioner)

    # constant RHS pieces: Neumann + convection h·Text (FemModule.cc:497-534)
    rhs_const = torch.zeros(prob.n_dofs, dtype=prob.dtype, device=prob.device)
    for nm in config.bcs.neumann:
        if nm.value is not None:
            rhs_const = prob.neumann_rhs(rhs_const, nm.surface, value=nm.value)
    for cv in config.convection:
        rhs_const = prob.neumann_rhs(rhs_const, cv.surface, value=cv.h * cv.Text)
    qdot_fn = config.qdot if callable(config.qdot) else None
    if config.qdot is not None and qdot_fn is None:
        rhs_const = rhs_const + prob.constant_source_rhs(config.qdot)

    # time-independent source-quadrature data, hoisted out of the loop
    src_cells = []
    if qdot_fn is not None:
        for ct, conn in mesh.cells.items():
            xyz = prob.cell_xyz(ct)
            meas = elements.measure(ct, xyz)
            bc3 = torch.mean(xyz, dim=1)  # (nc, 3)
            npc = conn.shape[1]
            src_cells.append((bc3[:, 0], bc3[:, 1], bc3[:, 2], meas / npc, npc))
        src_sum = prob.cell_sum(0)

    def _source_rhs_at(t_eval):
        """Manufactured source at barycenters: rhs[node] += q(bc, t)·meas/npc
        (applyManufacturedSourceToRhs, ArcaneFemFunctions.h:1030-1053)."""
        return src_sum(torch.cat([torch.repeat_interleave(qdot_fn(x, y, z, t_eval) * w, npc)
                                  for x, y, z, w, npc in src_cells]))

    Mmat = None
    lumped = None
    if config.mass_rhs == "consistent":
        Mmat = prob.assemble_matrix(lambda ct, xyz: elements.mass(ct, xyz))
    elif config.mass_rhs == "lumped":
        # lumped nodal measure: rhs += T_old/dt · (sum of cell measure/npc)
        lnp = np.zeros(prob.n_dofs, np.float64)
        for ct, conn in mesh.cells.items():
            meas = elements.measure(ct, prob.cell_xyz(ct)).cpu().numpy()
            npc = conn.shape[1]
            np.add.at(lnp, conn.reshape(-1), np.repeat(meas / npc, npc))
        lumped = torch.as_tensor(lnp.astype(np_dtype), device=prob.device)
    else:
        raise ValueError(f"mass_rhs must be lumped|consistent, "
                         f"got {config.mass_rhs!r}")

    if T0 is not None:
        T = torch.as_tensor(np.asarray(T0).reshape(-1).astype(np_dtype), device=prob.device)
    else:
        T = torch.full((prob.n_dofs,), config.Tinit, dtype=prob.dtype, device=prob.device)
    t = 0.0
    steps = 0
    history = []
    step_iters = []
    solve_s = 0.0
    info = {}
    with timer.phase("time-loop"):
        while t < config.tmax:
            old_mass = lumped * T if Mmat is None else Mmat.spmv(T)
            step_rhs = rhs_const + old_mass / dt
            if qdot_fn is not None:
                # implicit Euler: the source is taken at the NEW time level
                step_rhs = step_rhs + _source_rhs_at(t + dt)
            rhs = fbc.apply(step_rhs)
            x0 = fbc.warm_start(T)
            if steps == 0:
                # later steps' absolute tolerance anchored at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(
                    config.solver,
                    atol=max(config.solver.atol,
                             anchor_atol(A_bc, M, rhs, x0, config.solver.rtol,
                                         method=config.solver.method)),
                )
            T, info = solve_finalized(A_bc, rhs, opts, x0=x0, precond=M)
            T = T.to(prob.dtype)
            step_iters.append(int(info["iterations"]))
            solve_s += info.get("solve_s", 0.0)
            t += dt
            steps += 1
            if keep_history:
                history.append((t, T.cpu().numpy()))
    if steps:
        info["free_residual"] = free_residual(A_bc, rhs, T, fbc.pen_mask | fbc.elim_mask)

    Tf = prob.node_values(T)[:, 0]
    with timer.phase("update-variables"):
        flux = {}
        for ct, conn in mesh.cells.items():
            grads = elements.gradients(ct, prob.cell_xyz(ct))
            Tn = T[prob._index(conn)]  # (nc, npc)
            flux[ct] = -config.lam * np.stack(
                [torch.sum(g * Tn, dim=1).cpu().numpy() for g in grads], axis=1)
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(mesh.node_uids, Tf, config.result_file, config.result_epsilon)
    return HeatResult(T=Tf, history=history, steps=steps, problem=prob, flux=flux,
                      iterations=sum(step_iters), step_iterations=step_iters,
                      residual=float(info.get("residual", 0.0)), solve_s=solve_s, info=info)


def parse_config(case, check: bool = True) -> HeatConfig:
    """The .arc fields of the heat module: <lambda>, <qdot>, <Tinit>,
    <dt>, <tmax>, Dirichlet and convection conditions."""
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    bcs = BoundaryConditions()
    method = opt_text(case.fem, "enforce-Dirichlet-method", "Penalty")
    for d in case.fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                value=opt_float(d, "value", 0.0),
                method=opt_text(d, "enforce-Dirichlet-method", method),
                penalty=opt_float(case.fem, "penalty", 1.0e30),
            )
        )
    convection = [
        ConvectionBC(
            surface=opt_text(c, "surface"),
            h=opt_float(c, "h", 1.0),
            Text=opt_float(c, "Text", 0.0),
        )
        for c in case.fem.findall("convection-boundary-condition")
    ]
    return HeatConfig(
        lam=opt_float(case.fem, "lambda", 1.0),
        qdot=opt_float(case.fem, "qdot"),
        Tinit=opt_float(case.fem, "Tinit", 0.0),
        dt=opt_float(case.fem, "dt", 0.1),
        tmax=opt_float(case.fem, "tmax", 1.0),
        bcs=bcs,
        convection=convection,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             keep_history: bool = False, device="cuda"):
    return solve(mesh, parse_config(case, check), dtype=dtype, timer=timer,
                 keep_history=keep_history, device=device)


def _register():
    from ..fem.runner import register

    register("Heat")(_run_arc)


_register()
