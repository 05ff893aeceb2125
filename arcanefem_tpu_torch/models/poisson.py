"""Poisson solver: −Δu = f with Dirichlet/Neumann/point BCs.

The counterpart of ``arcanefem_tpu/models/poisson.py`` (reference
modules/poisson, FemModule.cc:100-117 _doStationarySolve): P1 triangles /
tetrahedra, element matrix area·(∇x⊗∇x + ∇y⊗∇y[+∇z⊗∇z])
(FemModule.h:126-186), constant volume source, penalty Dirichlet by
default, CG solve.  It also covers the `laplace` module (the same solver
with f absent).

The system lives on ``device`` (the card by default): assembly is
``slot_reduce``, every CG, AMG and Chebyshev SpMV is ``sell_spmv``.  The
solution comes back to the host in the system's dtype, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions


@dataclass
class PoissonConfig:
    f: float | None = None
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4


@dataclass
class PoissonResult:
    u: np.ndarray  # (n_nodes,) in the system's dtype
    iterations: int
    residual: float
    problem: FemProblem
    # the solver's info: iterations, residual, true_residual, free_residual
    # and, for CG, precond_setup_s and solve_s (not printed by the CLI,
    # which prints the int, float and str fields)
    info: dict = field(default_factory=dict, repr=False)


def solve(
    mesh: Mesh,
    config: PoissonConfig,
    dtype=torch.float64,
    timer: PhaseTimer | None = None,
    device: torch.device | str = "cuda",
) -> PoissonResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)

    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))

    system = prob.new_system(A, config.solver)

    with timer.phase("rhs-vector-assembly"):
        if config.f is not None:
            system.rhs = prob.constant_source_rhs(config.f)
        for nm in config.bcs.neumann:
            if nm.value is not None:
                system.rhs = prob.neumann_rhs(system.rhs, nm.surface, value=nm.value)
            else:
                system.rhs = prob.neumann_rhs(
                    system.rhs, nm.surface, vector=nm.vector()
                )
        ms = config.bcs.manufactured
        if ms is not None and ms.source is not None:
            system.rhs = system.rhs + _manufactured_source_rhs(prob, ms.source)

        for bc in config.bcs.dirichlet:
            dofs = prob.group_dofs(bc.surface)
            prob.apply_dirichlet(
                system, dofs, bc.value, bc.method,
                dtype_safe_penalty(bc.penalty, np_dtype),
            )
        for bc in config.bcs.dirichlet_point:
            dofs = prob.group_dofs(bc.node_group)
            prob.apply_dirichlet(
                system, dofs, bc.value, bc.method,
                dtype_safe_penalty(bc.penalty, np_dtype),
            )
        if ms is not None and ms.dirichlet is not None:
            # all exterior boundary nodes get the manufactured value
            bnodes = _all_boundary_nodes(prob)
            xyz = torch.as_tensor(mesh.coords[bnodes], device=prob.device)
            vals = ms.dirichlet(xyz[:, 0], xyz[:, 1], xyz[:, 2])
            prob.apply_dirichlet(
                system, prob.dof_ids(bnodes), vals, ms.method,
                dtype_safe_penalty(ms.penalty, np_dtype),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()

    with timer.phase("update-variables"):
        u = prob.node_values(x)[:, 0]

    result = PoissonResult(
        u=u,
        iterations=int(info["iterations"]),
        residual=float(info["residual"]),
        problem=prob,
        info=info,
    )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, config.result_file, config.result_epsilon
            )
    return result


def _manufactured_source_rhs(prob: FemProblem, source_fn) -> torch.Tensor:
    """applyManufacturedSourceToRhs (ArcaneFemFunctions.h:1030-1053):
    rhs[node] += f(barycenter) * measure / npc."""
    parts = []
    for ctype, conn in prob.mesh.cells.items():
        xyz = prob.cell_xyz(ctype)
        meas = elements.measure(ctype, xyz)
        bc = torch.mean(xyz, dim=1)
        f = source_fn(bc[:, 0], bc[:, 1], bc[:, 2])
        npc = conn.shape[1]
        parts.append(torch.repeat_interleave(f * meas / npc, npc))
    return prob.cell_sum(0)(torch.cat(parts))  # a fixed-order sum (fem/problem.py)


def _all_boundary_nodes(prob: FemProblem) -> np.ndarray:
    faces = prob.mesh.boundary_faces()
    return np.unique(np.concatenate([c.ravel() for c in faces.values()]))


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float

    cfg = PoissonConfig(
        f=opt_float(case.fem, "f"),
        bcs=case.bcs,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Poisson")(_run_arc)
    register("Laplace")(_run_arc)  # modules/laplace: same solver, f absent


_register()
