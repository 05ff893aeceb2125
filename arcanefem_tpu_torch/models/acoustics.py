"""Acoustics (Helmholtz): (k/c)²u + Δu = 0 in weak form.

The counterpart of ``arcanefem_tpu/models/acoustics.py`` (reference
modules/acoustics): element matrix −∫∇u·∇v + kc2·∫uv (FemModule.cc:143-155),
Neumann forcing on the radiating surface.  The system is symmetric
indefinite: the dense back end (the reference's SequentialBasicLinearSystem
choice in sub.arc) or BiCGStab without a preconditioner.

The system lives on ``device`` (the card by default); u comes back to the
host in the system's dtype.
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
class AcousticsConfig:
    kc2: float = 1.0
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4


@dataclass
class AcousticsResult:
    u: np.ndarray  # (n_nodes,) in the system's dtype
    iterations: int
    residual: float
    problem: FemProblem
    info: dict = field(default_factory=dict, repr=False)  # the solver's


def solve(mesh: Mesh, config: AcousticsConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> AcousticsResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(
            lambda ct, xyz: -elements.stiffness(ct, xyz)
            + config.kc2 * elements.mass(ct, xyz)
        )

    if config.solver.method != "dense":
        # Helmholtz matrices are indefinite: CG is not applicable and the
        # (sign-flipping) Jacobi preconditioner breaks BiCGStab
        config.solver.method = "bicgstab"
        config.solver.preconditioner = "none"

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        for nm in config.bcs.neumann:
            if nm.value is not None:
                system.rhs = prob.neumann_rhs(system.rhs, nm.surface, value=nm.value)
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet(
                system, prob.group_dofs(bc.surface), bc.value, bc.method,
                dtype_safe_penalty(bc.penalty, np_dtype),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()

    with timer.phase("update-variables"):
        u = prob.node_values(x)[:, 0]
    result = AcousticsResult(
        u=u, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob, info=info,
    )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, config.result_file, config.result_epsilon
            )
    return result


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float

    cfg = AcousticsConfig(
        kc2=opt_float(case.fem, "kc2", 1.0),
        bcs=case.bcs,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Acoustics")(_run_arc)


_register()
