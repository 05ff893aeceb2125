"""Electrostatics: −Δφ = ρ/ε, then E = −∇φ per cell.

The counterpart of ``arcanefem_tpu/models/electrostatics.py`` (reference
modules/electrostatics): the Poisson solve for the potential with source
qdot = −ρ/ε (FemModule.cc:134-135), the shared BC service, then the
derived cell-wise electric field E = −∇φ over every cell bucket
(FemModule.cc:160-165).

The system lives on ``device`` (the card by default): assembly is
``slot_reduce``, every Krylov and AMG SpMV is ``sell_spmv``; φ and E come
back to the host in the system's dtype.
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
class ElectrostaticsConfig:
    rho: float = 0.0
    epsilon: float = 1.0
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4


@dataclass
class ElectrostaticsResult:
    phi: np.ndarray  # (n_nodes,) in the system's dtype
    E: dict  # cell type -> (nc, dim) field = −∇φ
    iterations: int
    residual: float
    problem: FemProblem
    info: dict = field(default_factory=dict, repr=False)  # the solver's


def solve(mesh: Mesh, config: ElectrostaticsConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> ElectrostaticsResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        if config.rho:
            system.rhs = prob.constant_source_rhs(-config.rho / config.epsilon)
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
        phi = prob.node_values(x)[:, 0]
        x = x.to(prob.dtype)
        E = {}
        for ct, conn in mesh.cells.items():
            grads = elements.gradients(ct, prob.cell_xyz(ct))  # (nc, npc) each
            pn = x[prob._index(conn)]  # (nc, npc)
            E[ct] = -torch.stack([torch.sum(g * pn, dim=1) for g in grads],
                                 dim=1).cpu().numpy()

    result = ElectrostaticsResult(
        phi=phi, E=E, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob, info=info,
    )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, phi, config.result_file, config.result_epsilon
            )
    return result


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float

    cfg = ElectrostaticsConfig(
        rho=opt_float(case.fem, "rho", 0.0),
        epsilon=opt_float(case.fem, "epsilon", 1.0),
        bcs=case.bcs,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Electrostatics")(_run_arc)


_register()
