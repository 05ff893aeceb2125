"""Bilaplacian via the mixed two-field formulation.

The counterpart of ``arcanefem_tpu/models/bilaplacian.py`` (reference
modules/bilaplacian): 2 DoFs per node (u1, u2), the 6×6 element matrix
(FemModule.cc:398-545) in the block form

    K(i,j) = [[ 0     S_ij ],
              [ S_ij  M_ij ]]

with S the P1 stiffness and M the P1 mass matrix.  Source f and Dirichlet
values act on the u1 component only (FemModule.cc:246,344).  The system
is symmetric indefinite with a zero (u1,u1) block, so it is solved dense
(``torch.linalg.solve`` of ``BellMatrix.todense``), as the reference's
cases and the JAX model do; assembly is one ``block_slot_reduce`` launch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions


def element_blocks(cell_type: str, xyz: torch.Tensor) -> torch.Tensor:
    S = elements.stiffness(cell_type, xyz)  # (nc, npc, npc)
    M = elements.mass(cell_type, xyz)
    Z = torch.zeros_like(S)
    return torch.stack(
        [torch.stack([Z, S], dim=-1), torch.stack([S, M], dim=-1)], dim=-2
    )  # (nc, npc, npc, 2, 2)


@dataclass
class BilaplacianConfig:
    f: float | None = None
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)


@dataclass
class BilaplacianResult:
    u1: np.ndarray
    u2: np.ndarray
    iterations: int
    residual: float
    problem: FemProblem


def solve(mesh: Mesh, config: BilaplacianConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> BilaplacianResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=2, dtype=dtype, device=device)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(element_blocks)

    # CG/Jacobi do not apply to the indefinite system with its zero (u1,u1)
    # block and BiCGStab breaks down on it: the reference runs this module
    # through its dense sequential backend only, and so does JAX
    system = prob.new_system(A, dataclasses.replace(config.solver, method="dense"))
    with timer.phase("rhs-vector-assembly"):
        if config.f is not None:
            rhs = torch.zeros(prob.n_dofs, dtype=prob.dtype, device=prob.device)
            system.rhs = prob.vector_source_rhs(rhs, (config.f, None))
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet(
                system, prob.group_dofs(bc.surface, comp=0), bc.value,
                bc.method, dtype_safe_penalty(bc.penalty, np_dtype),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()

    uv = prob.node_values(x)
    return BilaplacianResult(
        u1=uv[:, 0], u2=uv[:, 1],
        iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    bcs = BoundaryConditions()
    for d in case.fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                value=opt_float(d, "value", 0.0),
                method=opt_text(
                    case.fem, "enforce-Dirichlet-method",
                    opt_text(d, "enforce-Dirichlet-method", "Penalty"),
                ),
            )
        )
    cfg = BilaplacianConfig(f=opt_float(case.fem, "f"), bcs=bcs, solver=case.solver)
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Bilaplacian")(_run_arc)


_register()
