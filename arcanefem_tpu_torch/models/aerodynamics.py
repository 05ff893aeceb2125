"""Aerodynamics: potential flow Δu = 0 around an airfoil.

The counterpart of ``arcanefem_tpu/models/aerodynamics.py`` (reference
modules/aerodynamics): the Laplace operator, the "farfield" condition that
pins its boundary nodes at u = y − angle·x by penalty (FemModule.cc:200-210),
Dirichlet conditions elsewhere (the airfoil), and the derived per-cell
ψ = −(u_x² + u_y²) (FemModule.cc:129-141).

The system lives on ``device`` (the card by default); u and ψ come back to
the host in the system's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions


@dataclass
class FarfieldBC:
    surface: str
    angle: float = 0.0


@dataclass
class AerodynamicsConfig:
    farfield: list[FarfieldBC] = field(default_factory=list)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    penalty: float = 1.0e30
    solver: SolverOptions = field(default_factory=SolverOptions)


@dataclass
class AerodynamicsResult:
    u: np.ndarray  # (n_nodes,) potential, in the system's dtype
    psi: dict  # cell type -> (nc,) −|∇u|²
    iterations: int
    residual: float
    problem: FemProblem
    info: dict = field(default_factory=dict, repr=False)  # the solver's


def apply_boundary_conditions(prob: FemProblem, system, config: AerodynamicsConfig) -> None:
    """The farfield rows (u = y − angle·x by penalty) and the Dirichlet
    conditions of ``config`` on ``system``, a LinearSystem of ``prob``."""
    np_dtype = numpy_dtype(prob.dtype)
    mesh = prob.mesh
    pen = dtype_safe_penalty(config.penalty, np_dtype)
    for ff in config.farfield:
        nodes = mesh.group_nodes(ff.surface)
        vals = (mesh.coords[nodes, 1] - ff.angle * mesh.coords[nodes, 0]).astype(np_dtype)
        prob.apply_dirichlet(system, prob.dof_ids(nodes), vals, "Penalty", pen)
    for bc in config.bcs.dirichlet:
        prob.apply_dirichlet(
            system, prob.group_dofs(bc.surface), bc.value, bc.method,
            dtype_safe_penalty(bc.penalty, np_dtype),
        )


def solve(mesh: Mesh, config: AerodynamicsConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> AerodynamicsResult:
    timer = timer or PhaseTimer(verbose=False)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        apply_boundary_conditions(prob, system, config)

    with timer.phase("solve-linear-system"):
        x, info = system.solve()

    with timer.phase("update-variables"):
        u = prob.node_values(x)[:, 0]
        x = x.to(prob.dtype)
        psi = {}
        for ct, conn in mesh.cells.items():
            grads = elements.gradients(ct, prob.cell_xyz(ct))
            un = x[prob._index(conn)]
            comps = [torch.sum(g * un, dim=1) for g in grads]
            psi[ct] = -sum(c * c for c in comps).cpu().numpy()

    return AerodynamicsResult(
        u=u, psi=psi, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob, info=info,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    farfield = [
        FarfieldBC(
            surface=opt_text(ff, "surface"),
            angle=opt_float(ff, "angle", 0.0),
        )
        for ff in case.fem.findall("farfield-boundary-condition")
    ]
    bcs = BoundaryConditions()
    for d in case.fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                value=opt_float(d, "value", 0.0),
            )
        )
    cfg = AerodynamicsConfig(
        farfield=farfield,
        bcs=bcs,
        penalty=opt_float(case.fem, "penalty", 1.0e30),
        solver=case.solver,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Aerodynamics")(_run_arc)


_register()
