"""Linear elasticity: K u = f with traction, body force and vector Dirichlet.

The counterpart of ``arcanefem_tpu/models/elasticity.py`` (reference
modules/elasticity): λ, 2μ from E, ν (FemModule.cc:130-134), the block
element matrices λ(div u)(div v) + 2μ ε(u):ε(v) on tria3 (plane strain, 2
dofs per node) and tetra4 (3 dofs), body force and traction RHS
(FemModule.cc:221-272) and every Dirichlet method (FemModule.cc:285-400).

The system lives on ``device`` (the card by default) as the scalar
expansion of its b×b blocks: assembly is one ``block_slot_reduce`` launch,
every Krylov, Jacobi and AMG SpMV is ``sell_spmv``.  RowElimination makes
the system nonsymmetric, so a cg solve becomes bicgstab; the Hypre route
(AMG) gets the rigid body modes as its near-nullspace.  Neither change
touches the caller's config.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.amg_setup import rigid_body_modes
from ..solver.linear_system import SolverOptions


@dataclass
class ElasticityConfig:
    E: float = 1.0
    nu: float = 0.3
    f: tuple = ()  # body force per component (None = absent)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-3  # reference epsilon (FemModule.cc:547)
    # noise floors of the cross-solver comparison (fem/validation.py)
    result_min_value: float = 1.0e-12
    result_min_value_rel: float = 2.0e-5


@dataclass
class ElasticityResult:
    u: np.ndarray  # (n_nodes, ndof) in the system's dtype
    iterations: int
    residual: float
    problem: FemProblem
    # the solver's info (true_residual, free_residual, precond_setup_s,
    # solve_s for the Krylov methods)
    info: dict = field(default_factory=dict, repr=False)


def lame(E: float, nu: float) -> tuple[float, float]:
    """(λ, 2μ) exactly as FemModule.cc:133-134."""
    mu2 = E / (2.0 * (1.0 + nu)) * 2.0
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu2


def element_blocks(cell_type: str, xyz: torch.Tensor, lam, mu2) -> torch.Tensor:
    if cell_type == "tria3":
        return elements.elasticity_tria3(xyz, lam, mu2)
    if cell_type == "tetra4":
        return elements.elasticity_tetra4(xyz, lam, mu2)
    raise ValueError(f"no elasticity kernel for '{cell_type}'")


def solve(
    mesh: Mesh,
    config: ElasticityConfig,
    dtype=torch.float64,
    timer: PhaseTimer | None = None,
    device: torch.device | str = "cuda",
) -> ElasticityResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    # the method switch and the mesh-sized nullspace below stay off the
    # caller's config
    config = replace(config, solver=replace(config.solver))
    ndof = 3 if mesh.dim == 3 else 2

    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype, device=device)
        prob.block_assembly  # the layout and contributor lists, once

    lam, mu2 = lame(config.E, config.nu)
    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(lambda ct, xyz: element_blocks(ct, xyz, lam, mu2))

    # RowElimination gives a nonsymmetric system; the reference's cases
    # select gmres/bicgstab for it
    methods = {bc.method for bc in config.bcs.dirichlet} | {
        bc.method for bc in config.bcs.dirichlet_point}
    if "RowElimination" in methods and config.solver.method == "cg":
        config.solver.method = "bicgstab"
    if config.solver.preconditioner == "amg" and config.solver.amg_nullspace is None:
        config.solver.amg_nullspace = rigid_body_modes(mesh.coords, prob.ndof)

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        if config.f:
            system.rhs = prob.vector_source_rhs(system.rhs, config.f)
        for tr in config.bcs.traction:
            system.rhs = prob.traction_rhs(system.rhs, tr.surface, tr.t)
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet_vector(
                system, mesh.group_nodes(bc.surface), bc.values or (),
                bc.method, dtype_safe_penalty(bc.penalty, np_dtype))
        for bc in config.bcs.dirichlet_point:
            prob.apply_dirichlet_vector(
                system, mesh.group_nodes(bc.node_group), bc.values or (),
                bc.method, dtype_safe_penalty(bc.penalty, np_dtype))

    with timer.phase("solve-linear-system"):
        x, info = system.solve()

    with timer.phase("update-variables"):
        u = prob.node_values(x)

    result = ElasticityResult(u=u, iterations=int(info["iterations"]),
                              residual=float(info["residual"]), problem=prob, info=info)
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, config.result_file,
                config.result_epsilon, min_value=config.result_min_value,
                min_value_rel=config.result_min_value_rel,
            )
    return result


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float, parse_bcs_vector, parse_null_vector

    cfg = ElasticityConfig(
        E=opt_float(case.fem, "E", 1.0),
        nu=opt_float(case.fem, "nu", 0.3),
        f=parse_null_vector(
            case.fem.findtext("f").strip() if case.fem.find("f") is not None else None),
        bcs=parse_bcs_vector(case.fem),
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Elasticity")(_run_arc)


_register()
