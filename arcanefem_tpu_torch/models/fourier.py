"""Fourier steady heat conduction: −∇·(λ∇T) = qdot.

The counterpart of ``arcanefem_tpu/models/fourier.py`` (reference
modules/fourier): per-region material λ (`<material-property><volume>..
<lambda>`, FemModule.cc:133-148), constant source qdot, Dirichlet/Neumann
through the shared BC service, and manufactured solutions.  The reference
wires manufactured functions through C# user code and IStandardFunction
(ExternalFunctions.cs:30-38, FemModule.cc:35-55); here they are Python
callables of torch tensors, with the reference's sample functions
available by name.

The system lives on ``device`` (the card by default); T comes back to the
host in the system's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, ManufacturedSolution, dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype, row_ids
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions
from .poisson import _all_boundary_nodes, _manufactured_source_rhs


def make_standard_functions(lam: float):
    """The reference's C# sample functions (ExternalFunctions.cs:30-38):
    manufacturedDirichlet(λ, p) = λ(sin x + cos y), same for the source."""

    def fn(x, y, z):
        return lam * (torch.sin(x) + torch.cos(y))

    return {"manufacturedDirichlet": fn, "manufacturedSource": fn}


@dataclass
class FourierConfig:
    lam: float = 1.0  # <lambda>
    qdot: float | None = None
    materials: list[tuple[str, float]] = field(default_factory=list)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4


@dataclass
class FourierResult:
    u: np.ndarray  # (n_nodes,) in the system's dtype
    iterations: int
    residual: float
    problem: FemProblem
    info: dict = field(default_factory=dict, repr=False)  # the solver's


def solve(mesh: Mesh, config: FourierConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> FourierResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)

    # per-cell λ: default then per-region override (FemModule.cc:133-148)
    cell_lambda = {
        ct: np.full(conn.shape[0], config.lam, np_dtype)
        for ct, conn in mesh.cells.items()
    }
    for region, lam in config.materials:
        for ct, sel in mesh.cell_groups.get(region, {}).items():
            # cell_groups store connectivity; match rows against the bucket
            cell_lambda[ct][_rows_in_bucket(mesh.cells[ct], sel)] = lam

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(
            lambda ct, xyz: torch.as_tensor(cell_lambda[ct], device=prob.device)[:, None, None]
            * elements.stiffness(ct, xyz)
        )

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        if config.qdot is not None:
            system.rhs = prob.constant_source_rhs(config.qdot)
        for nm in config.bcs.neumann:
            if nm.value is not None:
                system.rhs = prob.neumann_rhs(system.rhs, nm.surface, value=nm.value)
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet(
                system, prob.group_dofs(bc.surface), bc.value, bc.method,
                dtype_safe_penalty(bc.penalty, np_dtype),
            )
        ms = config.bcs.manufactured
        if ms is not None:
            if ms.source is not None:
                system.rhs = system.rhs + _manufactured_source_rhs(prob, ms.source)
            if ms.dirichlet is not None:
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
    result = FourierResult(
        u=u, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob, info=info,
    )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, config.result_file, config.result_epsilon
            )
    return result


def _rows_in_bucket(bucket: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """Indices of the ``sel`` connectivity rows inside the full bucket.

    The JAX loop builds a dict from each bucket row to its index (the last
    one where rows repeat) and looks every ``sel`` row up in it, raising
    KeyError for a row the bucket lacks.  Here the same in numpy: the last
    bucket index per row id, for ids from one sort of 64-bit row hashes
    (a tetrahedron's four node numbers do not pack into one int64 key at
    the sphere's sizes, and ``row_ids``' lexsort of 22M such rows is about
    six times slower).  Every row is compared with the row its id maps to;
    where two different rows share a hash, the ids come from ``row_ids``."""
    sel = np.asarray(sel, dtype=bucket.dtype).reshape(-1, bucket.shape[1])
    nb = len(bucket)
    both = np.concatenate([bucket, sel])
    last = _last_bucket_index(np.unique(_row_hash(both), return_inverse=True)[1], nb)
    idx = last[nb:]
    found = idx >= 0
    if not ((bucket[last[:nb]] == bucket).all()
            and (bucket[idx[found]] == sel[found]).all()):
        idx = _last_bucket_index(row_ids(both), nb)[nb:]
    if (idx < 0).any():
        raise KeyError(f"{int((idx < 0).sum())} group rows are not cells of the bucket")
    return idx


def _row_hash(rows: np.ndarray) -> np.ndarray:
    """A 64-bit FNV-1a-style hash of each integer row (uint64, wrapping)."""
    h = np.full(len(rows), 0xCBF29CE484222325, np.uint64)
    for c in range(rows.shape[1]):
        h ^= rows[:, c].astype(np.uint64)
        h *= np.uint64(0x100000001B3)
        h ^= h >> np.uint64(29)
    return h


def _last_bucket_index(inv: np.ndarray, nb: int) -> np.ndarray:
    """For every row of ids ``inv`` (the bucket's nb rows first), the last
    bucket index whose row has the same id, else -1."""
    inv = inv.reshape(-1)
    last = np.full(int(inv.max(initial=-1)) + 1, -1, np.int64)
    np.maximum.at(last, inv[:nb], np.arange(nb))
    return last[inv]


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float, opt_text

    lam = opt_float(case.fem, "lambda", 1.0)
    materials = []
    for mp in case.fem.findall("material-property"):
        materials.append(
            (opt_text(mp, "volume"), opt_float(mp, "lambda", lam))
        )
    bcs = case.bcs
    # manufactured-solution block with named standard functions
    bce = case.fem.find("boundary-conditions")
    if bce is not None:
        msel = bce.find("manufactured-solution")
        if msel is not None:
            fns = make_standard_functions(lam)
            md = msel.find("manufactured-dirichlet")
            msrc = msel.find("manufactured-source")
            bcs.manufactured = ManufacturedSolution(
                dirichlet=fns[md.get("function")] if md is not None else None,
                source=fns[msrc.get("function")] if msrc is not None else None,
                method=opt_text(msel, "enforce-Dirichlet-method", "Penalty"),
                penalty=opt_float(msel, "penalty", 1.0e30),
            )
    cfg = FourierConfig(
        lam=lam,
        qdot=opt_float(case.fem, "qdot"),
        materials=materials,
        bcs=bcs,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Fourier")(_run_arc)


_register()
