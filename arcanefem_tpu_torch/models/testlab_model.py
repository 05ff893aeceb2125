"""Testlab case runner: Poisson physics with selectable assembly strategy.

The counterpart of ``arcanefem_tpu/models/testlab_model.py``.  Runs the
reference's modules/testlab .arc cases (codename "Testlab"): Poisson with a
format flag (<legacy>/<coo>/<coo-sorting>/<csr>/<nwcsr>/<blcsr>/<bsr>/
<bsr-atomic-free>/<coo-gpu>/..., testlab FemModule.cc:166-254) validated
against the same golden files.  The reference's GPU/CPU strategy pairs map
onto the lab's strategies (``arcanefem_tpu_torch/testlab.py``) as in the
JAX package:

    legacy, dok            -> bell-segsum   (default deterministic path)
    coo, coo-gpu           -> bell-scatter  (index_add_, the atomic analogue)
    coo-sorting, *-sort-*  -> bell-sorted   (pre-sorted entries)
    csr, csr-gpu, nwcsr,
    blcsr                  -> csr-segsum    (CSR value array + expansion)
    bsr, bsr-atomic-free   -> bell-segsum / bell-sorted (block path, ndof=1)

The system lives on ``device`` (the card by default), assembled into the
problem's own SELL layout.
"""

from __future__ import annotations

import numpy as np

from .. import testlab
from ..fem.bcs import dtype_safe_penalty
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results

_FLAG_TO_FORMAT = {
    "legacy": "bell-segsum",
    "dok": "bell-segsum",
    "coo": "bell-scatter",
    "coo-gpu": "bell-scatter",
    "coo-sorting": "bell-sorted",
    "coo-sort-gpu": "bell-sorted",
    "csr": "csr-segsum",
    "csr-gpu": "csr-segsum",
    "nwcsr": "csr-segsum",
    "blcsr": "csr-segsum",
    "bsr": "bell-segsum",
    "bsr-atomic-free": "bell-sorted",
}


def case_format(fem) -> str:
    """The lab format a case's ``<fem>`` block selects: the first flag of
    ``_FLAG_TO_FORMAT`` set to true, else ``bell-segsum``."""
    for flag, name in _FLAG_TO_FORMAT.items():
        el = fem.find(flag)
        if el is not None and (el.text or "true").strip().lower() == "true":
            return name
    return "bell-segsum"


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    from ..fem.arc import opt_float, opt_text

    fem = case.fem
    fmt = case_format(fem)
    timer = timer or PhaseTimer(verbose=False)
    prob = FemProblem(mesh, ndof=1, dtype=dtype, device=device)
    with timer.phase("lhs-matrix-assembly"):
        mats = testlab.element_matrices(mesh, prob.dtype, prob.device)
        A = testlab.FORMATS[fmt](prob.topo, mats, prob.dtype, prob.layout)

    system = prob.new_system(A, case.solver)
    with timer.phase("rhs-vector-assembly"):
        f = opt_float(fem, "f")
        if f is not None:
            system.rhs = prob.constant_source_rhs(f)
        for nb in fem.findall("neumann-boundary-condition"):
            vx, vy = opt_float(nb, "valueX"), opt_float(nb, "valueY")
            v = opt_float(nb, "value")
            if v is not None:
                system.rhs = prob.neumann_rhs(
                    system.rhs, opt_text(nb, "surface"), value=v
                )
            else:
                system.rhs = prob.neumann_rhs(
                    system.rhs, opt_text(nb, "surface"),
                    vector=(vx or 0.0, vy or 0.0, 0.0),
                )
        for d in fem.findall("dirichlet-boundary-condition"):
            prob.apply_dirichlet(
                system,
                prob.group_dofs(opt_text(d, "surface")),
                opt_float(d, "value", 0.0),
                opt_text(fem, "enforce-Dirichlet-method", "Penalty"),
                dtype_safe_penalty(opt_float(fem, "penalty", 1.0e30),
                                   numpy_dtype(prob.dtype)),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()

    from .poisson import PoissonResult

    u = prob.node_values(x)[:, 0]
    if check and case.result_file:
        check_node_results(mesh.node_uids, u, case.result_file, 1.0e-4)
    return PoissonResult(
        u=u, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob, info=info,
    )


def _register():
    from ..fem.runner import register

    register("Testlab")(_run_arc)


_register()
