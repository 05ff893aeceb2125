"""Frozen boundary conditions for transient loops.

The port's copy of ``arcanefem_tpu/fem/transient.py``.  The reference
rebuilds matrix and boundary conditions every time step (elastodynamics
FemModule.cc:144-158); here the BC-modified matrix is finalized once, and
each step's freshly built RHS gets the same treatment:

* penalty rows are overridden with P·g,
* Row/RowColumn-eliminated rows take their fixed value,
* the RowColumn correction (rhs_i -= A_ij·g_j, AlephDoFLinearSystem.cc:
  540-565), captured once by finalizing against the BC-only RHS, is
  re-added.

The masks and vectors live on the system's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..solver.linear_system import LinearSystem
from ..sparse.bell import BellMatrix


@dataclass
class FrozenBC:
    A: BellMatrix  # BC-finalized matrix
    pen_mask: torch.Tensor
    pen_val: torch.Tensor
    elim_mask: torch.Tensor
    elim_rhs: torch.Tensor
    rhs_corr: torch.Tensor

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        """Per-step RHS treatment."""
        rhs = torch.where(self.pen_mask, self.pen_val, rhs + self.rhs_corr)
        return torch.where(self.elim_mask, self.elim_rhs, rhs)

    @property
    def dirichlet_values(self) -> torch.Tensor:
        """g on constrained rows, 0 elsewhere (pen_val is P·g)."""
        d = self.A.diagonal()
        g_pen = torch.where(
            self.pen_mask, self.pen_val / torch.where(d == 0, 1.0, d), 0.0)
        return torch.where(self.elim_mask, self.elim_rhs, g_pen)

    def warm_start(self, x: torch.Tensor) -> torch.Tensor:
        """Solver initial guess: the state with constrained rows snapped to
        their imposed values, so that penalty rows (scale P·|g−x|) do not
        dominate the first residuals and stop the relative test early."""
        return torch.where(self.pen_mask | self.elim_mask, self.dirichlet_values, x)


def anchor_atol(A: BellMatrix, M, rhs: torch.Tensor, x0: torch.Tensor,
                rtol: float, method: str = "pcg") -> float:
    """Absolute tolerance anchored at a step's initial residual, in the norm
    the solver monitors: ``rtol * ||b - A x0||_C`` (the preconditioned
    norm) for pcg/bicgstab and ``rtol * ||b - A x0||_2`` for gmres.

    Transient loops warm-start every step, so the relative criterion
    degenerates when a late step is already converged; this anchor,
    computed at the first step and passed as later steps'
    ``SolverOptions.atol``, gives every step step one's absolute accuracy.
    """
    r0 = rhs - A.spmv(x0)
    if method == "gmres":
        return float(rtol) * float(torch.sqrt(torch.abs(torch.dot(r0, r0))))
    z0 = M.apply(r0)
    return float(rtol) * float(torch.sqrt(torch.abs(torch.dot(r0, z0))))


def freeze_bcs(system: LinearSystem) -> FrozenBC:
    """Finalize a system whose rhs holds only BC-written values (penalty
    P·g rows); capture the masks for per-step application."""
    A_bc, rhs_bc0 = system.finalized()
    n = A_bc.n_dofs
    dev = rhs_bc0.device
    elim = torch.zeros(n, dtype=torch.bool, device=dev)
    pen = torch.zeros(n, dtype=torch.bool, device=dev)
    for op in system.ops:
        (elim if op.kind in ("row", "rowcol") else pen)[op.dofs] = True
    # rhs_bc0 on penalty rows = P·g (written by apply_dirichlet); on
    # eliminated rows = g; elsewhere = the RowColumn correction
    return FrozenBC(
        A=A_bc,
        pen_mask=pen,
        pen_val=torch.where(pen, rhs_bc0, 0.0),
        elim_mask=elim,
        elim_rhs=torch.where(elim, rhs_bc0, 0.0),
        rhs_corr=torch.where(elim | pen, 0.0, rhs_bc0),
    )


def free_residual(A: BellMatrix, rhs: torch.Tensor, x: torch.Tensor,
                  constrained: torch.Tensor) -> float:
    """||(rhs − A x)_free|| / ||rhs_free|| in float64 over the rows the
    boolean mask ``constrained`` leaves free (absolute where rhs_free is
    0): a step's true free-row residual, as ``LinearSystem.solve`` reports
    it."""
    vals = A.values if A.values.dtype == torch.float64 else A.values.double()
    r = rhs.double() - A.with_values(vals).spmv(x.double())
    free = ~constrained
    bn = torch.linalg.vector_norm(rhs.double()[free])
    return float(torch.linalg.vector_norm(r[free]) / (bn if bn > 0 else 1.0))
