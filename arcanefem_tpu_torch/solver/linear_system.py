"""Linear-system facade with deferred boundary-condition semantics.

The counterpart of ``arcanefem_tpu/solver/linear_system.py`` (the
reference's ``DoFLinearSystem``, femutils/DoFLinearSystem.h:126-286) for
the port's ``BellMatrix`` in SELL storage.  A block matrix is stored as
its scalar expansion on dof rows (``sparse/bell.py``), so every operation
below works on dofs whatever the block size, and gives what the JAX
block masks give: an eliminated dof's row and column cleared and its
diagonal entry 1, a forced dof's diagonal entry set.  The deferred
semantics are the same:

* ``set_forced_diag(dofs, values)`` == matrixSetValue on the diagonal: it
  overrides any accumulated adds at solve time (the penalty method); it
  writes through the matrix's ``diag_slot``;
* ``eliminate_row(dofs, values)`` == ELIMINATE_ROW: row := e_i, rhs := g;
  each SELL slot's row is ``layout.slot_rows``;
* ``eliminate_row_col(dofs, values)`` == ELIMINATE_ROW_COLUMN: also
  rhs_i -= A[i,j] g_j for every other row i (one ``BellMatrix.spmv``) and
  column j zeroed; each SELL slot's column is ``layout.cols``.

Everything is applied as masked elementwise operations over the SELL
slots in :func:`apply_bcs`.  Back ends (``SolverOptions.method``):
"dense" (``torch.linalg.solve`` of ``BellMatrix.todense``), and "cg",
"bicgstab", "bicgstab2" and "gmres" (``solver/iterative.py``) with the
preconditioner of ``make_precond``.
"""

from __future__ import annotations

import functools
import math
import os
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..sparse.bell import BellMatrix
from .iterative import bicgstab, bicgstab2, gmres, make_precond, pcg


@dataclass
class BCOp:
    """One deferred boundary-condition operation.

    kind: 'forced' | 'row' | 'rowcol'; dofs int64 (k,), values (k,), both
    on the matrix's device.  dofs are scalar-dof ids (node * block +
    component).
    """

    dofs: torch.Tensor
    values: torch.Tensor
    kind: str


def _dof_masks(n_dofs: int, ops: list[BCOp], kinds: tuple[str, ...], device):
    # the value dtype promotes only over the ops being masked, as in JAX
    sel = [o for o in ops if o.kind in kinds]
    dtype = (functools.reduce(torch.promote_types, [o.values.dtype for o in sel])
             if sel else torch.get_default_dtype())
    mask = torch.zeros(n_dofs, dtype=torch.bool, device=device)
    val = torch.zeros(n_dofs, dtype=dtype, device=device)
    for op in sel:
        mask[op.dofs] = True
        val[op.dofs] = op.values.to(dtype)
    return mask, val


def apply_bcs(A: BellMatrix, rhs: torch.Tensor,
              ops: list[BCOp]) -> tuple[BellMatrix, torch.Tensor]:
    """The (A, b) handed to the solver, in the JAX order: the row-column
    correction of the rhs with the unmodified A, then the eliminated rows
    and columns cleared with 1 on their diagonals and g in the rhs, then
    the forced diagonal values.  The rhs of a forced op is the caller's
    (the reference writes rhs = P·g when it applies the condition).  New
    tensors; A and rhs are left as they are."""
    n = A.n_dofs
    dev = A.values.device
    vals = A.values
    dtype = vals.dtype

    forced_mask, forced_val = _dof_masks(n, ops, ("forced",), dev)
    row_mask, row_val = _dof_masks(n, ops, ("row",), dev)
    rc_mask, rc_val = _dof_masks(n, ops, ("rowcol",), dev)

    any_forced = any(o.kind == "forced" for o in ops)
    any_row = any(o.kind == "row" for o in ops)
    any_rc = any(o.kind == "rowcol" for o in ops)

    if any_rc:
        # rhs_i -= A[i,j] * g_j over eliminated columns j
        g = torch.where(rc_mask, rc_val.to(dtype), 0.0)
        contrib = A.spmv(g)
        rhs = rhs - torch.where(rc_mask, 0.0, contrib)

    elim_mask = row_mask | rc_mask  # rows to clear
    elim_val = torch.where(rc_mask, rc_val, row_val)

    if any_row or any_rc:
        # each slot's row (n for the lanes past the last row, never masked)
        slot_mask = torch.cat([elim_mask, elim_mask.new_zeros(1)])
        vals = torch.where(slot_mask[A.layout.slot_rows(dev).long()], 0.0, vals)
        if any_rc:
            # a padding slot's column is its row's last real one; its value
            # is 0 whatever the mask says
            vals = torch.where(rc_mask[A.layout.cols.long()], 0.0, vals)
        dslot = A.diag_slot
        vals[dslot] = torch.where(elim_mask, 1.0, vals[dslot])
        rhs = torch.where(elim_mask, elim_val.to(rhs.dtype), rhs)

    if any_forced:
        if vals is A.values:
            vals = vals.clone()
        dslot = A.diag_slot
        vals[dslot] = torch.where(forced_mask, forced_val.to(dtype), vals[dslot])

    return A.with_values(vals), rhs


@dataclass
class SolverOptions:
    """Mirrors HypreDoFLinearSystemFactory.axl:4-13 defaults."""

    method: str = "cg"  # cg | bicgstab | bicgstab2 | gmres | dense
    rtol: float = 1.0e-7
    atol: float = 0.0
    max_iter: int = 1000
    gmres_restart: int = 30  # Krylov basis size for method="gmres"
    preconditioner: str = "jacobi"  # none | jacobi | block-jacobi | amg | poly
    precise_dot: bool = True  # compensated f32 dots (no-op for f64)
    # SpMV: "pallas" (the JAX name of its kernel route) is the hand-written
    # kernel of the matrix (K1, sell_spmv) on the card; "xla" is its plain
    # twin (BellMatrix(plain=True)) on any device.  The CPU runs the plain
    # twin either way.
    spmv: str = "pallas"
    # optional (n_dofs, m) near-nullspace handed to the AMG set-up (the
    # elasticity family's rigid body modes, solver/amg_setup.py::
    # rigid_body_modes); ignored by the other preconditioners and by
    # scalar systems
    amg_nullspace: object = None
    # what to do when the iterative solve exhausts max_iter above rtol
    # (the Aleph stop_error_strategy role, AlephDoFLinearSystem.cc:360-362):
    # "dump" writes SolveErrorMatrix.npz + warns, "raise" additionally
    # raises, "ignore" skips the host-side check
    fail_action: str = "dump"


@dataclass
class LinearSystem:
    """Mutable facade used by the physics modules (DoFLinearSystem role)."""

    matrix: BellMatrix
    rhs: torch.Tensor
    ops: list[BCOp] = field(default_factory=list)
    options: SolverOptions = field(default_factory=SolverOptions)
    # Dirichlet (dofs, values) pairs for warm-starting the Krylov solve so
    # penalty-scaled rows start with zero error (see iterative.pcg)
    guesses: list[tuple[np.ndarray, torch.Tensor]] = field(default_factory=list)

    def _index(self, dofs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(dofs, np.int64), device=self.rhs.device)

    def _values(self, values) -> torch.Tensor:
        return torch.as_tensor(values, device=self.rhs.device)

    def add_guess(self, dofs, values) -> None:
        self.guesses.append((np.asarray(dofs), self._values(values)))

    def initial_guess(self, x0: torch.Tensor | None = None) -> torch.Tensor:
        x = x0.clone() if x0 is not None else torch.zeros_like(self.rhs)
        for dofs, vals in self.guesses:
            x[self._index(dofs)] = vals.to(x.dtype)
        return x

    # -- BC entry points (deferred) -----------------------------------------
    def set_forced_diag(self, dofs, values) -> None:
        self.ops.append(BCOp(self._index(dofs), self._values(values), "forced"))

    def eliminate_row(self, dofs, values) -> None:
        self.ops.append(BCOp(self._index(dofs), self._values(values), "row"))

    def eliminate_row_col(self, dofs, values) -> None:
        self.ops.append(BCOp(self._index(dofs), self._values(values), "rowcol"))

    def set_rhs(self, dofs, values) -> None:
        self.rhs = self.rhs.index_put(
            (self._index(dofs),),
            self._values(values).to(self.rhs.dtype).expand(len(dofs)))

    # -- solve ----------------------------------------------------------------
    def finalized(self) -> tuple[BellMatrix, torch.Tensor]:
        return apply_bcs(self.matrix, self.rhs, self.ops)

    def solve(self, x0: torch.Tensor | None = None):
        """(x, info) of the finalized system; besides ``solve_finalized``'s
        keys, ``info["free_residual"]`` is ||(b − A x)_free|| / ||b_free||
        in float64 over the rows that no Dirichlet value touches (absolute
        where b_free is 0)."""
        A, b = self.finalized()
        x, info = solve_finalized(A, b, self.options, self.initial_guess(x0))
        free = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
        for dofs, _ in self.guesses:
            free[self._index(dofs)] = False
        r = b.double() - _float64(A).spmv(x.double())
        bn = torch.linalg.vector_norm(b.double()[free])
        info["free_residual"] = float(torch.linalg.vector_norm(r[free])
                                      / (bn if bn > 0 else 1.0))
        return x, info


def _float64(A: BellMatrix) -> BellMatrix:
    return A if A.values.dtype == torch.float64 else A.with_values(A.values.double())


def solve_finalized(A: BellMatrix, b: torch.Tensor, options: SolverOptions,
                    x0: torch.Tensor | None = None, precond=None):
    """Dispatch on the back end; returns (x, info).  ``precond``: a
    preconditioner built earlier (a transient loop's, frozen with its
    matrix) in place of ``make_precond``'s; its set-up time is then 0.

    "dense": x in b's dtype and info {"iterations": 1, "residual": 0.0},
    as in JAX.  The Krylov methods: x (in float64 from "cg", whose ``pcg``
    accumulates the iterate in float64, in b's dtype from the others, as
    in JAX; the caller casts) and info with ``iterations``, ``residual``
    (the monitored residual), ``true_residual`` (||b − A x|| / ||b|| over
    all rows, in float64), ``precond_setup_s`` and ``solve_s`` (host
    clock of the preconditioner's set-up and of the iterations, the card
    synchronised), and with an AMG preconditioner ``amg_rows``, the rows
    of each level and of the coarse solve.  ``use_precise_dot`` is on in
    float32 only; the
    failure rule (``fail_action``) is JAX's max-iteration rule, and also
    takes a non-finite residual or x as a failure."""
    if options.spmv == "xla":
        A = A.with_values(A.values, plain=True)
    elif options.spmv != "pallas":
        raise ValueError(f"unknown spmv backend '{options.spmv}' "
                         "(pallas: the kernel, xla: its plain twin)")
    if options.method == "dense":
        x = torch.linalg.solve(A.todense(), b)
        return x, {"iterations": 1, "residual": 0.0}
    solvers = {"cg": pcg, "bicgstab": bicgstab, "bicgstab2": bicgstab2,
               "gmres": functools.partial(gmres, restart=options.gmres_restart)}
    if options.method not in solvers:
        raise ValueError(f"unknown solver method '{options.method}'")

    def clock() -> float:
        if b.is_cuda:
            torch.cuda.synchronize(b.device)
        return time.perf_counter()

    t0 = clock()
    M = precond if precond is not None else make_precond(
        A, options.preconditioner, nullspace=options.amg_nullspace)
    t1 = clock()
    # No operator swap: the JAX package solves f32 AMG systems with the
    # hierarchy's level-0 window-kernel operator in place of A (a TPU
    # layout with fewer padded slots); here level 0 is the same SELL
    # matrix as A, so A runs the Krylov SpMV itself, whatever the method.
    if x0 is None:
        x0 = torch.zeros_like(b)
    use_precise = options.precise_dot and b.dtype == torch.float32
    x, iters, res = solvers[options.method](
        A, b, M, x0, options.rtol, options.atol, options.max_iter,
        use_precise_dot=use_precise)
    t2 = clock()

    # true-residual report (Hypre monitors ||b-Ax||/||b|| for cold solves;
    # the Krylov methods here monitor a preconditioned norm): one SpMV more
    # per solve
    b64 = b.double()
    bn = torch.linalg.vector_norm(b64)
    true_res = float(torch.linalg.vector_norm(b64 - _float64(A).spmv(x.double()))
                     / (bn if bn > 0 else 1.0))
    info = {"iterations": iters, "residual": res, "true_residual": true_res,
            "precond_setup_s": t1 - t0, "solve_s": t2 - t1}
    if hasattr(M, "coarse_inv"):  # an AMG hierarchy: the rows of each level
        info["amg_rows"] = [m.n_nodes for m in M.mats] + [int(M.coarse_inv.shape[0])]

    if options.fail_action != "ignore":
        # JAX's rule (max_iter spent above rtol), and a non-finite residual
        # or x, which ends a Krylov loop early and which the JAX package
        # returns without a word
        finite = math.isfinite(res) and bool(torch.isfinite(x).all())
        if not finite or (iters >= options.max_iter and res > options.rtol):
            path = _dump_solve_failure(A, b, x0, options, info)
            warnings.warn(
                f"solver '{options.method}' did NOT converge: "
                f"{iters} iters, monitored rel residual {res:.3e} "
                f"(true ||b-Ax||/||b|| {true_res:.3e})"
                + ("" if finite else ", not finite")
                + (f"; system dumped to {path}" if path else ""),
                stacklevel=2,
            )
            if options.fail_action == "raise":
                raise RuntimeError(
                    f"linear solve failed to converge ({iters} iters, "
                    f"rel residual {res:.3e} > rtol {options.rtol:g}"
                    + ("" if finite else ", not finite") + ")"
                )
    return x, info


def _dump_solve_failure(A, b, x0, options, info) -> str | None:
    """Write the failed system as an npz artifact (BELL values (N, W, b, b)
    and node columns (N, W), rhs, guess), as the JAX package does,
    mirroring Aleph's SolveErrorAlephMatrix.dbg dump, into
    ``$AFEM_SOLVE_DEBUG_DIR`` (default: the working directory).  Best
    effort: a failed write gives None."""
    path = os.path.join(os.environ.get("AFEM_SOLVE_DEBUG_DIR", "."),
                        "SolveErrorMatrix.npz")
    payload = {
        "rhs": b.cpu().numpy(),
        "x0": x0.cpu().numpy(),
        "method": np.str_(options.method),
        "preconditioner": np.str_(options.preconditioner),
        "rtol": np.float64(options.rtol),
        "iterations": np.int64(int(info["iterations"])),
        "residual": np.float64(float(info["residual"])),
    }
    payload["bell_values"], payload["ell_cols"] = A.block_ell()
    try:
        np.savez_compressed(path, **payload)
    except OSError:
        return None
    return path
