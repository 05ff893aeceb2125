"""The numbers that decide ``correct``, and the control that must fail them.

Each number is a worst case over the rows of one output, in float64:

- ``matrix_err``: max |a_p - a_ref| over the stored entries, each taken
  relative to its row's largest stiffness entry, and on a penalised
  diagonal relative to the penalty;
- ``load_err``: max |b_p - b_ref| / |b_ref| over the free rows, and
  / penalty over the Dirichlet rows;
- ``x_backward_err``: the normwise backward error of the program's
  solution x under the reference's operator and load,
  ||(b - A x)_free|| / (||(|A| |x|)_free|| + ||b_free||): how far A and b
  would have to move for x to solve the system exactly.  Unlike
  ||r|| / ||b|| it does not grow as the mesh is refined (|A||x| ~ h and
  b ~ h³ per row), so one limit reads float32 rounding at any size;
- ``x_bc_err``: max |x - g| over the Dirichlet rows, relative to the
  case's largest |g| (1 where every g is 0).

The solvers stop on their preconditioned residual relative to the
initial one, which the reference cannot form without the program's
preconditioner; a case that returns that residual above the
configuration's ``rtol`` counts as failed (``traffic/closed_loop.py``)
and fails the run.

The control puts the reference in the program's place one precision
lower than the configuration's float32: its matrix and load rounded to
bfloat16, and the solution rounded to bfloat16.
"""

from __future__ import annotations

import torch

LOWER = torch.bfloat16  # the precision below float32 that tempts a change


def lower(t: torch.Tensor) -> torch.Tensor:
    """``t`` stored in the control's precision, read back as float64."""
    return t.to(LOWER).to(torch.float64)


def matrix_err(vals_p: torch.Tensor, vals_ref: torch.Tensor, scale: torch.Tensor) -> float:
    """max |vals_p - vals_ref| / scale over entries given in one order."""
    err = (vals_p.to(torch.float64) - vals_ref).abs() / scale
    return float(err.max())


def entry_scale(rowmax_of_entry: torch.Tensor, pen_diag: torch.Tensor,
                penalty: float) -> torch.Tensor:
    """The scale each entry is held to: its row's largest stiffness entry,
    the penalty on a penalised diagonal."""
    tiny = torch.finfo(torch.float64).tiny
    return torch.where(pen_diag, torch.full_like(rowmax_of_entry, penalty),
                       rowmax_of_entry.clamp(min=tiny))


def load_err(b_p: torch.Tensor, b_ref: torch.Tensor, dirichlet: torch.Tensor,
             penalty: float) -> float:
    tiny = torch.finfo(torch.float64).tiny
    scale = torch.where(dirichlet, torch.full_like(b_ref, penalty),
                        b_ref.abs().clamp(min=tiny))
    return float(((b_p.to(torch.float64) - b_ref).abs() / scale).max())


def x_backward_err(ax: torch.Tensor, abs_ax: torch.Tensor, b_ref: torch.Tensor,
                   free: torch.Tensor) -> float:
    """||(b - A x)_free|| / (||(|A||x|)_free|| + ||b_free||), from A x and
    |A||x| computed by the reference."""
    norm = torch.linalg.vector_norm
    r = (b_ref - ax)[free]
    return float(norm(r) / (norm(abs_ax[free]) + norm(b_ref[free])))


def x_bc_err(x: torch.Tensor, g_rows: torch.Tensor, dirichlet: torch.Tensor) -> float:
    """max |x - g| over the Dirichlet rows / max |g| (1 if all g are 0)."""
    gd = g_rows[dirichlet]
    scale = float(gd.abs().max()) if gd.numel() else 0.0
    scale = scale if scale > 0.0 else 1.0
    return float((x.to(torch.float64)[dirichlet] - gd).abs().max()) / scale


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): each number beside its limit; a number passes
    when it is at most its limit (NaN fails), and correct needs all."""
    checks = {}
    for name, value in numbers.items():
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
    ok = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
