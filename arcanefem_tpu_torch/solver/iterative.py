"""Preconditioned conjugate gradients with compensated dot products.

The counterpart of ``pcg``, ``precise_dot`` and ``Precond`` in
``arcanefem_tpu/solver/iterative.py``: the same recurrence, the same
stopping rule (the preconditioned residual r^T M r relative to its initial
value) and the same return values ``(x, iterations, rel)``.

``A`` is anything with ``.spmv(x)`` and ``M`` anything with ``.apply(r)``.
Vectors may have any shape: every dot sums over all elements, so the
structured path's padded plane vectors (``DiaPlaneMatrixP``, zero pads)
run through it as they are.
"""

from __future__ import annotations

import torch


class Precond:
    """Pointwise preconditioner: kind "none" or "jacobi"."""

    def __init__(self, kind: str, inv_diag: torch.Tensor | None = None):
        if kind not in ("none", "jacobi"):
            raise ValueError(f"unknown preconditioner kind {kind!r}")
        self.kind = kind
        self.inv_diag = inv_diag

    @classmethod
    def jacobi(cls, A) -> "Precond":
        d = A.diagonal()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return cls("jacobi", torch.where(d != 0, 1.0 / torch.where(d == 0, one, d), one))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return r
        return self.inv_diag * r


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a: torch.Tensor):
    # Dekker split; factor 2^ceil(p/2)+1: 2^12+1 for f32, 2^27+1 for f64
    factor = 4097.0 if a.dtype == torch.float32 else 134217729.0
    c = a * factor
    big = c - (c - a)
    return big, a - big


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    err = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, err


def precise_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ogita-Rump-Oishi dot2: error-free products, then the two partial
    sums joined by an error-free addition.  Lets f32 CG reach rtol 1e-8."""
    p, e = _two_prod(a, b)
    s, comp = _two_sum(p.sum(), e.sum())
    return s + comp


def default_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def pcg(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float, atol: float,
        max_iter: int, use_precise_dot: bool = False, replace_every: int = 0):
    """Solve A x = b.  Stops when r^T M r <= max(rtol^2 |r0^T M r0|, atol^2)
    or after max_iter iterations.  Returns (x, iterations, rel) with
    rel = sqrt(|r^T M r| / |r0^T M r0|) and x in float64.

    ``replace_every`` > 0 replaces the recurrence's residual by the true
    one, ``A.residual(b, x)`` evaluated in float64 and rounded to the
    working dtype, after every that many iterations (residual replacement;
    the JAX ``pcg`` has none).  It drops the rounding errors the recurrence
    has collected, of which the first, the working-dtype rounding of
    r0 = b − A x0, is the largest when x0 carries Dirichlet values.

    The iterate x is accumulated in float64 whatever the working dtype.
    CG never reads x back (r, z and p carry the recurrence), so the
    iterations and the monitored residual are those of the working dtype;
    what changes is that x no longer collects one rounding of the working
    type per iteration.  In float32 at 1.9M DoF that rounding alone held
    the true residual near 2e-4."""
    dot = precise_dot if use_precise_dot else default_dot
    x = x0.to(torch.float64)
    r = b - A.spmv(x0)
    z = M.apply(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    tol2 = torch.clamp(rtol * rtol * rz0.abs(), min=atol * atol)
    k = 0
    # One host read of the stopping test per iteration.  It costs a
    # device sync per iteration; a loop kept on the device (a CUDA graph
    # of a few iterations per check) is later work.
    while k < max_iter and bool(rz.abs() > tol2):
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha.to(torch.float64) * p.to(torch.float64)
        r = r - alpha * Ap
        k += 1
        if replace_every and k % replace_every == 0:
            r = A.residual(b.double(), x).to(b.dtype)
        z = M.apply(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
    tiny = torch.finfo(b.dtype).tiny
    rel = float(torch.sqrt(rz.abs() / torch.clamp(rz0.abs(), min=tiny)))
    return x, k, rel
