"""Krylov solvers with compensated dot products.

The counterpart of ``arcanefem_tpu/solver/iterative.py``: ``pcg``,
``pcg_chunked``, ``pcg_pair``, ``pcg_flex``, ``gmres``, ``bicgstab``,
``bicgstab2``, ``precise_dot``, ``Precond`` and ``make_precond``, with the
same recurrences, the same stopping rules and the same return values
``(x, iterations, rel)``.  ``pcg`` is ``pcg_chunked`` with ``chunk=1``:
one loop body.

Each JAX loop is a ``lax.while_loop``; here the stopping test is a host
read of a device scalar after every iteration (after every inner step in
GMRES), one device synchronise each, and no chunking adds iterations.
GMRES's small Hessenberg work (Givens rotations, the back-substitution)
runs on the host in the working dtype, on the column the synchronise
brings back anyway.

``A`` is anything with ``.spmv(x)`` and ``M`` anything with ``.apply(r)``.
Vectors may have any shape: every dot sums over all elements, so the
structured path's padded plane vectors (``DiaPlaneMatrixP``, zero pads)
run through it as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Precond:
    """Pointwise or block preconditioner: kind "none", "jacobi" (data: the
    (N,) inverse diagonal) or "block-jacobi" (data: the (N, b, b) inverse
    diagonal blocks)."""

    def __init__(self, kind: str, inv_diag: torch.Tensor | None = None):
        if kind not in ("none", "jacobi", "block-jacobi"):
            raise ValueError(f"unknown preconditioner kind {kind!r}")
        self.kind = kind
        self.inv_diag = inv_diag

    @classmethod
    def jacobi(cls, A) -> "Precond":
        d = A.diagonal()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return cls("jacobi", torch.where(d != 0, 1.0 / torch.where(d == 0, one, d), one))

    @classmethod
    def block_jacobi(cls, A) -> "Precond":
        """Inverses of the (N, b, b) diagonal blocks of the BellMatrix
        ``A`` ((N, 1, 1) for a scalar one), as the JAX
        ``jnp.linalg.inv(A.diag_blocks())`` (no guard: a zero diagonal gives
        inf)."""
        return cls("block-jacobi", torch.linalg.inv(A.diag_blocks()))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return r
        if self.kind == "jacobi":
            return self.inv_diag * r
        # one broadcast product and one sum over the row: an einsum becomes
        # a batched gemv that cuBLAS cuts into 65,535-block launches (29 per
        # apply at 1.9M nodes)
        n, b, _ = self.inv_diag.shape
        return (self.inv_diag * r.reshape(n, 1, b)).sum(dim=2).reshape(-1)


# build_amg's defaults, with which the JAX make_precond builds its AMG
AMG_THETA = 0.08
AMG_SMOOTHER = "jacobi"
AMG_CHEB_DEG = 2


def make_precond(A, name: str | None, nullspace=None):
    """The preconditioner ``name`` of the BellMatrix ``A``, as the JAX
    ``make_precond``: "none", "jacobi", "block-jacobi", "amg" (the
    smoothed-aggregation set-up of ``solver/amg_setup.py`` at
    ``build_amg``'s defaults, theta 0.08 and the Jacobi smoother, on ``A``'s
    values and stored pattern, moved to ``A``'s device as an
    ``AMGPrecond``; with ``A.plain`` its levels run the plain twin) or
    "poly" (``solver/poly.py``).  For a block matrix (``A.block`` b > 1)
    the AMG aggregates nodes, and ``nullspace`` (n_dofs, m), the
    elasticity family's rigid body modes, gives its tentative
    prolongator; a scalar matrix ignores ``nullspace``, as in JAX."""
    if name in (None, "none"):
        return Precond("none")
    if name == "jacobi":
        return Precond.jacobi(A)
    if name == "block-jacobi":
        return Precond.block_jacobi(A)
    if name == "amg":
        from .amg import amg_from_numpy
        from .amg_setup import amg_setup, stored_graph

        host = A.ell_values().cpu().numpy()  # in A's dtype, the hierarchy's
        d = amg_setup(host, stored_graph(A.layout), theta=AMG_THETA,
                      smoother=AMG_SMOOTHER, cheb_deg=AMG_CHEB_DEG,
                      dtype=host.dtype, block=A.block, nullspace=nullspace)
        return amg_from_numpy(d, A.values.device, A.values.dtype, plain=A.plain)
    if name == "poly":
        from .poly import build_chebyshev

        return build_chebyshev(A)
    raise ValueError(f"unknown preconditioner '{name}'")


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


def precise_dot_rows(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`precise_dot` of every row of ``V`` (k, n) with ``w`` (n,):
    the same arithmetic row by row (the JAX ``jax.vmap(precise_dot)``),
    with (k, n) two-product temporaries."""
    p, e = _two_prod(V, w[None, :])
    s, comp = _two_sum(p.sum(dim=1), e.sum(dim=1))
    return s + comp


def default_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def pcg_chunked(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float,
                atol: float, max_iter: int, use_precise_dot: bool = False,
                chunk: int = 4, replace_every: int = 0):
    """PCG with the stopping test read every ``chunk`` iterations.

    The counterpart of the JAX ``pcg_chunked``: ``chunk`` CG steps run
    between two host reads of the test r^T M r <= max(rtol^2 |r0^T M r0|,
    atol^2), so the count is a multiple of ``chunk`` and may run up to
    chunk − 1 steps past convergence (and past max_iter).  ``chunk=1`` is
    :func:`pcg`.  Returns (x, iterations, rel) with rel = sqrt(|r^T M r| /
    |r0^T M r0|) and x in float64.

    ``replace_every`` > 0 replaces the recurrence's residual by the true
    one, ``A.residual(b, x)`` evaluated in float64 and rounded to the
    working dtype, after every that many iterations (residual replacement;
    the JAX solvers have none).  It drops the rounding errors the
    recurrence has collected, of which the first, the working-dtype
    rounding of r0 = b − A x0, is the largest when x0 carries Dirichlet
    values.

    The iterate x is accumulated in float64 whatever the working dtype.
    CG never reads x back (r, z and p carry the recurrence), so the
    iterations and the monitored residual are those of the working dtype;
    what changes is that x no longer collects one rounding of the working
    type per iteration.  In float32 at 1.9M DoF that rounding alone held
    the true residual near 2e-4."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dot = precise_dot if use_precise_dot else default_dot
    x = x0.to(torch.float64)
    r = b - A.spmv(x0)
    z = M.apply(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    tol2 = torch.clamp(rtol * rtol * rz0.abs(), min=atol * atol)
    k = 0
    # One host read of the stopping test per chunk: a device sync each
    # time, which is what a CUDA graph of one chunk would leave.
    while k < max_iter and bool(rz.abs() > tol2):
        for _ in range(chunk):
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


def pcg(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float, atol: float,
        max_iter: int, use_precise_dot: bool = False, replace_every: int = 0):
    """Solve A x = b: :func:`pcg_chunked` with the stopping test read after
    every iteration (``chunk=1``), stopping when r^T M r <=
    max(rtol^2 |r0^T M r0|, atol^2) or after max_iter iterations."""
    return pcg_chunked(A, b, M, x0, rtol, atol, max_iter, use_precise_dot,
                       chunk=1, replace_every=replace_every)


def _rel(num: torch.Tensor, den: torch.Tensor) -> float:
    tiny = torch.finfo(den.dtype).tiny
    return float(num / torch.clamp(den, min=tiny))


def _pair_add(hi: torch.Tensor, lo: torch.Tensor, u: torch.Tensor):
    """(hi + lo) + u as a renormalised double-word pair (two_sum chain)."""
    s, e = _two_sum(hi, u)
    lo = lo + e
    return _two_sum(s, lo)


def pcg_pair(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float,
             atol: float, max_iter: int):
    """Pair-precision PCG: x and r ride as double-word pairs (two_sum
    updates; both words enter the compensated dot), so the update
    roundings do not accumulate while the SpMV and the preconditioner stay
    in the working dtype.  Exact-arithmetic equivalent to :func:`pcg`;
    returns (xh + xl, iterations, rel) as the JAX ``pcg_pair``."""
    dot = precise_dot
    zeros = torch.zeros_like(b)
    xh, xl = x0, zeros
    rh = b - A.spmv(x0)
    rl = zeros
    z = M.apply(rh)
    p = z
    rz = dot(rh, z)
    rz0 = rz
    tol2 = torch.clamp(rtol * rtol * rz0.abs(), min=atol * atol)
    k = 0
    while k < max_iter and bool(rz.abs() > tol2):
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        xh, xl = _pair_add(xh, xl, alpha * p)
        # α·Ap enters through two_prod so its own rounding is carried too
        uh, ul = _two_prod(alpha.expand(Ap.shape), Ap)
        rh, rl = _pair_add(rh, rl, -uh)
        rl = rl - ul
        z = M.apply(rh)
        rz_new = dot(rh, z) + dot(rl, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return xh + xl, k, math.sqrt(_rel(rz.abs(), rz0.abs()))


def pcg_flex(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float,
             atol: float, max_iter: int):
    """Flexible PCG (Polak-Ribière β = z_new·(r_new − r_old) / (z_old·
    r_old)): exact-arithmetic equivalent to :func:`pcg` for a fixed SPD
    preconditioner, robust when M varies per apply.  Compensated dots, as
    the JAX ``pcg_flex``."""
    dot = precise_dot
    x = x0
    r = b - A.spmv(x0)
    z = M.apply(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    tol2 = torch.clamp(rtol * rtol * rz0.abs(), min=atol * atol)
    k = 0
    while k < max_iter and bool(rz.abs() > tol2):
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M.apply(r_new)
        rz_new = dot(r_new, z_new)
        beta = (rz_new - dot(r_new, z)) / rz
        p = z_new + beta * p
        r, z, rz = r_new, z_new, rz_new
        k += 1
    return x, k, math.sqrt(_rel(rz.abs(), rz0.abs()))


def gmres(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float, atol: float,
          max_iter: int, restart: int = 30, use_precise_dot: bool = False):
    """Restarted GMRES(m), right-preconditioned (the Aleph method_gmres
    role), as the JAX ``gmres``: the basis V is an (m+1, n) tensor;
    classical Gram-Schmidt twice (CGS2) as products with the basis rows
    filled so far (the JAX package multiplies all m+1 rows and masks the
    ones past j, which hold zeros); Givens rotations give the residual
    norm |g[j+1]| every inner step; convergence is relative to the
    warm-started initial residual.  With ``use_precise_dot`` every
    projection and norm is the compensated dot2 (:func:`precise_dot_rows`
    over the basis rows).  Returns (x, total inner iterations, rel)."""
    m = restart
    n = b.shape[0]
    dtype = b.dtype
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    dot = precise_dot if use_precise_dot else default_dot
    tiny = torch.finfo(dtype).tiny
    tiny_h = npdt.type(tiny)

    def basis_dots(Vj, w):
        return precise_dot_rows(Vj, w) if use_precise_dot else torch.mv(Vj, w)

    def norm(v):
        return torch.sqrt(dot(v, v).abs())

    beta0 = norm(b - A.spmv(x0))
    beta0_h = npdt.type(float(beta0))
    tol = max(npdt.type(rtol) * beta0_h, npdt.type(atol))
    x, res, it = x0, beta0_h, 0
    V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
    while res > tol and it < max_iter:
        r = b - A.spmv(x)
        beta = norm(r)
        beta_h = npdt.type(float(beta))
        V.zero_()
        V[0] = r / torch.clamp(beta, min=tiny)
        H = np.zeros((m + 1, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = beta_h
        j, res_in = 0, beta_h
        while j < m and res_in > tol:
            w = A.spmv(M.apply(V[j]))
            Vj = V[: j + 1]
            h = basis_dots(Vj, w)
            w = w - Vj.T @ h
            h2 = basis_dots(Vj, w)
            w = w - Vj.T @ h2
            h = h + h2
            hnext = norm(w)
            V[j + 1] = w / torch.clamp(hnext, min=tiny)
            col = np.zeros(m + 1, npdt)
            col[: j + 2] = torch.cat([h, hnext[None]]).cpu().numpy()  # one read
            # the accumulated rotations, then the new one annihilating col[j+1]
            for i in range(j):
                hi, hip = col[i], col[i + 1]
                col[i] = cs[i] * hi + sn[i] * hip
                col[i + 1] = -sn[i] * hi + cs[i] * hip
            denom = max(np.sqrt(col[j] * col[j] + col[j + 1] * col[j + 1]), tiny_h)
            cs[j], sn[j] = col[j] / denom, col[j + 1] / denom
            col[j], col[j + 1] = denom, 0
            gj = g[j]
            g[j], g[j + 1] = cs[j] * gj, -sn[j] * gj
            H[:, j] = col
            j += 1
            res_in = abs(g[j])
        # back-substitution of the j x j upper-triangular system
        y = np.zeros(j, npdt)
        for i in range(j - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1: j] @ y[i + 1:]) / H[i, i]
        if j:
            yt = torch.as_tensor(y, device=b.device)
            x = x + M.apply(V[:j].T @ yt)
        res, it = res_in, it + j
    return x, it, float(res / max(beta0_h, tiny_h))


def bicgstab(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float,
             atol: float, max_iter: int, use_precise_dot: bool = False):
    """Preconditioned BiCGStab (the Aleph method_bicgstab role) for
    nonsymmetric systems, as the JAX ``bicgstab``: convergence is measured
    on the left-preconditioned residual ||M r||, relative to the
    warm-started initial one; ω is 0 where t·t is not positive."""
    dot = precise_dot if use_precise_dot else default_dot

    def pnorm(r):
        mr = M.apply(r)
        return torch.sqrt(dot(mr, mr))

    r = b - A.spmv(x0)
    rhat = r
    bnorm = pnorm(r)
    tol = torch.clamp(rtol * bnorm, min=atol)
    x = x0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    k = 0
    res = bnorm
    while bool(res > tol) and k < max_iter:
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = M.apply(p)
        v = A.spmv(ph)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        sh = M.apply(s)
        t = A.spmv(sh)
        tt = dot(t, t)
        omega = torch.where(tt > 0, dot(t, s) / tt, torch.zeros_like(tt))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        k += 1
        res = pnorm(r)
    return x, k, _rel(res, bnorm)


def bicgstab2(A, b: torch.Tensor, M, x0: torch.Tensor, rtol: float,
              atol: float, max_iter: int, use_precise_dot: bool = False):
    """BiCGStab(2) (Sleijpen & Fokkema's BiCGstab(l), l = 2; the Aleph
    method_bicgstab2 role), as the JAX ``bicgstab2``: two BiCG steps then a
    degree-2 minimal-residual update per iteration, right-preconditioned
    (the recurrence runs on A·M in y-space; x = x0 + M y with one M apply
    at the end), convergence on ||M r||, every division guarded by
    ``safe_div``.

    One step departs from the JAX arithmetic: where the GCR(2) Schur
    complement tau = t·t − (s·t)²/(s·s) rounds to tau <= 0 (t parallel to s
    at the working precision), the JAX step divides by it and y goes to inf
    or NaN; here the minimisation runs over t alone.  Everywhere else the
    steps are the JAX package's.  The 6x6 penalty Poisson system in float32
    meets it in its third iteration: its penalty rows give A·M a cluster of
    eigenvalues at 1, and K1 and its twin, which accumulate in float64 where
    the JAX SpMV accumulates in float32, leave the residual in that cluster's
    eigenspace, where tau rounds to 0."""
    dot = precise_dot if use_precise_dot else default_dot

    def op(z):
        return A.spmv(M.apply(z))

    def pnorm(r):
        mr = M.apply(r)
        return torch.sqrt(dot(mr, mr))

    r = b - A.spmv(x0)
    rhat = r
    bnorm = pnorm(r)
    tol = torch.clamp(rtol * bnorm, min=atol)
    eps = torch.finfo(b.dtype).tiny

    def safe_div(a, d):
        e = torch.full_like(d, eps)
        return a / torch.where(d.abs() > eps, d, torch.where(d < 0, -e, e))

    y = torch.zeros_like(b)
    u = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho0, alpha, omega = one, one, one
    k = 0
    res = bnorm
    while bool(res > tol) and k < max_iter:
        rho0 = -omega * rho0
        # even BiCG step
        rho1 = dot(rhat, r)
        beta = safe_div(alpha * rho1, rho0)
        rho0 = rho1
        u = r - beta * u
        v = op(u)
        gamma = dot(v, rhat)
        alpha = safe_div(rho0, gamma)
        r1 = r - alpha * v
        s = op(r1)
        y = y + alpha * u
        # odd BiCG step
        rho1 = dot(rhat, s)
        beta = safe_div(alpha * rho1, rho0)
        rho0 = rho1
        v = s - beta * v
        w = op(v)
        gamma = dot(w, rhat)
        alpha = safe_div(rho0, gamma)
        u = r1 - beta * u
        r1 = r1 - alpha * v
        s = s - alpha * w
        t = op(s)
        y = y + alpha * u
        # GCR(2): minimise ||r - omega1 s - omega2 t||
        w1 = dot(r1, s)
        mu = dot(s, s)
        nu = dot(s, t)
        tt = dot(t, t)
        w2 = dot(r1, t)
        tau = tt - safe_div(nu * nu, mu)
        # tau >= 0 in exact arithmetic, 0 where t is parallel to s; where
        # rounding leaves tau <= 0 the 2x2 system is singular, and dividing
        # by it (by `tiny` at 0) sends y to inf: minimise over t alone,
        # which spans the same line (omega1 = 0, omega2 = w2 / t·t, so the
        # next iteration's rho0 = -omega2 rho0 stays nonzero)
        line = tau <= 0
        omega2 = torch.where(line, safe_div(w2, tt),
                             safe_div(w2 - safe_div(nu * w1, mu), tau))
        omega1 = torch.where(line, torch.zeros_like(tau), safe_div(w1 - nu * omega2, mu))
        y = y + omega1 * r1 + omega2 * s
        r = r1 - omega1 * s - omega2 * t
        u = u - omega1 * v - omega2 * w
        omega = omega2
        k += 1
        res = pnorm(r)
    return x0 + M.apply(y), k, _rel(res, bnorm)
