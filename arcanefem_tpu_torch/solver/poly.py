"""Chebyshev polynomial preconditioner (Aleph's poly/ainv/ic/ilu/ilup).

The counterpart of ``arcanefem_tpu/solver/poly.py``: a fixed-degree
Chebyshev polynomial in the Jacobi-scaled operator stands in for the
reference's incomplete factorizations and approximate inverses
(AlephDoFLinearSystemFactory.axl:34-43), whose triangular solves are
sequential.  ``apply(r) = p(D^{-1}A) D^{-1} r`` on the interval
[lambda_max/eig_ratio, lambda_max] (Saad, "Iterative Methods", Alg. 12.1,
with Jacobi scaling folded in), symmetric in the D inner product, so it is
PCG-safe.  lambda_max comes from a power iteration at set-up, started from
``RandomState(0)`` as in the JAX package.  Every SpMV is ``A.spmv``: K1
(``sell_spmv``) on the card for the port's BellMatrix.
"""

from __future__ import annotations

import numpy as np
import torch


class ChebyshevPrecond:
    """apply(r) = p(D^{-1}A) D^{-1} r, p the degree-``degree`` Chebyshev
    polynomial; ``theta`` = (lmax+lmin)/2 and ``delta`` = (lmax-lmin)/2
    are 0-d tensors of the operator's dtype."""

    def __init__(self, A, inv_diag: torch.Tensor, theta: torch.Tensor,
                 delta: torch.Tensor, degree: int = 3):
        self.A = A
        self.inv_diag = inv_diag
        self.theta = theta
        self.delta = delta
        self.degree = int(degree)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        sigma = self.theta / self.delta
        rho = 1.0 / sigma
        pr = self.inv_diag * r
        x = pr / self.theta
        d = x
        for _ in range(1, self.degree):
            res = pr - self.inv_diag * self.A.spmv(x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / self.delta) * res
            x = x + d
            rho = rho_new
        return x


def build_chebyshev(A, degree: int = 3, eig_ratio: float = 30.0,
                    power_iters: int = 12) -> ChebyshevPrecond:
    """Set-up: Jacobi scaling and a power-iteration estimate of
    lambda_max(D^{-1}A), times 1.05; lambda_min = lambda_max / eig_ratio
    (30, as Hypre's polynomial smoothers cover the low end)."""
    d = A.diagonal()
    one = torch.ones((), dtype=d.dtype, device=d.device)
    inv_diag = torch.where(d != 0, 1.0 / torch.where(d == 0, one, d), one)
    n = inv_diag.shape[0]
    v = torch.as_tensor(np.random.RandomState(0).rand(n), device=d.device).to(d.dtype)
    for _ in range(power_iters):
        w = inv_diag * A.spmv(v)
        v = w / torch.linalg.vector_norm(w)
    w = inv_diag * A.spmv(v)
    lmax = 1.05 * (torch.dot(v, w) / torch.dot(v, v))
    lmin = lmax / eig_ratio
    return ChebyshevPrecond(A, inv_diag, (lmax + lmin) / 2.0,
                            (lmax - lmin) / 2.0, degree)
