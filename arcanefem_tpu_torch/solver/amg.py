"""Smoothed-aggregation AMG preconditioner: the apply side.

The counterpart of ``arcanefem_tpu/solver/amg.py::AMGPrecond`` for scalar
systems.  One ``apply`` is a V-cycle (or W-cycle): damped-Jacobi or
Chebyshev smoothing on each level, restriction by P^T and prolongation by
P held as row-ELL arrays, and a dense inverse on the coarsest level.  Every
level SpMV and both transfers are the ELL gather-reduce kernel
(``ell_spmv``, K1 on the card) at every level size; the coarse solve is
``torch.matmul``.  With ``plain=True`` the same cycle runs on the plain
twin of the kernel instead, on any device.

The hierarchy is built on the host by ``solver/amg_setup.py::amg_setup``
and moved to a device by :func:`amg_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.bell import BellMatrix, check_cols
from ..sparse.ell_gather import ell_spmv, ell_spmv_plain


class AMGPrecond:
    """AMG cycle over levels l = 0 (finest) .. L-1, then the coarse solve.

    mats[l]: BellMatrix of level l; inv_diags[l]: (N_l,) inverse diagonal;
    pcols/pvals[l]: (N_l, Wp) row-ELL of P_l (fine from coarse);
    ptcols/ptvals[l]: (N_{l+1}, Wt) row-ELL of P_l^T; coarse_inv: dense
    inverse of the coarsest operator.  omegas[l] = omega / rhos[l] damps
    the Jacobi smoother; rhos[l] estimates λmax(D⁻¹A_l) for Chebyshev.
    """

    def __init__(self, mats, inv_diags, pcols, pvals, ptcols, ptvals,
                 coarse_inv, *, omegas, rhos, smoother: str = "jacobi",
                 cheb_deg: int = 2, nu: int = 1, cycle: str = "V",
                 plain: bool = False):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        if cycle not in ("V", "W"):
            raise ValueError(f"unknown cycle {cycle!r}")
        self.mats = tuple(mats)
        self.inv_diags = tuple(inv_diags)
        self.pcols, self.pvals = tuple(pcols), tuple(pvals)
        self.ptcols, self.ptvals = tuple(ptcols), tuple(ptvals)
        self.coarse_inv = coarse_inv
        self.omegas = tuple(float(o) for o in omegas)
        self.rhos = tuple(float(r) for r in rhos)
        self.smoother = smoother
        self.cheb_deg = int(cheb_deg)
        self.nu = int(nu)
        self.cycle = cycle
        self._spmv = ell_spmv_plain if plain else ell_spmv

    def _smooth_jacobi(self, l: int, b: torch.Tensor) -> torch.Tensor:
        om = self.omegas[l]
        x = om * (self.inv_diags[l] * b)
        for _ in range(self.nu - 1):
            x = x + om * (self.inv_diags[l] * (b - self.mats[l].spmv(x)))
        return x

    def _smooth_cheb(self, l: int, b: torch.Tensor,
                     x: torch.Tensor | None = None) -> torch.Tensor:
        """x + p(D⁻¹A)·D⁻¹(b − A x) for the degree-cheb_deg Chebyshev
        polynomial on [ρ/4·1.1, 1.1ρ], by the three-term recurrence."""
        lmax = 1.1 * self.rhos[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        A = self.mats[l]
        r = b if x is None else b - A.spmv(x)
        d = (self.inv_diags[l] * r) / theta
        x = d if x is None else x + d
        rho_old = 1.0 / sigma
        for _ in range(self.cheb_deg - 1):
            r = b - A.spmv(x)
            rho_new = 1.0 / (2.0 * sigma - rho_old)
            d = (rho_new * rho_old) * d \
                + (2.0 * rho_new / delta) * (self.inv_diags[l] * r)
            x = x + d
            rho_old = rho_new
        return x

    def _restrict(self, l: int, r: torch.Tensor) -> torch.Tensor:
        return self._spmv(self.ptvals[l], self.ptcols[l], r)

    def _prolong(self, l: int, xc: torch.Tensor) -> torch.Tensor:
        return self._spmv(self.pvals[l], self.pcols[l], xc)

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == len(self.mats):
            return self.coarse_inv @ b
        A = self.mats[l]
        if self.smoother == "chebyshev":
            x = self._smooth_cheb(l, b)
        else:
            x = self._smooth_jacobi(l, b)
        r = b - A.spmv(x)
        x = x + self._prolong(l, self._cycle(l + 1, self._restrict(l, r)))
        if self.cycle == "W" and l + 1 < len(self.mats):
            # second coarse visit with the updated residual
            r = b - A.spmv(x)
            x = x + self._prolong(l, self._cycle(l + 1, self._restrict(l, r)))
        if self.smoother == "chebyshev":
            return self._smooth_cheb(l, b, x)
        om = self.omegas[l]
        for _ in range(self.nu):
            x = x + om * (self.inv_diags[l] * (b - A.spmv(x)))
        return x

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r)


def amg_from_numpy(d: dict, device: torch.device | str,
                   dtype: torch.dtype, *, plain: bool = False) -> AMGPrecond:
    """Build an :class:`AMGPrecond` on ``device`` from host arrays laid out
    like the JAX ``AMGPrecond`` fields: ``mats`` (a list of (values (N, W),
    cols (N, W)) pairs), ``inv_diags``, ``pcols``, ``pvals``, ``ptcols``,
    ``ptvals``, ``coarse_inv``, and the scalars ``omegas``, ``rhos``,
    ``smoother``, ``cheb_deg``, ``nu`` and ``cycle``.  Column ranges are
    checked here, once.  ``plain=True`` builds the kernel-free twin."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    def c(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    mats = [BellMatrix.from_numpy(v, cl, device=device, dtype=dtype,
                                  plain=plain)
            for v, cl in d["mats"]]
    sizes = [m.n_nodes for m in mats] + [np.asarray(d["coarse_inv"]).shape[0]]
    for l in range(len(mats)):
        check_cols(np.asarray(d["pcols"][l]), sizes[l + 1], f"pcols[{l}]")
        check_cols(np.asarray(d["ptcols"][l]), sizes[l], f"ptcols[{l}]")
    return AMGPrecond(
        mats,
        [t(v) for v in d["inv_diags"]],
        [c(v) for v in d["pcols"]], [t(v) for v in d["pvals"]],
        [c(v) for v in d["ptcols"]], [t(v) for v in d["ptvals"]],
        t(d["coarse_inv"]),
        omegas=d["omegas"], rhos=d["rhos"], smoother=d["smoother"],
        cheb_deg=d["cheb_deg"], nu=d["nu"], cycle=d["cycle"], plain=plain,
    )
