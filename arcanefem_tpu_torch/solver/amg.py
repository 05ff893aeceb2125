"""Smoothed-aggregation AMG preconditioner: the apply side.

The counterpart of ``arcanefem_tpu/solver/amg.py::AMGPrecond`` for scalar
systems.  One ``apply`` is a V-cycle (or W-cycle, or the sawtooth cycle
that skips the fine pre-smooth): damped-Jacobi or Chebyshev smoothing on
each level, restriction by P^T and prolongation by P, and a dense inverse
on the coarsest level.  Every level operator and both transfers are
BellMatrix operators in SELL storage, so each level SpMV and each transfer
is K1 (``sell_spmv``) at every level size; the coarse solve is
``torch.matmul``.  With ``plain=True`` the same cycle runs on the plain
twin of the kernel instead, on any device.

Options of the JAX class carried over: ``l0_binv`` (supernode
block-Jacobi on the fine level, :func:`with_supernode_smoother`),
``vmats`` (V-cycle-only level operators, :func:`with_bf16_vcycle`),
``p_apply``/``pt_apply`` (transfer operators that replace P and P^T
inside the cycle, :func:`with_compact_vcycle`), ``sawtooth``, and
``cheb_deg`` as an int or a per-level tuple.  The block
and rigid-body-mode paths (elasticity) are not ported.

The hierarchy is built on the host by ``solver/amg_setup.py::amg_setup``
and moved to a device by :func:`amg_from_numpy`.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.bell import BellMatrix
from ..sparse.compact import CompactMatrix
from ..sparse.supernode import block_products

# levels and transfers the bf16 V-cycle casts: those with at least this
# many (fine) rows, the ones the JAX package gives a Pallas plan
# (arcanefem_tpu/solver/amg.py:921 and :958)
BF16_MIN_ROWS = 1500


class AMGPrecond:
    """AMG cycle over levels l = 0 (finest) .. L-1, then the coarse solve.

    mats[l]: BellMatrix of level l (anything with ``spmv``); inv_diags[l]:
    (N_l,) inverse diagonal; P[l]: the (N_l, N_{l+1}) BellMatrix of P_l
    (fine from coarse); Pt[l]: the (N_{l+1}, N_l) BellMatrix of P_l^T;
    coarse_inv: dense inverse of the coarsest operator.  omegas[l] =
    omega / rhos[l] damps the Jacobi smoother; rhos[l] estimates λmax of the
    smoothed operator for Chebyshev.  ``vmats[l]``, when given and not None,
    replaces mats[l] inside the cycle, and ``p_apply[l]``/``pt_apply[l]``
    (objects with ``spmv``), when given and not None, replace P[l] and
    Pt[l]; ``l0_binv`` (n_sup, bs, bs) replaces the fine
    level's inverse diagonal by supernode block inverses.
    """

    def __init__(self, mats, inv_diags, P, Pt, coarse_inv, *, omegas, rhos,
                 smoother: str = "jacobi", cheb_deg: int | tuple = 2,
                 nu: int = 1, cycle: str = "V", sawtooth: bool = False,
                 l0_binv: torch.Tensor | None = None, vmats: tuple = (),
                 p_apply: tuple = (), pt_apply: tuple = ()):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        if cycle not in ("V", "W"):
            raise ValueError(f"unknown cycle {cycle!r}")
        self.mats = tuple(mats)
        self.inv_diags = tuple(inv_diags)
        self.P, self.Pt = tuple(P), tuple(Pt)
        self.coarse_inv = coarse_inv
        self.omegas = tuple(float(o) for o in omegas)
        self.rhos = tuple(float(r) for r in rhos)
        self.smoother = smoother
        self.cheb_deg = (tuple(int(d) for d in cheb_deg)
                         if isinstance(cheb_deg, (tuple, list)) else int(cheb_deg))
        self.nu = int(nu)
        self.cycle = cycle
        self.sawtooth = bool(sawtooth)
        self.l0_binv = l0_binv
        self.vmats = tuple(vmats)
        self.p_apply, self.pt_apply = tuple(p_apply), tuple(pt_apply)

    def replace(self, **changes) -> "AMGPrecond":
        """A copy with the given attributes changed; the level tensors are
        shared, not copied."""
        out = copy.copy(self)
        for k, v in changes.items():
            if not hasattr(out, k):
                raise AttributeError(f"AMGPrecond has no field {k!r}")
            setattr(out, k, v)
        return out

    def _mat(self, l: int):
        if l < len(self.vmats) and self.vmats[l] is not None:
            return self.vmats[l]
        return self.mats[l]

    def _minv(self, l: int, v: torch.Tensor) -> torch.Tensor:
        """The smoother's preconditioner: block-Jacobi on level 0 when
        l0_binv is set, the inverse diagonal otherwise."""
        if l == 0 and self.l0_binv is not None:
            n_sup, bs, _ = self.l0_binv.shape
            n = v.shape[0]
            vb = torch.nn.functional.pad(v, (0, n_sup * bs - n)).view(n_sup, bs)
            return block_products(self.l0_binv, vb).reshape(-1)[:n]
        return self.inv_diags[l] * v

    def _deg(self, l: int) -> int:
        """Chebyshev degree of level l; a tuple's last entry repeats."""
        cd = self.cheb_deg
        if isinstance(cd, tuple):
            return cd[min(l, len(cd) - 1)]
        return cd

    def _smooth_jacobi(self, l: int, b: torch.Tensor) -> torch.Tensor:
        om = self.omegas[l]
        x = om * self._minv(l, b)
        for _ in range(self.nu - 1):
            x = x + om * self._minv(l, b - self._mat(l).spmv(x))
        return x

    def _smooth_cheb(self, l: int, b: torch.Tensor,
                     x: torch.Tensor | None = None) -> torch.Tensor:
        """x + p(M⁻¹A)·M⁻¹(b − A x) for the Chebyshev polynomial of degree
        _deg(l) on [ρ/4·1.1, 1.1ρ], by the three-term recurrence (M the
        diagonal, or the fine level's block-Jacobi)."""
        lmax = 1.1 * self.rhos[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        A = self._mat(l)
        r = b if x is None else b - A.spmv(x)
        d = self._minv(l, r) / theta
        x = d if x is None else x + d
        rho_old = 1.0 / sigma
        for _ in range(self._deg(l) - 1):
            r = b - A.spmv(x)
            rho_new = 1.0 / (2.0 * sigma - rho_old)
            d = (rho_new * rho_old) * d \
                + (2.0 * rho_new / delta) * self._minv(l, r)
            x = x + d
            rho_old = rho_new
        return x

    def _restrict(self, l: int, r: torch.Tensor) -> torch.Tensor:
        if l < len(self.pt_apply) and self.pt_apply[l] is not None:
            return self.pt_apply[l].spmv(r)
        return self.Pt[l].spmv(r)

    def _prolong(self, l: int, xc: torch.Tensor) -> torch.Tensor:
        if l < len(self.p_apply) and self.p_apply[l] is not None:
            return self.p_apply[l].spmv(xc)
        return self.P[l].spmv(xc)

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == len(self.mats):
            return self.coarse_inv @ b
        A = self._mat(l)
        if l == 0 and self.sawtooth:
            # no fine pre-smooth: x = 0, so the residual is b
            x = self._prolong(l, self._cycle(l + 1, self._restrict(l, b)))
        else:
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
            x = x + om * self._minv(l, b - A.spmv(x))
        return x

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r)


def amg_from_numpy(d: dict, device: torch.device | str,
                   dtype: torch.dtype, *, plain: bool = False) -> AMGPrecond:
    """Build an :class:`AMGPrecond` on ``device`` from host arrays laid out
    like the JAX ``AMGPrecond`` fields: ``mats`` (a list of (values (N, W),
    cols (N, W)) pairs), ``inv_diags``, ``pcols``, ``pvals``, ``ptcols``,
    ``ptvals``, ``coarse_inv``, the scalars ``omegas``, ``rhos``,
    ``smoother``, ``cheb_deg`` (an int or a per-level tuple), ``nu`` and
    ``cycle``, and optionally ``sawtooth`` and ``l0_binv`` ((n_sup, bs, bs)
    or None).  Every level and transfer becomes a BellMatrix (SELL storage
    of its non-zero values, column ranges checked once, here).
    ``plain=True`` builds the kernel-free twin."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    def bell(v, cl, n_cols):
        return BellMatrix.from_numpy(v, cl, device=device, dtype=dtype,
                                     n_cols=n_cols, plain=plain)

    sizes = [np.shape(v)[0] for v, _ in d["mats"]] + [
        np.asarray(d["coarse_inv"]).shape[0]]
    mats = [bell(v, cl, n) for (v, cl), n in zip(d["mats"], sizes)]
    P = [bell(v, cl, sizes[l + 1])
         for l, (v, cl) in enumerate(zip(d["pvals"], d["pcols"]))]
    Pt = [bell(v, cl, sizes[l])
          for l, (v, cl) in enumerate(zip(d["ptvals"], d["ptcols"]))]
    binv = d.get("l0_binv")
    if binv is not None and (np.ndim(binv) != 3 or mats and
                             np.shape(binv)[0] * np.shape(binv)[1] < sizes[0]):
        raise ValueError(f"l0_binv of shape {np.shape(binv)} does not cover "
                         f"the {sizes[0]} fine rows")
    return AMGPrecond(
        mats, [t(v) for v in d["inv_diags"]], P, Pt, t(d["coarse_inv"]),
        omegas=d["omegas"], rhos=d["rhos"], smoother=d["smoother"],
        cheb_deg=d["cheb_deg"], nu=d["nu"], cycle=d["cycle"],
        sawtooth=d.get("sawtooth", False),
        l0_binv=None if binv is None else t(binv),
    )


def with_supernode_smoother(M: AMGPrecond, A, sn,
                            omega: float = 4.0 / 3.0) -> AMGPrecond:
    """M with supernode block-Jacobi as its fine-level smoother.

    A numpy copy of the JAX ``with_supernode_smoother``: ``sn`` is the
    :class:`~..sparse.supernode.SupernodeSpmv` of the BellMatrix ``A``; its
    diagonal blocks are inverted in float64 on the host (identity on the
    padded slots of the last supernode), and the fine level's damping is
    re-estimated for ρ(B⁻¹A) by 10 power iterations from RandomState(0).
    l0_binv lands on M's device in A's dtype."""
    bs, n = sn.bs, sn.n
    diag_idx = np.flatnonzero(sn.brow == sn.bcol)
    dblk = sn.blocks[torch.as_tensor(diag_idx, device=sn.blocks.device)]
    dblk = dblk.double().cpu().numpy()
    # padded slots (last supernode) are all-zero rows: identity them
    zero = ~np.any(dblk != 0.0, axis=2)
    for b_i in np.flatnonzero(zero.any(axis=1)):
        z = zero[b_i]
        # their couplings are already zero: no entry references a pad
        dblk[b_i][np.ix_(z, z)] += np.eye(int(z.sum()))
    binv = np.linalg.inv(dblk)

    # rho(B^-1 A) by power iteration on the host, A as scipy CSR; padding
    # slots hold zeros on their own row, which add nothing
    vals = A.ell_values().double().cpu().numpy()
    cols = A.layout.ell_cols.astype(np.int64)
    rows = np.repeat(np.arange(n), vals.shape[1])
    Asp = sp.csr_matrix((vals.reshape(-1), (rows, cols.reshape(-1))),
                        shape=(n, n))

    def bapply(v):
        vb = np.pad(v, (0, binv.shape[0] * bs - len(v))).reshape(-1, bs)
        return np.einsum("bij,bj->bi", binv, vb).reshape(-1)[: len(v)]

    rng = np.random.RandomState(0)
    v = rng.rand(n)
    v /= np.linalg.norm(v)
    rho = 1.0
    for _ in range(10):
        w = bapply(Asp @ v)
        rho = float(np.linalg.norm(w))
        if rho == 0:
            rho = 1.0
            break
        v = w / rho
    return M.replace(
        l0_binv=torch.tensor(binv, device=A.values.device, dtype=A.values.dtype),
        omegas=(omega / rho,) + M.omegas[1:],
        rhos=(rho,) + M.rhos[1:],
    )


def with_bf16_vcycle(M: AMGPrecond) -> AMGPrecond:
    """bfloat16 weights for the V-cycle's level operators and transfers.

    As the JAX ``with_bf16_vcycle``: only the levels and transfers with at
    least ``BF16_MIN_ROWS`` (fine) rows are cast, the ones the JAX package
    gave a Pallas plan, and only BellMatrix levels (a supernode fine level
    keeps its own blocks).  ``mats`` stays as it is (the V-cycle reads the
    cast copies from ``vmats``); the transfers are replaced by their casts,
    since nothing but the cycle reads them.  Each cast keeps its operator's
    SELL layout; K1 promotes the bf16 weights and sums in float64."""
    def cast(m):
        return m.with_values(m.values.to(torch.bfloat16))

    if any(op is not None for op in M.p_apply + M.pt_apply):
        raise ValueError("with_bf16_vcycle: M has compact transfers; a bf16 "
                         "V-cycle is not combined with a compact one")
    big = [p.n_nodes >= BF16_MIN_ROWS for p in M.P]
    return M.replace(
        vmats=tuple(cast(m) if isinstance(m, BellMatrix)
                    and m.n_nodes >= BF16_MIN_ROWS else None for m in M.mats),
        P=tuple(cast(p) if b else p for p, b in zip(M.P, big)),
        Pt=tuple(cast(p) if b else p for p, b in zip(M.Pt, big)),
    )


def with_compact_vcycle(M: AMGPrecond, band_pre: bool,
                        l0: CompactMatrix | None = None) -> AMGPrecond:
    """The compact two-stage SpMV (``sparse/compact.py``) for the V-cycle's
    level operators and transfers, as the JAX ``build_amg`` under
    ``AFEM_SPMV=compact`` (with ``AFEM_BAND_PRE=1`` when ``band_pre``).

    As there, only the levels and transfers with at least ``BF16_MIN_ROWS``
    (fine) rows are compacted, the ones the JAX package gives a Pallas plan
    (amg.py:921 and :958); a level's real entries are its non-zero values.
    ``l0``, the CG operator's CompactMatrix of the same operator as
    ``mats[0]``, is reused as the fine level, so its host build runs once.
    A bf16 V-cycle is not combined with this one: the call raises when M
    already has ``vmats``."""
    if any(v is not None for v in M.vmats):
        raise ValueError("with_compact_vcycle: M already has V-cycle "
                         "operators (a bf16 V-cycle); the two do not combine")

    def level(l, m):
        if l == 0 and l0 is not None:
            return l0
        if isinstance(m, BellMatrix) and m.n_nodes >= BF16_MIN_ROWS:
            return CompactMatrix.from_bell(m, band_pre=band_pre)
        return None

    def transfer(P):
        if P.n_nodes < BF16_MIN_ROWS:
            return None
        return CompactMatrix.from_bell(P, band_pre=band_pre)

    return M.replace(
        vmats=tuple(level(l, m) for l, m in enumerate(M.mats)),
        p_apply=tuple(transfer(P) for P in M.P),
        pt_apply=tuple(transfer(P) for P in M.Pt),
    )
