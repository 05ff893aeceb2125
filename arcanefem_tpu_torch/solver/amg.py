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
and moved to a device by :func:`amg_from_numpy`; :func:`amg_cached` keeps
it, with the SELL layouts of its levels and transfers, in an npz file
(:func:`hierarchy_arrays`, :func:`hierarchy_from_arrays`).
"""

from __future__ import annotations

import copy
import json

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.bell import BellMatrix
from ..sparse.compact import CompactMatrix
from ..sparse.sell import SellLayout
from ..sparse.supernode import block_products
from ..utils import tracing
from ..utils.cache import load_npz, save_npz
from .amg_setup import phase_marker

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

    def _cycle(self, l: int, b: torch.Tensor, on: bool = False) -> torch.Tensor:
        """One cycle from level ``l`` down; ``on``: record its spans."""
        span = tracing.span
        if l == len(self.mats):
            with span(tracing.VCYCLE_COARSE, on):
                return self.coarse_inv @ b
        A = self._mat(l)
        names = tracing.level(l)
        if l == 0 and self.sawtooth:
            # no fine pre-smooth: x = 0, so the residual is b
            with span(names.restrict, on):
                rc = self._restrict(l, b)
            xc = self._cycle(l + 1, rc, on)
            with span(names.prolong, on):
                x = self._prolong(l, xc)
        else:
            with span(names.smooth, on):
                if self.smoother == "chebyshev":
                    x = self._smooth_cheb(l, b)
                else:
                    x = self._smooth_jacobi(l, b)
            visits = 2 if self.cycle == "W" and l + 1 < len(self.mats) else 1
            for _ in range(visits):  # a W-cycle's second visit takes the new residual
                with span(names.residual, on):
                    r = b - A.spmv(x)
                with span(names.restrict, on):
                    rc = self._restrict(l, r)
                xc = self._cycle(l + 1, rc, on)
                with span(names.prolong, on):
                    x = x + self._prolong(l, xc)
        with span(names.smooth, on):
            if self.smoother == "chebyshev":
                return self._smooth_cheb(l, b, x)
            om = self.omegas[l]
            for _ in range(self.nu):
                x = x + om * self._minv(l, b - A.spmv(x))
            return x

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r, tracing.active())


def amg_from_numpy(d: dict, device: torch.device | str,
                   dtype: torch.dtype, *, plain: bool = False) -> AMGPrecond:
    """Build an :class:`AMGPrecond` on ``device`` from host arrays laid out
    like the JAX ``AMGPrecond`` fields: ``mats`` (a list of (values (N, W),
    cols (N, W)) pairs), ``inv_diags``, ``pcols``, ``pvals``, ``ptcols``,
    ``ptvals``, ``coarse_inv``, the scalars ``omegas``, ``rhos``,
    ``smoother``, ``cheb_deg`` (an int or a per-level tuple), ``nu`` and
    ``cycle``, and optionally ``sawtooth`` and ``l0_binv`` ((n_sup, bs, bs)
    or None).  Every level and transfer becomes a BellMatrix (SELL storage
    of its non-zero values, column ranges checked once, here), on the SELL
    layouts of ``d["layouts"]`` when the dict carries them (``{"mats",
    "P", "Pt"}``: lists of ``SellLayout.to_arrays``, as
    :func:`hierarchy_from_arrays` gives them), which are moved, not built.
    ``plain=True`` builds the kernel-free twin.  With ``AFEM_AMG_VERBOSE=1``
    it prints an ``[amg]`` line (``solver/amg_setup.py::phase_marker``)
    after each level's operator, ``to_bell[l] (n=N)``, and after each
    level's P and P^T, ``transfers[l]``: the JAX ``build_amg``'s labels of
    the device half of those steps."""
    mark = phase_marker()

    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    layouts = d.get("layouts") or {}

    def bell(v, cl, n_cols, role, l):
        if not layouts:
            return BellMatrix.from_numpy(v, cl, device=device, dtype=dtype,
                                         n_cols=n_cols, plain=plain)
        layout = SellLayout.from_arrays(layouts[role][l], device=device)
        if layout.ell_cols.shape != np.shape(v) or layout.n_cols != n_cols:
            raise ValueError(f"amg_from_numpy: the {role}[{l}] layout does not "
                             f"fit its {np.shape(v)} values and {n_cols} columns")
        return BellMatrix(layout.from_ell(np.asarray(v)).to(dtype), layout,
                          plain=plain)

    sizes = [np.shape(v)[0] for v, _ in d["mats"]] + [
        np.asarray(d["coarse_inv"]).shape[0]]
    mats, P, Pt = [], [], []
    for l, ((v, cl), n) in enumerate(zip(d["mats"], sizes)):
        mats.append(bell(v, cl, n, "mats", l))
        mark(f"to_bell[{l}] (n={n})")
    for l, (pv, pc, tv, tc) in enumerate(zip(d["pvals"], d["pcols"], d["ptvals"],
                                             d["ptcols"], strict=True)):
        P.append(bell(pv, pc, sizes[l + 1], "P", l))
        Pt.append(bell(tv, tc, sizes[l], "Pt", l))
        mark(f"transfers[{l}]")
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


def hierarchy_arrays(d: dict, M: AMGPrecond) -> dict[str, np.ndarray]:
    """The host arrays of :func:`amg_setup`'s dict ``d`` and of the SELL
    layouts that ``M = amg_from_numpy(d, ...)`` built for its levels and
    transfers, flat for an npz file (the column arrays once, in their
    layouts); :func:`hierarchy_from_arrays` takes them back."""
    out = {"coarse_inv": np.asarray(d["coarse_inv"]),
           "scalars": np.array(json.dumps(
               {k: d[k] for k in ("omegas", "rhos", "smoother", "cheb_deg",
                                  "nu", "cycle")}))}
    roles = {"mats": (M.mats, [v for v, _ in d["mats"]]),
             "P": (M.P, d["pvals"]), "Pt": (M.Pt, d["ptvals"])}
    for role, (ops, values) in roles.items():
        for l, (op, v) in enumerate(zip(ops, values, strict=True)):
            out[f"{role}{l}_values"] = np.asarray(v)
            for k, a in op.layout.to_arrays().items():
                out[f"{role}{l}_sell_{k}"] = a
    for l, a in enumerate(d["inv_diags"]):
        out[f"inv_diags{l}"] = np.asarray(a)
    return out


def hierarchy_from_arrays(arrays: dict[str, np.ndarray]) -> dict:
    """:func:`amg_from_numpy`'s dict, with its ``layouts``, from
    :func:`hierarchy_arrays`' arrays."""
    scalars = json.loads(str(arrays["scalars"]))
    if isinstance(scalars["cheb_deg"], list):
        scalars["cheb_deg"] = tuple(scalars["cheb_deg"])
    d = {"coarse_inv": arrays["coarse_inv"], "layouts": {},
         **{k: tuple(scalars[k]) for k in ("omegas", "rhos")},
         **{k: scalars[k] for k in ("smoother", "cheb_deg", "nu", "cycle")}}
    for role in ("mats", "P", "Pt"):
        d["layouts"][role] = lays = []
        while f"{role}{len(lays)}_values" in arrays:
            pre = f"{role}{len(lays)}_sell_"
            lays.append({k[len(pre):]: a for k, a in arrays.items()
                         if k.startswith(pre)})
    vals = {role: [arrays[f"{role}{l}_values"] for l in range(len(lays))]
            for role, lays in d["layouts"].items()}
    cols = {role: [lay["ell_cols"] for lay in lays]
            for role, lays in d["layouts"].items()}
    d["mats"] = list(zip(vals["mats"], cols["mats"]))
    d["pvals"], d["pcols"] = vals["P"], cols["P"]
    d["ptvals"], d["ptcols"] = vals["Pt"], cols["Pt"]
    d["inv_diags"] = [arrays[f"inv_diags{l}"] for l in range(len(d["mats"]))]
    return d


def amg_cached(path: str | None, meta: dict, build, device: torch.device | str,
               dtype: torch.dtype, *, plain: bool = False) -> tuple[AMGPrecond, bool]:
    """(M, cached): the hierarchy of the npz file ``path`` when its stored
    meta equals ``meta`` (``utils/cache.py::load_npz``), with its SELL
    layouts, moved to ``device``; else ``M = amg_from_numpy(build(), ...)``
    and the file written anew.  ``path`` None: no cache."""
    arrays = load_npz(path, meta, "AMG hierarchy") if path else None
    if arrays is not None:
        return amg_from_numpy(hierarchy_from_arrays(arrays), device, dtype,
                              plain=plain), True
    d = build()
    M = amg_from_numpy(d, device, dtype, plain=plain)
    if path:
        save_npz(path, hierarchy_arrays(d, M), meta)
    return M, False


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
    SELL layout; K1 promotes the bf16 weights and sums in float64.

    On a compact V-cycle (:func:`with_compact_vcycle` first, as the JAX
    bench combines ``AFEM_SPMV=compact`` with ``BENCH_UNSTR_BF16=1``) the
    compact levels and transfers are cast the same way: their
    pre-gathers stay, and their second stage, K1 on the remap, takes the
    bf16 weights (the JAX ``ChainedGather.with_weights_dtype``)."""
    def cast(m):
        return m.with_values(m.values.to(torch.bfloat16))

    def cast_compact(c):
        return None if c is None else c.with_values(c.op.values.to(torch.bfloat16))

    def level(m, v):
        if isinstance(v, CompactMatrix):
            return cast_compact(v)
        if isinstance(m, BellMatrix) and m.n_nodes >= BF16_MIN_ROWS:
            return cast(m)
        return None

    big = [p.n_nodes >= BF16_MIN_ROWS for p in M.P]
    return M.replace(
        vmats=tuple(level(m, v) for m, v in
                    zip(M.mats, M.vmats or (None,) * len(M.mats))),
        P=tuple(cast(p) if b else p for p, b in zip(M.P, big)),
        Pt=tuple(cast(p) if b else p for p, b in zip(M.Pt, big)),
        p_apply=tuple(cast_compact(c) for c in M.p_apply),
        pt_apply=tuple(cast_compact(c) for c in M.pt_apply),
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
    A bf16 V-cycle comes after this one (:func:`with_bf16_vcycle` casts
    the compact operators): the call raises when M already has
    ``vmats``."""
    if any(v is not None for v in M.vmats):
        raise ValueError("with_compact_vcycle: M already has V-cycle "
                         "operators (a bf16 V-cycle); compact it first, then cast")

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
