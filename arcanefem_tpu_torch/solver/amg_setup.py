"""Smoothed-aggregation AMG setup for scalar systems (host numpy/scipy).

A copy of the scalar path of ``arcanefem_tpu/solver/amg.py::build_amg``:
that module imports jax at its top, and the machine that runs the port has
no jax.  Per level: the native fused strength test and filtered operator,
greedy Vanek aggregation, the native smoothed prolongator with row
truncation, and the Galerkin product P^T A P; then the ELL layouts of
every level operator and transfer and the dense inverse of the coarsest
operator.  It calls the port's copies of the same native functions as the
JAX setup (``utils/native.py``), so ties break the same way, and the
CPU tests hold the result to ``build_amg``'s with exact equality.

The output is a dict of numpy arrays and scalars laid out like the fields
of the JAX ``AMGPrecond``; ``solver/amg.py::amg_from_numpy`` moves it to a
device.  The block, rigid-body-mode and sawtooth variants of ``build_amg``
are not ported yet.
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp

from ..utils.native import (
    amg_smooth_p_native,
    amg_strength_filter_native,
)

# pass-2 aggregate-size cap: typical 3D aggregates are ~25-60 nodes; 128
# leaves real meshes untouched while bounding hub pathologies
_AGG_CAP = 128
# build_amg's defaults, the values the main path runs with
COARSE_SIZE = 400  # coarsen while a level has more rows than this
MAX_LEVELS = 12
OMEGA = 4.0 / 3.0  # Jacobi damping numerator: omega_l = OMEGA / rho_l
NU = 1  # Jacobi sweeps before and after the coarse correction
TRUNC_KMAX = 8  # prolongator entries kept per row
TRUNC_REL = 0.05  # and only those >= TRUNC_REL * the row's largest


def _ell_from_csr(indptr: np.ndarray, cols: np.ndarray):
    """ELL layout of a CSR graph: (ell_cols (n, W) int32 with padding on
    the own row, the flat ELL slot of each CSR entry)."""
    n = len(indptr) - 1
    deg = np.diff(indptr)
    W = max(int(deg.max()), 1)
    ell_cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], W, axis=1)
    idx = np.arange(len(cols))
    slot = idx - np.repeat(indptr[:-1], deg)
    rows = np.repeat(np.arange(n), deg)
    ell_cols[rows, slot] = cols.astype(np.int32)
    return ell_cols, (rows * W + slot).astype(np.int32)


def _aggregate(S, n: int) -> tuple[np.ndarray, int]:
    """Greedy Vanek aggregation on the strength graph S (scipy csr).

    Rows with no strong neighbour keep agg = -1 and get no coarse
    representation: that isolates the penalty (Dirichlet) rows, which the
    smoother handles exactly.
    """
    indptr, cols = S.indptr, S.indices
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n), deg)
    agg = np.full(n, -1, np.int64)
    isolated = deg == 0
    na = 0
    # pass 1, Luby-style rounds: a node roots an aggregate when it and its
    # whole strong neighbourhood are free and it has the smallest random
    # priority among its free candidate neighbours
    pri = np.random.RandomState(0).permutation(n)
    rounds_used = 0
    for _ in range(64):
        free = agg < 0
        cand = free & ~isolated
        nb_all_free = np.ones(n, bool)
        np.logical_and.at(nb_all_free, rows, free[cols])
        cand &= nb_all_free
        nbr_min = np.full(n, n, np.int64)
        sel = cand[rows] & cand[cols]
        np.minimum.at(nbr_min, rows[sel], pri[cols[sel]])
        roots = cand & (pri <= nbr_min)
        nr = int(roots.sum())
        if nr == 0:
            break
        rounds_used += 1
        ids = np.full(n, -1, np.int64)
        ids[roots] = na + np.arange(nr)
        agg[roots] = ids[roots]
        # members join their root (the max id where several roots touch)
        take = roots[rows] & (agg[cols] < 0)
        np.maximum.at(agg, cols[take], ids[rows[take]])
        na += nr
    # pass 2, two rounds: leftovers join an aggregated strong neighbour,
    # at most _AGG_CAP - size joiners per aggregate and round
    for _ in range(2):
        free = agg < 0
        if not free.any():
            break
        best = np.full(n, -1, np.int64)
        sel = free[rows] & (agg[cols] >= 0)
        np.maximum.at(best, rows[sel], agg[cols][sel])
        upd = free & (best >= 0)
        if not upd.any():
            break
        sizes = np.bincount(agg[agg >= 0], minlength=na)
        joiners = np.flatnonzero(upd)
        tgt = best[joiners]
        order = np.argsort(tgt, kind="stable")
        st = tgt[order]
        run_start = np.concatenate([[0], np.flatnonzero(np.diff(st)) + 1])
        pos = np.arange(len(st)) - np.repeat(
            run_start, np.diff(np.concatenate([run_start, [len(st)]])))
        quota = np.maximum(_AGG_CAP - sizes[st], 0)
        keep = joiners[order[pos < quota]]
        if not len(keep):
            break
        agg[keep] = best[keep]
    # anything still free but connected becomes a singleton aggregate
    left = (agg < 0) & ~isolated
    nl = int(left.sum())
    if nl:
        agg[left] = na + np.arange(nl)
        na += nl
    if na:
        max_sz = int(np.bincount(agg[agg >= 0], minlength=na).max())
        if max_sz > _AGG_CAP + _AGG_CAP // 2 or rounds_used >= 64:
            warnings.warn(
                f"_aggregate quality: max aggregate size {max_sz} "
                f"(cap {_AGG_CAP}), Luby rounds {rounds_used}/64, "
                f"{nl} singletons of {n} nodes — pathological strength "
                "graph? expect degraded AMG convergence", stacklevel=2)
    # relabel aggregates in first-member order: the coarse numbering then
    # inherits the fine node order's locality
    if na:
        sel = agg >= 0
        firsts = np.full(na, n, np.int64)
        np.minimum.at(firsts, agg[sel], np.arange(n)[sel])
        rank = np.empty(na, np.int64)
        rank[np.argsort(firsts, kind="stable")] = np.arange(na)
        agg[sel] = rank[agg[sel]]
    return agg, na


def rho_est(A_csr, d: np.ndarray, iters: int = 40, seed: int = 0) -> float:
    """λmax(D⁻¹A) estimate: Lanczos on S = D^-1/2 A D^-1/2 (+8% safety),
    capped by S's Gershgorin bound; stops early once the Ritz value moves
    less than 0.3% over four steps."""
    n = A_csr.shape[0]
    s = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))

    def Sv(v):
        return s * (A_csr @ (s * v))

    gersh = float((s * (abs(A_csr) @ s)).max())
    if not np.isfinite(gersh) or gersh == 0.0:
        return 1.0
    rng = np.random.RandomState(seed)
    v = rng.rand(n) - 0.5
    v /= np.linalg.norm(v)
    v_prev = np.zeros(n)
    alphas, betas = [], []
    beta = 0.0
    lam_hist = []

    def top_eig():
        T = np.diag(alphas)
        off = betas[:-1]
        if off:
            T += np.diag(off, 1) + np.diag(off, -1)
        return float(np.linalg.eigvalsh(T).max())

    for it in range(iters):
        w = Sv(v) - beta * v_prev
        alpha = float(v @ w)
        w -= alpha * v
        beta = float(np.linalg.norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if beta < 1e-12 * max(abs(alpha), 1.0):
            break
        v_prev, v = v, w / beta
        if it >= 8 and (it & 1):
            lam_hist.append((it, top_eig()))
            if len(lam_hist) >= 3:
                l0 = lam_hist[-3][1]
                l1 = lam_hist[-1][1]
                if abs(l1 - l0) <= 3e-3 * max(abs(l1), 1e-30):
                    break
    lam = top_eig() if len(alphas) else gersh
    return float(min(1.08 * lam, gersh))


def _coarse_inverse(coarse_dense: np.ndarray) -> np.ndarray:
    """Inverse of the coarsest operator, row-equilibrated so that penalty
    rows do not set the scale; a row-scaled pinv where the operator is
    singular."""
    d = np.abs(np.diag(coarse_dense))
    d = np.where(d > 0.0, d, 1.0)
    B = coarse_dense / d[:, None]
    try:
        Binv = np.linalg.inv(B)
        # np.linalg.inv does not reliably raise on singular input
        resid = np.abs(B @ Binv - np.eye(B.shape[0])).max()
        if np.isfinite(resid) and resid < 1e-6:
            return Binv / d[None, :]
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(B, rcond=1e-10) / d[None, :]


def _p_ell(P, dtype):
    """Row-ELL of a transfer operator: padding has column 0 and value 0."""
    deg = np.diff(P.indptr)
    Wp = max(int(deg.max()), 1)
    pc = np.zeros((P.shape[0], Wp), np.int32)
    pv = np.zeros((P.shape[0], Wp), dtype)
    rows = np.repeat(np.arange(P.shape[0]), deg)
    slot = np.arange(len(P.indices)) - np.repeat(P.indptr[:-1], deg)
    pc[rows, slot] = P.indices.astype(np.int32)
    pv[rows, slot] = P.data.astype(dtype)
    return pc, pv


def stored_graph(layout) -> SimpleNamespace:
    """The CSR graph of the slots a SELL layout stores (``sparse/sell.py``),
    with the fields of a ``Topology`` that :func:`amg_setup` reads:
    ``n_nodes``, ``width``, ``row_ptr``, ``csr_cols`` and ``csr_to_ell``.
    For the fine layout of a mesh (``sparse/bell.py::fine_layout``, built
    from the topology's ``ell_valid``) these equal the topology's own: its
    ELL rows hold each row's CSR entries first, in CSR order."""
    n, W = layout.n_rows, layout.width
    real = (layout.ell_to_sell >= 0).reshape(n, W)
    csr_to_ell = np.flatnonzero(real)
    row_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(real.sum(axis=1), out=row_ptr[1:])
    return SimpleNamespace(
        n_nodes=n, width=W, row_ptr=row_ptr, csr_to_ell=csr_to_ell,
        csr_cols=layout.ell_cols.reshape(-1)[csr_to_ell])


def amg_setup(values: np.ndarray, topo, *, theta: float, smoother: str,
              cheb_deg: int, dtype=np.float64) -> dict:
    """Hierarchy of the scalar BELL operator with (N, W) host ``values``
    on ``topo`` (a ``sparse.topology.Topology``), Dirichlet
    rows already penalised: ``build_amg(A, theta=theta, smoother=smoother,
    cheb_deg=cheb_deg)`` with its other defaults.  ``dtype`` is the type
    the device will hold.  Returns the dict that ``amg_from_numpy`` takes,
    for a V-cycle."""
    dtype = np.dtype(dtype)
    vals = np.asarray(values).reshape(topo.n_nodes, topo.width)
    data = vals.reshape(-1)[topo.csr_to_ell]
    cur = sp.csr_matrix(
        (data.astype(np.float64), topo.csr_cols, topo.row_ptr),
        shape=(topo.n_nodes, topo.n_nodes),
    )
    mats, Ps, rhos = [], [], []
    while cur.shape[0] > COARSE_SIZE and len(mats) < MAX_LEVELS:
        n = cur.shape[0]
        # Vanek's per-level strength decay
        theta_l = theta * (0.5 ** len(mats))
        cur_csr = cur.tocsr()
        nat_sf = amg_strength_filter_native(
            cur_csr.indptr, cur_csr.indices, cur_csr.data, theta_l)
        if nat_sf is None:
            raise RuntimeError(
                "native AMG strength filter unavailable (the port's native/ library not "
                "built, or a row without a diagonal entry)")
        s_indptr, s_cols, af_data, ddf = nat_sf
        S = sp.csr_matrix((np.ones(len(s_cols)), s_cols, s_indptr),
                          shape=cur.shape)
        agg, na = _aggregate(S, n)
        if na == 0 or na >= n:  # no coarsening progress
            break
        # smoothing on the filtered operator Af (A's pattern, weak entries
        # zeroed and lumped onto the diagonal); the smoother's damping uses
        # the true operator's spectral radius
        Af = sp.csr_matrix((af_data, cur_csr.indices, cur_csr.indptr),
                           shape=cur.shape)
        rho_f = rho_est(Af, ddf)
        rhos.append(rho_est(cur_csr, np.asarray(cur.diagonal())))
        p_indptr, p_cols, p_data = amg_smooth_p_native(
            cur_csr.indptr, cur_csr.indices, af_data, ddf,
            4.0 / 3.0 / rho_f, agg, na, TRUNC_KMAX, TRUNC_REL, rescale=True)
        P = sp.csr_matrix((p_data, p_cols, p_indptr), shape=(n, na))
        nxt = (P.T @ cur @ P).tocsr()
        nxt.sum_duplicates()
        if not np.isfinite(nxt.data).all():
            raise FloatingPointError(
                f"non-finite Galerkin operator at level {len(mats) + 1} "
                f"({int((~np.isfinite(nxt.data)).sum())} bad entries)")
        mats.append(cur)
        Ps.append(P)
        cur = nxt

    if cur.shape[0] > 8 * COARSE_SIZE:
        raise RuntimeError(
            f"AMG coarsening stalled at {cur.shape[0]} dofs (target coarse "
            f"size {COARSE_SIZE}, {len(mats)} levels); loosen theta")

    out = {k: [] for k in ("mats", "inv_diags", "pcols", "pvals", "ptcols",
                           "ptvals")}
    for M in mats:
        M = M.tocsr()
        M.sum_duplicates()
        ell_cols, flat = _ell_from_csr(M.indptr, M.indices)
        v = np.zeros(ell_cols.size, dtype)
        v[flat] = M.data.astype(dtype)
        out["mats"].append((v.reshape(ell_cols.shape), ell_cols))
        d = np.asarray(M.diagonal(), dtype)
        out["inv_diags"].append(
            np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0))
    for P in Ps:
        pc, pv = _p_ell(P, dtype)
        PT = P.T.tocsr()
        PT.sum_duplicates()
        tc, tv = _p_ell(PT, dtype)
        out["pcols"].append(pc)
        out["pvals"].append(pv)
        out["ptcols"].append(tc)
        out["ptvals"].append(tv)
    out["coarse_inv"] = _coarse_inverse(cur.toarray()).astype(dtype)
    out.update(
        omegas=tuple(OMEGA / r for r in rhos),
        rhos=tuple(float(r) for r in rhos),
        smoother=smoother, cheb_deg=cheb_deg, nu=NU, cycle="V",
    )
    return out
