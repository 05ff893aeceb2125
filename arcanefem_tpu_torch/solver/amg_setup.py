"""Smoothed-aggregation AMG setup (host numpy/scipy).

A copy of ``arcanefem_tpu/solver/amg.py::build_amg`` at its default
options: that module imports jax at its top, and the machine that runs the
port has no jax.  Per level of a scalar system: the native fused strength
test and filtered operator, greedy Vanek aggregation, the native smoothed
prolongator with row truncation, and the Galerkin product P^T A P; then
the ELL layouts of every level operator and transfer and the dense inverse
of the coarsest operator.  It calls the port's copies of the same native
functions as the JAX setup (``utils/native.py``), so ties break the same
way, and the CPU tests hold the result to ``build_amg``'s with exact
equality.  ``AFEM_NATIVE_AMG=0`` sends the scalar levels through
``build_amg``'s scipy branch instead (:func:`native_amg`), as it does in
JAX; its truncation breaks ties otherwise than the native pass.

Block systems (b dofs per node, the scalar expansion dof = node·b + comp)
take ``build_amg``'s scipy branch at every level, as JAX does: node-level
strength on the blocks' Frobenius norms, aggregation of nodes, and either
the component-preserving tentative prolongator (dof (i, a) -> (agg[i], a))
or, with a near-nullspace B (:func:`rigid_body_modes`), the per-aggregate
SVD of :func:`_rbm_tentative`, after which a coarse level has m dofs per
aggregate and B becomes the R factors ``Bc``.  The levels stay scalar
matrices, so the V-cycle needs no block code.

The output is a dict of numpy arrays and scalars laid out like the fields
of the JAX ``AMGPrecond`` (plus ``nullspaces``, each level's B, for the
tests); ``solver/amg.py::amg_from_numpy`` moves it to a device.  The
sawtooth variant of ``build_amg`` is not ported.
"""

from __future__ import annotations

import os
import time
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


def phase_marker():
    """``mark(label)``: with ``AFEM_AMG_VERBOSE=1``, print ``[amg] <label>:
    <s>s``, the seconds since the marker was made or last marked, as the
    JAX ``build_amg``'s ``_mark`` prints them (to the millisecond, where
    JAX prints tenths); else nothing."""
    verbose = os.environ.get("AFEM_AMG_VERBOSE") == "1"
    last = time.time()

    def mark(label: str) -> None:
        nonlocal last
        if verbose:
            t = time.time()
            print(f"[amg] {label}: {t - last:.3f}s", flush=True)
            last = t

    return mark


def native_amg(env=os.environ) -> bool:
    """``AFEM_NATIVE_AMG``: "1" (the default) sets up scalar levels with the
    native fused strength, filter and smoothing pass; "0" with ``build_amg``'s
    scipy branch (strength test, filter, smoothing and ``truncate_rows``).
    Any other value raises.  Unlike JAX, "1" does not fall back to scipy
    where the native library is missing: :func:`amg_setup` raises."""
    v = env.get("AFEM_NATIVE_AMG", "1")
    if v not in ("0", "1"):
        raise ValueError(f"AFEM_NATIVE_AMG must be 0 or 1, got {v!r}")
    return v == "1"


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


def rigid_body_modes(coords: np.ndarray, b: int) -> np.ndarray:
    """Near-nullspace B (n·b, m) of linear elasticity: m=3 modes in 2D
    (tx, ty, rotation), m=6 in 3D (3 translations + 3 rotations), on
    centred coordinates (BoomerAMG's interp-vectors role; PyAMG's B)."""
    c = np.asarray(coords, np.float64)
    c = c - c.mean(axis=0, keepdims=True)
    n = c.shape[0]
    if b == 2:
        B = np.zeros((n * 2, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -c[:, 1]
        B[1::2, 2] = c[:, 0]
        return B
    if b == 3:
        B = np.zeros((n * 3, 6))
        for a in range(3):
            B[a::3, a] = 1.0
        x, y, z = c[:, 0], c[:, 1], c[:, 2]
        B[1::3, 3], B[2::3, 3] = -z, y  # rot about x
        B[0::3, 4], B[2::3, 4] = z, -x  # rot about y
        B[0::3, 5], B[1::3, 5] = -y, x  # rot about z
        return B
    raise ValueError(f"rigid body modes need b in (2, 3), got {b}")


def _rbm_tentative(agg: np.ndarray, na: int, B: np.ndarray, bl: int):
    """Tentative prolongator from a near-nullspace: per-aggregate SVD.

    Returns (T (n, na*m) csr, Bc (na*m, m)) with T's aggregate column
    blocks orthonormal (Q of Ba = Q·R) and Bc = R, so T @ Bc == B on
    aggregated rows.  Rank-deficient aggregates get their surplus columns
    zeroed; those coarse dofs have zero rows and are inert in the cycle.
    """
    nn = len(agg)
    m = B.shape[1]
    sel = np.flatnonzero(agg >= 0)
    order = np.argsort(agg[sel], kind="stable")
    nodes_sorted = sel[order]
    aggs_sorted = agg[sel][order]
    counts = np.bincount(aggs_sorted, minlength=na)
    kmax = max(int(counts.max()), 1)
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(nodes_sorted)) - starts[aggs_sorted]
    pad = np.full((na, kmax), -1, np.int64)
    pad[aggs_sorted, slot] = nodes_sorted
    node_mask = pad >= 0  # (na, kmax)
    dofrows = (
        np.maximum(pad, 0)[:, :, None] * bl + np.arange(bl)[None, None, :]
    ).reshape(na, kmax * bl)
    dmask = np.repeat(node_mask, bl, axis=1)
    Tcols_data = np.zeros((na, kmax * bl, m))
    Bc = np.zeros((na, m, m))
    # chunked batched SVD (memory: chunk * kmax*bl * m)
    chunk = max(1, 50_000_000 // max(kmax * bl * m, 1))
    for lo in range(0, na, chunk):
        hi = min(lo + chunk, na)
        Ba = np.where(
            dmask[lo:hi, :, None], B[dofrows[lo:hi], :], 0.0
        )  # (c, kbl, m)
        U, S, Vt = np.linalg.svd(Ba, full_matrices=False)
        keep = S > np.maximum(S[:, :1] * 1e-10, 1e-12)
        Tcols_data[lo:hi] = U * (keep[:, None, :] * 1.0)
        Bc[lo:hi] = S[:, :, None] * Vt
    rows = np.broadcast_to(
        dofrows[:, :, None], (na, kmax * bl, m)
    ).reshape(-1)
    cols = (
        np.arange(na)[:, None, None] * m + np.arange(m)[None, None, :]
    )
    cols = np.broadcast_to(cols, (na, kmax * bl, m)).reshape(-1)
    data = (Tcols_data * dmask[:, :, None]).reshape(-1)
    nzsel = data != 0.0
    T = sp.csr_matrix(
        (data[nzsel], (rows[nzsel], cols[nzsel])),
        shape=(nn * bl, na * m),
    )
    return T, Bc.reshape(na * m, m)


def truncate_rows(P, kmax=8, rel=0.05, rescale=True):
    """Cap P's row width: keep the kmax largest-|.| entries per row (and
    drop entries below rel·rowmax), rescaling the survivors so each row
    sum is preserved where the kept entries carry the row's mass (at most
    4x).  ``rescale=False`` for rigid-body-mode prolongators, whose rows
    mix translation and rotation columns."""
    indptr, dat = P.indptr, P.data
    deg = np.diff(indptr)
    if len(dat) == 0 or int(deg.max(initial=0)) <= kmax and rel == 0:
        return P
    nr = P.shape[0]
    rows = np.repeat(np.arange(nr), deg)
    order = np.lexsort((-np.abs(dat), rows))
    rank = np.arange(len(dat)) - np.repeat(indptr[:-1], deg)
    keep = np.zeros(len(dat), bool)
    keep[order] = rank < kmax
    if rel > 0:
        rowmax = np.zeros(nr)
        np.maximum.at(rowmax, rows, np.abs(dat))
        keep &= np.abs(dat) >= rel * rowmax[rows]
    if not rescale:
        Q = sp.csr_matrix((dat * keep, P.indices, indptr), shape=P.shape)
        Q.eliminate_zeros()
        return Q
    full = np.zeros(nr)
    kept = np.zeros(nr)
    np.add.at(full, rows, dat)
    np.add.at(kept, rows, dat * keep)
    ok = np.abs(kept) > 0.1 * np.abs(full)
    raw = full / np.where(ok, kept, 1.0)
    scale = np.where(ok, np.clip(raw, -4.0, 4.0), 1.0)
    Q = sp.csr_matrix(
        (dat * keep * scale[rows], P.indices, indptr), shape=P.shape
    )
    Q.eliminate_zeros()
    return Q


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


def _scipy_level(cur, bl: int, theta_l: float, Bns, mark, lvl: int):
    """One level (number ``lvl``) of ``build_amg``'s scipy branch for an
    operator ``cur`` of bl dofs per node (a scalar level at bl = 1): (P,
    next bl, next nullspace, rho of cur), or None where aggregation makes
    no progress; ``mark`` (:func:`phase_marker`) after each of JAX's
    phases."""
    n = cur.shape[0]
    nn = n // bl
    if bl > 1:
        # node-level strength on block Frobenius norms: E^T |A|^2 E with
        # E = I_nn (x) 1_bl collapses each bl x bl block to a scalar
        E = sp.kron(sp.identity(nn, format="csr"), np.ones((bl, 1)), format="csr")
        A2 = cur.copy()
        A2.data = A2.data**2
        nodeA = (E.T @ A2 @ E).tocsr()
        nodeA.data = np.sqrt(nodeA.data)
    else:
        nodeA = cur
    d = np.asarray(nodeA.diagonal())
    # strength: |a_ij| >= θ_l·sqrt(a_ii·a_jj), diagonal excluded
    co = nodeA.tocoo()
    scale = np.sqrt(np.abs(d[co.row] * d[co.col])) + 1e-300
    keep = (np.abs(co.data) >= theta_l * scale) & (co.row != co.col)
    S = sp.csr_matrix((co.data[keep], (co.row[keep], co.col[keep])), shape=nodeA.shape)
    mark(f"  strength[{lvl}]")
    agg, na = _aggregate(S, nn)
    mark(f"  aggregate[{lvl}]")
    if na == 0 or na >= nn:  # no coarsening progress
        return None
    sel = agg >= 0
    bl_next, Bc = bl, None
    if Bns is not None:
        T, Bc = _rbm_tentative(agg, na, Bns, bl)
        bl_next = Bns.shape[1]
    else:
        # component-preserving tentative: dof (i, a) -> (agg[i], a); at bl = 1
        # JAX's scalar tentative, row i -> agg[i]
        dsel = np.repeat(sel, bl)
        drow = np.arange(n)[dsel]
        dcol = np.repeat(agg[sel], bl) * bl + np.tile(np.arange(bl), int(sel.sum()))
        T = sp.csr_matrix((np.ones(len(drow)), (drow, dcol)), shape=(n, na * bl))
    # prolongator smoothing on the filtered operator: weak node connections
    # dropped from A and lumped onto the diagonal
    aco = cur.tocoo()
    ni = aco.row // bl
    nj = aco.col // bl
    Sco = S.tocoo()
    skey = np.sort(Sco.row.astype(np.int64) * nn + Sco.col)
    akey = ni.astype(np.int64) * nn + nj
    if len(skey):
        pos = np.minimum(np.searchsorted(skey, akey), len(skey) - 1)
        strong = (skey[pos] == akey) | (ni == nj)
    else:
        strong = ni == nj
    af_data = np.where(strong, aco.data, 0.0)
    drop_row = np.zeros(n)
    np.add.at(drop_row, aco.row, aco.data - af_data)
    Af = sp.csr_matrix((af_data, (aco.row, aco.col)), shape=cur.shape) + sp.diags(drop_row)
    ddf = np.asarray(Af.diagonal())
    Dinvf = sp.diags(1.0 / np.where(ddf == 0, 1.0, ddf))
    DAf = (Dinvf @ Af).tocsr()
    mark(f"  filter[{lvl}]")
    rho_f = rho_est(Af.tocsr(), ddf)
    mark(f"  rho_f[{lvl}]")
    # the smoother's damping uses the true operator's spectral radius
    rho = rho_est(cur.tocsr(), np.asarray(cur.diagonal()))
    mark(f"  rho_A[{lvl}]")
    P = (sp.identity(n, format="csr") - (4.0 / 3.0 / rho_f) * DAf) @ T
    P = truncate_rows(P.tocsr(), kmax=TRUNC_KMAX, rel=TRUNC_REL,
                      rescale=Bns is None)
    return P, bl_next, Bc, rho


def amg_setup(values: np.ndarray, topo, *, theta: float, smoother: str,
              cheb_deg: int, dtype=np.float64, block: int = 1,
              nullspace: np.ndarray | None = None,
              coarse_size: int = COARSE_SIZE) -> dict:
    """Hierarchy of the BELL operator with (N, W) host ``values`` on
    ``topo`` (a ``sparse.topology.Topology``, or :func:`stored_graph` of a
    SELL layout), Dirichlet rows already penalised: ``build_amg(A,
    theta=theta, smoother=smoother, cheb_deg=cheb_deg, nullspace=nullspace)``
    with its other defaults.  ``block`` b: the operator is the scalar
    expansion of b×b blocks (dof = node·b + comp); ``nullspace`` (n_dofs,
    m) is used for b > 1 only, as in JAX.  ``dtype`` is the type the device
    will hold.  ``coarse_size`` is ``build_amg``'s: levels coarsen while
    they have more than ``coarse_size``·b rows.  Returns the dict that
    ``amg_from_numpy`` takes, for a V-cycle.  Scalar levels take the native
    pass, or with ``AFEM_NATIVE_AMG=0`` (:func:`native_amg`) the scipy
    branch of the block levels at b = 1.

    With ``AFEM_AMG_VERBOSE=1`` it prints one ``[amg] <label>: <s>s`` line
    per phase (:func:`phase_marker`), with the JAX ``build_amg``'s labels
    in its order (per level ``strength[l]``, ``aggregate[l]``,
    ``filter[l]``, ``rho_f[l]``, ``rho_A[l]``, ``smoothP[l]``,
    ``galerkin[l]``, ``level l (n->m dofs)``), then two of its own:
    ``ell layouts`` (the ELL arrays of every level and transfer, the host
    half of JAX's ``to_bell`` and ``transfers``) and ``coarse_inv``."""
    mark = phase_marker()
    dtype = np.dtype(dtype)
    vals = np.asarray(values).reshape(topo.n_nodes, topo.width)
    data = vals.reshape(-1)[topo.csr_to_ell]
    cur = sp.csr_matrix(
        (data.astype(np.float64), topo.csr_cols, topo.row_ptr),
        shape=(topo.n_nodes, topo.n_nodes),
    )
    mats, Ps, rhos = [], [], []
    bl = block
    Bns = (np.asarray(nullspace, np.float64)
           if nullspace is not None and block > 1 else None)
    used_rbm = Bns is not None
    nullspaces = [Bns]
    native = native_amg()
    while cur.shape[0] > coarse_size * bl and len(mats) < MAX_LEVELS:
        n = cur.shape[0]
        # Vanek's per-level strength decay
        theta_l = theta * (0.5 ** len(mats))
        if bl > 1 or not native:
            level = _scipy_level(cur, bl, theta_l, Bns, mark, len(mats))
            if level is None:
                break
            P, bl, Bns, rho = level
            rhos.append(rho)
        else:
            cur_csr = cur.tocsr()
            nat_sf = amg_strength_filter_native(
                cur_csr.indptr, cur_csr.indices, cur_csr.data, theta_l)
            if nat_sf is None:
                raise RuntimeError(
                    "native AMG strength filter unavailable (the port's native/ "
                    "library not built, or a row without a diagonal entry)")
            s_indptr, s_cols, af_data, ddf = nat_sf
            S = sp.csr_matrix((np.ones(len(s_cols)), s_cols, s_indptr),
                              shape=cur.shape)
            mark(f"  strength[{len(mats)}]")
            agg, na = _aggregate(S, n)
            mark(f"  aggregate[{len(mats)}]")
            if na == 0 or na >= n:  # no coarsening progress
                break
            # smoothing on the filtered operator Af (A's pattern, weak
            # entries zeroed and lumped onto the diagonal); the smoother's
            # damping uses the true operator's spectral radius
            Af = sp.csr_matrix((af_data, cur_csr.indices, cur_csr.indptr),
                               shape=cur.shape)
            mark(f"  filter[{len(mats)}]")
            rho_f = rho_est(Af, ddf)
            mark(f"  rho_f[{len(mats)}]")
            rhos.append(rho_est(cur_csr, np.asarray(cur.diagonal())))
            mark(f"  rho_A[{len(mats)}]")
            p_indptr, p_cols, p_data = amg_smooth_p_native(
                cur_csr.indptr, cur_csr.indices, af_data, ddf,
                4.0 / 3.0 / rho_f, agg, na, TRUNC_KMAX, TRUNC_REL, rescale=True)
            P = sp.csr_matrix((p_data, p_cols, p_indptr), shape=(n, na))
        mark(f"  smoothP[{len(mats)}]")
        nxt = (P.T @ cur @ P).tocsr()
        nxt.sum_duplicates()
        mark(f"  galerkin[{len(mats)}]")
        if not np.isfinite(nxt.data).all():
            raise FloatingPointError(
                f"non-finite Galerkin operator at level {len(mats) + 1} "
                f"({int((~np.isfinite(nxt.data)).sum())} bad entries)")
        mats.append(cur)
        Ps.append(P)
        nullspaces.append(Bns)
        cur = nxt
        mark(f"level {len(mats) - 1} ({n}->{cur.shape[0]} dofs)")

    if cur.shape[0] > 8 * coarse_size * bl:
        raise RuntimeError(
            f"AMG coarsening stalled at {cur.shape[0]} dofs (target coarse "
            f"size {coarse_size * bl}, {len(mats)} levels); loosen theta")

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
    mark("ell layouts")
    coarse_dense = cur.toarray()
    if used_rbm:
        # aggregates that cannot carry every mode leave zero rows and
        # columns in the coarsest operator: identity rows there, so the
        # exact inverse exists (their residual is zero, and so stays the
        # correction)
        zero_rows = ~np.any(coarse_dense != 0.0, axis=1)
        if zero_rows.any():
            idx = np.flatnonzero(zero_rows)
            coarse_dense[idx, idx] = 1.0
    out["coarse_inv"] = _coarse_inverse(coarse_dense).astype(dtype)
    mark("coarse_inv")
    out.update(
        omegas=tuple(OMEGA / r for r in rhos),
        rhos=tuple(float(r) for r in rhos),
        smoother=smoother, cheb_deg=cheb_deg, nu=NU, cycle="V",
        nullspaces=nullspaces, block=block,
    )
    return out
