"""IC(0)/ILUT against Chebyshev-polynomial preconditioning: the decision
experiment behind the substitution of the reference's Aleph ``ic``,
``ilu`` and ``ilup`` preconditioners by one Chebyshev polynomial.

    python -m arcanefem_tpu_torch.tools.ilu_decision [--device cuda|cpu] [--out PATH]

The counterpart of ``tools/ilu_decision.py``.  :func:`systems` assembles
three systems in float64 through the port's FEM core on ``--device`` (the
card by default: ``slot_reduce`` sums the two Poisson operators and
``block_slot_reduce`` the b = 2 elasticity operator): −Δu = 1 on a 90×90
triangle rect and on a 22³ tetra box, penalty Dirichlet on every boundary
node, and plane elasticity (E = 21e5, ν = 0.28) on a 50×50 rect, clamped on
its left edge and loaded by f = (0, −1).  Each goes to the host as a scipy
CSR (:func:`csr_of`) and :func:`decision_row` records, with the JAX tool's
keys:

1. PCG iterations to rtol 1e-8 (at most 2000) with Jacobi, Chebyshev(3),
   true IC(0) on A's lower-triangle pattern and a pivoted fill-10 ILUT
   (scipy's ``spilu``, drop tolerance 1e-4);
2. the level-schedule depth of each triangular factor: the longest
   dependency chain of its forward solve.

The cost model on the card: a triangular solve scheduled one level per
launch takes ``depth`` dependent launches for L and as many for Lᵀ, so
``2 × depth`` dependent steps per preconditioner apply, whatever the
flops; a PCG iteration with Chebyshev(3) costs three K1 SpMVs (two in the
polynomial, one for A·p).  ``chip_smoke.py``'s ``[ilu]`` phase times both
on the H100.  That bounds a level-per-launch schedule only: a single-kernel
triangular solve without host synchronisation is not bound by it, and
neither package has one.

The numeric functions are the JAX tool's, in its loop order, so the same A
gives the same IC(0) factor, depths and counts.  It prints one JSON line
per system and writes the list to ``--out``
(``.cache/queue_results/ilu_decision.json`` by default).  Without a CUDA
device it exits 1 and prints no row unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

# the JAX tool's systems: name -> mesh size
SIZES = {"poisson2d_8k": (90, 90), "poisson3d_11k": (22, 22, 22),
         "elasticity2d_5k": (50, 50)}
PENALTY = 1e12  # 1e12, not 1e30: SuperLU's pivoting misbehaves at 1e30
RTOL = 1e-8
MAXITER = 2000


class System(NamedTuple):
    name: str
    A: sp.csr_matrix  # host float64, Dirichlet rows penalised
    rhs: np.ndarray
    bell: object  # the assembled BellMatrix (no penalty) on the device


def csr_of(A, topo) -> sp.csr_matrix:
    """The scipy CSR of the BellMatrix ``A`` assembled on ``topo``: the
    JAX tool's ``csr_of`` on ``ell_values()`` (scalar) or ``block_ell()``
    (b > 1, each b×b block expanded to dof = node·b + comp)."""
    b = A.block
    n, W = topo.n_nodes, topo.width
    if b == 1:
        vals = A.ell_values().cpu().numpy().astype(np.float64)
        if vals.shape != (n, W):
            raise ValueError(f"ELL values {vals.shape} do not match the topology's "
                             f"({n}, {W})")
        data = vals.reshape(-1)[topo.csr_to_ell]
        return sp.csr_matrix((data, topo.csr_cols, topo.row_ptr), shape=(n, n))
    vals, cols = A.block_ell()
    if cols.shape != (n, W) or not np.array_equal(
            cols.reshape(-1)[topo.csr_to_ell], topo.csr_cols):
        raise ValueError("the block layout's node columns are not the topology's")
    blocks = vals.astype(np.float64).reshape(n * W, b, b)[topo.csr_to_ell]
    rows_n = np.repeat(np.arange(n), np.diff(topo.row_ptr))
    r = rows_n[:, None, None] * b + np.arange(b)[None, :, None]
    c = topo.csr_cols[:, None, None] * b + np.arange(b)[None, None, :]
    M = sp.csr_matrix(
        (blocks.reshape(-1),
         (np.broadcast_to(r, blocks.shape).reshape(-1),
          np.broadcast_to(c, blocks.shape).reshape(-1))),
        shape=(n * b, n * b))
    M.sum_duplicates()
    return M


def pcg_iters(A, rhs, M_apply, rtol=RTOL, maxiter=MAXITER):
    """Plain PCG, counting iterations to ||r|| <= rtol*||b||."""
    x = np.zeros_like(rhs)
    r = rhs - A @ x
    z = M_apply(r)
    p = z.copy()
    rz = float(r @ z)
    nb = float(np.linalg.norm(rhs))
    for k in range(maxiter):
        if np.linalg.norm(r) <= rtol * nb:
            return k
        Ap = A @ p
        alpha = rz / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        z = M_apply(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return maxiter


def cheb_apply_factory(A, degree=3, eig_ratio=30.0):
    """``solver/poly.py::ChebyshevPrecond`` semantics with scipy ops."""
    d = np.asarray(A.diagonal())
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    rng = np.random.RandomState(0)
    v = rng.rand(A.shape[0])
    for _ in range(12):
        w = inv_d * (A @ v)
        v = w / np.linalg.norm(w)
    w = inv_d * (A @ v)
    lmax = 1.05 * float(v @ w) / float(v @ v)
    lmin = lmax / eig_ratio
    theta, delta = (lmax + lmin) / 2, (lmax - lmin) / 2

    def apply(r):
        sigma = theta / delta
        rho = 1.0 / sigma
        pr = inv_d * r
        x = pr / theta
        dvec = x
        for _ in range(1, degree):
            res = pr - inv_d * (A @ x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            dvec = (rho_new * rho) * dvec + (2.0 * rho_new / delta) * res
            x = x + dvec
            rho = rho_new
        return x

    return apply


def ic0(A):
    """True IC(0): incomplete Cholesky on A's lower-triangle pattern, row
    by row.  Sequential by definition, which is the point of the
    experiment.  Returns L (csr) or None on breakdown (a non-positive
    pivot)."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, idx, dat = A.indptr, A.indices, A.data
    Lrows = [dict() for _ in range(n)]
    diag = np.zeros(n)
    for i in range(n):
        Li = Lrows[i]
        for k in range(indptr[i], indptr[i + 1]):
            j = idx[k]
            if j > i:
                continue
            a = dat[k]
            Lj = Lrows[j]
            # sum over the common columns < j
            acc = 0.0
            if len(Li) < len(Lj):
                for c, v in Li.items():
                    if c < j:
                        w = Lj.get(c)
                        if w is not None:
                            acc += v * w
            else:
                for c, w in Lj.items():
                    if c < j:
                        v = Li.get(c)
                        if v is not None:
                            acc += v * w
            if j == i:
                val = a - acc
                if val <= 0:
                    return None
                diag[i] = np.sqrt(val)
                Li[i] = diag[i]
            else:
                Li[j] = (a - acc) / diag[j]
    rows, colsL, vals = [], [], []
    for i in range(n):
        for c, v in Lrows[i].items():
            rows.append(i)
            colsL.append(c)
            vals.append(v)
    return sp.csr_matrix((vals, (rows, colsL)), shape=(n, n))


def level_depth(L):
    """Longest dependency chain of a lower-triangular solve: the number of
    dependent steps a level-scheduled solve needs."""
    L = L.tocsr()
    n = L.shape[0]
    lvl = np.zeros(n, np.int64)
    indptr, idx = L.indptr, L.indices
    for i in range(n):
        m = 0
        for k in range(indptr[i], indptr[i + 1]):
            j = idx[k]
            if j < i and lvl[j] >= m:
                m = lvl[j] + 1
        lvl[i] = m
    return int(lvl.max()) + 1


def systems(device="cuda", sizes: dict | None = None) -> list[System]:
    """The JAX tool's three systems, assembled in float64 on ``device``;
    ``sizes`` maps each name of :data:`SIZES` to another mesh size (the
    names stay)."""
    import torch

    from ..fem.bcs import dtype_safe_penalty
    from ..fem.problem import FemProblem
    from ..mesh.generate import box_tetra_mesh, rect_tria_mesh
    from ..models.elasticity import element_blocks, lame
    from ..ops import elements

    sizes = {**SIZES, **(sizes or {})}
    pen = dtype_safe_penalty(PENALTY, np.float64)
    out = []

    def poisson(mesh, name):
        prob = FemProblem(mesh, ndof=1, dtype=torch.float64, device=device)
        A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
        Ac = csr_of(A, prob.topo).tolil()
        bnodes = np.unique(np.concatenate(
            [c.ravel() for c in mesh.boundary_faces().values()]))
        for i in bnodes:
            Ac[i, i] = Ac[i, i] + pen
        rhs = np.ones(mesh.n_nodes)
        rhs[bnodes] = 0.0
        out.append(System(name, Ac.tocsr(), rhs, A))

    poisson(rect_tria_mesh(*sizes["poisson2d_8k"]), "poisson2d_8k")
    poisson(box_tetra_mesh(*sizes["poisson3d_11k"]), "poisson3d_11k")

    mesh = rect_tria_mesh(*sizes["elasticity2d_5k"])
    prob = FemProblem(mesh, ndof=2, dtype=torch.float64, device=device)
    lam, mu2 = lame(E=21e5, nu=0.28)  # the JAX tool passes 2μ as "mu"
    A = prob.assemble_matrix(lambda ct, xyz: element_blocks(ct, xyz, lam, mu2))
    Ac = csr_of(A, prob.topo).tolil()
    left = np.flatnonzero(mesh.coords[:, 0] < 1e-12)
    for i in np.concatenate([2 * left, 2 * left + 1]):
        Ac[i, i] = Ac[i, i] + pen
    rhs = np.zeros(2 * mesh.n_nodes)
    rhs[1::2] = -1.0
    rhs[2 * left] = 0.0
    rhs[2 * left + 1] = 0.0
    out.append(System("elasticity2d_5k", Ac.tocsr(), rhs, A))
    return out


def decision_row(name: str, A: sp.csr_matrix, rhs: np.ndarray) -> dict:
    """The JAX tool's row of one system: ``system``, ``n``, ``nnz``, the
    PCG iterations of ``jacobi``, ``cheb3``, ``ic0_iters`` and
    ``ilut_iters``, the depths ``ic0_depth`` and ``ilut_depth``, and
    ``ic0_error`` / ``ilut_error`` where a factorisation fails."""
    n = A.shape[0]
    inv_d = 1.0 / np.asarray(A.diagonal())
    row = {"system": name, "n": n, "nnz": A.nnz}
    row["jacobi"] = pcg_iters(A, rhs, lambda r: inv_d * r)
    row["cheb3"] = pcg_iters(A, rhs, cheb_apply_factory(A, 3))
    L = ic0(A)
    if L is not None:
        Lc = L.tocsr()
        Uc = L.T.tocsr()

        def ic_apply(r):
            y = spla.spsolve_triangular(Lc, r, lower=True)
            return spla.spsolve_triangular(Uc, y, lower=False)

        row["ic0_iters"] = pcg_iters(A, rhs, ic_apply)
        row["ic0_depth"] = level_depth(Lc)
    else:
        row["ic0_iters"] = None
        row["ic0_error"] = "breakdown (non-positive pivot)"
    try:
        # stronger than the reference's ILU (pivoted, fill 10x): the upper
        # bound of the incomplete factorisations; its M is not exactly
        # symmetric (pivoting), so its counts are indicative
        ilut = spla.spilu(A.tocsc(), drop_tol=1e-4, fill_factor=10.0)
        row["ilut_iters"] = pcg_iters(A, rhs, ilut.solve)
        row["ilut_depth"] = level_depth(sp.tril(ilut.L.tocsr()))
    except (RuntimeError, ZeroDivisionError) as e:  # a singular factor, a breakdown
        row["ilut_iters"] = None
        row["ilut_error"] = repr(e)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m arcanefem_tpu_torch.tools.ilu_decision",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the systems are assembled (the card by default)")
    ap.add_argument("--out", default=os.path.join(".cache", "queue_results",
                                                  "ilu_decision.json"))
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ilu_decision: no CUDA device is available; pass --device cpu",
              file=sys.stderr)
        return 1
    results = []
    for s in systems(args.device):
        row = decision_row(s.name, s.A, s.rhs)
        print(json.dumps(row), flush=True)
        results.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
