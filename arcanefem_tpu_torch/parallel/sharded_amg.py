"""Distributed unstructured AMG-PCG over torch.distributed.

The counterpart of ``arcanefem_tpu/parallel/sharded_amg.py``: the Hypre
role (reference femutils/HypreDoFLinearSystem.cc:264-303,686-742: global
numbering + distributed BoomerAMG-preconditioned PCG) over the RCB node
partition:

* the FINE level — where virtually all V-cycle flops and bandwidth live —
  is sharded: damped Jacobi (``omega0``, ``nu`` sweeps) over the shard's
  rows, residuals through the halo-exchange SpMV (K1);
* restriction ``r_c = P^T r`` is K1 on the shard's rows of P^T (its owned
  rows' transfer entries, transposed on the host), then one
  ``all_reduce`` of the coarse vector (the reference's allReduce role);
* all COARSER levels are replicated: every rank runs the port's own
  ``AMGPrecond`` (K1 on every level and transfer) on its copy — coarse
  grids are small, so duplicated flops are cheaper than collectives;
* prolongation is K1 on the shard's rows of P.

Set-up (strength/aggregation/Galerkin) stays on the host, in
``solver/amg_setup.py::amg_setup`` on the globally assembled matrix (or
any hierarchy in that dict form); :func:`build_sharded_amg` re-partitions
its fine level and keeps the rest as the replicated inner hierarchy.  The
JAX module strips the inner hierarchy's Pallas operators because
``shard_map`` cannot hold them; a rank here runs its kernels as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sps
import torch

from ..solver.amg import amg_from_numpy
from ..solver.amg_setup import _p_ell
from ..sparse.bell import BellMatrix
from .comm import Comm
from .partition import ShardedProblem
from .sharded import Shard, penalised_poisson, rank_rows, shard_pcg, shard_spmv


@dataclass
class ShardedAMG:
    """Host-built partition of an AMG hierarchy (see build_sharded_amg)."""

    inv_diag0: np.ndarray  # (P, N_own_max) fine inverse diagonal, 0 on pad
    pcols0: np.ndarray  # (P, N_own_max, Wp) coarse GLOBAL ids, pad -> n1
    pvals0: np.ndarray  # (P, N_own_max, Wp) 0.0 on padding
    n1: int  # coarse-space size of the first transfer
    omega0: float
    nu: int
    inner: dict  # levels 1.. (replicated), amg_from_numpy's dict; may have 0 mats


def _shift(v):
    """A per-level tuple without its first level (its last entry kept when
    it has one level only), or a scalar as it is."""
    if isinstance(v, (tuple, list)):
        return tuple(v[1:]) or tuple(v[-1:])
    return v


def build_sharded_amg(sp: ShardedProblem, amg: dict) -> ShardedAMG:
    """Partition the fine level of a host-built AMG hierarchy (the dict of
    ``amg_setup``, which ``amg_from_numpy`` takes) by sp's rows."""
    inv0 = np.asarray(amg["inv_diags"][0])
    pc0 = np.asarray(amg["pcols"][0])
    pv0 = np.asarray(amg["pvals"][0])
    # mats[0] is the FINE matrix; the coarse size of transfer 0 is the row
    # count of level 1 (mats[1] if present, else the dense coarsest)
    n1 = (int(np.shape(amg["mats"][1][0])[0]) if len(amg["mats"]) > 1
          else int(np.asarray(amg["coarse_inv"]).shape[0]))
    P, N = sp.n_parts, sp.n_own_max
    Wp = pc0.shape[1]
    inv_diag0 = np.zeros((P, N), inv0.dtype)
    pcols0 = np.full((P, N, Wp), n1, np.int32)
    pvals0 = np.zeros((P, N, Wp), pv0.dtype)
    for p in range(P):
        k = sp.n_own[p]
        own = sp.owned_global[p, :k]
        inv_diag0[p, :k] = inv0[own]
        pcols0[p, :k] = pc0[own]
        pvals0[p, :k] = pv0[own]
    # zero-valued transfer entries keep their (arbitrary) column; route all
    # of them to the dump column n1
    pcols0 = np.where(pvals0 != 0.0, pcols0, n1).astype(np.int32)
    inner = {k: v for k, v in amg.items() if k != "layouts"}
    for k in ("mats", "inv_diags", "pcols", "pvals", "ptcols", "ptvals"):
        inner[k] = list(amg[k][1:])
    inner.update(omegas=tuple(amg["omegas"][1:]),
                 rhos=tuple(amg["rhos"][1:]) if amg.get("rhos") else (),
                 cheb_deg=_shift(amg["cheb_deg"]), l0_binv=None)
    return ShardedAMG(inv_diag0=inv_diag0, pcols0=pcols0, pvals0=pvals0, n1=n1,
                      omega0=float(amg["omegas"][0]), nu=int(amg["nu"]), inner=inner)


def put_sharded_amg(samg: ShardedAMG, comm: Comm, dtype) -> dict:
    """This rank's fine-level AMG operators on its device: ``inv_diag0``,
    ``P0`` (N_own_max × n1) and ``Pt0`` (n1 × N_own_max), BellMatrix
    operators (K1), and ``inner``, the replicated ``AMGPrecond`` of levels
    1.. (its levels and transfers K1 too)."""
    p, dev = comm.rank, comm.device
    pv, pc = samg.pvals0[p], samg.pcols0[p]
    real = pv != 0
    N = pv.shape[0]
    P0 = BellMatrix.from_numpy(pv, np.where(real, pc, 0), device=dev, dtype=dtype,
                               n_cols=samg.n1)
    rows = np.repeat(np.arange(N), real.sum(axis=1))
    Pt = sps.csr_matrix((pv[real].astype(np.float64), (pc[real], rows)),
                        shape=(samg.n1, N))
    Pt.sum_duplicates()
    tc, tv = _p_ell(Pt, np.float64)
    Pt0 = BellMatrix.from_numpy(tv, tc, device=dev, dtype=dtype, n_cols=N)
    return {"inv_diag0": torch.as_tensor(samg.inv_diag0[p], device=dev).to(dtype),
            "P0": P0, "Pt0": Pt0,
            "inner": amg_from_numpy(samg.inner, dev, dtype)}


def fine_vcycle(comm: Comm, spmv, arrs: dict, omega0: float, nu: int,
                r: torch.Tensor) -> torch.Tensor:
    """Sharded fine level (smooth/restrict/prolong) around the replicated
    inner hierarchy; ``arrs`` is :func:`put_sharded_amg`'s."""
    inv = arrs["inv_diag0"]
    om = omega0
    x = om * inv * r
    for _ in range(nu - 1):
        x = x + om * inv * (r - spmv(x))
    rr = r - spmv(x)
    rc = comm.psum(arrs["Pt0"].spmv(rr))
    xc = arrs["inner"].apply(rc)
    x = x + arrs["P0"].spmv(xc)
    for _ in range(nu):
        x = x + om * inv * (r - spmv(x))
    return x


def make_poisson_amg_step(sp: ShardedProblem, comm: Comm, samg: ShardedAMG,
                          rtol: float = 1.0e-7, atol: float = 0.0,
                          max_iter: int = 200):
    """The sharded Poisson step preconditioned by the distributed AMG
    V-cycle: fn(sh, samg_arrs, f, forced_mask, forced_val, penalty) ->
    (x, iters, res), ``samg_arrs`` from :func:`put_sharded_amg` (it holds
    the inner hierarchy that JAX passes apart); otherwise as
    ``sharded.make_poisson_step``."""
    omega0, nu = samg.omega0, samg.nu

    def step(sh: Shard, samg_arrs: dict, f, forced_mask, forced_val, penalty):
        values, rhs, _inv, x0 = penalised_poisson(sh, comm, f, forced_mask,
                                                  forced_val, penalty)

        def spmv(x):
            return shard_spmv(comm, values, sh.layout, x, sh.send_idx, sh.halo_src)

        def vcycle(r):
            return fine_vcycle(comm, spmv, samg_arrs, omega0, nu, r)

        return shard_pcg(comm, spmv, vcycle, rhs, x0, rtol, atol, max_iter,
                         free=~rank_rows(forced_mask, comm).bool())

    return step
