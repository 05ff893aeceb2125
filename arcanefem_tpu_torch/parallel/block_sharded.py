"""Sharded block (ndof > 1) systems: elasticity and elastodynamics over
torch.distributed.

The counterpart of ``arcanefem_tpu/parallel/block_sharded.py`` (the
reference's distributed vector problems: elasticity assembles
``BSRFormat<2>`` blocks and solves under MPI, modules/elasticity/
FemModule.cc:146-195).  The *same node partition* as the scalar path
(``partition.py``) carries (b, b) blocks: the topology is node-based, so
``ShardedProblem`` is reused unchanged.

Per rank, as the single-card block systems (``sparse/bell.py``):

* values: the SELL values of the scalar expansion (row n·b + a, column
  m·b + c) of the shard's (N_own_max, W) node rows over its
  (N_own_max + H_max)·b [owned | halo] columns, assembled by one
  ``block_slot_reduce`` launch (``Shard.block(b)`` holds its plan);
* x: (N_own_max, b) owned values; the halo exchange moves whole node
  rows, then K1 (``sell_spmv``) on the flattened [owned | halo] vector;
* Dirichlet: a per-dof mask (N_own_max, b); penalty writes the (c, c)
  diagonal entry of the owned diagonal block (HypreDoFLinearSystem.cc:
  356-382 role);
* dots: the local dot and one ``all_reduce`` (IParallelMng::reduce).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import elements
from ..sparse.slot_reduce import block_slot_reduce
from .comm import Comm
from .partition import ShardedProblem
from .sharded import (
    Shard,
    _owner_local,
    rank_rows,
    shard_halo_x,
    shard_pcg,
    shard_spmv,
)


def shard_assemble_blocks(sh: Shard, kernel, b: int) -> torch.Tensor:
    """Element block kernels (nc, npc, npc, b, b) + the fixed-order sum
    into the shard's SELL values of the scalar expansion
    (``block_slot_reduce``, one launch)."""
    plan = sh.block(b)
    parts = [kernel(name, xyz).reshape(-1) for name, xyz in sh.cells_xyz.items()]
    table = parts[0] if len(parts) == 1 else torch.cat(parts)
    return block_slot_reduce(plan.ptr, plan.ids, table.contiguous(), plan.row_ptr,
                             plan.layout, b)


def shard_halo_block(comm: Comm, x_own, send_idx, halo_src) -> torch.Tensor:
    """(N_own_max, b) owned values -> (N_loc, b) [owned | halo]."""
    return shard_halo_x(comm, x_own, send_idx, halo_src)


def shard_spmv_block(comm: Comm, values, sh: Shard, x_own: torch.Tensor) -> torch.Tensor:
    """(N_own_max, b) rows of A x for the block operator ``values``."""
    return shard_spmv(comm, values, sh.block(x_own.shape[1]).layout, x_own,
                      sh.send_idx, sh.halo_src)


def shard_vector_source(sh: Shard, f: torch.Tensor) -> torch.Tensor:
    """rhs[node, c] += f[c] * measure / npc (constant body force, the
    reference's bodyforce option, elasticity FemModule.cc:221-272)."""
    b = f.shape[0]
    parts = []
    for name, xyz in sh.cells_xyz.items():
        npc = xyz.shape[1]
        meas = torch.repeat_interleave(elements.measure(name, xyz) / npc, npc)
        parts.append(meas[:, None] * f[None, :])
    rhs = sh.block(b).rhs_sum(torch.cat(parts))
    return rhs.view(sh.n_own_max + 1, b)[:-1]


def apply_penalty_blocks(values: torch.Tensor, sh: Shard, forced_mask: torch.Tensor,
                         penalty) -> torch.Tensor:
    """Write penalty on the (c, c) diagonal entries of forced dofs
    (``forced_mask`` (N_own_max, b) bool), in place; returns ``values``."""
    plan = sh.block(forced_mask.shape[1])
    values[plan.diag[forced_mask[: sh.n_own]]] = penalty
    return values


def _inv_diag(values: torch.Tensor, sh: Shard, b: int) -> torch.Tensor:
    """(N_own_max, b) inverse of the dof diagonal, 0 on padding rows."""
    d = torch.zeros((sh.n_own_max, b), dtype=values.dtype, device=values.device)
    d[: sh.n_own] = values[sh.block(b).diag]
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def _element_kernel(lam: float, mu2: float):
    def kernel(name, xyz):
        if name == "tria3":
            return elements.elasticity_tria3(xyz, lam, mu2)
        if name == "tetra4":
            return elements.elasticity_tetra4(xyz, lam, mu2)
        raise ValueError(f"no elasticity kernel for '{name}'")

    return kernel


def make_elasticity_step(sp: ShardedProblem, comm: Comm, lam: float, mu2: float,
                         rtol: float = 1.0e-7, atol: float = 0.0,
                         max_iter: int = 1000, ndof: int = 2):
    """The sharded elasticity step: block assembly + penalty BC + Jacobi-PCG.

    fn(sh, f, forced_mask, forced_val, penalty) -> (x, iters, res) with x
    this rank's (N_own_max, b) rows; forced_mask/val are the (P,
    N_own_max, b) stacked per-dof penalty-Dirichlet arrays of
    :func:`stacked_dof_mask` (host); ``f`` the (b,) constant body force."""
    b = ndof
    kernel = _element_kernel(lam, mu2)

    def step(sh: Shard, f, forced_mask, forced_val, penalty):
        mask = rank_rows(forced_mask, comm).bool()
        val = rank_rows(forced_val, comm, sh.dtype)
        values = shard_assemble_blocks(sh, kernel, b)
        rhs = shard_vector_source(sh, torch.as_tensor(f, device=sh.device).to(sh.dtype))
        values = apply_penalty_blocks(values, sh, mask, penalty)
        rhs = torch.where(mask, penalty * val, rhs)
        inv_diag = _inv_diag(values, sh, b)
        x0 = torch.where(mask, val, 0.0)

        def spmv(x):
            return shard_spmv_block(comm, values, sh, x)

        return shard_pcg(comm, spmv, inv_diag, rhs, x0, rtol, atol, max_iter, free=~mask)

    return step


def make_elastodynamics_loop(sp: ShardedProblem, comm: Comm, coeffs: dict,
                             gamma: float, beta: float, dt: float, n_steps: int,
                             rtol: float = 1.0e-10, atol: float = 0.0,
                             max_iter: int = 2000, ndof: int = 2):
    """Sharded transient elastodynamics: the reference's synchronize()-per-
    step Newmark loop (modules/elastodynamics/FemModule.cc:429+).

    The three unit operators M (mass), D (divdiv), E (epseps) are assembled
    once per shard (one ``block_slot_reduce`` each), the LHS is c0·M +
    c1·D + c2·E with penalty Dirichlet written once, and each of the
    ``n_steps`` steps rebuilds only the RHS (three halo-exchanged block
    SpMVs), solves with the distributed PCG warm-started at the previous
    displacement, and applies the Newmark update.

    Returns fn(sh, f, forced_mask, forced_val, penalty) -> (U, V, A,
    iters_total) with this rank's (N_own_max, b) states."""
    b = ndof
    c = coeffs
    mass_c = (c["c0"], c["c3"], c["c4"])
    div_c = (-c["c5"], c["c7"], c["c8"])
    eps_c = (-c["c6"], c["c9"], c["c10"])

    def run(sh: Shard, f, forced_mask, forced_val, penalty):
        mask = rank_rows(forced_mask, comm).bool()
        val = rank_rows(forced_val, comm, sh.dtype)
        Mv = shard_assemble_blocks(sh, lambda ct, xyz: elements.mass_blocks(ct, xyz, b), b)
        Dv = shard_assemble_blocks(sh, elements.divdiv, b)
        Ev = shard_assemble_blocks(sh, elements.epseps, b)
        Av = c["c0"] * Mv + c["c1"] * Dv + c["c2"] * Ev
        Av = apply_penalty_blocks(Av, sh, mask, penalty)
        rhs_body = shard_vector_source(sh, torch.as_tensor(f, device=sh.device).to(sh.dtype))
        inv_diag = _inv_diag(Av, sh, b)

        def spmv_of(vals):
            return lambda x: shard_spmv_block(comm, vals, sh, x)

        A_mv, M_mv, D_mv, E_mv = spmv_of(Av), spmv_of(Mv), spmv_of(Dv), spmv_of(Ev)
        U = torch.where(mask, val, 0.0)
        V = torch.zeros_like(U)
        Acc = torch.zeros_like(U)
        it_tot = 0
        for _ in range(n_steps):
            rhs = rhs_body
            rhs = rhs + M_mv(mass_c[0] * U + mass_c[1] * V + mass_c[2] * Acc)
            rhs = rhs + D_mv(div_c[0] * U + div_c[1] * V + div_c[2] * Acc)
            rhs = rhs + E_mv(eps_c[0] * U + eps_c[1] * V + eps_c[2] * Acc)
            rhs = torch.where(mask, penalty * val, rhs)
            x0 = torch.where(mask, val, U)
            dU, it, _res = shard_pcg(comm, A_mv, inv_diag, rhs, x0, rtol, atol, max_iter,
                                     free=~mask)
            aloc = ((dU - U - dt * V) / (beta * dt * dt)
                    - (1 - 2 * beta) / (2 * beta) * Acc)
            V = V + dt * ((1 - gamma) * Acc + gamma * aloc)
            U, Acc = dU, aloc
            it_tot += it
        return U, V, Acc, it_tot

    return run


def stacked_dof_mask(sp: ShardedProblem, ndof: int,
                     node_sets: list[tuple[np.ndarray, int, float]]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(P, N_own_max, b) mask/value arrays from (nodes, comp, value) sets."""
    mask = np.zeros((sp.n_parts, sp.n_own_max, ndof), bool)
    val = np.zeros((sp.n_parts, sp.n_own_max, ndof), np.float64)
    for nodes, comp, value in node_sets:
        p_of, loc = _owner_local(sp, nodes)
        mask[p_of, loc, comp] = True
        val[p_of, loc, comp] = value
    return mask, val
