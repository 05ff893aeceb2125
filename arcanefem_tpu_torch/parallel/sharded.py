"""Sharded FEM execution over torch.distributed: assembly, halo-exchange
SpMV, distributed PCG.

The counterpart of ``arcanefem_tpu/parallel/sharded.py`` (the reference's
MPI execution model, SURVEY.md §2.3).  JAX runs one ``shard_map`` program
over a leading device axis; here one process per rank runs the same steps
on its own shard (``parallel/comm.py`` maps the collectives):

* assembly needs **no communication** — each rank recomputes the element
  matrices of its boundary cells (``partition.py`` builds the overlap):
  ``ops/elements`` over the shard's cells, summed into the shard's SELL
  slots by the fixed-order ``slot_reduce`` (one launch, through contributor
  lists built once per shard; the entries of rows owned elsewhere go to a
  dump slot past the last), the RHS by a ``SlotSum``;
* SpMV = publish the owned values others need, all-gather the pool, gather
  the halo (``index_select``, as JAX's XLA gathers), then K1
  (``sell_spmv``) on the shard's rectangular SELL layout: N_own_max rows
  over the N_own_max + H_max columns of [owned | halo];
* CG dot products are the local dot and one ``all_reduce`` (JAX's
  ``psum(vdot)``; the reference's ``IParallelMng::reduce``).

:func:`shard_pcg` keeps the JAX ``while_loop``'s semantics: the stopping
test is read after every iteration, one host synchronisation per
iteration, so the iteration counts are JAX's.

Rows past ``n_own[p]`` are padding: no slot of theirs is stored (their
SELL rows are empty, so K1 gives 0 there), their diagonal is 0 and so is
their inverse diagonal.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import elements
from ..sparse.bell import block_layout
from ..sparse.sell import SellLayout, sell_spmv
from ..sparse.slot_reduce import SlotSum, group_by_slot, slot_reduce
from .comm import Comm
from .partition import ShardedProblem


class Shard:
    """Rank ``rank``'s row of a :class:`ShardedProblem` on its device, and
    the plans its kernels take, built once:

    * ``layout``: the SELL layout of the shard's (N_own_max, W) ELL rows
      over the N_own_max + H_max local columns, its real slots the ones
      some element entry sums into;
    * ``asm_ptr``, ``asm_ids``: the contributor lists of every SELL slot
      over the buckets' element matrices, concatenated (entries
      ``c·npc² + i·npc + j``), for ``slot_reduce``;
    * ``rhs_sum``: the ``SlotSum`` of the cell-node entries into owned rows;
    * ``diag``: the SELL slot of each owned row's diagonal (n_own,);
    * ``send_idx``, ``halo_src``: the halo exchange's index maps (int64);
    * ``cells_xyz``: bucket -> (C_max, npc, 3) corner coordinates.

    :meth:`block` gives the b×b block plan of the same shard."""

    def __init__(self, sp: ShardedProblem, rank: int, device, dtype: torch.dtype):
        if not 0 <= rank < sp.n_parts:
            raise ValueError(f"rank {rank} of a {sp.n_parts}-part problem")
        self.rank, self.device, self.dtype = rank, torch.device(device), dtype
        N, W = sp.n_own_max, sp.width
        self.n_own = int(sp.n_own[rank])
        self.n_own_max, self.width, self.h_max = N, W, sp.h_max
        self.ell_cols = np.asarray(sp.ell_cols[rank])
        self.slot_map = {k: np.asarray(v[rank]) for k, v in sp.slot_map.items()}
        dump = N * W
        used = np.zeros(N * W + 1, bool)
        for smap in self.slot_map.values():
            used[smap.reshape(-1)] = True
        self.real = used[:dump].reshape(N, W)
        self.layout = SellLayout.build(self.ell_cols, self.real, device=self.device,
                                       n_cols=N + sp.h_max)
        lay = self.layout
        e2s = np.append(lay.ell_to_sell, lay.n_slots)  # the dump slot: past the last
        slots = np.concatenate([e2s[m.reshape(-1).astype(np.int64)]
                                for m in self.slot_map.values()])
        ptr, self.asm_ids = group_by_slot(torch.as_tensor(slots, device=self.device),
                                          lay.n_slots + 1)
        self.asm_ptr = ptr[: lay.n_slots + 1].contiguous()  # the dump's sum is never read
        rmap = np.concatenate([np.asarray(v[rank]).reshape(-1)
                               for v in sp.rhs_map.values()])
        self.rhs_map = {k: np.asarray(v[rank]) for k, v in sp.rhs_map.items()}
        self.rhs_sum = SlotSum(rmap, N + 1, self.device)
        self.diag_slot = np.asarray(sp.diag_slot[rank], np.int64)  # flat ELL slots
        self.diag = torch.as_tensor(lay.ell_to_sell[self.diag_slot[: self.n_own]],
                                    device=self.device)
        self.send_idx = torch.as_tensor(np.asarray(sp.send_idx[rank], np.int64),
                                        device=self.device)
        self.halo_src = torch.as_tensor(np.asarray(sp.halo_src[rank], np.int64),
                                        device=self.device)
        self.cells_xyz = {k: torch.as_tensor(v[rank], device=self.device).to(dtype)
                          for k, v in sp.cells_xyz.items()}
        self._blocks: dict = {}

    def block(self, b: int) -> "BlockShard":
        """The b×b block plan of this shard (built once per b)."""
        if b not in self._blocks:
            self._blocks[b] = BlockShard(self, b)
        return self._blocks[b]


class BlockShard:
    """The block (b×b, dof = node·b + comp) plan of a :class:`Shard`: the
    SELL layout of the scalar expansion over (N_own_max + H_max)·b columns
    (``sparse/bell.py::block_layout``), the node-level contributor lists
    and node CSR ``row_ptr`` that ``block_slot_reduce`` takes, ``diag``
    the (n_own, b) SELL slots of the owned dofs' diagonals and ``rhs_sum``
    the ``SlotSum`` of (cell-node, comp) entries into owned dofs."""

    def __init__(self, sh: Shard, b: int):
        N, W = sh.n_own_max, sh.width
        self.b = b
        counts = sh.real.sum(axis=1)
        row_ptr = np.zeros(N + 1, np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        # the shard's real slots lead their rows, in column order
        # (partition.py fills positions 0 .. count-1 of each row)
        lead = np.arange(W)[None, :] < counts[:, None]
        if not np.array_equal(lead, sh.real):
            raise ValueError("BlockShard: the shard's real slots do not lead their rows")
        # the Topology fields block_layout reads, for the shard's rows
        topo = SimpleNamespace(n_nodes=N, width=W, ell_cols=sh.ell_cols,
                               ell_valid=sh.real, diag_slot=sh.diag_slot)
        self.layout, diag, dblock = block_layout(topo, b, sh.device,
                                                 n_cols=(N + sh.h_max) * b)
        self.diag = diag.view(N, b)[: sh.n_own]
        self.dblock_slot = dblock[: sh.n_own]
        n_csr = int(row_ptr[-1])
        ell_to_csr = np.full(N * W + 1, n_csr, np.int64)  # the dump: past the last
        ell_to_csr[np.flatnonzero(sh.real.reshape(-1))] = np.arange(n_csr)
        slots = np.concatenate([ell_to_csr[m.reshape(-1).astype(np.int64)]
                                for m in sh.slot_map.values()])
        ptr, self.ids = group_by_slot(torch.as_tensor(slots, device=sh.device), n_csr + 1)
        self.ptr = ptr[: n_csr + 1].contiguous()
        self.row_ptr = torch.as_tensor(row_ptr.astype(np.int32), device=sh.device)
        rmap = np.concatenate([v.reshape(-1).astype(np.int64)
                               for v in sh.rhs_map.values()])
        comp = np.arange(b, dtype=np.int64)
        self.rhs_sum = SlotSum((rmap[:, None] * b + comp[None, :]).reshape(-1),
                               (N + 1) * b, sh.device)


def put_sharded(sp: ShardedProblem, comm: Comm, dtype=torch.float32) -> Shard:
    """This rank's shard of ``sp`` on its device (JAX's ``put_sharded``
    places every shard; a rank holds only its own)."""
    return Shard(sp, comm.rank, comm.device, dtype)


# --- per-shard steps (each rank on its own shard) ----------------------------


def shard_assemble(sh: Shard, coef=1.0) -> torch.Tensor:
    """Element kernels + the fixed-order sum into the shard's (n_slots,)
    SELL values (``slot_reduce``, one launch)."""
    parts = [(coef * elements.stiffness(name, xyz)).reshape(-1)
             for name, xyz in sh.cells_xyz.items()]
    table = parts[0] if len(parts) == 1 else torch.cat(parts)
    return slot_reduce(sh.asm_ptr, sh.asm_ids, table.contiguous())


def shard_source_rhs(sh: Shard, f) -> torch.Tensor:
    """rhs[node] += f * measure / npc (constant volume source)."""
    parts = []
    for name, xyz in sh.cells_xyz.items():
        npc = xyz.shape[1]
        parts.append(torch.repeat_interleave(f * elements.measure(name, xyz) / npc, npc))
    return sh.rhs_sum(torch.cat(parts))[:-1]


def shard_halo_x(comm: Comm, x_own: torch.Tensor, send_idx: torch.Tensor,
                 halo_src: torch.Tensor) -> torch.Tensor:
    """Publish owned values, all-gather the pool, gather halo values:
    (N_own_max[, b]) -> (N_own_max + H_max[, b]) [owned | halo]."""
    pool = comm.all_gather_pool(x_own[send_idx])
    return torch.cat([x_own, pool[halo_src]])


def shard_spmv(comm: Comm, values: torch.Tensor, layout: SellLayout, x_own: torch.Tensor,
               send_idx: torch.Tensor, halo_src: torch.Tensor) -> torch.Tensor:
    """The shard's rows of A x: the halo exchange, then K1 on the
    rectangular layout (x of shape (N[, b]) gives (N[, b]))."""
    x_loc = shard_halo_x(comm, x_own, send_idx, halo_src)
    return sell_spmv(values, layout, x_loc.reshape(-1)).view(x_own.shape)


def pdot(comm: Comm, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return comm.pdot(a.reshape(-1), b.reshape(-1))


_CLOCK = {"s": 0.0, "iters": 0}  # the CG loops' seconds and iterations
_LAST: dict = {}  # the last solve's operator, right-hand side and free rows


def reset_solve_clock() -> None:
    _CLOCK.update(s=0.0, iters=0)


def solve_clock() -> tuple[float, int]:
    """(seconds, iterations) of the CG loops since :func:`reset_solve_clock`
    (host clock; the stopping test synchronises every iteration)."""
    return _CLOCK["s"], _CLOCK["iters"]


def record_solve(spmv, b: torch.Tensor, free, seconds: float, iters: int) -> None:
    """Keep a finished solve's operator, right-hand side and free rows (a
    bool tensor of b's shape, or None for all) for
    :func:`last_system_residual`, and add its time to the clock."""
    _LAST.update(spmv=spmv, b=b, free=free)
    _CLOCK["s"] += seconds
    _CLOCK["iters"] += iters


def last_system_residual(comm: Comm, x: torch.Tensor, free=None) -> float:
    """‖(b − A x)_free‖ / ‖b_free‖ over every rank's free rows, in float64,
    of the last recorded solve (``free`` overrides its rows)."""
    b = _LAST["b"]
    free = _LAST["free"] if free is None else free
    r = (b - _LAST["spmv"](x)).double()
    bd = b.double()
    if free is not None:
        r = torch.where(free, r, 0.0)
        bd = torch.where(free, bd, 0.0)
    num = comm.psum((r * r).sum())
    den = comm.psum((bd * bd).sum())
    return math.sqrt(float(num) / max(float(den), 1e-300))


def shard_pcg(comm: Comm, spmv, precond, b: torch.Tensor, x0: torch.Tensor,
              rtol: float, atol: float, max_iter: int, free=None):
    """Distributed PCG; same convergence criterion as solver.iterative
    (preconditioned norm, relative to the warm-started initial residual).

    ``precond`` is an inverse-diagonal tensor (elementwise Jacobi) or a
    callable r -> M r (e.g. a sharded AMG V-cycle).  The stopping test is
    read on the host after every iteration, as the JAX ``while_loop``
    tests it.  ``free``: the rows that are not Dirichlet rows, kept with
    the solve (:func:`record_solve`).  Returns (x, iterations, rel)."""
    t0 = time.perf_counter()
    apply_M = precond if callable(precond) else (lambda r: precond * r)
    r = b - spmv(x0)
    z = apply_M(r)
    rz0 = pdot(comm, r, z)
    tol2 = max(rtol * rtol * abs(float(rz0)), atol * atol)
    x, p, rz, k = x0, z, rz0, 0
    while abs(float(rz)) > tol2 and k < max_iter:
        Ap = spmv(p)
        alpha = rz / pdot(comm, p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = pdot(comm, r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    rel = math.sqrt(abs(float(rz)) / max(abs(float(rz0)), 1e-300))
    record_solve(spmv, b, free, time.perf_counter() - t0, k)
    return x, k, rel


def rank_rows(stacked, comm: Comm, dtype=None) -> torch.Tensor:
    """Row ``comm.rank`` of a stacked (P, ...) host array (a mask or value
    array of :func:`stacked_node_mask`), on the rank's device."""
    t = torch.as_tensor(np.asarray(stacked)[comm.rank], device=comm.device)
    return t if dtype is None else t.to(dtype)


def penalised_poisson(sh: Shard, comm: Comm, f, forced_mask, forced_val, penalty):
    """The shard's Poisson system with penalty Dirichlet
    (HypreDoFLinearSystem.cc:356-382 role): (values, rhs, inv_diag, x0)."""
    dtype = sh.dtype
    values = shard_assemble(sh)
    rhs = shard_source_rhs(sh, f)
    mask = rank_rows(forced_mask, comm).bool()
    val = rank_rows(forced_val, comm, dtype)
    values[sh.diag[mask[: sh.n_own]]] = penalty
    rhs = torch.where(mask, penalty * val, rhs)
    d = torch.zeros(sh.n_own_max, dtype=dtype, device=sh.device)
    d[: sh.n_own] = values[sh.diag]
    inv_diag = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)
    x0 = torch.where(mask, val, 0.0)
    return values, rhs, inv_diag, x0


def make_poisson_step(sp: ShardedProblem, comm: Comm, rtol: float = 1.0e-7,
                      atol: float = 0.0, max_iter: int = 1000):
    """The sharded Poisson step: assemble + penalty BC + Jacobi-PCG.

    Returns fn(sh, f, forced_mask, forced_val, penalty) -> (x, iters, res)
    with x this rank's (N_own_max,) rows; ``sh`` is :func:`put_sharded`'s
    shard and ``forced_mask``/``forced_val`` the (P, N_own_max) stacked
    penalty-Dirichlet arrays of :func:`stacked_node_mask` (host)."""

    def step(sh: Shard, f, forced_mask, forced_val, penalty):
        values, rhs, inv_diag, x0 = penalised_poisson(sh, comm, f, forced_mask,
                                                      forced_val, penalty)

        def spmv(x):
            return shard_spmv(comm, values, sh.layout, x, sh.send_idx, sh.halo_src)

        return shard_pcg(comm, spmv, inv_diag, rhs, x0, rtol, atol, max_iter,
                         free=~rank_rows(forced_mask, comm).bool())

    return step


def all_gather_shards(comm: Comm, x: torch.Tensor) -> np.ndarray:
    """Every rank's (N_own_max[, b]) rows stacked (P, N_own_max[, b]) on the
    host, on every rank (``ShardedProblem.scatter_global`` takes them)."""
    pool = comm.all_gather_pool(x)
    return pool.view((comm.world,) + tuple(x.shape)).cpu().numpy()


def stacked_node_mask(
    sp: ShardedProblem, nodes: np.ndarray, values: np.ndarray | float
) -> tuple[np.ndarray, np.ndarray]:
    """(P, N_own_max) mask/value arrays for a global node set (host)."""
    mask = np.zeros((sp.n_parts, sp.n_own_max), bool)
    val = np.zeros((sp.n_parts, sp.n_own_max), np.float64)
    vals = np.broadcast_to(np.asarray(values, np.float64), np.shape(nodes))
    p_of, loc = _owner_local(sp, nodes)
    mask[p_of, loc] = True
    val[p_of, loc] = vals
    return mask, val


def _owner_local(sp: ShardedProblem, nodes) -> tuple[np.ndarray, np.ndarray]:
    """(owner part, local row) of each global node."""
    nodes = np.asarray(nodes)
    loc = np.full(sp.n_nodes, -1, np.int64)
    for p in range(sp.n_parts):
        k = sp.n_own[p]
        loc[sp.owned_global[p, :k]] = np.arange(k)
    return sp.part[nodes], loc[nodes]

