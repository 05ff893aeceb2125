"""Mesh partitioning + per-shard topology (host NumPy, built once per mesh).

The port's copy of ``arcanefem_tpu/parallel/partition.py``: the same
recursive coordinate bisection, the same recompute-overlap rule and the
same stacked arrays, built by the same NumPy code, so both packages shard
a mesh identically, bit for bit (the CPU tests hold them equal).

The decomposition is the reference's MPI domain decomposition (SURVEY.md
§2.3): Arcane partitions the mesh at load, each rank owns cells/nodes plus
a ghost layer, DoF owners mirror node owners (femutils/FemDoFsOnNodes.cc:
113-127) and results are halo-exchanged with ``synchronize()``.

* nodes are partitioned by recursive coordinate bisection (RCB) — balanced,
  locality-preserving, no external graph partitioner needed;
* each shard processes **every cell that touches one of its owned nodes**
  and scatters only into owned rows (the reference's atomic-free
  node-parallel recompute discipline, femutils/BSRFormat.h:938-1100, turned
  into the sharding rule: boundary cells are recomputed on both sides, so
  assembled rows are complete *without any communication*);
* SpMV halo exchange: every shard publishes the owned values other shards
  need into a fixed-size slot of a pool that is all-gathered over the
  ranks; halo values are gathered from the pool by a precomputed index map
  (the ``synchronize()`` role);
* all per-shard arrays are padded to identical shapes and stacked on a
  leading rank axis; rank p of a run (``parallel/sharded.py``) takes row p.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.core import Mesh
from ..sparse.topology import Topology, build_topology


def partition_nodes_rcb(coords: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection of nodes into n_parts balanced parts.

    Returns (n_nodes,) int32 part ids. n_parts need not be a power of two:
    each split is proportional to the number of leaves on each side.
    """
    n = coords.shape[0]
    part = np.zeros(n, np.int32)

    def rec(idx: np.ndarray, parts: int, first: int):
        if parts == 1:
            part[idx] = first
            return
        left = parts // 2
        spread = coords[idx].max(axis=0) - coords[idx].min(axis=0)
        axis = int(np.argmax(spread))
        order = np.argsort(coords[idx, axis], kind="stable")
        cut = int(round(len(idx) * left / parts))
        rec(idx[order[:cut]], left, first)
        rec(idx[order[cut:]], parts - left, first + left)

    rec(np.arange(n), n_parts, 0)
    return part


@dataclass
class ShardedProblem:
    """Stacked per-shard arrays (leading axis = rank). All host NumPy.

    Local x-vector layout per shard: [owned (N_own_max) | halo (H_max)].
    Flat value-slot space per shard: N_own_max * width, plus one dump slot
    (index N_own_max*width) receiving contributions to rows owned elsewhere.
    """

    n_parts: int
    n_nodes: int
    ndof: int
    width: int
    n_own_max: int
    h_max: int
    s_max: int

    part: np.ndarray  # (n_nodes,) int32
    n_own: np.ndarray  # (P,) int32 true owned counts
    owned_global: np.ndarray  # (P, N_own_max) int64, pad = -1
    ell_cols: np.ndarray  # (P, N_own_max, W) int32 local x-space ids
    diag_slot: np.ndarray  # (P, N_own_max) int32 flat slots
    row_valid: np.ndarray  # (P, N_own_max) bool
    send_idx: np.ndarray  # (P, S_max) int32 local owned ids to publish
    halo_src: np.ndarray  # (P, H_max) int32 index into (P*S_max) pool
    # per cell bucket
    cells_xyz: dict  # name -> (P, C_max, npc, 3) float64
    slot_map: dict  # name -> (P, C_max, npc, npc) int32 (dump = N*W)
    rhs_map: dict  # name -> (P, C_max, npc) int32 row ids (dump = N)
    cell_offsets: dict  # name -> (P, C_max) int64 global cell index, pad = -1

    def scatter_global(self, x_shards: np.ndarray) -> np.ndarray:
        """(P, N_own_max[, b]) shard solutions -> (n_nodes[, b]) global."""
        out_shape = (self.n_nodes,) + x_shards.shape[2:]
        out = np.zeros(out_shape, x_shards.dtype)
        for p in range(self.n_parts):
            k = self.n_own[p]
            out[self.owned_global[p, :k]] = x_shards[p, :k]
        return out


# reference corner coordinates used to pad cell buckets so padded element
# matrices are finite (their slots all point at the dump entry anyway)
_PAD_XYZ = {
    3: np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]),
    4: np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]),
}


def build_sharded(
    mesh: Mesh, n_parts: int, pad_width_to: int = 1, pad_rows_to: int = 8,
    topo: Topology | None = None,
) -> ShardedProblem:
    """Partition a mesh and build uniform per-shard assembly topologies.

    The arrays are JAX's ``build_sharded``'s, bit for bit.  JAX sorts each
    part's element keys (16 per tetrahedron) to find its rows; here the rows
    come from the mesh's global node graph ``topo`` (``sparse/topology.py``,
    built here when not given; every cell of an owned node is local, so an
    owned row's columns are its graph row), and the slot of each element
    entry from the graph's slot map, with gathers and prefix sums only: no
    sort of the element entries.  A row's local columns sort as its owned
    columns, then its halo columns, each in global order, since both local
    numberings follow the global one."""
    coords = mesh.coords
    n_nodes = mesh.n_nodes
    part = partition_nodes_rcb(coords, n_parts)
    if topo is None:
        topo = build_topology(n_nodes, mesh.cells)
    if topo.n_nodes != n_nodes or set(topo.slot_maps) != set(mesh.cells):
        raise ValueError("build_sharded: topo is not the mesh's node graph")
    row_ptr = np.asarray(topo.row_ptr, np.int64)
    csr_cols = np.asarray(topo.csr_cols, np.int64)
    deg = np.diff(row_ptr)

    owned = [np.where(part == p)[0] for p in range(n_parts)]
    n_own = np.array([len(o) for o in owned], np.int32)

    # --- local cell sets + halos -------------------------------------------
    local_cells = {}  # name -> list per part of global cell index arrays
    halos = [None] * n_parts
    touched = np.zeros(n_nodes, bool)
    for p in range(n_parts):
        own_mask = part == p
        touched[:] = False
        per_bucket = {}
        for name, conn in mesh.cells.items():
            sel = np.where(own_mask[conn].any(axis=1))[0]
            per_bucket[name] = sel
            touched[conn[sel].reshape(-1)] = True
        local_cells[p] = per_bucket
        tn = np.flatnonzero(touched)
        halos[p] = tn[part[tn] != p]

    n_own_max = int(n_own.max())
    if pad_rows_to > 1:
        n_own_max = -(-n_own_max // pad_rows_to) * pad_rows_to
    h_max = max((len(h) for h in halos), default=0)
    h_max = max(h_max, 1)

    # --- send sets: for each owner q, the union of nodes others need -------
    need_from = [[] for _ in range(n_parts)]
    for p in range(n_parts):
        h = halos[p]
        for q in np.unique(part[h]) if len(h) else []:
            need_from[q].append(h[part[h] == q])
    send_sets = [
        np.unique(np.concatenate(lst)) if lst else np.zeros(0, np.int64)
        for lst in need_from
    ]
    s_max = max(max((len(s) for s in send_sets), default=0), 1)

    # --- per-part local numbering + topology -------------------------------
    g2l = np.full(n_nodes, -1, np.int64)
    owned_global = np.full((n_parts, n_own_max), -1, np.int64)
    send_idx = np.zeros((n_parts, s_max), np.int32)
    halo_src = np.zeros((n_parts, h_max), np.int32)

    # precompute position of each global node inside its owner's send set
    send_pos = np.full(n_nodes, -1, np.int64)
    for q, s in enumerate(send_sets):
        send_pos[s] = np.arange(len(s))

    def numbering(p: int) -> None:
        g2l[:] = -1
        g2l[owned[p]] = np.arange(len(owned[p]))
        g2l[halos[p]] = n_own_max + np.arange(len(halos[p]))

    entries = []  # per part: (global CSR index, local row, position, local col)
    for p in range(n_parts):
        own = owned[p]
        halo = halos[p]
        owned_global[p, : len(own)] = own
        numbering(p)
        if len(send_sets[p]):
            send_idx[p, : len(send_sets[p])] = g2l[send_sets[p]]
        if len(halo):
            halo_src[p, : len(halo)] = (
                part[halo].astype(np.int64) * s_max + send_pos[halo]
            ).astype(np.int32)

        # the owned rows' graph entries, in CSR order
        d = deg[own]
        first = np.cumsum(d) - d  # each row's first entry here
        lrow = np.repeat(np.arange(len(own), dtype=np.int64), d)
        k = np.arange(int(d.sum()), dtype=np.int64)
        idx = k - first[lrow] + row_ptr[own][lrow]
        lcol = g2l[csr_cols[idx]]
        # position in the row's sorted local order: owned columns first
        o = (lcol < n_own_max).astype(np.int64)
        ex = np.cumsum(o) - o  # owned entries before each entry
        own_in_row = np.bincount(lrow, weights=o, minlength=len(own)).astype(np.int64)
        before = ex - ex[first][lrow]  # owned entries before it in its row
        pos = np.where(o == 1, before,
                       own_in_row[lrow] + (k - first[lrow]) - before)
        entries.append((idx, lrow, pos, lcol, d))

    width = max((int(e[4].max()) if len(e[4]) else 1 for e in entries), default=1)
    if pad_width_to > 1:
        width = -(-width // pad_width_to) * pad_width_to

    ell_cols = np.tile(
        np.arange(n_own_max, dtype=np.int32)[None, :, None],
        (n_parts, 1, width),
    )
    # padding rows point at their own (always-zero) first slot so that
    # scatter updates over diag_slot never alias a real row's slot 0
    diag_slot = np.tile(
        (np.arange(n_own_max, dtype=np.int32) * width)[None, :], (n_parts, 1)
    )
    row_valid = np.zeros((n_parts, n_own_max), bool)
    dump = n_own_max * width

    # global ELL slot -> global CSR index, for the graph's slot maps
    ell_to_csr = np.full(n_nodes * topo.width, -1, np.int64)
    ell_to_csr[np.asarray(topo.csr_to_ell, np.int64)] = np.arange(len(csr_cols))

    # --- stacked cell buckets ----------------------------------------------
    c_max = {
        name: max(
            max((len(local_cells[p][name]) for p in range(n_parts)), default=0),
            1,
        )
        for name in mesh.cells
    }
    cells_xyz, slot_map, rhs_map, cell_offsets = {}, {}, {}, {}
    for name, conn_all in mesh.cells.items():
        npc = conn_all.shape[1]
        cm = c_max[name]
        cells_xyz[name] = np.tile(
            _PAD_XYZ[npc][None, None, :, :], (n_parts, cm, 1, 1)
        ).astype(np.float64)
        slot_map[name] = np.full((n_parts, cm, npc, npc), dump, np.int32)
        rhs_map[name] = np.full((n_parts, cm, npc), n_own_max, np.int32)
        cell_offsets[name] = np.full((n_parts, cm), -1, np.int64)

    csr_to_local = np.full(len(csr_cols), dump, np.int64)
    for p in range(n_parts):
        idx, lrow, pos, lcol, _ = entries[p]
        ell_cols[p, lrow, pos] = lcol
        row_valid[p, : n_own[p]] = True
        slot = lrow * width + pos
        on_diag = lcol == lrow
        diag_slot[p, lrow[on_diag]] = slot[on_diag]
        csr_to_local[idx] = slot
        numbering(p)
        for name, conn_all in mesh.cells.items():
            sel = local_cells[p][name]
            if not len(sel):
                continue
            conn = conn_all[sel]
            nc = len(sel)
            cells_xyz[name][p, :nc] = coords[conn]
            cell_offsets[name][p, :nc] = sel
            gslot = np.asarray(topo.slot_maps[name])[sel].astype(np.int64)
            slot_map[name][p, :nc] = csr_to_local[ell_to_csr[gslot]]
            lr = g2l[conn]
            rhs_map[name][p, :nc] = np.where(lr < n_own_max, lr, n_own_max)
        csr_to_local[idx] = dump
        entries[p] = None

    return ShardedProblem(
        n_parts=n_parts,
        n_nodes=n_nodes,
        ndof=1,
        width=width,
        n_own_max=n_own_max,
        h_max=h_max,
        s_max=s_max,
        part=part,
        n_own=n_own,
        owned_global=owned_global,
        ell_cols=ell_cols,
        diag_slot=diag_slot,
        row_valid=row_valid,
        send_idx=send_idx,
        halo_src=halo_src,
        cells_xyz=cells_xyz,
        slot_map=slot_map,
        rhs_map=rhs_map,
        cell_offsets=cell_offsets,
    )
