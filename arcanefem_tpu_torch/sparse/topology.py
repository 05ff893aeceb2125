"""Sparsity topology and assembly slot maps (host numpy, once per mesh).

The port's copy of ``Topology`` and ``build_topology`` from
``arcanefem_tpu/sparse/topology.py``; the CPU tests hold it to the original
with exact equality.  The node-pair graph of a mesh in two views: ELL rows
padded to a fixed width W (the device layout of ``BellMatrix``) and CSR
(the AMG set-up's), plus, per cell bucket, the flat ELL slot of every
(cell, i, j) entry, which turns assembly into one segment sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(eq=False)
class Topology:
    """Node-graph sparsity of one mesh + per-bucket assembly slot maps."""

    n_nodes: int
    width: int  # ELL row width W (max node degree incl. self)
    ell_cols: np.ndarray  # (n_nodes, W) int32; padding entries = own row id
    ell_valid: np.ndarray  # (n_nodes, W) bool; False on padding
    row_ptr: np.ndarray  # (n_nodes+1,) CSR row pointers
    csr_cols: np.ndarray  # (nnz,) int32
    csr_to_ell: np.ndarray  # (nnz,) int32 flat ELL slot of each CSR entry
    diag_slot: np.ndarray  # (n_nodes,) int32 flat ELL slot of the diagonal
    slot_maps: dict[str, np.ndarray]  # bucket -> (nc, npc, npc) int32 slots

    @property
    def nnz(self) -> int:
        return int(self.csr_cols.shape[0])

    @property
    def n_slots(self) -> int:
        return self.n_nodes * self.width


def build_topology(
    n_nodes: int,
    buckets: dict[str, np.ndarray],
    pad_width_to: int = 1,
    use_native: bool = True,
) -> Topology:
    """The node-pair sparsity graph of a mesh: the union over cells of all
    (node_i, node_j) pairs.  buckets: cell type -> (nc, npc) int32
    connectivity; pad_width_to rounds W up to a multiple.  Uses the native
    C++ builder (``native/topology.cpp``) when it loads, numpy otherwise."""
    if use_native and buckets:
        from ..utils.native import build_topology_native

        out = build_topology_native(n_nodes, buckets, pad_width_to)
        if out is not None:
            width, row_ptr, csr_cols, csr_to_ell, diag_slot, ell_cols, ell_valid, smaps = out
            return Topology(
                n_nodes=n_nodes,
                width=int(width),
                ell_cols=ell_cols,
                ell_valid=ell_valid,
                row_ptr=row_ptr.astype(np.int64),
                csr_cols=csr_cols,
                csr_to_ell=csr_to_ell,
                diag_slot=diag_slot,
                slot_maps=smaps,
            )
    keys = []
    for conn in buckets.values():
        nc, npc = conn.shape
        c64 = conn.astype(np.int64)
        rows = np.repeat(c64, npc, axis=1)  # (nc, npc*npc) row-major i
        cols = np.tile(c64, (1, npc))  # j fastest
        keys.append((rows * n_nodes + cols).ravel())
    all_keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)

    uniq, inverse = np.unique(all_keys, return_inverse=True)
    rows = (uniq // n_nodes).astype(np.int32)
    cols = (uniq % n_nodes).astype(np.int32)

    counts = np.bincount(rows, minlength=n_nodes).astype(np.int32)
    width = int(counts.max()) if len(counts) else 1
    if pad_width_to > 1:
        width = -(-width // pad_width_to) * pad_width_to

    row_ptr = np.zeros(n_nodes + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    pos_in_row = np.arange(len(uniq), dtype=np.int32) - row_ptr[rows]
    csr_to_ell = (rows.astype(np.int64) * width + pos_in_row).astype(np.int32)

    # padding col = own row (a safe gather of a zero value)
    ell_cols = np.tile(np.arange(n_nodes, dtype=np.int32)[:, None], (1, width))
    ell_valid = np.zeros((n_nodes, width), bool)
    ell_cols[rows, pos_in_row] = cols
    ell_valid[rows, pos_in_row] = True

    diag_csr = np.searchsorted(uniq, np.arange(n_nodes, dtype=np.int64) * (n_nodes + 1))
    diag_slot = csr_to_ell[np.minimum(diag_csr, len(uniq) - 1)]

    slot_maps: dict[str, np.ndarray] = {}
    off = 0
    entry_slots = csr_to_ell[inverse]
    for name, conn in buckets.items():
        nc, npc = conn.shape
        n = nc * npc * npc
        slot_maps[name] = entry_slots[off : off + n].reshape(nc, npc, npc)
        off += n

    return Topology(
        n_nodes=n_nodes,
        width=width,
        ell_cols=ell_cols,
        ell_valid=ell_valid,
        row_ptr=row_ptr,
        csr_cols=cols,
        csr_to_ell=csr_to_ell,
        diag_slot=diag_slot,
        slot_maps=slot_maps,
    )
