"""Supernode-brick node order (host numpy).

A copy of ``arcanefem_tpu/sparse/supernode.py::supernode_order``: that
module imports jax at its top, and the machine that runs the port has no
jax.  The CPU tests hold this copy to the original with exact equality.

Spatial bricks of about ``bs`` nodes, ordered by reverse Cuthill-McKee on
the brick quotient graph, then nodes ordered by (brick rank, node id).
Neighbouring rows then touch neighbouring columns, which keeps the ELL
gathers' x reads in L2.
"""

from __future__ import annotations

import numpy as np

from ..utils.ordering import rcm_order

BS = 8


def supernode_order(topo, coords: np.ndarray, bs: int = BS) -> np.ndarray:
    """Node permutation with perm[new_id] = old_id (the convention of
    ``rcm_order`` and ``renumber_mesh``)."""
    n, dim = coords.shape
    lo, hi = coords.min(0), coords.max(0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-30)))
    edge = (bs * vol / max(n, 1)) ** (1.0 / dim)
    cell = np.floor((coords - lo) / max(edge, 1e-30)).astype(np.int64)
    dims = cell.max(0) + 1
    key = cell[:, 0]
    for d in range(1, dim):
        key = key * dims[d] + cell[:, d]
    _, brick = np.unique(key, return_inverse=True)
    nb = int(brick.max()) + 1

    # brick quotient graph (CSR) from the node adjacency
    rp, cc = topo.row_ptr.astype(np.int64), topo.csr_cols.astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(rp))
    bk = np.unique(brick[rows] * np.int64(nb) + brick[cc])
    br, bc = (bk // nb).astype(np.int64), (bk % nb).astype(np.int64)
    bptr = np.zeros(nb + 1, np.int64)
    np.add.at(bptr, br + 1, 1)
    np.cumsum(bptr, out=bptr)
    bperm = rcm_order(nb, bptr, bc)  # bperm[new_brick] = old_brick
    rank = np.empty(nb, np.int64)
    rank[bperm] = np.arange(nb)
    return np.lexsort((np.arange(n), rank[brick])).astype(np.int64)
