"""Gather assemblies for general meshes: the contributor-list orders of the
JAX package's window-gather assemblers.

The counterpart of ``arcanefem_tpu/sparse/pallas_assembly.py::
PallasAssembler`` (:50-102) and ``::ReorderedAssembler`` (:105-213).  On
the TPU each inverts the assembly's scatter into a gather whose sources
must fit a VMEM window: ``PallasAssembler`` gathers every slot's entries
(its ``src`` rows, padded with -1), ``ReorderedAssembler`` first splits the
tetrahedra's entries into 16 streams by local corner pair (stream (ki, kj)
sorts the cells by ``conn[:, ki]``) and reduces the concatenated streams.
Their plans exist only where the windows fit (2D and narrow-band meshes);
on a 3D mesh they decline (``available`` False).

Here both are the same operator as ``sparse/slot_reduce.py``: each SELL
slot sums its contributors in float64, rounded once (one ``slot_reduce``
launch, no atomics), and the two classes differ only in the order of each
slot's list — ``PallasAssembler`` in entry order (the ``src`` rows without
their padding), ``ReorderedAssembler`` in stream order (stream q = ki·4 +
kj, then the stream's sorted position).  A gather on the card reads
through L2 and needs no window, so ``available`` is True on any mesh.
The lists are built once, on the device, with torch (stable sorts).
"""

from __future__ import annotations

import numpy as np
import torch

from .bell import fine_layout, slot_contributors
from .sell import SellLayout
from .slot_reduce import group_by_slot, slot_reduce

# tetra upper-triangle (i<=j) local pair -> packed index 0..9 (row-major:
# (0,0),(0,1),...,(3,3)): the columns of the (nc, 10) element table that
# ops/lane_assembly.py::tet_element writes; Q2P16 maps the full ordered
# pair q=i*4+j onto it
TRI10 = {
    (i, j): k
    for k, (i, j) in enumerate((i, j) for i in range(4) for j in range(i, 4))
}
Q2P16 = np.array(
    [TRI10[(min(i, j), max(i, j))] for i in range(4) for j in range(4)],
    np.int64,
)


class PallasAssembler:
    """values = PallasAssembler(topo, device=...)(mats): the (n_slots,) SELL
    values of ``layout`` (default ``fine_layout(topo)``) from cell-type ->
    (nc, npc, npc) element matrices of any cell types, each slot's entries
    ``base + c·npc² + i·npc + j`` summed in entry order.  ``available`` is
    True: the JAX class declines where its VMEM window does not fit, which
    a gather on the card does not need."""

    def __init__(self, topo, *, device: torch.device | str,
                 layout: SellLayout | None = None):
        self.topo = topo
        self.layout = fine_layout(topo, device) if layout is None else layout
        self.ptr, self.ids = slot_contributors(topo, list(topo.slot_maps), self.layout)

    @property
    def available(self) -> bool:
        return True

    def __call__(self, mats: dict) -> torch.Tensor:
        parts = [mats[k].reshape(-1) for k in self.topo.slot_maps]
        table = parts[0] if len(parts) == 1 else torch.cat(parts)
        return slot_reduce(self.ptr, self.ids, table.contiguous())


def reordered_lists(topo, conn: np.ndarray, layout: SellLayout
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ptr, ids), int32 on ``layout``'s device: each SELL slot's
    contributors in ``ReorderedAssembler``'s stream order, as rows
    ``c·10 + TRI10[min(ki, kj), max(ki, kj)]`` of the (nc, 10) element
    table."""
    dev = layout.device
    c = torch.as_tensor(np.asarray(conn), device=dev).long()
    nc = c.shape[0]
    e2s = torch.as_tensor(layout.ell_to_sell.astype(np.int32), device=dev)
    sm = e2s[torch.as_tensor(topo.slot_maps["tetra4"], device=dev).reshape(nc, 16)]
    dest, src = [], []
    for q16, (ki, kj) in enumerate((i, j) for i in range(4) for j in range(4)):
        order = torch.sort(c[:, ki], stable=True).indices
        dest.append(sm[order, q16])
        src.append((order * 10 + TRI10[min(ki, kj), max(ki, kj)]).to(torch.int32))
    del sm
    ptr, pos = group_by_slot(torch.cat(dest), layout.n_slots)
    del dest
    return ptr, torch.cat(src)[pos.long()]


class ReorderedAssembler:
    """Scatter-free 3D tetra assembly in per-ordered-pair stream order:
    ``ReorderedAssembler(topo, conn, device=...)(ke10)`` sums the (nc, 10)
    element table (``tet_element``'s, cell-major; the JAX class takes its
    (10, nc) transpose) into the (n_slots,) SELL values of ``layout``
    (default ``fine_layout(topo)``).  The JAX class plans only on 2D and
    narrow meshes; here ``available`` is True on any tetra mesh."""

    def __init__(self, topo, conn: np.ndarray, *, device: torch.device | str,
                 layout: SellLayout | None = None):
        self.topo = topo
        self.n_cells = int(np.shape(conn)[0])
        self.layout = fine_layout(topo, device) if layout is None else layout
        self.ptr, self.ids = reordered_lists(topo, conn, self.layout)

    @property
    def available(self) -> bool:
        return True

    def __call__(self, ke10: torch.Tensor) -> torch.Tensor:
        if ke10.shape != (self.n_cells, 10):
            raise ValueError(f"ReorderedAssembler: ke10 must be ({self.n_cells}, 10), "
                             f"got {tuple(ke10.shape)}")
        return slot_reduce(self.ptr, self.ids, ke10.contiguous().view(-1))
