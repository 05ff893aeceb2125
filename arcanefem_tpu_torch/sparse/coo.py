"""Standalone COO sparse matrix — the CooFormatMatrix role
(reference femutils/CooFormatMatrix.h:37-355).

The counterpart of ``arcanefem_tpu/sparse/coo.py``.  COO needs no
precomputed sparsity: rows/cols/vals come straight from the cell
connectivity with duplicates kept, like the reference's ``matrixAddValue``
accumulation.  The index arrays are int32 tensors on the matrix's device,
the values float32 or float64 there.  Every sum of duplicates runs in a
fixed order, as one ``slot_reduce`` (``sparse/slot_reduce.py``: float64, in
entry order, rounded once), where the JAX package uses a ``segment_sum``:

* ``spmv`` — ``vals * x[cols]`` summed per row by a :class:`SlotSum` over
  ``rows``;
* ``sorted()`` — a stable sort by the packed key ``row * n + col`` (int64),
  the distinct keys with their counts, and the merge of each key's
  entries as one ``slot_reduce`` (the S-COO variant, testlab
  CooSortBiliAssembly);
* ``to_bell(topo, layout)`` — the (row, col) → CSR position lookup as one
  ``torch.searchsorted`` over the topology's packed CSR keys, then
  ``csr_to_ell`` and the layout's ``ell_to_sell``, and one ``slot_reduce``
  into the SELL slots (CooFormatMatrix::translateToLinearSystem,
  h:88-95).

The sort and the search are index work: each is done once per index
pattern, on the device, and kept in a plan that :meth:`CooMatrix.with_values`
shares, so a repeated assembly over the same pattern runs only the value
path (one ``slot_reduce`` per step), as the JAX package's jit cache does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .bell import BellMatrix, fine_layout
from .sell import SellLayout
from .slot_reduce import SlotSum, group_by_slot, slot_reduce
from .topology import Topology


@dataclass
class CooMatrix:
    """(nnz,) triplets; duplicates allowed (accumulating semantics).

    ``rows``, ``cols``: int32 tensors on the values' device; ``vals``: the
    values there (None in a pattern that only carries plans); ``n``: the
    matrix order.  ``plans`` holds the index work done for this pattern
    (shared by :meth:`with_values`)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor | None
    n: int
    plans: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nnz_stored(self) -> int:
        return int(self.rows.shape[0])

    def with_values(self, vals: torch.Tensor) -> "CooMatrix":
        """The same pattern (and its plans) with other values."""
        return CooMatrix(self.rows, self.cols, vals, self.n, self.plans)

    def _plan(self, key, build):
        if key not in self.plans:
            self.plans[key] = build()
        return self.plans[key]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        ss = self._plan("spmv", lambda: SlotSum(self.rows, self.n, self.rows.device))
        return ss(self.vals * x[self.cols])

    def _sort_plan(self):
        key = self.rows.long() * self.n + self.cols.long()
        skey, order = torch.sort(key, stable=True)
        del key
        uniq, counts = torch.unique_consecutive(skey, return_counts=True)
        del skey
        ptr = torch.zeros(uniq.numel() + 1, dtype=torch.int64, device=uniq.device)
        torch.cumsum(counts, 0, out=ptr[1:])
        rows = torch.div(uniq, self.n, rounding_mode="floor").to(torch.int32)
        cols = (uniq % self.n).to(torch.int32)
        return ptr.to(torch.int32), order.to(torch.int32), rows, cols, {}

    def sorted_pattern(self) -> "CooMatrix":
        """The merged pattern of :meth:`sorted` (values None), its sort
        done here once."""
        _, _, rows, cols, plans = self._plan("sorted", self._sort_plan)
        return CooMatrix(rows, cols, None, self.n, plans)

    def sorted(self) -> "CooMatrix":
        """S-COO: sort by packed (row, col) key and merge duplicates."""
        ptr, ids = self._plan("sorted", self._sort_plan)[:2]
        return self.sorted_pattern().with_values(
            slot_reduce(ptr, ids, self.vals.contiguous()))

    def _bell_plan(self, topo: Topology, layout: SellLayout):
        dev = self.rows.device
        rp = torch.as_tensor(np.asarray(topo.row_ptr, np.int64), device=dev)
        key_all = torch.repeat_interleave(
            torch.arange(topo.n_nodes, device=dev), rp.diff(),
            output_size=topo.nnz) * self.n + torch.as_tensor(topo.csr_cols, device=dev)
        want = self.rows.long() * self.n + self.cols.long()
        # one batched binary search over the packed (row, col) keys — columns
        # are sorted within each CSR row, so the packed key array is sorted;
        # clipped so that an entry outside the sparsity reaches the check
        pos = torch.searchsorted(key_all, want).clamp_(max=max(topo.nnz - 1, 0))
        if not torch.equal(key_all[pos], want):
            raise AssertionError("COO entry outside the topology sparsity")
        del key_all, want
        c2e = torch.as_tensor(np.asarray(topo.csr_to_ell, np.int64), device=dev)
        e2s = torch.as_tensor(layout.ell_to_sell.astype(np.int32), device=dev)
        ptr, ids = group_by_slot(e2s[c2e[pos]], layout.n_slots)
        diag = torch.as_tensor(layout.ell_to_sell[np.asarray(topo.diag_slot, np.int64)],
                               device=dev)
        return topo, layout, ptr, ids, diag

    def bell_plan(self, topo: Topology, layout: SellLayout | None = None):
        """(layout, ptr, ids, diag) of :meth:`to_bell`, its search done here
        once per (topology, layout): ``layout`` defaults to
        :func:`~.bell.fine_layout` of ``topo``, built once per pattern."""
        if layout is None:
            layout = self._plan(("layout", id(topo)),
                                lambda: (topo, fine_layout(topo, self.rows.device)))[1]
        # the topology and layout are kept in the plan, so their ids stay theirs
        return self._plan(("bell", id(topo), id(layout)),
                          lambda: self._bell_plan(topo, layout))[1:]

    def to_bell(self, topo: Topology, layout: SellLayout | None = None) -> BellMatrix:
        """Translate into the BELL system layout (translateToLinearSystem):
        the SELL values of ``layout``, one ``slot_reduce``."""
        layout, ptr, ids, diag = self.bell_plan(topo, layout)
        return BellMatrix(slot_reduce(ptr, ids, self.vals.contiguous()), layout, diag)

    def todense(self) -> torch.Tensor:
        """The dense (n, n) matrix on the values' device, duplicates summed
        in entry order (a :class:`SlotSum`, built here)."""
        dev = self.vals.device
        flat, inv = torch.unique(self.rows.long() * self.n + self.cols.long(),
                                 return_inverse=True)
        dense = torch.zeros(self.n * self.n, dtype=self.vals.dtype, device=dev)
        dense[flat] = SlotSum(inv, flat.numel(), dev)(self.vals)
        return dense.view(self.n, self.n)


def coo_from_elements(n_nodes: int, conns: dict[str, np.ndarray],
                      mats: dict[str, torch.Tensor]) -> CooMatrix:
    """Emit COO triplets from element matrices — no sparsity build.

    conns[bucket]: (nc, npc) node ids; mats[bucket]: (nc, npc, npc), all on
    one device, where the index arrays are made."""
    rows, cols, vals = [], [], []
    for name, conn in conns.items():
        ke = mats[name]
        c = torch.as_tensor(np.asarray(conn, np.int32), device=ke.device)
        npc = c.shape[1]
        rows.append(c.repeat_interleave(npc, dim=1).reshape(-1))
        cols.append(c.repeat(1, npc).reshape(-1))
        vals.append(ke.reshape(-1))
    return CooMatrix(rows=torch.cat(rows), cols=torch.cat(cols), vals=torch.cat(vals),
                     n=n_nodes)
