"""Deterministic assembly reduction: each slot sums its sorted contributors.

    ptr, ids = group_by_slot(slots, n_slots)       # once, when an assembler is made
    out = slot_reduce(ptr, ids, table)             # out[s] = sum_{k in [ptr[s], ptr[s+1])}
                                                   #          table[ids[k]]

The counterpart of ``arcanefem_tpu/sparse/pallas_assembly.py::
SortedEntryAssembler``: the element entries are sorted by the slot they
sum into once, so assembly becomes a gather-sum over each slot's
contributors, with no scatter.  ``slots[e]`` is the slot of entry ``e``;
a stable sort keeps each slot's contributors in ascending entry order,
which for cell-major entries is ascending (cell, local entry), the order
of the JAX ``group_by_slot``.  ``ids`` are the entries' rows in the table
the caller sums: the entries themselves, or with ``per_cell`` a packing
of each cell's P entries into fewer table rows (the tetrahedron's
symmetric ``c*10 + Q2P16[q]``).  Both lists are int32 and built on the
slots' device (a sort, a ``bincount`` and a ``cumsum``: unique, hence the
same in every run).

On a CUDA tensor :func:`slot_reduce` launches the hand-written kernel of
``csrc/tet_assembly.cu`` or raises; on a CPU tensor it runs the plain twin
below, which sums in the kernel's order and type (float64, in stored
order, rounded once to the table's type), so the two agree bit for bit on
the same table.  ``launch_counts()`` counts the kernel launches, and
``sum_launch_counts()`` the part of them that :class:`SlotSum` made.

:class:`SlotSum` is the same reduction as a fixed-order scatter-add into a
vector (the RHS sums, the boundary-face matrices, the dense form of a
matrix): its lists are built once, each call is one ``slot_reduce``.

:func:`block_slot_reduce` is the block form for the b×b node blocks of the
vector systems (b = 2, 3): the contributor lists stay node-level (one per
node-pair slot, over the element entries ``c·npc² + i·npc + j``), each
contributor adds its b² table entries ``ids[k]·b² + a·b + c`` in list
order, and the b² sums of node slot s land in the expanded slots
``dst[s·b² + a·b + c]`` of a zeroed output.  Its kernel lies beside the
scalar one, and its plain twin sums in the same order and type.
"""

from __future__ import annotations

import torch

from ..utils import kernels

_ENTRY = {torch.float32: "afem_slot_reduce_f32", torch.float64: "afem_slot_reduce_f64"}
_BLOCK_ENTRY = {torch.float32: "afem_block_slot_reduce_f32",
                torch.float64: "afem_block_slot_reduce_f64"}
BLOCKS = (2, 3)  # the block sizes the block kernel is built for
_LAUNCHES = {"slot_reduce": 0, "block_slot_reduce": 0}
# the launches of slot_reduce made by SlotSum (the fixed-order RHS and
# face-matrix sums), a part of the "slot_reduce" count
_SUM_LAUNCHES = {"slot_sum": 0}


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
    _SUM_LAUNCHES["slot_sum"] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def sum_launch_counts() -> dict[str, int]:
    """{"slot_sum": the slot_reduce launches that SlotSum made}, zeroed by
    :func:`reset_launch_counts`."""
    return dict(_SUM_LAUNCHES)


def group_by_slot(slots: torch.Tensor, n_slots: int,
                  per_cell: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ptr, ids), int32 on ``slots``' device: the contributors of slot s
    are ``ids[ptr[s]:ptr[s+1]]``, in ascending entry order.  ``slots`` is
    the (E,) slot of every entry, each in [0, n_slots); ``per_cell``, a
    (P,) integer map, packs entry e into table row
    ``(e // P) * T + per_cell[e % P]`` with T = max(per_cell) + 1."""
    E = slots.numel()
    if E >= 2**31 or n_slots >= 2**31:
        raise ValueError(f"group_by_slot: {E} entries into {n_slots} slots "
                         "overflow int32")
    slots = slots.reshape(-1)
    if E and (int(slots.min()) < 0 or int(slots.max()) >= n_slots):
        raise ValueError(f"group_by_slot: an entry falls outside the layout's "
                         f"slots [0, {n_slots})")
    sorted_slots, order = torch.sort(slots, stable=True)
    counts = torch.bincount(sorted_slots, minlength=n_slots)
    ptr = torch.zeros(n_slots + 1, dtype=torch.int64, device=slots.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    del sorted_slots, counts
    if per_cell is not None:
        pc = per_cell.to(device=slots.device, dtype=torch.int64)
        P, T = pc.numel(), int(pc.max()) + 1
        order = torch.div(order, P, rounding_mode="floor").mul_(T).add_(pc[order % P])
    return ptr.to(torch.int32), order.to(torch.int32)


def slot_reduce_plain(ptr: torch.Tensor, ids: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`slot_reduce`: one masked gather-add in float64
    per contributor position k, so each slot adds its contributors in
    stored order, as the kernel does."""
    n = ptr.numel() - 1
    p = ptr.long()
    start, count = p[:-1], p[1:] - p[:-1]
    acc = torch.zeros(n, dtype=torch.float64, device=table.device)
    for k in range(int(count.max()) if n else 0):
        live = count > k
        g = table[ids[torch.where(live, start + k, 0)].long()].double()
        acc += torch.where(live, g, 0.0)
    return acc.to(table.dtype)


def slot_reduce(ptr: torch.Tensor, ids: torch.Tensor,
                table: torch.Tensor, role: str | None = None) -> torch.Tensor:
    """out[s] = sum_{k in [ptr[s], ptr[s+1])} table[ids[k]], summed in
    float64 in stored order, a new (len(ptr) - 1,) tensor of the table's
    type (float32 or float64).  ``role="sum"`` (:class:`SlotSum`) also
    counts the launch under ``sum_launch_counts()["slot_sum"]``."""
    entry = _ENTRY.get(table.dtype)
    if entry is None:
        raise TypeError(f"slot_reduce: table must be float32 or float64, got {table.dtype}")
    if ptr.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError(f"slot_reduce: ptr and ids must be int32, got {ptr.dtype} "
                        f"and {ids.dtype}")
    if ptr.dim() != 1 or ids.dim() != 1 or table.dim() != 1 or ptr.numel() < 1:
        raise ValueError("slot_reduce: ptr, ids and table must be 1-D, ptr non-empty")
    dev = table.get_device()
    if ptr.get_device() != dev or ids.get_device() != dev:
        raise ValueError("slot_reduce: operands lie on different devices")
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"slot_reduce: no kernel for device {table.device}")
        return slot_reduce_plain(ptr, ids, table)
    if not (ptr.is_contiguous() and ids.is_contiguous() and table.is_contiguous()):
        raise ValueError("slot_reduce: the CUDA kernel takes contiguous operands")
    n = ptr.numel() - 1
    out = table.new_empty(n)
    if n:
        kernels.launch(entry, table.device, ptr.data_ptr(), ids.data_ptr(),
                       table.data_ptr(), out.data_ptr(), n)
        _LAUNCHES["slot_reduce"] += 1
        if role == "sum":
            _SUM_LAUNCHES["slot_sum"] += 1
    return out


def block_slot_reduce_plain(ptr: torch.Tensor, ids: torch.Tensor, table: torch.Tensor,
                            dst: torch.Tensor, n_out: int, b: int) -> torch.Tensor:
    """Plain twin of :func:`block_slot_reduce`: one masked gather-add of
    (n, b²) rows in float64 per contributor position k, then one scatter
    into the expanded slots."""
    n = ptr.numel() - 1
    bb = b * b
    p = ptr.long()
    start, count = p[:-1], p[1:] - p[:-1]
    rows = table.view(-1, bb)
    acc = torch.zeros((n, bb), dtype=torch.float64, device=table.device)
    for k in range(int(count.max()) if n else 0):
        live = count > k
        g = rows[ids[torch.where(live, start + k, 0)].long()].double()
        acc += torch.where(live[:, None], g, 0.0)
    out = torch.zeros(n_out, dtype=table.dtype, device=table.device)
    out[dst.long().view(-1)] = acc.view(-1).to(table.dtype)
    return out


def block_slot_reduce(ptr: torch.Tensor, ids: torch.Tensor, table: torch.Tensor,
                      dst: torch.Tensor, n_out: int, b: int) -> torch.Tensor:
    """out[dst[s·b² + e]] = sum_{k in [ptr[s], ptr[s+1])} table[ids[k]·b² + e]
    for e < b², summed in float64 in stored order, into a new zeroed
    (n_out,) tensor of the table's type; ``dst`` (n·b²,) int32 holds
    distinct slots in [0, n_out)."""
    entry = _BLOCK_ENTRY.get(table.dtype)
    if entry is None:
        raise TypeError(f"block_slot_reduce: table must be float32 or float64, got "
                        f"{table.dtype}")
    if b not in BLOCKS:
        raise ValueError(f"block_slot_reduce: block size {b} not in {BLOCKS}")
    if ptr.dtype != torch.int32 or ids.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError("block_slot_reduce: ptr, ids and dst must be int32")
    if (ptr.dim() != 1 or ids.dim() != 1 or table.dim() != 1 or dst.dim() != 1
            or ptr.numel() < 1):
        raise ValueError("block_slot_reduce: ptr, ids, table and dst must be 1-D, "
                         "ptr non-empty")
    n = ptr.numel() - 1
    if dst.numel() != n * b * b or table.numel() % (b * b):
        raise ValueError(f"block_slot_reduce: dst of {dst.numel()} slots for {n} "
                         f"node slots of {b}x{b}, table of {table.numel()} entries")
    dev = table.get_device()
    if ptr.get_device() != dev or ids.get_device() != dev or dst.get_device() != dev:
        raise ValueError("block_slot_reduce: operands lie on different devices")
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"block_slot_reduce: no kernel for device {table.device}")
        return block_slot_reduce_plain(ptr, ids, table, dst, n_out, b)
    if not all(t.is_contiguous() for t in (ptr, ids, table, dst)):
        raise ValueError("block_slot_reduce: the CUDA kernel takes contiguous operands")
    out = torch.zeros(n_out, dtype=table.dtype, device=table.device)
    if n:
        kernels.launch(entry, table.device, ptr.data_ptr(), ids.data_ptr(),
                       table.data_ptr(), dst.data_ptr(), out.data_ptr(), n, b)
        _LAUNCHES["block_slot_reduce"] += 1
    return out


class SlotSum:
    """A scatter-add in a fixed order: ``SlotSum(slots, n)(table)`` is the
    (n,) vector whose entry s sums ``table[e]`` over the entries e with
    ``slots[e] == s``, in ascending e and in float64, rounded once to the
    table's type.  The lists are built once (:func:`group_by_slot` on
    ``device``); each call is one :func:`slot_reduce`, so the sum is the
    same in every run and on the card and the CPU alike, where an
    ``index_add`` on the card sums through atomics in a varying order."""

    def __init__(self, slots, n: int, device: torch.device | str):
        slots = torch.as_tensor(slots, device=device).to(torch.int64)
        self.n = int(n)
        self.n_entries = slots.numel()
        self.ptr, self.ids = group_by_slot(slots, self.n)

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        table = table.reshape(-1)
        if table.numel() != self.n_entries:
            raise ValueError(f"SlotSum: a table of {table.numel()} entries for lists "
                             f"of {self.n_entries}")
        return slot_reduce(self.ptr, self.ids, table.contiguous(), role="sum")
