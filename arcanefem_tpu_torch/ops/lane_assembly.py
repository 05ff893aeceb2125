"""P1 tetrahedron stiffness assembly into BELL values.

The counterpart of ``arcanefem_tpu/ops/lane_assembly.py::TetraLaneAssembler``
with the JAX TPU default reducer (``AFEM_UNSTR_ASM=window``,
``sparse/pallas_assembly.py::SortedEntryAssembler``): two kernels of
``csrc/tet_assembly.cu``.

1. ``tet_element``: one pass over the cells computes each element matrix
   from the cofactors of its corner coordinates and writes its 10
   upper-triangle entries (``TRI10`` order) to a cell-major (nc, 10)
   float32 table.  By default it gathers the corners itself from the
   (N, 3) coordinates through the corner-major connectivity
   ``corner_cols`` (request i*nc + c is corner i of cell c).  Its second
   input mode reads corners that a route's own gather fetched, (3, 4nc)
   in the same order: with ``coords_batched=True`` (the JAX package's
   ``AFEM_ASM_COORDS=batched``) one launch of ``ell_gather_sum_batched``
   (K3a) reading the (N, 3) coordinates in place; with
   ``coords_compact=True`` (``AFEM_ASM_COMPACT=1``) the compact two-stage
   gather of ``sparse/compact.py`` in blocks of 16384, its pre-gather K2
   (or with ``band_pre`` one banded K9a launch over its narrow and wide
   tiles), then K2 over the block-local indices; batched, K3a (or K9b)
   then K3a.  Every form
   fetches the same values, so every route computes the same table.
2. ``slot_reduce`` (``sparse/slot_reduce.py``): each SELL slot sums its
   contributors ``c*10 + Q2P16[q]`` in float64, rounded once.  The lists
   are built once, on the assembler's device, in the order ``reduce``
   (the JAX package's ``AFEM_UNSTR_ASM``) names: ``window`` ascending
   (cell, q), the JAX window reducer's order and the default; ``segsum``
   ascending (q, cell), the lane-major entry order of the JAX
   ``segment_sum``; ``reorder`` the 16 per-pair streams of
   ``sparse/pallas_assembly.py::ReorderedAssembler``.  The three differ
   only in list order, so each slot's sum of the same float32 entries
   differs between them by at most the float64 sum's round-off.

On the card, the split route with the ``window`` order (the default:
``coords_batched`` and ``coords_compact`` false, not ``plain``) runs the
two as one kernel, ``tet_assemble`` (:class:`TetPatches`,
:func:`tet_assemble`), so that the element table never goes to HBM.  The
slices of the SELL layout are cut into patches, runs of whole slices
whose cells (those with a corner on one of its rows) fit a block's
shared memory.  A block computes a patch's cells into a table in shared
memory with ``tet_element``'s arithmetic, then sums each of the patch's
slots over its contributors there, as local ids (local cell * 10 + TRI10
column) in the ``window`` lists' order, in float64 rounded once.  Cells
on the rows of two patches are computed in both (the halo factor: cells
computed over cells).  So the values equal ``slot_reduce`` over
``tet_element`` bit for bit; the assembler keeps the patch lists instead
of ``ptr`` and ``ids``.  Every other route, and the CPU, keeps the two
steps above; the plain twin of ``tet_assemble`` sums the same lists in
the same order.

So the assembled values are the same bit for bit from run to run and
across the coordinate routes.  The element arithmetic runs in float32 whatever the
caller's dtype, as the JAX package does.  On a CUDA tensor each wrapper
launches its kernel or raises; on a CPU tensor it runs the plain twin
below (``plain=True`` takes the twins on any device).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sparse.bell import check_cols, fine_layout
from ..sparse.compact import CompactGather
from ..sparse.sell import C, SellLayout
from ..sparse.ell_gather import ell_gather_sum_batched, ell_gather_sum_batched_plain
# the element table's columns: TRI10 (upper-triangle pair -> 0..9) and
# Q2P16 (ordered pair q = i*4 + j -> its column)
from ..sparse.pallas_assembly import Q2P16, TRI10, reordered_lists  # noqa: F401
from ..sparse.slot_reduce import group_by_slot, slot_reduce, slot_reduce_plain
from ..utils import kernels, tracing

REDUCES = ("window", "segsum", "reorder")  # the orders of the contributor lists

_LAUNCHES = tracing.counters("tet_element", "tet_assemble")
# the shared memory of a tet_assemble block, one on each SM: the table of
# the largest patch and two buffers of a patch's corners and lists
PATCH_BYTES = 227 * 1024
_CELL_BYTES = 108  # a cell's share of it: 40 of table, ~34 in each buffer
_ASSEMBLE_THREADS = 512  # threads of a tet_assemble block (csrc: kAssembleThreads)
_NODE_SHARE = 0.5  # a patch's nodes per cell, as its growth first counts them
_U16 = 1 << 16  # the local ids and pointers are uint16
_BUILD_CELLS = 1 << 20  # cells per step of the patch lists' build
_SMEM: dict = {}  # device index -> the most shared memory a block may ask for


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def tet_corners_plain(coords: torch.Tensor, corner_cols: torch.Tensor) -> torch.Tensor:
    """The (3, 4nc) corners :func:`tet_element` gathers: entry i*nc + c of
    row k is axis k of corner i of cell c."""
    return coords.T[:, corner_cols.reshape(-1).long()]


def tet_element_plain(corners) -> torch.Tensor:
    """Plain twin of :func:`tet_element` and :func:`tet_element_gathered`:
    the (nc, 10) float32 upper-triangle entries of each cell from its
    (3, 4nc) corners (a tensor or three (4nc,) vectors)."""
    nc = corners[0].shape[0] // 4
    x, y, z = ([g[i * nc:(i + 1) * nc] for i in range(4)] for g in corners)
    # 6V = (p1-p0) . (p2-p0) x (p3-p0)
    ax, ay, az = x[1] - x[0], y[1] - y[0], z[1] - z[0]
    bx, by, bz = x[2] - x[0], y[2] - y[0], z[2] - z[0]
    cx, cy, cz = x[3] - x[0], y[3] - y[0], z[3] - z[0]
    v6 = ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz) + az * (
        bx * cy - by * cx)
    inv = 1.0 / v6.abs()

    def comp(u, w):
        # cofactor rows: the gradient of each barycentric coordinate
        # times 6V
        return [
            u[1] * (w[3] - w[2]) + u[2] * (w[1] - w[3]) + u[3] * (w[2] - w[1]),
            u[0] * (w[2] - w[3]) + u[2] * (w[3] - w[0]) + u[3] * (w[0] - w[2]),
            u[0] * (w[3] - w[1]) + u[1] * (w[0] - w[3]) + u[3] * (w[1] - w[0]),
            u[0] * (w[1] - w[2]) + u[1] * (w[2] - w[0]) + u[2] * (w[0] - w[1]),
        ]

    dx, dy, dz = comp(y, z), comp(z, x), comp(x, y)
    # ke_ij = V (dx_i dx_j + dy_i dy_j + dz_i dz_j) / (6V)^2, V = |6V|/6
    scale = inv / 6.0
    return torch.stack([(dx[i] * dx[j] + dy[i] * dy[j] + dz[i] * dz[j]) * scale
                        for i in range(4) for j in range(i, 4)], dim=1)


def _check_f32(name: str, t: torch.Tensor, dev: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 operands only, got {t.dtype}")
    if t.get_device() != dev:
        raise ValueError(f"{name}: operands lie on different devices")
    if t.is_cuda and not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous operands")


def _launch(device: torch.device, cols_ptr, rows, stride: int, nc: int) -> torch.Tensor:
    ke = torch.empty((nc, 10), dtype=torch.float32, device=device)
    if nc:
        kernels.launch("afem_tet_element_f32", device, cols_ptr, *rows, stride,
                       ke.data_ptr(), nc)
        tracing.count("tet_element")
    return ke


def tet_element(coords: torch.Tensor, corner_cols: torch.Tensor) -> torch.Tensor:
    """The (nc, 10) float32 element table from the (N, 3) float32
    coordinates and the (4nc,) or (4nc, 1) int32 corner-major connectivity
    (the corner gather fused into the element kernel on the card)."""
    if coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"tet_element: coords must be (N, 3), got {tuple(coords.shape)}")
    if corner_cols.dtype != torch.int32 or corner_cols.numel() % 4:
        raise ValueError("tet_element: corner_cols must be int32, 4 per cell")
    dev = coords.get_device()
    _check_f32("tet_element", coords, dev)
    if corner_cols.get_device() != dev:
        raise ValueError("tet_element: operands lie on different devices")
    if not coords.is_cuda:
        if coords.device.type != "cpu":
            raise ValueError(f"tet_element: no kernel for device {coords.device}")
        return tet_element_plain(tet_corners_plain(coords, corner_cols))
    if not corner_cols.is_contiguous():
        raise ValueError("tet_element: the CUDA kernel takes contiguous operands")
    p = coords.data_ptr()
    return _launch(coords.device, corner_cols.data_ptr(),
                   (p, p + 4, p + 8), 3, corner_cols.numel() // 4)


def tet_element_gathered(corners) -> torch.Tensor:
    """:func:`tet_element` on corners a gather already fetched: a (3, 4nc)
    float32 tensor or three (4nc,) vectors, each row contiguous."""
    rows = tuple(corners)
    if len(rows) != 3 or any(r.dim() != 1 or r.shape != rows[0].shape for r in rows) \
            or rows[0].shape[0] % 4:
        raise ValueError("tet_element_gathered: corners must be three (4nc,) rows")
    dev = rows[0].get_device()
    for r in rows:
        _check_f32("tet_element_gathered", r, dev)
    if not rows[0].is_cuda:
        if rows[0].device.type != "cpu":
            raise ValueError(f"tet_element_gathered: no kernel for device {rows[0].device}")
        return tet_element_plain(rows)
    return _launch(rows[0].device, None,
                   tuple(r.data_ptr() for r in rows), 1, rows[0].shape[0] // 4)


def _u16(t: torch.Tensor) -> torch.Tensor:
    """int16 tensor holding the uint16 bits of ``t`` (values in [0, 2^16))."""
    return torch.where(t >= _U16 // 2, t - _U16, t).to(torch.int16)


def _align(n, k: int = 16):
    return (n + k - 1) // k * k


def _buffer_bytes(cells, nodes, slots, lists):
    """A patch's buffer in tet_assemble: its cells' local corners (8 bytes
    a cell, to 16), its nodes' ids and coordinates (20 bytes a node, to 4
    nodes), then its part of the blob (S + 1 pointers, S slots, the
    lists: 2 bytes each, to 8 entries)."""
    return _align(8 * cells) + 20 * _align(nodes, 4) + 2 * _align(2 * slots + 1 + lists, 8)


def _caps(max_bytes: int) -> tuple[int, int]:
    """(cells, buffer bytes) a patch may have so that the table of the
    most cells and two of the largest buffers fit ``max_bytes``."""
    cells = max_bytes // _CELL_BYTES
    return cells, (max_bytes - _align(40 * cells)) // 32 * 16


def _fits_u16(cells, slots, lists) -> bool:
    """Whether a patch's local ids (10 a cell), slots and list positions
    fit 16 bits (its nodes, at most 4 a cell, then do too)."""
    return 10 * cells < _U16 and slots < _U16 and lists < _U16


def _starts(counts: torch.Tensor) -> torch.Tensor:
    """(len + 1,) int64 exclusive prefix sums of ``counts``."""
    out = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


class TetPatches:
    """The lists of the fused assembly (:func:`tet_assemble`), built once on
    ``device`` by :meth:`build`.

    A patch is a run of whole SELL slices, and one block's work.  Its cells
    are those with a corner on a row of the patch, ascending; its nodes
    the corners of its cells, ascending.  ``lconn`` (cells, 4) holds each
    patch's cells, patch after patch, as the positions of their corners
    among the patch's nodes, and ``nodes`` (int32) each patch's nodes,
    padded to 4 with node 0.  ``meta`` (4, n_patches + 1) int64 holds each
    patch's first row of ``lconn``, first SELL slot, first entry of
    ``blob`` and first entry of ``nodes``.  A patch's part of ``blob``
    (padded to 8 entries) holds, for its S slots in the order its threads
    take them (longest list first, ties by slot): S + 1 pointers into its
    lists, relative to their start; the S slots, relative to its first;
    and the lists, each slot's contributors in ascending (cell, q) order as
    ``group_by_slot``'s ``window`` lists, as local ids ``local cell * 10 +
    Q2P16[q]``.  ``lconn`` and ``blob`` hold uint16 bits in int16.  A
    block's shared memory, ``smem_bytes``, holds the table of the patch of
    the most cells (``max_cells``, 40 bytes a cell) and two buffers of the
    largest patch (``buf_bytes``, :func:`_buffer_bytes`)."""

    def __init__(self, lconn, nodes, meta, blob, max_cells: int, buf_bytes: int,
                 n_nodes: int, share: float):
        self.lconn, self.nodes, self.meta, self.blob = lconn, nodes, meta, blob
        self.share = share  # the nodes per cell the growth counted
        self.max_cells, self.buf_bytes = max_cells, buf_bytes
        self.smem_bytes = _align(40 * max_cells) + 2 * buf_bytes
        self.n_nodes = n_nodes
        self.n_patches = meta.shape[1] - 1
        self.n_slots = int(meta[1, -1])
        self.n_computed = lconn.shape[0]  # cells computed, over all patches
        self.device = lconn.device
        self.device_index = lconn.get_device()
        self._args = (lconn.data_ptr(), nodes.data_ptr(), meta.data_ptr(), blob.data_ptr())

    @classmethod
    def build(cls, topo, conn: np.ndarray, layout: SellLayout, device, *,
              max_bytes: int = PATCH_BYTES) -> "TetPatches":
        """The lists of the tetrahedra ``conn`` (nc, 4) on ``topo`` into
        ``layout``, on ``device``.  Patches grow slice by slice while their
        cells and buffer stay within the caps of ``max_bytes``
        (:func:`_caps`) and their local indices within 16 bits (a slice
        past either is a patch alone: past the bits, the build raises).
        The growth counts a patch's nodes as ``share`` of its cells; where
        a patch of more than one slice then passes the buffer's cap, it
        grows again at that patch's share."""
        dev = torch.device(device)
        conn = np.asarray(conn)
        nc, ns, n_nodes = conn.shape[0], layout.n_slices, topo.n_nodes
        cn = torch.as_tensor(conn.astype(np.int32), device=dev)
        pos = torch.arange(layout.n_rows, device=dev)
        if layout.perm is not None:
            pos = torch.empty_like(pos).index_put_((layout.perm.to(dev).long(),), pos)
        node_slice = pos // C
        slice_ptr = layout.slice_ptr.to(dev)
        e2s = torch.as_tensor(layout.ell_to_sell, device=dev)
        sm = np.asarray(topo.slot_maps["tetra4"]).reshape(nc, 16)
        steps = range(0, nc, _BUILD_CELLS)

        def slots_of(c0):
            s = e2s[torch.as_tensor(sm[c0:c0 + _BUILD_CELLS].reshape(-1), device=dev).long()]
            if s.numel() and int(s.min()) < 0:
                raise ValueError("TetPatches: an element entry falls on no SELL slot")
            return s

        # every slot's contributors: the pointers of the window lists
        ptr = torch.zeros(layout.n_slots + 1, dtype=torch.int64, device=dev)
        for c0 in steps:
            ptr[1:] += torch.bincount(slots_of(c0), minlength=layout.n_slots)
        torch.cumsum(ptr, 0, out=ptr)
        per_slice = (ptr[slice_ptr[1:]] - ptr[slice_ptr[:-1]]).cpu().numpy()
        width = (slice_ptr[1:] - slice_ptr[:-1]).cpu().numpy()
        # a cell is new to the patch [a, b] at slice b when the last of its
        # slices before b (its "prev", -1 if none) is below a
        cs = torch.sort(node_slice[cn.long()], dim=1).values
        prev = torch.cat([torch.full((nc, 1), -1, device=dev), cs[:, :-1]], dim=1)
        first = cs != prev
        key = torch.sort(cs[first] * (ns + 1) + prev[first] + 1).values
        del cs, prev, first
        off = np.zeros(ns + 1, np.int64)
        np.cumsum(torch.bincount(key // (ns + 1), minlength=ns).cpu().numpy(), out=off[1:])
        prevs = (key % (ns + 1) - 1).cpu().numpy()
        del key
        cap_cells, cap_buf = _caps(max_bytes)
        share = _NODE_SHARE
        while True:
            bounds = _grow(prevs, off, width, per_slice, cap_cells, cap_buf, share)
            n_patches = len(bounds) - 1
            bounds_t = torch.as_tensor(bounds, device=dev)
            slot0 = slice_ptr[bounds_t]
            list0 = ptr[slot0]
            keys, cell0 = _patch_cells(cn, node_slice, bounds_t)
            lconn, nodes, node0 = _patch_nodes(cn, keys, cell0, n_nodes)
            sizes = [t.cpu().numpy() for t in (cell0.diff(), node0.diff(), slot0.diff(),
                                                list0.diff())]
            if not all(_fits_u16(c, s, k) for c, _, s, k in zip(*sizes)):
                raise ValueError("TetPatches: a slice's cells, slots or contributors pass the "
                                 "16-bit local indices")
            buffers = _buffer_bytes(*(z.astype(np.int64) for z in sizes))
            over = buffers > cap_buf
            if not (over & (np.diff(bounds) > 1)).any():
                break
            # a patch of more nodes than counted: grow again at its share
            share = max(share + 1 / 16, float((sizes[1][over] / sizes[0][over]).max()))
            del keys, lconn, nodes
        del prevs
        n_slots = slot0.diff()
        n_lists = list0.diff()
        slot_patch = torch.repeat_interleave(torch.arange(n_patches, device=dev), n_slots)
        # each patch's part of the blob: S + 1 pointers, S slots, the lists
        blob0 = _starts(_align(2 * n_slots + 1 + n_lists, 8))
        blob = torch.zeros(int(blob0[-1]), dtype=torch.int16, device=dev)
        # the order in which a patch's threads take its slots: longest list
        # first, ties by slot, so that the lists of a warp's slots are alike
        # in length; the lists are laid out in that order
        count = ptr.diff()
        longest = int(count.max())
        taken = torch.sort(slot_patch * (longest + 1) + longest - count, stable=True).indices
        begin = _starts(count[taken])
        del count
        at = torch.arange(layout.n_slots, device=dev) - slot0[slot_patch]  # i, per patch
        base = blob0[slot_patch] + at
        blob[base] = _u16(begin[:-1] - list0[slot_patch])
        blob[blob0[:-1] + n_slots] = _u16(n_lists)
        blob[base + n_slots[slot_patch] + 1] = _u16(taken - slot0[slot_patch])
        del at, base
        # each slot's local ids in ascending (cell, q) order: the entries of
        # a step of cells, sorted by slot (stable), after the steps before,
        # at their blob position (list position + the patch's shift)
        shift = blob0[:-1] + 2 * n_slots + 1 - list0[:-1]
        fill = torch.empty(layout.n_slots, dtype=torch.int64, device=dev)
        fill[taken] = begin[:-1] + shift[slot_patch[taken]]
        del taken, begin
        q2p = torch.as_tensor(Q2P16, device=dev)
        for c0 in steps:
            s = slots_of(c0)
            e = torch.arange(s.numel(), device=dev)
            p = slot_patch[s]
            local = torch.searchsorted(keys, p * nc + c0 + e // 16) - cell0[p]
            lid = local * 10 + q2p[e % 16]
            ss, order = torch.sort(s, stable=True)
            run = torch.ones_like(ss, dtype=torch.bool)
            run[1:] = ss[1:] != ss[:-1]
            rank = e - torch.where(run, e, 0).cummax(0).values
            blob[fill[ss] + rank] = _u16(lid[order])
            fill += torch.bincount(s, minlength=layout.n_slots)
        del fill, keys
        return cls(lconn, nodes, torch.stack([cell0, slot0, blob0, node0]), blob,
                   int(sizes[0].max()), int(buffers.max()), n_nodes, share)

    def corners(self) -> torch.Tensor:
        """(cells computed, 4) int64: the global corners of ``lconn``."""
        cell0, _, _, node0 = self.meta
        patch = torch.repeat_interleave(torch.arange(self.n_patches, device=self.device),
                                        cell0.diff())
        return self.nodes.long()[node0[patch][:, None] + (self.lconn.long() & (_U16 - 1))]

    def lists(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ptr, ids, slot) int64, in the order the threads take the slots:
        position i sums ``ids[ptr[i]:ptr[i + 1]]`` (``slot_reduce``'s lists
        over the patches' tables laid end to end, row ``cell0[p] + local
        cell``) into SELL slot ``slot[i]``."""
        cell0, slot0, blob0, _ = self.meta
        dev = self.device
        n_slots = slot0.diff()
        b = self.blob.long() & (_U16 - 1)
        patch = torch.repeat_interleave(torch.arange(self.n_patches, device=dev), n_slots)
        at = torch.arange(self.n_slots, device=dev) - slot0[patch]
        n_lists = b[blob0[:-1] + n_slots]
        list0 = _starts(n_lists)
        ptr = torch.empty(self.n_slots + 1, dtype=torch.int64, device=dev)
        ptr[:-1] = list0[patch] + b[blob0[patch] + at]
        ptr[-1] = list0[-1]
        kp = torch.repeat_interleave(torch.arange(self.n_patches, device=dev), n_lists)
        k = torch.arange(int(list0[-1]), device=dev) - list0[kp]
        ids = cell0[kp] * 10 + b[blob0[kp] + 2 * n_slots[kp] + 1 + k]
        return ptr, ids, slot0[patch] + b[blob0[patch] + n_slots[patch] + 1 + at]


def _grow(prevs, off, width, per_slice, cap_cells: int, cap_buf: int, share: float) -> list:
    """The first slice of each patch, and the number of slices last.  A
    patch takes slice after slice while it stays within the caps and 16
    bits, its nodes counted as ``share`` of its cells; a cell is new to
    the patch [a, b] at slice b where one of its (slice b, prev) pairs,
    ``prevs[off[b]:off[b + 1]]`` ascending, has prev < a."""
    bounds, a, cells, lists, slots = [0], 0, 0, 0, 0
    for b in range(len(width)):
        new = int(np.searchsorted(prevs[off[b]:off[b + 1]], a))
        grown = (cells + new, slots + int(width[b]), lists + int(per_slice[b]))
        if b > a and (grown[0] > cap_cells or not _fits_u16(*grown)
                      or _buffer_bytes(grown[0], int(np.ceil(share * grown[0])), *grown[1:])
                      > cap_buf):
            bounds.append(b)
            a, cells, lists, slots = b, int(off[b + 1] - off[b]), 0, 0
        else:
            cells += new
        lists += int(per_slice[b])
        slots += int(width[b])
    bounds.append(len(width))
    return bounds


def _patch_cells(cn: torch.Tensor, node_slice: torch.Tensor, bounds: torch.Tensor):
    """The sorted (patch * nc + cell) keys of each patch's cells, and each
    patch's first key (n_patches + 1,)."""
    nc = cn.shape[0]
    n_patches = bounds.numel() - 1
    slice_patch = torch.repeat_interleave(torch.arange(n_patches, device=cn.device),
                                          bounds.diff())
    cp = torch.sort(slice_patch[node_slice[cn.long()]], dim=1).values
    first = torch.ones_like(cp, dtype=torch.bool)
    first[:, 1:] = cp[:, 1:] != cp[:, :-1]
    owner = torch.arange(nc, device=cn.device)[:, None].expand_as(cp)
    keys = torch.sort(cp[first] * nc + owner[first]).values
    return keys, _starts(torch.bincount(keys // nc, minlength=n_patches))


def _patch_nodes(cn: torch.Tensor, keys: torch.Tensor, cell0: torch.Tensor, n_nodes: int):
    """(lconn, nodes, node0): each patch's nodes, the distinct corners of
    its cells ascending, padded to 4 with node 0, and its cells' corners as
    positions among them; in steps of about ``_BUILD_CELLS`` cells."""
    nc, dev = cn.shape[0], cn.device
    n_patches = cell0.numel() - 1
    lconn = torch.empty((keys.numel(), 4), dtype=torch.int16, device=dev)
    found, counts = [], []
    pa = 0
    while pa < n_patches:
        pb = max(pa + 1, int(torch.searchsorted(cell0, cell0[pa] + _BUILD_CELLS, right=True)) - 1)
        pb = min(pb, n_patches)
        k0, k1 = int(cell0[pa]), int(cell0[pb])
        cells = keys[k0:k1]
        patch = cells // nc - pa
        key = patch[:, None] * n_nodes + cn[cells % nc].long()
        u, inv = torch.unique(key, sorted=True, return_inverse=True)
        start = torch.searchsorted(u, torch.arange(pb - pa, device=dev) * n_nodes)
        lconn[k0:k1] = _u16(inv - start[patch][:, None])
        found.append((u % n_nodes).to(torch.int32))
        counts.append(torch.diff(start, append=start.new_tensor([u.numel()])))
        pa = pb
    counts = torch.cat(counts)
    node0 = _starts(_align(counts, 4))
    at = torch.repeat_interleave(node0[:-1] - _starts(counts)[:-1], counts)
    nodes = torch.zeros(int(node0[-1]), dtype=torch.int32, device=dev)
    nodes[at + torch.arange(at.numel(), device=dev)] = torch.cat(found)
    return lconn, nodes, node0


def tet_assemble_plain(patches: TetPatches, coords: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`tet_assemble`: the patches' tables by
    :func:`tet_element_plain`, end to end, and each slot's local
    contributors summed by :func:`slot_reduce_plain` (float64, list
    order, rounded once)."""
    corners = coords.T[:, patches.corners().T.reshape(-1)]
    ptr, ids, slot = patches.lists()
    out = torch.empty(patches.n_slots, dtype=torch.float32, device=coords.device)
    out[slot] = slot_reduce_plain(ptr, ids, tet_element_plain(corners).view(-1))
    return out


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _smem_limit(device: torch.device) -> int:
    """The most shared memory a tet_assemble block may ask for on
    ``device``."""
    idx = torch.device(device).index
    if idx not in _SMEM:
        got = ctypes.c_int(0)
        kernels.launch("afem_tet_assemble_smem", torch.device(device), ctypes.addressof(got))
        _SMEM[idx] = got.value
    return _SMEM[idx]


def tet_assemble(patches: TetPatches, coords: torch.Tensor) -> torch.Tensor:
    """The (n_slots,) float32 SELL values of the cells' P1 stiffness, from
    the (N, 3) coordinates (cast to float32), in one launch on the card:
    each patch computes its cells' element entries into shared memory
    (``tet_element``'s arithmetic) and sums each of its slots' contributors
    there, in ``slot_reduce``'s type and order, so the values equal
    ``slot_reduce`` over ``tet_element`` on the ``window`` lists bit for
    bit.  Padding slots are 0.  Patches that pass the card's shared memory
    per block are refused, not launched."""
    if coords.shape != (patches.n_nodes, 3):
        raise ValueError(f"tet_assemble: coords must be ({patches.n_nodes}, 3), got "
                         f"{tuple(coords.shape)}")
    c32 = coords.to(torch.float32).contiguous()
    if c32.get_device() != patches.device_index:
        raise ValueError("tet_assemble: coords and lists lie on different devices")
    if not c32.is_cuda:
        if c32.device.type != "cpu":
            raise ValueError(f"tet_assemble: no kernel for device {c32.device}")
        return tet_assemble_plain(patches, c32)
    dev = c32.device
    limit = _smem_limit(dev)
    if patches.smem_bytes > limit:
        raise ValueError(f"tet_assemble: a patch needs {patches.smem_bytes} bytes, past "
                         f"the {limit} bytes of shared memory a block may have on {dev}")
    out = torch.empty(patches.n_slots, dtype=torch.float32, device=dev)
    lconn, nodes, meta, blob = patches._args
    kernels.launch("afem_tet_assemble_f32", dev, lconn, nodes, c32.data_ptr(), meta, blob,
                   out.data_ptr(), patches.n_patches, patches.max_cells, patches.buf_bytes,
                   min(patches.n_patches, _sm_count(dev)))
    tracing.count("tet_assemble")
    return out


class TetraAssembler:
    """vals = TetraAssembler(topo, conn, device=...)(coords)  # (n_slots,) f32

    topo: ``sparse.topology.Topology`` of the mesh;
    conn: (nc, 4) tetra connectivity; ``layout``: the SELL layout the
    values are assembled into (default ``fine_layout(topo)``; the values
    then go to ``BellMatrix(vals, asm.layout, ...)``).  The corner columns
    go to the device once, and each slot's contributor list is built
    there once (``ptr``, ``ids``: int32, 4 bytes per slot and 16 per
    cell; on the fused route the patch lists ``patches`` instead, about
    2 bytes per contributor and 8 per cell computed).  ``coords_batched`` fetches the corners with one batched
    gather first; ``coords_compact`` through the compact two-stage gather,
    its pre-gather banded when ``band_pre``; ``reduce`` the order of the
    contributor lists (:data:`REDUCES`, module docstring); ``plain=True``
    runs every kernel's plain twin instead.
    """

    def __init__(self, topo, conn: np.ndarray, *, device: torch.device | str,
                 plain: bool = False, coords_batched: bool = False,
                 coords_compact: bool = False, band_pre: bool = False,
                 layout: SellLayout | None = None, reduce: str = "window"):
        if reduce not in REDUCES:
            raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
        if band_pre and not coords_compact:
            raise ValueError("band_pre bands the compact pre-gather: it needs "
                             "coords_compact=True")
        conn = np.asarray(conn)
        nc = conn.shape[0]
        check_cols(conn, topo.n_nodes, "TetraAssembler conn")
        self.n_cells = nc
        self.layout = fine_layout(topo, device) if layout is None else layout
        self.coords_batched = coords_batched
        self.plain = plain
        self._gather_b = (ell_gather_sum_batched_plain if plain
                          else ell_gather_sum_batched)
        # (4nc, 1): row i*nc + c fetches corner i of cell c
        corner = np.ascontiguousarray(conn.astype(np.int32).T).reshape(-1, 1)
        self.corner_cols = torch.as_tensor(corner, device=device)
        self.compact = None
        if coords_compact:
            self.compact = CompactGather.build(
                corner, np.ones(corner.shape, bool), band_pre=band_pre,
                device=device, plain=plain)
        self.reduce = reduce
        # the fused route: on the card, the split coordinates and the window
        # order, one tet_assemble launch over patch lists (no ptr, ids)
        self.patches = None
        if (self.corner_cols.is_cuda and not plain and not coords_batched
                and not coords_compact and reduce == "window" and nc):
            self.patches = TetPatches.build(
                topo, conn, self.layout, device,
                max_bytes=min(PATCH_BYTES, _smem_limit(self.corner_cols.device)))
            return
        if reduce == "reorder":
            self.ptr, self.ids = reordered_lists(topo, conn, self.layout)
            return
        # the SELL slot of entry q = i*4 + j of cell c, cell-major (int32:
        # the slots of any mesh one card holds are < 2^31), grouped by slot
        e2s = torch.as_tensor(self.layout.ell_to_sell, device=device)
        sm = torch.as_tensor(np.asarray(topo.slot_maps["tetra4"]).reshape(-1),
                             device=device)
        slots = e2s[sm.long()].to(torch.int32)
        del sm
        if reduce == "window":
            self.ptr, self.ids = group_by_slot(slots, self.layout.n_slots,
                                               per_cell=torch.as_tensor(Q2P16))
            return
        # segsum: lane-major entries e = q*nc + c
        self.ptr, order = group_by_slot(slots.view(nc, 16).T.reshape(-1),
                                        self.layout.n_slots)
        del slots
        q = torch.div(order, nc, rounding_mode="floor")
        self.ids = ((order - q * nc) * 10
                    + torch.as_tensor(Q2P16, device=device)[q.long()]).to(torch.int32)

    def gather_corners(self, coords: torch.Tensor):
        """Axis k of every corner, float32: entry i*nc + c of the k-th row is
        corner i of cell c.  One (3, 4nc) tensor, or three (4nc,) vectors
        from the compact split gather.  The default (split) route has no
        gather of its own, since its element kernel fetches the corners:
        there a CUDA tensor raises unless ``plain``, and a CPU tensor gets
        the plain gather."""
        c32 = coords.to(torch.float32)
        if self.compact is not None:
            if self.coords_batched:
                return self.compact.gather_batched(c32.T)
            ct = c32.T.contiguous()
            return [self.compact.gather(ct[k]) for k in range(3)]
        if self.coords_batched:
            # (N, 3) read in place as (3, N) tables; the result axis-major
            return self._gather_b(self.corner_cols, c32.T)
        if c32.is_cuda and not self.plain:
            raise ValueError("TetraAssembler.gather_corners: the split route has no "
                             "corner gather on the card; tet_element fetches them")
        return tet_corners_plain(c32, self.corner_cols)

    def element_table(self, coords: torch.Tensor) -> torch.Tensor:
        """The (nc, 10) float32 element table of ``coords``."""
        if self.plain:
            return tet_element_plain(self.gather_corners(coords))
        if self.compact is None and not self.coords_batched:
            return tet_element(coords.to(torch.float32).contiguous(), self.corner_cols)
        return tet_element_gathered(self.gather_corners(coords))

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        with tracing.span(tracing.ASM):
            if self.patches is not None:
                return tet_assemble(self.patches, coords)
            reduce = slot_reduce_plain if self.plain else slot_reduce
            return reduce(self.ptr, self.ids, self.element_table(coords).view(-1))
