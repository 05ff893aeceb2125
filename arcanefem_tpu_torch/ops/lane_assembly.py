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

So the assembled values are the same bit for bit from run to run and
across the coordinate routes.  The element arithmetic runs in float32 whatever the
caller's dtype, as the JAX package does.  On a CUDA tensor each wrapper
launches its kernel or raises; on a CPU tensor it runs the plain twin
below (``plain=True`` takes the twins on any device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.bell import check_cols, fine_layout
from ..sparse.compact import CompactGather
from ..sparse.sell import SellLayout
from ..sparse.ell_gather import ell_gather_sum_batched, ell_gather_sum_batched_plain
# the element table's columns: TRI10 (upper-triangle pair -> 0..9) and
# Q2P16 (ordered pair q = i*4 + j -> its column)
from ..sparse.pallas_assembly import Q2P16, TRI10, reordered_lists  # noqa: F401
from ..sparse.slot_reduce import group_by_slot, slot_reduce, slot_reduce_plain
from ..utils import kernels

REDUCES = ("window", "segsum", "reorder")  # the orders of the contributor lists

_LAUNCHES = {"tet_element": 0}


def reset_launch_counts() -> None:
    _LAUNCHES["tet_element"] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


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
        _LAUNCHES["tet_element"] += 1
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


class TetraAssembler:
    """vals = TetraAssembler(topo, conn, device=...)(coords)  # (n_slots,) f32

    topo: ``sparse.topology.Topology`` of the mesh;
    conn: (nc, 4) tetra connectivity; ``layout``: the SELL layout the
    values are assembled into (default ``fine_layout(topo)``; the values
    then go to ``BellMatrix(vals, asm.layout, ...)``).  The corner columns
    go to the device once, and each slot's contributor list is built
    there once (``ptr``, ``ids``: int32, 4 bytes per slot and 16 per
    cell).  ``coords_batched`` fetches the corners with one batched
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
        reduce = slot_reduce_plain if self.plain else slot_reduce
        return reduce(self.ptr, self.ids, self.element_table(coords).view(-1))
