"""P1 tetrahedron stiffness assembly into BELL values.

The counterpart of the segment-sum form of
``arcanefem_tpu/ops/lane_assembly.py::TetraLaneAssembler``.  Every
intermediate is a length-nc vector over cells (cell axis last), the
element matrices come from the cofactors of the corner coordinates, and
the 16 entries of each element matrix are scatter-added straight into the
SELL storage of ``sparse/sell.py`` (the JAX package's flat (N*W) slot
space there), through the topology's slot map remapped once on the host
into SELL slots.

The corner-coordinate fetch is the ELL gather kernel at W=1, in
corner-major order: request i*nc + c is corner i of cell c, so corner i's
coordinates are one contiguous slice.  By default it is three launches of
``ell_gather_sum`` (K2 on the card), one per axis; with
``coords_batched=True`` (the JAX package's ``AFEM_ASM_COORDS=batched``) it
is one launch of ``ell_gather_sum_batched`` (K3a) that reads the (N, 3)
coordinates in place.  With ``coords_compact=True`` (the JAX package's
``AFEM_ASM_COMPACT=1`` coordinate gather) the requests go through the
compact two-stage gather of ``sparse/compact.py`` in blocks of 16384: a
pre-gather of each block's distinct nodes (K2, or with ``band_pre`` the
banded K9a plus K2 on its wide tiles), then K2 over the block-local
indices; batched, the same stages are K9b/K3a and K3a.  Every form fetches
the same values, so all give the same corners.  The element arithmetic
runs in float32 whatever the caller's dtype, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.bell import check_cols, fine_layout
from ..sparse.compact import CompactGather
from ..sparse.sell import SellLayout
from ..sparse.ell_gather import (
    ell_gather_sum,
    ell_gather_sum_batched,
    ell_gather_sum_batched_plain,
    ell_gather_sum_plain,
)

_PAIRS = [(i, j) for i in range(4) for j in range(4)]


class TetraAssembler:
    """vals = TetraAssembler(topo, conn, device=...)(coords)  # (n_slots,) f32

    topo: ``sparse.topology.Topology`` of the mesh;
    conn: (nc, 4) tetra connectivity; ``layout``: the SELL layout the
    values are assembled into (default ``fine_layout(topo)``; the values
    then go to ``BellMatrix(vals, asm.layout, ...)``).  The corner columns
    and the transposed slot map are copied to the device once.  ``coords_batched``
    fetches the three axes with one batched gather; ``coords_compact``
    through the compact two-stage gather, its pre-gather banded when
    ``band_pre``; ``plain=True`` fetches the coordinates with the kernels'
    plain twins instead.
    """

    def __init__(self, topo, conn: np.ndarray, *, device: torch.device | str,
                 plain: bool = False, coords_batched: bool = False,
                 coords_compact: bool = False, band_pre: bool = False,
                 layout: SellLayout | None = None):
        if band_pre and not coords_compact:
            raise ValueError("band_pre bands the compact pre-gather: it needs "
                             "coords_compact=True")
        conn = np.asarray(conn)
        nc = conn.shape[0]
        check_cols(conn, topo.n_nodes, "TetraAssembler conn")
        self.n_cells = nc
        self.layout = fine_layout(topo, device) if layout is None else layout
        self.coords_batched = coords_batched
        self._gather = ell_gather_sum_plain if plain else ell_gather_sum
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
        # entry q = i*4 + j of cell c sits at q*nc + c, as its SELL slot
        # (int32: the slots of any mesh one card holds are < 2^31)
        sm = self.layout.ell_to_sell[
            np.asarray(topo.slot_maps["tetra4"], np.int64).reshape(nc, 16)]
        if int(sm.min(initial=0)) < 0:
            raise ValueError("TetraAssembler: an element entry falls on a slot "
                             "the layout drops")
        self.slot_map_t = torch.as_tensor(
            np.ascontiguousarray(sm.T.astype(np.int32)).reshape(-1),
            device=device)

    def gather_corners(self, coords: torch.Tensor):
        """Axis k of every corner, float32: entry i*nc + c of the k-th row is
        corner i of cell c.  Three (4nc,) vectors, or one (3, 4nc) tensor
        when the coordinates are batched."""
        c32 = coords.to(torch.float32)
        if self.compact is not None:
            if self.coords_batched:
                return self.compact.gather_batched(c32.T)
            ct = c32.T.contiguous()
            return [self.compact.gather(ct[k]) for k in range(3)]
        if self.coords_batched:
            # (N, 3) read in place as (3, N) tables; the result axis-major
            return self._gather_b(self.corner_cols, c32.T)
        ct = c32.T.contiguous()  # (3, N)
        return [self._gather(self.corner_cols, ct[k]) for k in range(3)]

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        nc = self.n_cells
        g = self.gather_corners(coords)
        x, y, z = ([g[k][i * nc:(i + 1) * nc] for i in range(4)]
                   for k in range(3))
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
        vals = torch.zeros(self.layout.n_slots, dtype=torch.float32,
                           device=coords.device)
        # in place: one entry's (nc,) contribution at a time, so no (16, nc)
        # element-matrix stack is ever held
        for q, (i, j) in enumerate(_PAIRS):
            keq = (dx[i] * dx[j] + dy[i] * dy[j] + dz[i] * dz[j]) * scale
            vals.index_add_(0, self.slot_map_t[q * nc:(q + 1) * nc], keq)
        return vals
