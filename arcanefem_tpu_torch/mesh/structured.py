"""Structured Kuhn-tetrahedron box: geometry, masks and plain assembly.

The counterpart of ``arcanefem_tpu/mesh/structured.py``.  A box of
(nx, ny, nz) hexes, each split into the same 6 tetrahedra (the Kuhn split),
has a node graph with a fixed set of 15 index offsets, so its stiffness
matrix is 15 diagonal bands (``sparse/dia.py::DiaMatrix``) and assembly is
96 static slice-adds: no gather, no scatter.

``assemble_stiffness`` and ``source_rhs`` here are plain PyTorch.  They are
the CPU path and the plain version of the stencil-assembly kernel K4
(``mesh/stencil_assembly.py``).  Geometry and masks are host numpy, built
as in the JAX package, so both packages see the same coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.dia import DiaMatrix

# Kuhn 6-tet decomposition of the unit hex
_HEX_CORNERS = [  # grid deltas (di, dj, dk) of hex corners 0..7
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
]
_TETS = [
    (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
    (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
]


class StructuredBox:
    """(nx, ny, nz) hex grid, each hex split into 6 tets; nodes z-fastest."""

    def __init__(self, nx: int, ny: int, nz: int, lx: float = 1.0,
                 ly: float = 1.0, lz: float = 1.0):
        self.nx, self.ny, self.nz = nx, ny, nz
        self.lx, self.ly, self.lz = lx, ly, lz
        self.sy = nz + 1
        self.sx = (ny + 1) * (nz + 1)
        offs = set()
        for tet in _TETS:
            for i in tet:
                for j in tet:
                    offs.add(self._lin(_HEX_CORNERS[j]) - self._lin(_HEX_CORNERS[i]))
        self.offsets = tuple(sorted(offs))

    def _lin(self, d) -> int:
        return d[0] * self.sx + d[1] * self.sy + d[2]

    @property
    def shape(self) -> tuple[int, int, int]:
        """Nodes per axis, (nx+1, ny+1, nz+1)."""
        return (self.nx + 1, self.ny + 1, self.nz + 1)

    @property
    def n_nodes(self) -> int:
        return (self.nx + 1) * (self.ny + 1) * (self.nz + 1)

    @property
    def n_cells(self) -> int:
        return 6 * self.nx * self.ny * self.nz

    def grid_coords(self, dtype=np.float32, jitter: float = 0.0, seed: int = 0):
        """(nx+1, ny+1, nz+1, 3) node coordinates; optional interior jitter
        (a fraction of the local spacing), from the same numpy generator as
        the JAX package."""
        xs = np.linspace(0, self.lx, self.nx + 1)
        ys = np.linspace(0, self.ly, self.ny + 1)
        zs = np.linspace(0, self.lz, self.nz + 1)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        c = np.stack([X, Y, Z], axis=-1)
        if jitter > 0:
            rng = np.random.RandomState(seed)
            h = np.array([self.lx / self.nx, self.ly / self.ny, self.lz / self.nz])
            d = (rng.rand(*c.shape) - 0.5) * 2 * jitter * h
            d[0, :, :] = d[-1, :, :] = 0.0
            d[:, 0, :] = d[:, -1, :] = 0.0
            d[:, :, 0] = d[:, :, -1] = 0.0
            c = c + d
        return c.astype(dtype)

    def boundary_mask(self, planes=("xmin", "xmax")) -> np.ndarray:
        """(n_nodes,) bool mask of nodes on the named box faces."""
        m = np.zeros(self.shape, bool)
        sel = {
            "xmin": (0, slice(None), slice(None)),
            "xmax": (-1, slice(None), slice(None)),
            "ymin": (slice(None), 0, slice(None)),
            "ymax": (slice(None), -1, slice(None)),
            "zmin": (slice(None), slice(None), 0),
            "zmax": (slice(None), slice(None), -1),
        }
        for p in planes:
            m[sel[p]] = True
        return m.reshape(-1)

    def coarsened(self) -> "StructuredBox":
        """The box with every axis halved (the next multigrid level)."""
        return StructuredBox(self.nx // 2, self.ny // 2, self.nz // 2,
                             self.lx, self.ly, self.lz)

    # -- plain assembly ------------------------------------------------------

    def _corner_xyz(self, coords3d: torch.Tensor, corner: int) -> torch.Tensor:
        di, dj, dk = _HEX_CORNERS[corner]
        return coords3d[di : di + self.nx, dj : dj + self.ny,
                        dk : dk + self.nz].reshape(-1, 3)

    def _tet_geometry(self, coords3d: torch.Tensor, tet):
        """|6V|/6 and the scaled cofactor gradients of one tet of every hex:
        (vol, scale, (gx, gy, gz)) with each g a list of 4 (nhex,) tensors
        and scale = vol / |6V|^2 (0 where |6V| <= 1e-30), so that entry
        (a, b) is scale * (g[a] . g[b]) — the kernel's arithmetic."""
        P = [self._corner_xyz(coords3d, c) for c in tet]
        X, Y, Z = ([p[:, k] for p in P] for k in range(3))
        v0x, v0y, v0z = X[1] - X[0], Y[1] - Y[0], Z[1] - Z[0]
        v1x, v1y, v1z = X[2] - X[0], Y[2] - Y[0], Z[2] - Z[0]
        v2x, v2y, v2z = X[3] - X[0], Y[3] - Y[0], Z[3] - Z[0]
        cxx = v1y * v2z - v1z * v2y
        cyy = v1z * v2x - v1x * v2z
        czz = v1x * v2y - v1y * v2x
        av6 = (v0x * cxx + v0y * cyy + v0z * czz).abs()
        ok = av6 > 1e-30
        inv = torch.where(ok, 1.0 / torch.where(ok, av6, 1.0), 0.0)
        vol = av6 / 6.0

        def comp(u, w):
            return [
                u[1] * (w[3] - w[2]) + u[2] * (w[1] - w[3]) + u[3] * (w[2] - w[1]),
                u[0] * (w[2] - w[3]) + u[2] * (w[3] - w[0]) + u[3] * (w[0] - w[2]),
                u[0] * (w[3] - w[1]) + u[1] * (w[0] - w[3]) + u[3] * (w[1] - w[0]),
                u[0] * (w[1] - w[2]) + u[1] * (w[2] - w[0]) + u[2] * (w[0] - w[1]),
            ]

        return vol, vol * inv * inv, (comp(Y, Z), comp(Z, X), comp(X, Y))

    def assemble_stiffness(self, coords3d: torch.Tensor) -> DiaMatrix:
        """P1 stiffness by 96 static slice-adds grouped by the 15 offsets.

        coords3d: (nx+1, ny+1, nz+1, 3) on any device, float32 or float64."""
        nx, ny, nz = self.nx, self.ny, self.nz
        bands = torch.zeros((len(self.offsets),) + self.shape,
                            dtype=coords3d.dtype, device=coords3d.device)
        band_of = {d: i for i, d in enumerate(self.offsets)}
        for tet in _TETS:
            _, scale, (gx, gy, gz) = self._tet_geometry(coords3d, tet)
            for a, ca in enumerate(tet):
                di, dj, dk = _HEX_CORNERS[ca]
                la = self._lin(_HEX_CORNERS[ca])
                for b, cb in enumerate(tet):
                    d = band_of[self._lin(_HEX_CORNERS[cb]) - la]
                    contrib = scale * (gx[a] * gx[b] + gy[a] * gy[b] + gz[a] * gz[b])
                    bands[d, di : di + nx, dj : dj + ny, dk : dk + nz] += \
                        contrib.reshape(nx, ny, nz)
        return DiaMatrix(bands.reshape(len(self.offsets), -1), self.offsets)

    def source_rhs(self, coords3d: torch.Tensor, f: float) -> torch.Tensor:
        """rhs[node] += f * vol / 4 per incident tet (constant source)."""
        nx, ny, nz = self.nx, self.ny, self.nz
        rhs = torch.zeros(self.shape, dtype=coords3d.dtype, device=coords3d.device)
        for tet in _TETS:
            vol, _, _ = self._tet_geometry(coords3d, tet)
            contrib = (f * vol / 4.0).reshape(nx, ny, nz)
            for ca in tet:
                di, dj, dk = _HEX_CORNERS[ca]
                rhs[di : di + nx, dj : dj + ny, dk : dk + nz] += contrib
        return rhs.reshape(-1)


def apply_penalty_dirichlet(A: DiaMatrix, rhs: torch.Tensor, mask: torch.Tensor,
                            values: torch.Tensor, penalty: float):
    """Penalty Dirichlet on a DIA matrix: diag := P, rhs := P*g on masked rows."""
    d0 = A.offsets.index(0)
    bands = A.bands.clone()
    bands[d0] = torch.where(mask, torch.full_like(bands[d0], penalty), bands[d0])
    return A.with_bands(bands), torch.where(mask, penalty * values, rhs)
