"""Synthetic structured meshes (host numpy).

The port's copy of ``rect_tria_mesh`` and ``box_tetra_mesh`` from
``arcanefem_tpu/mesh/generate.py``; the CPU tests hold them to the
originals with exact equality.  They give the RCM-ordered meshes of the
diagonal SpMV's tests and its box measurement.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh


def rect_tria_mesh(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0) -> Mesh:
    """Structured triangle mesh of an (lx × ly) rectangle.

    Boundary face groups: left/right/bottom/top (edges), mirrors the naming
    used by the reference's bar meshes.
    """
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.zeros(((nx + 1) * (ny + 1), 3), np.float64)
    coords[:, 0] = X.ravel()
    coords[:, 1] = Y.ravel()

    def nid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    cells = {"tria3": np.asarray(tris, np.int32)}

    fg = {}
    fg["left"] = {"line2": np.asarray([(nid(0, j), nid(0, j + 1)) for j in range(ny)], np.int32)}
    fg["right"] = {"line2": np.asarray([(nid(nx, j), nid(nx, j + 1)) for j in range(ny)], np.int32)}
    fg["bottom"] = {"line2": np.asarray([(nid(i, 0), nid(i + 1, 0)) for i in range(nx)], np.int32)}
    fg["top"] = {"line2": np.asarray([(nid(i, ny), nid(i + 1, ny)) for i in range(nx)], np.int32)}

    return Mesh(
        coords=coords,
        node_uids=np.arange(1, len(coords) + 1, dtype=np.int64),
        cells=cells,
        dim=2,
        face_groups=fg,
    )


def box_tetra_mesh(
    nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
) -> Mesh:
    """Structured tetra mesh of a box: each hex cell split into 6 tets.

    This is the scalable stand-in for the reference's sphere_cut 3D Poisson
    benchmark mesh (BASELINE.md: ~10M DoF target).
    Boundary groups: xmin/xmax/ymin/ymax/zmin/zmax (tria faces).
    """
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    sy = nz + 1
    sx = (ny + 1) * (nz + 1)

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    base = (I * sx + J * sy + K).ravel()
    # hex corners (gmsh-style ordering not needed; only tets emitted)
    c = np.stack(
        [
            base,
            base + sx,
            base + sx + sy,
            base + sy,
            base + 1,
            base + sx + 1,
            base + sx + sy + 1,
            base + sy + 1,
        ],
        axis=1,
    )  # (nhex, 8): 0..3 bottom face, 4..7 top face
    # 6-tet (Kuhn) decomposition of the hex, consistent across neighbors
    tet_local = [
        (0, 1, 2, 6),
        (0, 2, 3, 6),
        (0, 3, 7, 6),
        (0, 7, 4, 6),
        (0, 4, 5, 6),
        (0, 5, 1, 6),
    ]
    tets = np.concatenate([c[:, t] for t in tet_local], axis=0).astype(np.int32)

    def plane(axis: int, fixed: int) -> np.ndarray:
        if axis == 0:
            jj, kk = np.meshgrid(np.arange(ny + 1), np.arange(nz + 1), indexing="ij")
            return (fixed * sx + jj * sy + kk).astype(np.int64)
        if axis == 1:
            ii, kk = np.meshgrid(np.arange(nx + 1), np.arange(nz + 1), indexing="ij")
            return (ii * sx + fixed * sy + kk).astype(np.int64)
        ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
        return (ii * sx + jj * sy + fixed).astype(np.int64)

    def quad_faces(grid: np.ndarray) -> np.ndarray:
        a = grid[:-1, :-1].ravel()
        b = grid[1:, :-1].ravel()
        cc = grid[1:, 1:].ravel()
        d = grid[:-1, 1:].ravel()
        # split each boundary quad into 2 triangles
        t1 = np.stack([a, b, cc], axis=1)
        t2 = np.stack([a, cc, d], axis=1)
        return np.concatenate([t1, t2]).astype(np.int32)

    fg = {
        "xmin": {"tria3": quad_faces(plane(0, 0))},
        "xmax": {"tria3": quad_faces(plane(0, nx))},
        "ymin": {"tria3": quad_faces(plane(1, 0))},
        "ymax": {"tria3": quad_faces(plane(1, ny))},
        "zmin": {"tria3": quad_faces(plane(2, 0))},
        "zmax": {"tria3": quad_faces(plane(2, nz))},
    }

    return Mesh(
        coords=coords,
        node_uids=np.arange(1, len(coords) + 1, dtype=np.int64),
        cells={"tetra4": tets},
        dim=3,
        face_groups=fg,
    )
