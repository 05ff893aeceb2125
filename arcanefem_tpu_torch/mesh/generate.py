"""Synthetic structured meshes (host numpy).

The port's copy of ``rect_tria_mesh``, ``box_tetra_mesh`` and
``quadratize`` from ``arcanefem_tpu/mesh/generate.py``; the CPU tests hold
them to the originals with exact equality.  They give the RCM-ordered
meshes of the diagonal SpMV's tests and its box measurement, and the P2
meshes of the model tests and chip_smoke.
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


# --- quadratic (P2/serendipity) mesh refinement ----------------------------

# gmsh edge-node orderings, matching ops/quadrature.py shape_tables
_Q_EDGES = {
    "line2": ("line3", [(0, 1)]),
    "tria3": ("tria6", [(0, 1), (1, 2), (2, 0)]),
    "quad4": ("quad8", [(0, 1), (1, 2), (2, 3), (3, 0)]),
    "tetra4": ("tetra10", [(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)]),
    "hexa8": (
        "hexa20",
        [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
         (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)],
    ),
}


def quadratize(mesh: Mesh) -> Mesh:
    """Convert a linear mesh to its quadratic counterpart (tria3->tria6,
    tetra4->tetra10, quad4->quad8, hexa8->hexa20, boundary line2->line3)
    by inserting one mid-edge node per unique edge, gmsh node ordering.

    The reference ships quadratic meshes from Gmsh (passmo quadratic
    cases); this generates them from any linear mesh, so the quadratic
    elements (ops/quadrature.py) run on in-repo meshes at any size.
    """

    def blocks():
        for ct, conn in mesh.cells.items():
            yield ("cell", None, ct, conn)
        for g, types in mesh.face_groups.items():
            for ct, conn in types.items():
                yield ("face", g, ct, conn)

    # collect every unique undirected edge that needs a midpoint
    edge_lists = []
    for _, _, ct, conn in blocks():
        if ct not in _Q_EDGES:
            raise ValueError(f"no quadratic counterpart for '{ct}'")
        pairs = np.asarray(_Q_EDGES[ct][1])
        edge_lists.append(
            conn.astype(np.int64)[:, pairs].reshape(-1, 2)
        )
    all_edges = np.sort(np.concatenate(edge_lists), axis=1)
    uniq, inv = np.unique(all_edges, axis=0, return_inverse=True)
    mid_ids = (mesh.n_nodes + np.arange(len(uniq))).astype(np.int64)

    coords = np.concatenate(
        [mesh.coords, 0.5 * (mesh.coords[uniq[:, 0]] + mesh.coords[uniq[:, 1]])]
    )
    uid0 = int(mesh.node_uids.max()) + 1
    node_uids = np.concatenate(
        [mesh.node_uids, np.arange(uid0, uid0 + len(uniq), dtype=np.int64)]
    )

    new_cells, new_fg = {}, {g: {} for g in mesh.face_groups}
    new_cell_groups = {}
    pos = 0
    for kind, g, ct, conn in blocks():
        qt, pairs = _Q_EDGES[ct]
        ne = len(pairs) * len(conn)
        mids = mid_ids[inv[pos : pos + ne]].reshape(len(conn), len(pairs))
        pos += ne
        qconn = np.concatenate([conn.astype(np.int64), mids], axis=1).astype(
            np.int32
        )
        if kind == "cell":
            new_cells[qt] = qconn
        else:
            new_fg[g][qt] = qconn
    for g, types in mesh.cell_groups.items():
        new_cell_groups[g] = {
            _Q_EDGES[ct][0]: idx for ct, idx in types.items()
        }

    return Mesh(
        coords=coords,
        node_uids=node_uids,
        cells=new_cells,
        dim=mesh.dim,
        face_groups=new_fg,
        node_groups=dict(mesh.node_groups),
        cell_groups=new_cell_groups,
    )
