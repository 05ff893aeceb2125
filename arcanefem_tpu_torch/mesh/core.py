"""Unstructured mesh container and Gmsh reader (host numpy).

The port's copy of ``arcanefem_tpu/mesh/core.py``: the ``Mesh`` dataclass,
``read_msh`` (with ``mesh/gmsh.py``) and the exterior-face search for
every cell type; the CPU tests hold it to the original with exact
equality.  Everything is a flat array:

* ``coords``      — (n_nodes, 3) float64 node coordinates
* ``cells``       — cell-type name -> (n_cells, nodes_per_cell) int32
  0-based connectivity (mixed meshes have several buckets)
* ``face_groups`` — named boundary groups: type -> connectivity
* ``node_groups`` — named node sets
* ``cell_groups`` — named cell sets (material regions)
* ``node_uids``   — 1-based Gmsh tags; golden-file validation keys on these
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .gmsh import NAME_TO_DIM, parse_msh

# canonical corner-node counts for the linear cell zoo
CELL_NNODES = {
    "line2": 2,
    "line3": 3,
    "tria3": 3,
    "tria6": 6,
    "quad4": 4,
    "quad8": 8,
    "tetra4": 4,
    "tetra10": 10,
    "hexa8": 8,
    "hexa20": 20,
    "penta6": 6,
    "pyramid5": 5,
}


@dataclass
class Mesh:
    coords: np.ndarray  # (n_nodes, 3) float64
    node_uids: np.ndarray  # (n_nodes,) int64, gmsh tags (1-based)
    cells: dict[str, np.ndarray]  # type -> (nc, npc) int32
    dim: int
    face_groups: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)
    node_groups: dict[str, np.ndarray] = field(default_factory=dict)
    cell_groups: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return sum(c.shape[0] for c in self.cells.values())

    def group_nodes(self, name: str) -> np.ndarray:
        """All unique node ids belonging to a named group (face or node)."""
        if name in self.node_groups:
            return self.node_groups[name]
        if name in self.face_groups:
            parts = [conn.ravel() for conn in self.face_groups[name].values()]
            return np.unique(np.concatenate(parts))
        raise KeyError(f"no group named '{name}'")

    def boundary_faces(self) -> dict[str, np.ndarray]:
        """Extract all exterior faces (faces adjacent to exactly one cell)."""
        return _boundary_faces(self)

    def cell_type(self) -> str:
        """Cell type if the mesh is single-type; error otherwise."""
        if len(self.cells) != 1:
            raise ValueError(f"mixed-type mesh: {list(self.cells)}")
        return next(iter(self.cells))

    def connectivity(self) -> np.ndarray:
        return self.cells[self.cell_type()]


def read_msh(path: str) -> Mesh:
    """Read a Gmsh file and resolve physical groups into a Mesh."""
    raw = parse_msh(path)

    # remap gmsh node tags -> dense 0-based ids (tags may be sparse)
    order = np.argsort(raw.node_tags, kind="stable")
    node_uids = raw.node_tags[order]
    coords = raw.coords[order]
    tag_to_idx = np.full(int(node_uids.max()) + 1 if len(node_uids) else 1, -1, np.int32)
    tag_to_idx[node_uids] = np.arange(len(node_uids), dtype=np.int32)

    mesh_dim = 0
    for _dim, _etag, tname, _tags, _conn in raw.blocks:
        mesh_dim = max(mesh_dim, NAME_TO_DIM[tname])

    cells: dict[str, list[np.ndarray]] = {}
    group_elems: dict[str, dict[str, list[np.ndarray]]] = {}
    group_dims: dict[str, int] = {}
    group_points: dict[str, list[np.ndarray]] = {}

    for dim, etag, tname, _etags, conn in raw.blocks:
        conn0 = tag_to_idx[conn]
        ptags = raw.entity_physicals.get((dim, etag), [])
        names = [
            raw.physical_names.get((dim, p), f"phys_{dim}_{p}") for p in ptags
        ]
        if dim == mesh_dim:
            cells.setdefault(tname, []).append(conn0.astype(np.int32))
        if dim == 0:
            for name in names:
                group_points.setdefault(name, []).append(conn0.ravel())
            continue
        for name in names:
            group_dims[name] = dim
            group_elems.setdefault(name, {}).setdefault(tname, []).append(
                conn0.astype(np.int32)
            )

    mesh = Mesh(
        coords=coords,
        node_uids=node_uids,
        cells={t: np.concatenate(parts) for t, parts in cells.items()},
        dim=mesh_dim,
    )
    for name, by_type in group_elems.items():
        resolved = {t: np.concatenate(p) for t, p in by_type.items()}
        if group_dims[name] == mesh_dim:
            mesh.cell_groups[name] = resolved
        else:
            mesh.face_groups[name] = resolved
    for name, parts in group_points.items():
        mesh.node_groups[name] = np.unique(
            np.concatenate(parts).astype(np.int32)
        )
    return mesh


_FACES_OF = {
    # faces of each volume cell type, as local node index tuples
    # (quadratic tuples carry the mid-edge nodes, gmsh edge ordering —
    # see mesh/generate._Q_EDGES and ops/quadrature.shape_tables)
    "tetra4": [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)],
    "tetra10": [
        (0, 1, 2, 4, 5, 6),
        (0, 1, 3, 4, 9, 7),
        (0, 2, 3, 6, 8, 7),
        (1, 2, 3, 5, 8, 9),
    ],
    "hexa8": [
        (0, 1, 2, 3),
        (4, 5, 6, 7),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
    ],
    "hexa20": [
        (0, 1, 2, 3, 8, 11, 13, 9),
        (4, 5, 6, 7, 16, 18, 19, 17),
        (0, 1, 5, 4, 8, 12, 16, 10),
        (1, 2, 6, 5, 11, 14, 18, 12),
        (2, 3, 7, 6, 13, 15, 19, 14),
        (3, 0, 4, 7, 9, 10, 17, 15),
    ],
    # edges of each surface cell type
    "tria3": [(0, 1), (1, 2), (2, 0)],
    "quad4": [(0, 1), (1, 2), (2, 3), (3, 0)],
    "tria6": [(0, 1, 3), (1, 2, 4), (2, 0, 5)],
    "quad8": [(0, 1, 4), (1, 2, 5), (2, 3, 6), (3, 0, 7)],
}

_VOLUME_TYPES = {"tetra4", "tetra10", "hexa8", "hexa20", "penta6", "pyramid5"}


def _boundary_faces(mesh: Mesh) -> dict[str, np.ndarray]:
    """All faces that appear exactly once over all cells, grouped by face type."""
    acc: dict[tuple, list[np.ndarray]] = {}
    for ctype, conn in mesh.cells.items():
        vol = ctype in _VOLUME_TYPES
        for loc in _FACES_OF.get(ctype, []):
            faces = conn[:, loc]  # (nc, k)
            acc.setdefault((vol, len(loc)), []).append(faces)
    out: dict[str, np.ndarray] = {}
    names = {
        (False, 2): "line2", (False, 3): "line3",
        (True, 3): "tria3", (True, 4): "quad4",
        (True, 6): "tria6", (True, 8): "quad8",
    }
    for key_k, lists in acc.items():
        faces = np.concatenate(lists)
        key = np.sort(faces, axis=1)
        _uniq, idx, cnt = np.unique(
            key, axis=0, return_index=True, return_counts=True
        )
        boundary = faces[idx[cnt == 1]]
        out[names[key_k]] = boundary.astype(np.int32)
    return out
