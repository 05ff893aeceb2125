"""Unstructured mesh container (host numpy).

The port's copy of the ``Mesh`` dataclass of ``arcanefem_tpu/mesh/core.py``
and of the exterior-face search it uses to group the sphere_cut boundary.
Gmsh reading (``read_msh``) is not copied: the port's meshes are generated
in-repo.  Everything is a flat array:

* ``coords``      — (n_nodes, 3) float64 node coordinates
* ``cells``       — cell-type name -> (n_cells, nodes_per_cell) int32
* ``face_groups`` — named boundary groups: type -> connectivity
* ``node_groups`` — named node sets
* ``cell_groups`` — named cell sets
* ``node_uids``   — 1-based node tags
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mesh:
    coords: np.ndarray  # (n_nodes, 3) float64
    node_uids: np.ndarray  # (n_nodes,) int64, 1-based
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

    def boundary_faces(self) -> dict[str, np.ndarray]:
        """All exterior faces (faces adjacent to exactly one cell)."""
        return _boundary_faces(self)


# the faces of a tetra4, as local node index tuples
_TETRA4_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]


def _boundary_faces(mesh: Mesh) -> dict[str, np.ndarray]:
    """The tria3 faces that appear exactly once over the tetra4 cells (the
    port generates tetrahedral meshes only)."""
    if "tetra4" not in mesh.cells:
        return {}
    conn = mesh.cells["tetra4"]
    faces = np.concatenate([conn[:, loc] for loc in _TETRA4_FACES])
    _uniq, idx, cnt = np.unique(np.sort(faces, axis=1), axis=0,
                                return_index=True, return_counts=True)
    return {"tria3": faces[idx[cnt == 1]].astype(np.int32)}
