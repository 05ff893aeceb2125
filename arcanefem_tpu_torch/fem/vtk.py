"""VTK legacy writer for post-processing/visualization.

The port's copy of ``arcanefem_tpu/fem/vtk.py`` (the CPU tests hold its
files byte-identical to the original's).  The reference emits VtkHdfV2
files through Arcane's post-processing service (`<arcane-post-processing>`
blocks) for ParaView; this writes the portable VTK legacy
unstructured-grid format (ASCII), which ParaView/VisIt read directly — no
HDF5 dependency.  ``fem/runner.py`` uses it where h5py is missing.
"""

from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh

_VTK_TYPE = {
    "line2": 3, "tria3": 5, "quad4": 9, "tetra4": 10,
    "hexa8": 12, "penta6": 13, "pyramid5": 14,
}


def write_vtk(
    path: str,
    mesh: Mesh,
    point_data: dict | None = None,
    cell_data: dict | None = None,
    title: str = "arcanefem_tpu",
) -> None:
    """point_data: name -> (n_nodes,) or (n_nodes, k) arrays (k<=3).
    cell_data: name -> {cell_type: (nc,) array} or flat (n_cells,) in
    bucket order."""
    types, conns = [], []
    for ct, conn in mesh.cells.items():
        types.append(np.full(conn.shape[0], _VTK_TYPE[ct], np.int32))
        conns.append(conn)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{title}\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {mesh.n_nodes} double\n")
        np.savetxt(f, mesh.coords, fmt="%.10g")
        ncell = mesh.n_cells
        sz = sum(c.shape[0] * (c.shape[1] + 1) for c in conns)
        f.write(f"CELLS {ncell} {sz}\n")
        for conn in conns:
            block = np.column_stack(
                [np.full(conn.shape[0], conn.shape[1], np.int64), conn]
            )
            np.savetxt(f, block, fmt="%d")
        f.write(f"CELL_TYPES {ncell}\n")
        np.savetxt(f, np.concatenate(types)[:, None], fmt="%d")

        if point_data:
            f.write(f"POINT_DATA {mesh.n_nodes}\n")
            for name, arr in point_data.items():
                a = np.asarray(arr)
                if a.ndim == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, a[:, None], fmt="%.10g")
                else:
                    v = np.zeros((a.shape[0], 3))
                    v[:, : a.shape[1]] = a
                    f.write(f"VECTORS {name} double\n")
                    np.savetxt(f, v, fmt="%.10g")
        if cell_data:
            f.write(f"CELL_DATA {ncell}\n")
            for name, arr in cell_data.items():
                if isinstance(arr, dict):
                    flat = np.concatenate(
                        [np.asarray(arr[ct]) for ct in mesh.cells]
                    )
                else:
                    flat = np.asarray(arr)
                if flat.ndim == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, flat[:, None], fmt="%.10g")
                else:
                    v = np.zeros((flat.shape[0], 3))
                    v[:, : flat.shape[1]] = flat
                    f.write(f"VECTORS {name} double\n")
                    np.savetxt(f, v, fmt="%.10g")
