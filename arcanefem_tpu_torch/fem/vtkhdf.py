"""VTKHDF (v2.0) unstructured-grid writer — the reference's output format.

The port's copy of ``arcanefem_tpu/fem/vtkhdf.py`` (the CPU tests hold its
datasets equal to the original's through h5py).  The reference emits post-processing output through Arcane's
`VtkHdfV2PostProcessor` service, selected by the `<arcane-post-processing>`
block of every case file (e.g. modules/poisson/inputs/circle.2D.arc:8-14:
`<format name="VtkHdfV2PostProcessor"/> <output><variable>U</variable>`).
This writes the same on-disk format — the VTK HDF File Format v2.0
("UnstructuredGrid" type) that ParaView ≥5.11 reads natively — built
directly on h5py rather than VTK.

Layout written (single partition):

    /VTKHDF                 attrs: Version=[2,0], Type="UnstructuredGrid"
      NumberOfPoints / NumberOfCells / NumberOfConnectivityIds  (nparts,)
      Points (np,3) f64 · Connectivity (nids,) i64 · Offsets (nc+1,) i64
      Types (nc,) u8
      PointData/<name>  · CellData/<name>
      Steps/ ...          (temporal runs: static geometry, appended fields)

Temporal output (`VtkHdfWriter.add_step`) follows the v2 "Steps" group
convention with a static mesh: geometry datasets are written once with
zero Point/Cell/ConnectivityId offsets per step, and each field dataset
grows along axis 0 with per-step offsets in Steps/PointDataOffsets — so a
transient case produces ONE file holding the whole time series, exactly
like the reference's output directory.
"""

from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh

try:  # gated: h5py is optional — the legacy writer (vtk.py) needs nothing
    import h5py

    HAVE_H5PY = True
except ImportError:  # pragma: no cover
    h5py = None
    HAVE_H5PY = False

# VTK cell-type codes (VTKCellType enum) for every element the mesh layer
# produces, including the quadratic zoo (ops/quadrature.py).
_VTK_TYPE = {
    "line2": 3, "tria3": 5, "quad4": 9, "tetra4": 10,
    "hexa8": 12, "penta6": 13, "pyramid5": 14,
    "line3": 21, "tria6": 22, "quad8": 23, "tetra10": 24, "hexa20": 25,
}


def _require_h5py():
    if not HAVE_H5PY:
        raise ImportError(
            "VTKHDF output needs h5py; use arcanefem_tpu_torch.fem.vtk.write_vtk "
            "(legacy ASCII) instead"
        )


def _as_point_array(arr) -> np.ndarray:
    """Field values as (n, 1|3) f64 — 2D vectors are padded to 3 components
    the way the reference's Real3 node variables always carry a z slot."""
    a = np.asarray(arr, np.float64)
    if a.ndim == 1:
        return a[:, None]
    if a.shape[1] == 3:
        return a
    out = np.zeros((a.shape[0], 3))
    out[:, : a.shape[1]] = a
    return out


class VtkHdfWriter:
    """Write one VTKHDF file; call :meth:`add_step` per output time."""

    def __init__(self, path: str, mesh: Mesh):
        _require_h5py()
        self.mesh = mesh
        self._file = h5py.File(path, "w")
        g = self._file.create_group("VTKHDF")
        g.attrs.create("Version", np.array([2, 0], np.int64))
        g.attrs.create(
            "Type", "UnstructuredGrid",
            dtype=h5py.string_dtype("ascii", len("UnstructuredGrid")),
        )
        self._root = g
        self._n_steps = 0
        self._point_sets: dict = {}
        self._cell_sets: dict = {}
        self._write_geometry()

    def _write_geometry(self):
        mesh, g = self.mesh, self._root
        conns, types, sizes = [], [], []
        for ct, conn in mesh.cells.items():
            if ct not in _VTK_TYPE:
                raise ValueError(f"no VTK cell type for '{ct}'")
            conns.append(np.asarray(conn, np.int64).ravel())
            types.append(np.full(conn.shape[0], _VTK_TYPE[ct], np.uint8))
            sizes.append(np.full(conn.shape[0], conn.shape[1], np.int64))
        conn_flat = np.concatenate(conns)
        off_flat = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(np.concatenate(sizes))]
        )
        pts = np.zeros((mesh.n_nodes, 3))
        pts[:, : mesh.coords.shape[1]] = mesh.coords
        g.create_dataset("NumberOfPoints", data=[mesh.n_nodes], dtype=np.int64)
        g.create_dataset("NumberOfCells", data=[mesh.n_cells], dtype=np.int64)
        g.create_dataset(
            "NumberOfConnectivityIds", data=[conn_flat.size], dtype=np.int64
        )
        g.create_dataset("Points", data=pts)
        g.create_dataset("Connectivity", data=conn_flat)
        g.create_dataset("Offsets", data=off_flat)
        g.create_dataset("Types", data=np.concatenate(types))
        self._n_conn = int(conn_flat.size)

    def add_step(
        self,
        time: float,
        point_data: dict | None = None,
        cell_data: dict | None = None,
    ) -> None:
        """Append one output time; fields grow along axis 0 (v2 temporal)."""
        g = self._root
        steps = g.require_group("Steps")
        n = self._n_steps

        def _append(ds_name, group, value):
            grp = g.require_group(group)
            if ds_name not in grp:
                grp.create_dataset(
                    ds_name, data=value, maxshape=(None,) + value.shape[1:]
                )
            else:
                ds = grp[ds_name]
                ds.resize(ds.shape[0] + value.shape[0], axis=0)
                ds[-value.shape[0]:] = value

        def _offset(name, value, shape1=None):
            if name not in steps:
                ms = (None,) if shape1 is None else (None, shape1)
                data = np.asarray([value], np.int64)
                if shape1 is not None:
                    data = data.reshape(1, shape1)
                steps.create_dataset(name, data=data, maxshape=ms,
                                     dtype=np.int64)
            else:
                ds = steps[name]
                ds.resize(ds.shape[0] + 1, axis=0)
                ds[-1] = value

        # static geometry: every step points at offset 0 / part 0
        if "Values" not in steps:
            steps.create_dataset("Values", data=[float(time)], maxshape=(None,))
        else:
            ds = steps["Values"]
            ds.resize(ds.shape[0] + 1, axis=0)
            ds[-1] = float(time)
        _offset("PartOffsets", 0)
        _offset("NumberOfParts", 1)
        _offset("PointOffsets", 0)
        _offset("CellOffsets", 0, shape1=1)
        _offset("ConnectivityIdOffsets", 0, shape1=1)

        for name, arr in (point_data or {}).items():
            a = _as_point_array(arr)
            a = a[:, 0] if a.shape[1] == 1 else a
            _append(name, "PointData", np.asarray(a))
            og = steps.require_group("PointDataOffsets")
            off = n * self.mesh.n_nodes
            if name not in og:
                og.create_dataset(name, data=[off], maxshape=(None,),
                                  dtype=np.int64)
            else:
                ds = og[name]
                ds.resize(ds.shape[0] + 1, axis=0)
                ds[-1] = off
        for name, arr in (cell_data or {}).items():
            flat = (
                np.concatenate([np.asarray(arr[ct]) for ct in self.mesh.cells])
                if isinstance(arr, dict) else np.asarray(arr)
            )
            _append(name, "CellData", np.asarray(flat, np.float64))
            og = steps.require_group("CellDataOffsets")
            off = n * self.mesh.n_cells
            if name not in og:
                og.create_dataset(name, data=[off], maxshape=(None,),
                                  dtype=np.int64)
            else:
                ds = og[name]
                ds.resize(ds.shape[0] + 1, axis=0)
                ds[-1] = off

        self._n_steps += 1
        steps.attrs.create("NSteps", np.int64(self._n_steps))

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_vtkhdf(
    path: str,
    mesh: Mesh,
    point_data: dict | None = None,
    cell_data: dict | None = None,
) -> None:
    """One-shot snapshot (no Steps group): geometry + final fields.

    point_data: name -> (n_nodes,) or (n_nodes, k<=3); cell_data: name ->
    flat (n_cells,) in bucket order or {cell_type: (nc,)}.
    """
    _require_h5py()
    w = VtkHdfWriter(path, mesh)
    try:
        g = w._root
        for name, arr in (point_data or {}).items():
            a = _as_point_array(arr)
            g.require_group("PointData").create_dataset(
                name, data=a[:, 0] if a.shape[1] == 1 else a
            )
        for name, arr in (cell_data or {}).items():
            flat = (
                np.concatenate([np.asarray(arr[ct]) for ct in mesh.cells])
                if isinstance(arr, dict) else np.asarray(arr)
            )
            g.require_group("CellData").create_dataset(
                name, data=np.asarray(flat, np.float64)
            )
    finally:
        w.close()
