"""fem/vtk.py, fem/vtkhdf.py and run_case(output_dir=) against the JAX
package: ``write_vtk`` byte-identical on the same mesh and fields;
``write_vtkhdf`` and the temporal ``VtkHdfWriter`` dataset-equal through
h5py (skipped where h5py is missing); ``run_case(output_dir=)`` on both
sides of the h5py rule (VTKHDF with h5py, legacy VTK without; the rule is
switched off in the port's module only) against the JAX run's file."""

import numpy as np
import pytest

from arcanefem_tpu.fem import vtk as jvtk
from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.mesh.core import Mesh as JaxMesh
from arcanefem_tpu_torch.fem import vtk, vtkhdf
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, quadratize, rect_tria_mesh
from arcanefem_tpu_torch.tools.write_msh import rect_quad_mesh, write_arc, write_msh


def _jax_mesh(m):
    return JaxMesh(coords=m.coords, node_uids=m.node_uids, cells=m.cells, dim=m.dim,
                   face_groups=m.face_groups, node_groups=m.node_groups,
                   cell_groups=m.cell_groups)


def _fields(mesh, seed=0):
    rng = np.random.RandomState(seed)
    n, nc = mesh.n_nodes, mesh.n_cells
    point = {"u": rng.standard_normal(n), "grad": rng.standard_normal((n, mesh.dim))}
    cell = {"psi": {ct: rng.standard_normal(len(c)) for ct, c in mesh.cells.items()},
            "E": rng.standard_normal((nc, mesh.dim))}
    return point, cell


MESHES = {"tria3": lambda: rect_tria_mesh(5, 4), "quad4": lambda: rect_quad_mesh(4, 3),
          "tetra4": lambda: box_tetra_mesh(2, 2, 3)}


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_write_vtk_byte_identical(tmp_path, kind):
    mesh = MESHES[kind]()
    point, cell = _fields(mesh)
    vtk.write_vtk(str(tmp_path / "port.vtk"), mesh, point_data=point, cell_data=cell,
                  title="t")
    jvtk.write_vtk(str(tmp_path / "jax.vtk"), _jax_mesh(mesh), point_data=point,
                   cell_data=cell, title="t")
    assert (tmp_path / "port.vtk").read_bytes() == (tmp_path / "jax.vtk").read_bytes()


def _h5_equal(a_path, b_path, rtol=0.0):
    """Every group, dataset and attribute of two HDF5 files equal (data to
    rtol of each dataset's largest magnitude)."""
    import h5py

    with h5py.File(a_path, "r") as a, h5py.File(b_path, "r") as b:
        names_a, names_b = [], []
        a.visit(names_a.append)
        b.visit(names_b.append)
        assert names_a == names_b
        for name in ["/", *names_a]:
            assert sorted(a[name].attrs) == sorted(b[name].attrs), name
            for k in a[name].attrs:
                np.testing.assert_array_equal(a[name].attrs[k], b[name].attrs[k])
            if isinstance(a[name], h5py.Dataset):
                x, y = a[name][()], b[name][()]
                assert x.dtype == y.dtype and x.shape == y.shape, name
                if rtol and x.dtype.kind == "f":
                    np.testing.assert_allclose(x, y, rtol=0,
                                               atol=rtol * max(np.abs(y).max(), 1e-300))
                else:
                    np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("kind", sorted(MESHES) + ["tetra10"])
def test_write_vtkhdf_dataset_equal(tmp_path, kind):
    pytest.importorskip("h5py")
    from arcanefem_tpu.fem import vtkhdf as jvtkhdf

    mesh = quadratize(box_tetra_mesh(2, 2, 2)) if kind == "tetra10" else MESHES[kind]()
    point, cell = _fields(mesh, seed=1)
    vtkhdf.write_vtkhdf(str(tmp_path / "port.hdf"), mesh, point_data=point, cell_data=cell)
    jvtkhdf.write_vtkhdf(str(tmp_path / "jax.hdf"), _jax_mesh(mesh), point_data=point,
                         cell_data=cell)
    _h5_equal(tmp_path / "port.hdf", tmp_path / "jax.hdf")


def test_vtkhdf_writer_temporal_dataset_equal(tmp_path):
    pytest.importorskip("h5py")
    from arcanefem_tpu.fem import vtkhdf as jvtkhdf

    mesh = rect_tria_mesh(4, 3)
    for writer, m, name in ((vtkhdf.VtkHdfWriter, mesh, "port.hdf"),
                            (jvtkhdf.VtkHdfWriter, _jax_mesh(mesh), "jax.hdf")):
        with writer(str(tmp_path / name), m) as w:
            for step in range(3):
                point, cell = _fields(mesh, seed=10 + step)
                w.add_step(0.5 * step, point_data=point, cell_data=cell)
    _h5_equal(tmp_path / "port.hdf", tmp_path / "jax.hdf")
    assert not vtkhdf.HAVE_H5PY or vtkhdf.h5py is not None


def _electrostatics_case(d):
    write_msh(str(d / "rect.msh"), rect_tria_mesh(12, 9))
    path = str(d / "es.arc")
    write_arc(path, "rect.msh", codename="Electrostatics",
              values={"rho": 1.0, "epsilon": 2.0},
              dirichlet=[("left", 0.0), ("right", 1.0)],
              linear_system={"name": "HypreLinearSystem", "rtol": "1e-12"},
              post_processing=["Phi", "E", "UExact"])
    return path


def test_run_case_output_dir_vtkhdf(tmp_path):
    """With h5py: the port's .hdf equals the JAX run's, the fields to 1e-10
    (the two solves agree to round-off), everything else exactly;
    UExact, which no model holds, is skipped on both sides."""
    pytest.importorskip("h5py")
    path = _electrostatics_case(tmp_path)
    res = run_case(path, device="cpu", output_dir=str(tmp_path / "port"))
    jax_run_case(path, output_dir=str(tmp_path / "jax"))
    _h5_equal(tmp_path / "port" / "es.hdf", tmp_path / "jax" / "es.hdf", rtol=1e-10)
    import h5py

    with h5py.File(tmp_path / "port" / "es.hdf", "r") as f:
        np.testing.assert_array_equal(f["VTKHDF/PointData/Phi"][()], res.phi)
        assert sorted(f["VTKHDF/CellData"]) == ["E"]
    assert run_case(path, device="cpu").phi is not None  # no output_dir: no file
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["es.hdf"]


def _vtk_sections(path):
    """The file's lines, with the numeric rows of each data section parsed."""
    text, data = [], []
    for ln in open(path).read().splitlines():
        try:
            data.append([float(v) for v in ln.split()])
        except ValueError:
            text.append(ln)
    return text, data


def test_run_case_output_dir_legacy_vtk_without_h5py(tmp_path, monkeypatch):
    """HAVE_H5PY false in the port's vtkhdf module: a legacy .vtk instead,
    the JAX write_vtk of the JAX run's fields in all but round-off of the
    field values (1e-9), and no .hdf."""
    path = _electrostatics_case(tmp_path)
    monkeypatch.setattr(vtkhdf, "HAVE_H5PY", False)
    run_case(path, device="cpu", output_dir=str(tmp_path / "port"))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["es.vtk"]
    jres = jax_run_case(path)
    jvtk.write_vtk(str(tmp_path / "jax.vtk"), jres.problem.mesh,
                   point_data={"Phi": np.asarray(jres.phi)}, cell_data={"E": jres.E})
    (t1, d1), (t2, d2) = _vtk_sections(tmp_path / "port" / "es.vtk"), _vtk_sections(
        tmp_path / "jax.vtk")
    assert t1 == t2 and len(d1) == len(d2)
    for a, b in zip(d1, d2):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
