"""The port's own copies of the JAX package's host modules equal the
originals: mesh generation and refinement, topology (native and numpy
builders), node orders and the cache directory."""

import numpy as np
import pytest

from arcanefem_tpu.mesh.unstructured import refine_tetra as jax_refine
from arcanefem_tpu.mesh.unstructured import sphere_cut_tetra_mesh as jax_sphere_cut
from arcanefem_tpu.sparse.topology import build_topology as jax_build_topology
from arcanefem_tpu.utils.cache import CACHE_DIR as JAX_CACHE_DIR
from arcanefem_tpu.utils.ordering import rcm_order as jax_rcm
from arcanefem_tpu.utils.ordering import renumber_mesh as jax_renumber
from arcanefem_tpu_torch.mesh.unstructured import refine_tetra, sphere_cut_tetra_mesh
from arcanefem_tpu_torch.sparse.topology import build_topology
from arcanefem_tpu_torch.utils import native
from arcanefem_tpu_torch.utils.cache import CACHE_DIR
from arcanefem_tpu_torch.utils.ordering import rcm_order, renumber_mesh


def _assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.node_uids, b.node_uids)
    assert a.dim == b.dim and sorted(a.cells) == sorted(b.cells)
    for t in a.cells:
        np.testing.assert_array_equal(a.cells[t], b.cells[t])
    assert sorted(a.face_groups) == sorted(b.face_groups)
    for g in a.face_groups:
        assert sorted(a.face_groups[g]) == sorted(b.face_groups[g])
        for t in a.face_groups[g]:
            np.testing.assert_array_equal(a.face_groups[g][t], b.face_groups[g][t])


@pytest.fixture(scope="module")
def meshes():
    """(port, jax) sphere_cut h=14 meshes after one red refinement."""
    return refine_tetra(sphere_cut_tetra_mesh(h=14.0)), jax_refine(jax_sphere_cut(h=14.0))


def test_sphere_cut_and_refine_equal(meshes):
    _assert_mesh_equal(*meshes)
    assert meshes[0].n_cells > 0 and set(meshes[0].face_groups) == {"Cut", "sphere"}


@pytest.mark.parametrize("use_native", [True, False])
def test_build_topology_equal(meshes, use_native):
    mesh, jmesh = meshes
    t = build_topology(mesh.n_nodes, mesh.cells, use_native=use_native)
    j = jax_build_topology(jmesh.n_nodes, jmesh.cells, use_native=use_native)
    assert (t.n_nodes, t.width, t.nnz) == (j.n_nodes, j.width, j.nnz)
    for name in ("ell_cols", "ell_valid", "row_ptr", "csr_cols", "csr_to_ell",
                 "diag_slot"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), name)
    np.testing.assert_array_equal(t.slot_maps["tetra4"], j.slot_maps["tetra4"])


def test_native_library_builds_and_matches_numpy(meshes):
    """The port's g++ build of its native/ copies loads, and its topology
    equals the numpy builder's."""
    assert native.library() is not None
    assert "build/afem_native/" in native.library_path()
    mesh = meshes[0]
    a = build_topology(mesh.n_nodes, mesh.cells, use_native=True)
    b = build_topology(mesh.n_nodes, mesh.cells, use_native=False)
    np.testing.assert_array_equal(a.ell_cols, b.ell_cols)
    np.testing.assert_array_equal(a.slot_maps["tetra4"], b.slot_maps["tetra4"])


def test_rcm_and_renumber_equal(meshes):
    mesh, jmesh = meshes
    topo = build_topology(mesh.n_nodes, mesh.cells)
    perm = rcm_order(mesh.n_nodes, topo.row_ptr, topo.csr_cols)
    np.testing.assert_array_equal(perm, jax_rcm(mesh.n_nodes, topo.row_ptr,
                                                topo.csr_cols))
    _assert_mesh_equal(renumber_mesh(mesh, perm), jax_renumber(jmesh, perm))


def test_cache_dir_equal():
    assert CACHE_DIR == JAX_CACHE_DIR
