"""The port's COO matrix (arcanefem_tpu_torch/sparse/coo.py) against the JAX
package's, on the CPU in float64: the five cases of tests/test_coo.py
(no sparsity needed, spmv summing duplicates, sorted() merging, to_bell,
the testlab coo strategies), each held to JAX's values at 1e-12 of the
largest, and sorted() giving JAX's rows and cols exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.ops import elements as jax_elements
from arcanefem_tpu.sparse.bell import assemble_bell as jax_assemble_bell
from arcanefem_tpu.sparse.coo import coo_from_elements as jax_coo_from_elements
from arcanefem_tpu.sparse.topology import build_topology as jax_build_topology
from arcanefem_tpu_torch import testlab
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.ops import elements
from arcanefem_tpu_torch.sparse.bell import assemble_bell
from arcanefem_tpu_torch.sparse.coo import CooMatrix, coo_from_elements
from arcanefem_tpu_torch.sparse.topology import build_topology


def _both(n=8):
    """The port's and JAX's mesh, stiffness matrices and COO matrix."""
    mesh, jmesh = rect_tria_mesh(n, n), jax_rect(n, n)
    conn = mesh.cells["tria3"]
    ke = elements.stiffness_tria3(torch.as_tensor(mesh.coords)[torch.as_tensor(conn).long()])
    jcoords = jnp.asarray(jmesh.coords)
    jke = jax_elements.stiffness_tria3(jcoords[jnp.asarray(jmesh.cells["tria3"])])
    coo = coo_from_elements(mesh.n_nodes, mesh.cells, {"tria3": ke})
    jcoo = jax_coo_from_elements(jmesh.n_nodes, jmesh.cells, {"tria3": jke})
    return mesh, {"tria3": ke}, coo, jmesh, {"tria3": jke}, jcoo


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_coo_from_elements_no_sparsity_needed():
    mesh, mats, coo, jmesh, jmats, jcoo = _both()
    assert coo.nnz_stored == jcoo.nnz_stored == mesh.cells["tria3"].shape[0] * 9
    assert coo.rows.dtype == coo.cols.dtype == torch.int32
    assert np.array_equal(coo.rows.numpy(), jcoo.rows)
    assert np.array_equal(coo.cols.numpy(), jcoo.cols)
    _close(coo.todense().numpy(), jcoo.todense())
    topo = build_topology(mesh.n_nodes, mesh.cells)
    ref = assemble_bell(topo, mats, device="cpu", dtype=torch.float64).todense()
    _close(coo.todense().numpy(), ref.numpy())


def test_coo_spmv_sums_duplicates():
    mesh, mats, coo, jmesh, jmats, jcoo = _both()
    x = np.random.RandomState(0).rand(mesh.n_nodes)
    got = coo.spmv(torch.as_tensor(x)).numpy()
    _close(got, np.asarray(jcoo.spmv(jnp.asarray(x))))
    _close(got, jcoo.todense() @ x)


def test_coo_sorted_merges():
    mesh, mats, coo, jmesh, jmats, jcoo = _both()
    s, js = coo.sorted(), jcoo.sorted()
    assert s.nnz_stored == js.nnz_stored < coo.nnz_stored
    assert s.rows.dtype == s.cols.dtype == torch.int32
    assert np.array_equal(s.rows.numpy(), js.rows)
    assert np.array_equal(s.cols.numpy(), js.cols)
    _close(s.vals.numpy(), np.asarray(js.vals))
    keys = s.rows.numpy().astype(np.int64) * s.n + s.cols.numpy()
    assert np.all(np.diff(keys) > 0), "sorted COO keys must be unique+sorted"
    _close(s.todense().numpy(), coo.todense().numpy())
    # a second pattern's values reuse the plan: the same merge, no new sort
    again = coo.with_values(2 * coo.vals).sorted()
    assert again.rows is s.rows and torch.equal(again.vals, 2 * s.vals)


def test_coo_to_bell_translate():
    mesh, mats, coo, jmesh, jmats, jcoo = _both()
    topo = build_topology(mesh.n_nodes, mesh.cells)
    jtopo = jax_build_topology(jmesh.n_nodes, jmesh.cells)
    A = coo.to_bell(topo)
    ref = assemble_bell(topo, mats, device="cpu", dtype=torch.float64)
    assert torch.equal(A.values, ref.values)  # the same lists, in entry order
    want = np.asarray(jcoo.to_bell(jtopo).values).reshape(topo.n_nodes, topo.width)
    _close(A.ell_values().numpy(), want)
    _close(np.asarray(jax_assemble_bell(jtopo, jmats, block=1, dtype=np.float64)
                      .values).reshape(want.shape), want)
    _close(coo.sorted().to_bell(topo).ell_values().numpy(), want)
    with pytest.raises(AssertionError, match="outside the topology sparsity"):
        CooMatrix(torch.tensor([0], dtype=torch.int32),
                  torch.tensor([mesh.n_nodes - 1], dtype=torch.int32),
                  torch.ones(1, dtype=torch.float64), mesh.n_nodes).to_bell(topo)


def test_testlab_coo_strategies_cross_validate():
    from arcanefem_tpu.testlab import cross_validate as jax_cross_validate

    mesh = rect_tria_mesh(6, 6)
    report = testlab.cross_validate(mesh, device="cpu")
    assert "coo" in report and "coo-sorted" in report
    assert set(report) == set(jax_cross_validate(jax_rect(6, 6)))
    assert max(report.values()) < 1e-12
