"""The slot-major SpMV's planner (sparse/diag_spmv.py::plan_diag) and
DiagEllMatrix against the JAX package's, and the port's copies of the mesh
generators, on the CPU."""

import numpy as np
import pytest
import torch

from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.sparse.pallas_spmv_diag import plan_diag as jax_plan_diag
from arcanefem_tpu.sparse.topology import build_topology
from arcanefem_tpu.utils.ordering import rcm_order, renumber_mesh
from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.sparse.diag_spmv import (
    DiagEllMatrix,
    diag_spmv,
    plan_diag,
    tile_values,
)
from arcanefem_tpu_torch.sparse.ell_gather import ell_spmv_plain


def _rcm_topo(mesh):
    """tests/test_pallas_spmv_diag.py:21-24: RCM order, W padded to 8."""
    t = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    mesh2 = renumber_mesh(mesh, rcm_order(mesh.n_nodes, t.row_ptr, t.csr_cols))
    return build_topology(mesh2.n_nodes, mesh2.cells, pad_width_to=8)


CASES = {
    "rect_90x90_rcm": lambda: _rcm_topo(jax_rect(90, 90)).ell_cols,
    "box_22x20x18_rcm": lambda: _rcm_topo(jax_box(22, 20, 18)).ell_cols,
    "sphere_h8_sn": lambda: sphere_cut_system(8.0, 0, cache=False)[1].ell_cols,
}


@pytest.mark.parametrize("mesh", [(jax_rect, rect_tria_mesh, (7, 5)),
                                  (jax_box, box_tetra_mesh, (3, 4, 5))],
                         ids=["rect_tria_mesh", "box_tetra_mesh"])
def test_generate_copies_match_jax(mesh):
    fj, fp, args = mesh
    a, b = fj(*args), fp(*args)
    np.testing.assert_array_equal(b.coords, a.coords)
    np.testing.assert_array_equal(b.node_uids, a.node_uids)
    assert b.dim == a.dim and b.cells.keys() == a.cells.keys()
    for k in a.cells:
        np.testing.assert_array_equal(b.cells[k], a.cells[k])
    assert b.face_groups.keys() == a.face_groups.keys()
    for g in a.face_groups:
        for k in a.face_groups[g]:
            np.testing.assert_array_equal(b.face_groups[g][k], a.face_groups[g][k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_diag_matches_jax(name):
    cols = CASES[name]()
    n = cols.shape[0]
    pj = jax_plan_diag(cols, n - 1, block_rows=4096)
    pp = plan_diag(cols, n - 1, block_rows=4096)
    assert pj is not None and pp is not None
    for f in ("n_nodes", "width", "block_rows", "window", "n_blocks", "n_probes"):
        assert getattr(pp, f) == getattr(pj, f), f
    for f in ("lo", "c0", "scnt", "lcols"):
        a, b = getattr(pj, f), getattr(pp, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a)


def test_plan_diag_rejects_incoherent():
    """tests/test_pallas_spmv_diag.py:56-61: random columns; and the
    matrix raises instead of falling back."""
    rng = np.random.RandomState(0)
    n, W = 8192, 8
    cols = rng.randint(0, n, size=(n, W)).astype(np.int32)
    assert jax_plan_diag(cols, n - 1, block_rows=4096, max_probes=8) is None
    assert plan_diag(cols, n - 1, block_rows=4096, max_probes=8) is None
    vals = torch.ones((n, 64), dtype=torch.float64)
    wide = rng.randint(0, n, size=(n, 64)).astype(np.int32)
    with pytest.raises(ValueError, match="plan_diag declines"):
        DiagEllMatrix(vals, wide)


@pytest.mark.parametrize("name", sorted(CASES))
def test_diag_matrix_matches_ell(name):
    """DiagEllMatrix.spmv (the plain twin of K10) == the f64 ELL product to
    1e-12 of each row's Σ|a·x|; its tiles hold the values slot-major."""
    cols = CASES[name]()
    n, W = cols.shape
    rng = np.random.RandomState(1)
    vals = torch.as_tensor(rng.rand(n, W) * 2 - 1)
    x = torch.as_tensor(rng.rand(n) * 2 - 1)
    A = DiagEllMatrix(vals, cols)
    ct = torch.as_tensor(cols.astype(np.int32))
    want = ell_spmv_plain(vals, ct, x)
    scale = ell_spmv_plain(vals.abs(), ct, x.abs())
    assert float(((A.spmv(x) - want).abs() / scale).max()) <= 1e-12
    vt = tile_values(vals, 4096)
    qn = 4
    back = vt.reshape(-1, W, qn, 8, 128).permute(0, 2, 3, 4, 1).reshape(-1, W)
    assert torch.equal(back[:n], vals) and not back[n:].any()
    f32 = DiagEllMatrix(vals.float(), cols).spmv(x.float())
    assert f32.dtype == torch.float32
    assert float(((f32.double() - want).abs() / scale).max()) <= 1e-5


def test_diag_wrapper_checks_operands():
    cols = CASES["rect_90x90_rcm"]()
    A = DiagEllMatrix(torch.ones(cols.shape, dtype=torch.float64), cols)
    x = torch.ones(cols.shape[0], dtype=torch.float64)
    args = (A.lo, A.c0, A.scnt, A.lcols, A.vals_tiled)
    with pytest.raises(TypeError):  # vals and x of different types
        diag_spmv(*args, x.float(), A.plan.width)
    with pytest.raises(ValueError):  # W does not divide G
        diag_spmv(*args, x, A.plan.width + 3)
    with pytest.raises(ValueError):
        diag_spmv(*args[:-1], A.vals_tiled[:, :-1], x, A.plan.width)
    with pytest.raises(ValueError):  # no kernel off CPU and CUDA
        diag_spmv(*(a.to("meta") for a in args), x.to("meta"), A.plan.width)


def test_diag_matrix_checks_plan_once_and_x_per_call():
    """DiagEllMatrix raises at construction on values that do not fit its
    columns, and per call on an x its plan does not take."""
    cols = CASES["rect_90x90_rcm"]()
    n, W = cols.shape
    vals = torch.ones((n, W), dtype=torch.float64)
    with pytest.raises(ValueError):  # values one slot narrower than cols
        DiagEllMatrix(vals[:, 1:], cols)
    with pytest.raises(ValueError):  # one row fewer
        DiagEllMatrix(vals[1:], cols)
    with pytest.raises(TypeError):  # no kernel for integer values
        DiagEllMatrix(vals.int(), cols)
    A = DiagEllMatrix(vals, cols)
    x = torch.ones(n, dtype=torch.float64)
    assert A.spmv(x).shape == (n,)
    with pytest.raises(TypeError):  # x of another type than the values
        A.spmv(x.float())
    with pytest.raises(ValueError):
        A.spmv(x[None])
    with pytest.raises(ValueError):  # longer than the plan's rows
        A.spmv(torch.ones(A.lo.shape[0] * 4096 + 1, dtype=torch.float64))
    with pytest.raises(ValueError):  # off the plan's device
        A.spmv(x.to("meta"))
