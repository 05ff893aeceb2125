"""The DIA operators of the structured box against the JAX package, float64
on the CPU (where the stencil kernel's wrapper runs its plain twin):
``DiaMatrix``, and ``spmv``, ``jacobi_sweep`` and ``residual`` on both
padded layouts, against the JAX ``DiaMatrix.spmv`` and the formulas of
tests/test_padded_mg.py, to 1e-13 relative, with pads exactly 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.mesh.structured import apply_penalty_dirichlet as jax_penalty
from arcanefem_tpu.sparse.dia_pallas import offsets3d as jax_offsets3d
from arcanefem_tpu.sparse.dia_pallas import pad_host_vec as jax_pad_host_vec
from arcanefem_tpu.sparse.dia_pallas import to_plane_matrix as jax_to_plane
from arcanefem_tpu_torch.mesh.structured import StructuredBox
from arcanefem_tpu_torch.sparse import dia_stencil as ds
from arcanefem_tpu_torch.sparse.dia import DiaMatrix

TOL = 1e-13


@pytest.fixture(scope="module")
def system():
    """The penalised 16x12x20 stiffness (JAX, f64) and random vectors."""
    box, jbox = StructuredBox(16, 12, 20), JaxBox(16, 12, 20)
    c = jnp.asarray(jbox.grid_coords(np.float64, jitter=0.1))
    mask = jbox.boundary_mask(("xmin", "xmax"))
    Aj = jbox.assemble_stiffness(c, backend="xla")
    Aj, rhs = jax_penalty(Aj, jbox.source_rhs(c, 1.0), jnp.asarray(mask),
                          jnp.zeros(jbox.n_nodes), 1e12)
    rng = np.random.RandomState(1)
    x, b = rng.rand(2, box.n_nodes)
    A = DiaMatrix(torch.tensor(np.asarray(Aj.bands)), Aj.offsets)
    return box, Aj, A, mask, x, b


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _pads_zero(box, yp) -> bool:
    real = torch.zeros(yp.shape, dtype=torch.bool)
    real[:, 1 : box.ny + 2, 1 : box.nz + 2] = True
    return bool((yp[~real] == 0).all())


def test_layout_constants_match_jax(system):
    box = system[0]
    assert ds.offsets3d(box) == jax_offsets3d(JaxBox(16, 12, 20)) == ds.KUHN_OFFS3
    assert ds.KUHN_OFFS3[ds.D0] == (0, 0, 0)
    v = np.arange(box.n_nodes, dtype=np.float32)
    np.testing.assert_array_equal(ds.pad_host_vec(box, v),
                                  jax_pad_host_vec(JaxBox(16, 12, 20), v))


def test_dia_matrix_matches_jax(system):
    box, Aj, A, _, x, _ = system
    y = A.spmv(torch.as_tensor(x)).numpy()
    assert _rel(y, np.asarray(Aj.spmv(jnp.asarray(x)))) <= TOL
    np.testing.assert_array_equal(A.diagonal().numpy(), np.asarray(Aj.diagonal()))
    np.testing.assert_array_equal(A.todense(), Aj.todense())


def test_plane_matrix_ops_match_formulas(system):
    """DiaPlaneMatrixP (x-major planes, K5-K7's layout)."""
    box, Aj, A, mask, x, b = system
    P = ds.to_plane_matrix(A, box)
    xp, bp = P.pad_vec(torch.as_tensor(x)), P.pad_vec(torch.as_tensor(b))
    y_ref = np.asarray(Aj.spmv(jnp.asarray(x)))
    d = np.asarray(Aj.diagonal())
    invd = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0)

    yp = P.spmv(xp)
    assert _rel(P.unpad_vec(yp), y_ref) <= TOL and _pads_zero(box, yp)
    invd_p = P.inv_diagonal_p()
    np.testing.assert_array_equal(P.unpad_vec(invd_p).numpy(), invd)
    sw = P.jacobi_sweep(xp, bp, invd_p, 0.8)
    assert _rel(P.unpad_vec(sw), x + 0.8 * invd * (b - y_ref)) <= TOL
    assert _pads_zero(box, sw)
    mm = P.pad_vec(torch.as_tensor(1.0 - mask))
    r = P.residual(bp, xp, mm)
    assert _rel(P.unpad_vec(r), (b - y_ref) * (1.0 - mask)) <= TOL
    assert _pads_zero(box, r)
    assert _rel(P.unpad_vec(P.residual(bp, xp)), b - y_ref) <= TOL


def test_stencil_matrix_ops_match_formulas(system):
    """DiaStencilMatrix (band-major planes, K8's layout), flat vectors."""
    box, Aj, A, _, x, b = system
    S = ds.to_stencil_matrix(A, box)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    y_ref = np.asarray(Aj.spmv(jnp.asarray(x)))
    d = np.asarray(Aj.diagonal())
    assert _rel(S.spmv(xt), y_ref) <= TOL
    np.testing.assert_array_equal(S.diagonal().numpy(), d)
    assert _rel(S.jacobi_sweep(xt, bt, 0.8), x + 0.8 / d * (b - y_ref)) <= TOL
    assert _rel(S.residual(bt, xt), b - y_ref) <= TOL


def test_plane_matrix_from_jax_numpy(system):
    """A JAX DiaPlaneMatrixP's bands carry over unchanged, bf16 included."""
    box, Aj, A, _, x, _ = system
    jbox = JaxBox(16, 12, 20)
    Pj = jax_to_plane(Aj, jbox)  # float32 bands
    P = ds.DiaPlaneMatrixP.from_jax_numpy(np.asarray(Pj.bands_p), box, "cpu")
    np.testing.assert_array_equal(P.bands_p.numpy(),
                                  ds.to_plane_matrix(A, box).bands_p.float().numpy())
    Pb = ds.DiaPlaneMatrixP.from_jax_numpy(np.asarray(Pj.astype_bands(jnp.bfloat16).bands_p),
                                           box, "cpu")
    assert Pb.bands_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(Pb.bands_p.float().numpy(),
                                  np.asarray(Pj.bands_p.astype(jnp.bfloat16), np.float32))
    with pytest.raises(ValueError):
        ds.DiaPlaneMatrixP.from_jax_numpy(np.asarray(Pj.bands_p)[:-1], box, "cpu")


def test_wrapper_checks_and_counts():
    box = StructuredBox(4, 3, 5)
    nyp, nzp = ds._pads(box)
    bands = torch.zeros((box.nx + 1, 15, nyp, nzp))
    x = torch.zeros((box.nx + 1, nyp, nzp))
    ds.reset_launch_counts()
    assert torch.equal(ds.dia_stencil("spmv", bands, x, band_major=False, ny=3, nz=5), x)
    assert sum(ds.launch_counts().values()) == 0
    with pytest.raises(ValueError):
        ds.dia_stencil("spmv", bands, x, band_major=True, ny=3, nz=5)
    with pytest.raises(ValueError):
        ds.dia_stencil("jacobi", bands, x, band_major=False, ny=3, nz=5, b=x)
    with pytest.raises(ValueError):
        ds.dia_stencil("sweep", bands, x, band_major=False, ny=3, nz=5)
    with pytest.raises(ValueError):
        ds.dia_stencil("spmv", bands, x, band_major=False, ny=nyp, nz=5)
    with pytest.raises(ValueError):
        ds.dia_stencil("residual", bands, x, band_major=False, ny=3, nz=5,
                       b=x.double())
    with pytest.raises(ValueError):
        ds.dia_stencil("spmv", bands.to("meta"), x.to("meta"), band_major=False,
                       ny=3, nz=5)
