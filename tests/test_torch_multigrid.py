"""The geometric multigrid of the structured box against the JAX package on
the CPU: transfers (exact), one V-cycle of the padded hierarchy against the
JAX ``build_mg(...).apply`` in float64 (1e-10 relative), and the padded
bf16 hierarchy against the JAX ``build_mg_padded`` (the ``fused=False``
branch, which reaches no Pallas kernel), then carried across with
``mg_from_numpy``.

The JAX V-cycle runs eagerly: XLA:CPU compiles it under ``jit``
pathologically slowly (tests/test_multigrid.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.solver.multigrid import build_mg as jax_build_mg
from arcanefem_tpu.solver.multigrid import build_mg_padded as jax_build_mg_padded
from arcanefem_tpu.solver.multigrid import prolong3 as jax_prolong3
from arcanefem_tpu.solver.multigrid import restrict3 as jax_restrict3
from arcanefem_tpu_torch.mesh.structured import StructuredBox
from arcanefem_tpu_torch.solver.multigrid import (
    build_mg,
    build_mg_padded,
    mg_from_numpy,
    prolong3,
    restrict3,
)

PENALTY = 1e12
DIMS = (16, 16, 16)  # two levels with min_size 8


@pytest.fixture(scope="module")
def box_data():
    box, jbox = StructuredBox(*DIMS), JaxBox(*DIMS)
    c = box.grid_coords(np.float64, jitter=0.1)
    mask = box.boundary_mask(("xmin", "xmax"))
    r = np.random.RandomState(4).rand(box.n_nodes)
    return box, jbox, c, mask, r


def test_transfers_equal_jax():
    rng = np.random.RandomState(0)
    cshape, fshape = (5, 9, 7), (9, 17, 13)
    xc = rng.rand(int(np.prod(cshape)))
    xf = rng.rand(int(np.prod(fshape)))
    np.testing.assert_array_equal(prolong3(torch.as_tensor(xc), cshape, fshape).numpy(),
                                  np.asarray(jax_prolong3(jnp.asarray(xc), cshape, fshape)))
    np.testing.assert_array_equal(restrict3(torch.as_tensor(xf), fshape, cshape).numpy(),
                                  np.asarray(jax_restrict3(jnp.asarray(xf), fshape, cshape)))


@pytest.mark.parametrize("nu", [1, 2])
def test_padded_vcycle_matches_jax_build_mg(box_data, nu):
    """float64, band_dtype None: one apply of the port's padded hierarchy
    == the JAX flat ``build_mg(...).apply`` to 1e-10 relative; the port's
    flat ``build_mg`` agrees too, on plain and stencil levels."""
    box, jbox, c, mask, r = box_data
    Mj = jax_build_mg(jbox, jnp.asarray(c), mask, PENALTY, nu=nu)
    zj = np.asarray(Mj.apply(jnp.asarray(r)))
    M = build_mg_padded(box, torch.as_tensor(c), mask, PENALTY, nu=nu)
    assert [m.shape for m in M.mats] == [(17, 17, 17), (9, 9, 9)]
    rt = torch.as_tensor(r)
    z = M.mats[0].unpad_vec(M.apply(M.mats[0].pad_vec(rt))).numpy()
    scale = np.abs(zj).max()
    assert np.abs(z - zj).max() <= 1e-10 * scale
    for stencil in (False, True):
        Mf = build_mg(box, torch.as_tensor(c), mask, PENALTY, nu=nu,
                      use_stencil_spmv=stencil)
        assert np.abs(Mf.apply(rt).numpy() - zj).max() <= 1e-10 * scale


@pytest.fixture(scope="module")
def bf16_hierarchies(box_data):
    """Chebyshev padded hierarchies in float32: (port bf16, JAX bf16, port
    before the cast, JAX before the cast)."""
    box, jbox, c, mask, _ = box_data
    c32 = c.astype(np.float32)
    out = []
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (None, None)):
        out.append(build_mg_padded(box, torch.as_tensor(c32), mask, PENALTY, nu=2,
                                   cheb=True, band_dtype=dtype))
        out.append(jax_build_mg_padded(jbox, jnp.asarray(c32), mask, PENALTY, nu=2,
                                       fused=False, cheb=True, band_dtype=jdtype))
    return out


def test_bf16_hierarchy_matches_jax(bf16_hierarchies):
    """Bands within f32 round-off (1e-6 of the largest non-penalty entry)
    of the JAX ones before the bf16 cast and within 1 bf16 ulp after it;
    inverse diagonals, masks, mask multipliers, shapes and Chebyshev
    weights alike."""
    M, Mj, M32, Mj32 = bf16_hierarchies
    assert M.shapes == tuple(Mj.shapes) and M.omegas == pytest.approx(Mj.omegas, rel=1e-15)
    assert (M.nu, M.omega, M.coarse_iters) == (Mj.nu, Mj.omega, Mj.coarse_iters)
    for l in range(len(M.mats)):
        b32, bj32 = M32.mats[l].bands_p.numpy(), np.asarray(Mj32.mats[l].bands_p)
        off_pen = np.abs(bj32) < 1e11  # all but the penalty diagonal entries
        assert np.abs(b32 - bj32)[off_pen].max() <= 1e-6 * np.abs(bj32[off_pen]).max()
        np.testing.assert_array_equal(b32[~off_pen], bj32[~off_pen])
        b16 = M.mats[l].bands_p.float().numpy()
        bj = np.asarray(Mj.mats[l].bands_p, np.float32)  # bf16 values, exact in f32
        ulp = 2.0 ** -7 * np.maximum(np.abs(b16), np.abs(bj))
        assert (np.abs(b16 - bj) <= ulp).all(), l
        ij = np.asarray(Mj.inv_diags_p[l])
        assert np.abs(M.inv_diags_p[l].numpy() - ij).max() <= 1e-6 * np.abs(ij).max()
        np.testing.assert_array_equal(M.masks_p[l].numpy(), np.asarray(Mj.masks_p[l]))
        np.testing.assert_array_equal(M.maskmul_p[l].numpy(), np.asarray(Mj.maskmul_p[l]))


def test_mg_from_numpy_applies_like_own(box_data, bf16_hierarchies):
    """The JAX bf16 hierarchy carried across applies like the port's own:
    the two differ only where a band rounds to a neighbouring bf16 value,
    so within 1e-2 relative (bf16 keeps 8 bits)."""
    box, _, _, _, r = box_data
    M, Mj = bf16_hierarchies[:2]
    Mc = mg_from_numpy([np.asarray(m.bands_p) for m in Mj.mats], Mj.inv_diags_p,
                       Mj.maskmul_p, Mj.masks_p, Mj.shapes, device="cpu", nu=Mj.nu,
                       omega=Mj.omega, coarse_iters=Mj.coarse_iters,
                       omegas=Mj.omegas)
    assert Mc.mats[0].bands_p.dtype == torch.bfloat16
    rp = M.mats[0].pad_vec(torch.as_tensor(r, dtype=torch.float32))
    z, zc = M.apply(rp), Mc.apply(rp)
    assert float((z - zc).abs().max()) <= 1e-2 * float(z.abs().max())


@pytest.fixture(scope="module")
def unfused_hierarchies(box_data):
    """``fused=False`` padded hierarchies, (port, JAX): float64 bands from
    float64 coordinates, and bf16 bands from float32 ones."""
    box, jbox, c, mask, _ = box_data
    out = {}
    for name, cc, dt, jdt in (("f64", c, None, None),
                              ("bf16", c.astype(np.float32), torch.bfloat16, jnp.bfloat16)):
        out[name] = (build_mg_padded(box, torch.as_tensor(cc), mask, PENALTY, nu=2,
                                     fused=False, band_dtype=dt),
                     jax_build_mg_padded(jbox, jnp.asarray(cc), mask, PENALTY, nu=2,
                                         fused=False, band_dtype=jdt))
    return out


@pytest.mark.parametrize("bands", ["f64", "bf16"])
def test_unfused_hierarchy_matches_jax(unfused_hierarchies, box_data, bands):
    """The port's ``fused=False`` branch against the JAX one.  The JAX
    branch's ``to_plane_matrix`` rounds the plane bands to float32
    (sparse/dia_pallas.py), the port's keeps float64: so the f64 bands are
    held within that rounding (2^-24 of each entry) of the JAX plane bands
    and within 1e-12 of the largest non-penalty band of the JAX flat
    ``build_mg`` levels (float64, the same rediscretisation and penalty);
    the bf16 bands within 1 bf16 ulp, their penalty entries equal.
    Inverse diagonals within 1e-6 relative, masks equal.  One V-cycle apply: the JAX padded
    apply runs the Pallas plane kernels, which have no CPU mode here, so
    the f64 apply is held to the JAX flat ``build_mg(...).apply`` (the same
    V-cycle on flat vectors, 1e-10 of max|z|) and the bf16 one to the JAX
    bf16 hierarchy carried across by ``mg_from_numpy`` (1e-2: bf16 keeps 8
    bits)."""
    M, Mj = unfused_hierarchies[bands]
    box, jbox, c, mask, r = box_data
    assert M.shapes == tuple(Mj.shapes) and len(M.mats) == 2
    f64 = bands == "f64"
    if f64:
        Mflat = jax_build_mg(jbox, jnp.asarray(c), mask, PENALTY, nu=2)
    for l in range(len(M.mats)):
        b = M.mats[l].bands_p.double().numpy()
        bj = np.asarray(Mj.mats[l].bands_p, np.float64)
        pen = np.abs(bj) >= 1e11
        if f64:
            assert (np.abs(b - bj) <= 2.0 ** -24 * np.abs(bj)).all()
            (nx, ny, nz) = M.shapes[l]
            real = np.moveaxis(b, 1, 0)[:, :, 1:ny + 1, 1:nz + 1].reshape(15, -1)
            flat = np.asarray(Mflat.mats[l].bands)
            fpen = np.abs(flat) >= 1e11
            assert np.abs(real - flat)[~fpen].max() <= 1e-12 * np.abs(flat[~fpen]).max()
            np.testing.assert_array_equal(real[fpen], flat[fpen])
        else:
            assert (np.abs(b - bj) <= 2.0 ** -7 * np.maximum(np.abs(b), np.abs(bj))).all()
            np.testing.assert_array_equal(b[pen], bj[pen])
        ij = np.asarray(Mj.inv_diags_p[l], np.float64)
        assert np.abs(M.inv_diags_p[l].double().numpy() - ij).max() <= 1e-6 * np.abs(ij).max()
        np.testing.assert_array_equal(M.masks_p[l].numpy(), np.asarray(Mj.masks_p[l]))
        np.testing.assert_array_equal(M.maskmul_p[l].numpy(), np.asarray(Mj.maskmul_p[l]))
    dt = torch.float64 if f64 else torch.float32
    rt = torch.as_tensor(r, dtype=dt)
    z = M.mats[0].unpad_vec(M.apply(M.mats[0].pad_vec(rt))).double().numpy()
    if f64:
        zj = np.asarray(Mflat.apply(jnp.asarray(r)))
        assert np.abs(z - zj).max() <= 1e-10 * np.abs(zj).max()
    else:
        Mc = mg_from_numpy([np.asarray(m.bands_p) for m in Mj.mats], Mj.inv_diags_p,
                           Mj.maskmul_p, Mj.masks_p, Mj.shapes, device="cpu",
                           nu=Mj.nu, omega=Mj.omega, coarse_iters=Mj.coarse_iters,
                           omegas=Mj.omegas)
        zc = Mc.mats[0].unpad_vec(Mc.apply(Mc.mats[0].pad_vec(rt))).double().numpy()
        assert np.abs(z - zc).max() <= 1e-2 * np.abs(zc).max()


def test_unfused_levels_equal_fused_levels(box_data):
    """On the CPU both branches assemble with the plain twins: the unfused
    levels equal the fused ones to round-off (1e-12 of the largest
    non-penalty band, f64)."""
    box, _, c, mask, _ = box_data
    Mf = build_mg_padded(box, torch.as_tensor(c), mask, PENALTY, nu=1)
    Mu = build_mg_padded(box, torch.as_tensor(c), mask, PENALTY, nu=1, fused=False)
    for a, b in zip(Mf.mats, Mu.mats, strict=True):
        a, b = a.bands_p.numpy(), b.bands_p.numpy()
        pen = np.abs(a) >= 1e11
        np.testing.assert_array_equal(a[pen], b[pen])
        assert np.abs(a - b)[~pen].max() <= 1e-12 * np.abs(a[~pen]).max()
