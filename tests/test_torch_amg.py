"""AMG (arcanefem_tpu_torch/solver/amg_setup.py and solver/amg.py) against
the JAX package's build_amg and AMGPrecond on the CPU, on the bench system
at sphere_cut h=8 (8,324 nodes: levels 8324 and 642, then a 52x52 coarse
solve): the set-up, one cycle with each smoother and cycle option, the
supernode block-Jacobi fine smoother and the bf16 V-cycle."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.solver.amg import with_supernode_smoother as jax_sn_smoother
from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu.sparse.supernode import SupernodeSpmv as JaxSn
from arcanefem_tpu_torch.bench_unstructured import (
    dirichlet_data,
    sphere_cut_system,
)
from arcanefem_tpu_torch.solver.amg import (
    BF16_MIN_ROWS,
    amg_from_numpy,
    with_bf16_vcycle,
)
from arcanefem_tpu_torch.solver.amg_setup import amg_setup

PENALTY = 1e30


@pytest.fixture(scope="module")
def system():
    """The JAX bench operator at h=8 (f64, penalty rows) and its values."""
    mesh, topo = sphere_cut_system(8.0, 0, cache=False)
    vals = TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(mesh.coords.astype(np.float32)))
    mask, _, _ = dirichlet_data(mesh, PENALTY)
    flat = np.asarray(vals, np.float64).reshape(-1)
    flat[topo.diag_slot[mask]] = PENALTY
    A = JaxBell(values=jnp.asarray(flat.reshape(topo.n_nodes, topo.width, 1, 1)),
                topo=topo, block=1, cols=jnp.asarray(topo.ell_cols))
    return A, flat, topo


@pytest.fixture(scope="module")
def hierarchies(system):
    A, flat, topo = system
    M = build_amg(A, smoother="chebyshev", cheb_deg=2, theta=0.03,
                  values_np=flat)
    d = amg_setup(flat, topo, theta=0.03, smoother="chebyshev", cheb_deg=2)
    return M, d


def _as_numpy(M) -> dict:
    """The JAX hierarchy as the dict amg_from_numpy takes."""
    return {
        "mats": [(np.asarray(m.values).reshape(m.topo.n_nodes, m.topo.width),
                  np.asarray(m.cols)) for m in M.mats],
        **{k: [np.asarray(a) for a in getattr(M, k)]
           for k in ("inv_diags", "pcols", "pvals", "ptcols", "ptvals")},
        "coarse_inv": np.asarray(M.coarse_inv),
        "omegas": M.omegas, "rhos": M.rhos, "smoother": M.smoother,
        "cheb_deg": M.cheb_deg, "nu": M.nu, "cycle": M.cycle,
        "sawtooth": M.sawtooth,
        "l0_binv": None if M.l0_binv is None else np.asarray(M.l0_binv),
    }


def test_amg_setup_matches_build_amg(hierarchies):
    M, d = hierarchies
    ref = _as_numpy(M)
    assert [v.shape[0] for v, _ in d["mats"]] == [8324, 642]
    assert d["coarse_inv"].shape == (52, 52)
    assert len(d["mats"]) == len(ref["mats"])
    for (v, c), (rv, rc) in zip(d["mats"], ref["mats"]):
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(v, rv)
    for k in ("pcols", "ptcols", "inv_diags"):
        for a, b in zip(d[k], ref[k], strict=True):
            np.testing.assert_array_equal(a, b)
    for k in ("pvals", "ptvals"):
        for a, b in zip(d[k], ref[k], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for k in ("rhos", "omegas"):
        np.testing.assert_allclose(d[k], ref[k], rtol=1e-12)
    np.testing.assert_allclose(d["coarse_inv"], ref["coarse_inv"],
                               rtol=1e-12, atol=1e-12 * np.abs(
                                   ref["coarse_inv"]).max())
    assert (d["smoother"], d["cheb_deg"], d["nu"], d["cycle"]) == \
        ("chebyshev", 2, 1, "V")


@pytest.mark.parametrize("smoother,cycle", [("chebyshev", "V"),
                                            ("chebyshev", "W"),
                                            ("jacobi", "V")])
def test_amg_apply_matches_jax(hierarchies, smoother, cycle):
    """amg_from_numpy of the JAX hierarchy: one cycle on a random vector
    equals the JAX M.apply in f64 (rtol 1e-10)."""
    M, _ = hierarchies
    M = replace(M, smoother=smoother, cycle=cycle)
    r = np.random.RandomState(1).rand(M.mats[0].topo.n_nodes) - 0.5
    want = np.asarray(M.apply(jnp.asarray(r)))
    P = amg_from_numpy(_as_numpy(M), "cpu", torch.float64)
    got = P.apply(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_amg_from_numpy_checks_columns(hierarchies):
    _, d = hierarchies
    bad = dict(d, pcols=[d["pcols"][0] + 642])
    with pytest.raises(ValueError):
        amg_from_numpy(bad, "cpu", torch.float64)


def _apply_both(M, r, dtype=torch.float64):
    want = np.asarray(M.apply(jnp.asarray(r)))
    got = amg_from_numpy(_as_numpy(M), "cpu", dtype).apply(torch.as_tensor(r)).numpy()
    return got, want


@pytest.mark.parametrize("variant", ["l0_binv-chebyshev", "l0_binv-jacobi",
                                     "sawtooth-chebyshev", "sawtooth-jacobi",
                                     "cheb_deg_2_4"])
def test_amg_apply_options_match_jax(system, hierarchies, variant):
    """One cycle with each carried option == the JAX M.apply in f64 (rtol
    1e-10): the supernode block-Jacobi smoother (l0_binv from the JAX
    with_supernode_smoother), the sawtooth cycle, per-level degrees."""
    A, _, _ = system
    M, _ = hierarchies
    if variant.startswith("l0_binv"):
        M = jax_sn_smoother(M, A, JaxSn.build(A))
        M = replace(M, smoother=variant.split("-")[1])
    elif variant.startswith("sawtooth"):
        M = replace(M, sawtooth=True, smoother=variant.split("-")[1])
    else:
        M = replace(M, cheb_deg=(2, 4))
    r = np.random.RandomState(2).rand(M.mats[0].topo.n_nodes) - 0.5
    got, want = _apply_both(M, r)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    plain, _ = _apply_both(hierarchies[0], r)
    assert np.abs(plain - want).max() > 1e-6 * np.abs(want).max()  # it acts


def _rounded_bf16(M):
    """The JAX hierarchy in f32, with the levels and transfers that
    with_bf16_vcycle casts (>= 1500 fine rows) holding bf16-rounded
    values: the cycle the bf16 kernels compute."""
    def f32(a, cast=False):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a.astype(jnp.bfloat16).astype(np.float32) if cast else a)

    big = [m.topo.n_nodes >= BF16_MIN_ROWS for m in M.mats]
    return replace(
        M,
        mats=tuple(JaxBell(values=f32(m.values, b), topo=m.topo, block=1,
                           cols=m.cols) for m, b in zip(M.mats, big)),
        inv_diags=tuple(f32(v) for v in M.inv_diags),
        pvals=tuple(f32(v, b) for v, b in zip(M.pvals, big)),
        ptvals=tuple(f32(v, b) for v, b in zip(M.ptvals, big)),
        coarse_inv=f32(M.coarse_inv))


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_bf16_vcycle_matches_rounded_jax(hierarchies, smoother):
    """with_bf16_vcycle: bf16 weights on level 0 (8324 rows) and on its
    transfers, level 1 (642 rows) untouched, as the JAX rule casts them;
    one f32 cycle == a JAX f32 cycle on bf16-rounded values (1e-5 of
    max|y|), and differs from the unrounded cycle."""
    M, _ = hierarchies
    M = replace(M, smoother=smoother)
    r = (np.random.RandomState(5).rand(M.mats[0].topo.n_nodes) - 0.5).astype(np.float32)
    P = amg_from_numpy(_as_numpy(M), "cpu", torch.float32)
    Pb = with_bf16_vcycle(P)
    assert Pb.vmats[0].values.dtype == torch.bfloat16 and Pb.vmats[1] is None
    assert Pb.P[0].values.dtype == Pb.Pt[0].values.dtype == torch.bfloat16
    assert P.mats[0].values.dtype == Pb.mats[0].values.dtype == torch.float32
    want = np.asarray(_rounded_bf16(M).apply(jnp.asarray(r)))
    got = Pb.apply(torch.as_tensor(r)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(P.apply(torch.as_tensor(r)).numpy() - want).max() > 1e-4 * scale
