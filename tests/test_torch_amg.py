"""AMG (arcanefem_tpu_torch/solver/amg_setup.py and solver/amg.py) against
the JAX package's build_amg and AMGPrecond on the CPU, on the bench system
at sphere_cut h=8 (8,324 nodes: levels 8324 and 642, then a 52x52 coarse
solve)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu_torch.bench_unstructured import (
    dirichlet_data,
    sphere_cut_system,
)
from arcanefem_tpu_torch.solver.amg import amg_from_numpy
from arcanefem_tpu_torch.solver.amg_setup import amg_setup

PENALTY = 1e30


@pytest.fixture(scope="module")
def hierarchies():
    mesh, topo = sphere_cut_system(8.0, 0, cache=False)
    vals = TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(mesh.coords.astype(np.float32)))
    mask, _, _ = dirichlet_data(mesh, PENALTY)
    flat = np.asarray(vals, np.float64).reshape(-1)
    flat[topo.diag_slot[mask]] = PENALTY
    A = JaxBell(values=jnp.asarray(flat.reshape(topo.n_nodes, topo.width, 1, 1)),
                topo=topo, block=1, cols=jnp.asarray(topo.ell_cols))
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
