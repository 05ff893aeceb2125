"""The whole unstructured main path of the port against the JAX package on
the CPU, in f64 with penalty 1e30 as bench.py runs it off the TPU, plus its
host ordering and solver pieces.

One deliberate difference from bench.py:771-793: both sides write the
penalty into the matrix after the cast to the solve's dtype.  bench.py
writes it into the float32 assembled values (1e30 rounds to
1.0000000150e30) while the rhs carries 1e30 in float64; the mismatch leaves
1.5e22 residuals on the sphere rows, which dominate the initial
preconditioned residual and stop CG at a true interior residual of ~3e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.solver.iterative import Precond as JaxPrecond
from arcanefem_tpu.solver.iterative import pcg as jax_pcg
from arcanefem_tpu.solver.iterative import precise_dot as jax_precise_dot
from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu.sparse.supernode import supernode_order as jax_sn_order
from arcanefem_tpu.sparse.topology import build_topology
from arcanefem_tpu.mesh.unstructured import sphere_cut_tetra_mesh
from arcanefem_tpu.utils.ordering import rcm_order, renumber_mesh
from arcanefem_tpu_torch.bench_unstructured import (
    dirichlet_data,
    solve_sphere_cut,
    sphere_cut_system,
)
from arcanefem_tpu_torch.solver.iterative import Precond, pcg, precise_dot
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.ordering import supernode_order

PENALTY = 1e30


def _jax_system(mesh, topo):
    """bench.py's JAX system on the CPU: segsum assembly, penalty rows,
    rhs and warm start."""
    vals = TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(mesh.coords.astype(np.float32)))
    mask, g, rhs = dirichlet_data(mesh, PENALTY)
    flat = np.asarray(vals, np.float64).reshape(-1)
    flat[topo.diag_slot[mask]] = PENALTY
    A = JaxBell(values=jnp.asarray(flat.reshape(topo.n_nodes, topo.width, 1, 1)),
                topo=topo, block=1, cols=jnp.asarray(topo.ell_cols))
    return A, flat, mask, jnp.asarray(rhs), jnp.asarray(np.where(mask, g, 0.0))


def test_supernode_order_copy_matches_jax():
    mesh = sphere_cut_tetra_mesh(h=14.0)
    topo = build_topology(mesh.n_nodes, mesh.cells)
    mesh = renumber_mesh(mesh, rcm_order(mesh.n_nodes, topo.row_ptr,
                                         topo.csr_cols))
    topo = build_topology(mesh.n_nodes, mesh.cells)
    np.testing.assert_array_equal(supernode_order(topo, mesh.coords),
                                  jax_sn_order(topo, mesh.coords))


@pytest.mark.parametrize("h", [14.0, 8.0])
def test_slice_matches_jax(h):
    """Same CG iteration count (±1), solutions within 1e-6 of max|x|, and
    a true interior residual ≤ 1e-6."""
    mesh, topo = sphere_cut_system(h, 0, cache=False)
    A, flat, mask, b, x0 = _jax_system(mesh, topo)
    M = build_amg(A, smoother="chebyshev", cheb_deg=2, theta=0.03,
                  values_np=flat)
    xj, kj, relj = jax_pcg(A, b, M, x0, 1e-8, 0.0, 1000,
                           use_precise_dot=True)
    xj = np.asarray(xj)

    res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                           penalty=PENALTY)
    x = res["x"].numpy()
    assert abs(res["iterations"] - int(kj)) <= 1, (res["iterations"], int(kj))
    assert res["rel"] <= 1e-8 and float(relj) <= 1e-8
    assert np.abs(x - xj).max() <= 1e-6 * np.abs(xj).max()
    assert res["true_residual"] <= 1e-6
    assert np.isfinite(x).all()


def test_precise_dot_matches_jax():
    """Compensated f32 dot == the JAX one, both near the f64 value."""
    rng = np.random.RandomState(3)
    a = (rng.rand(100_000) - 0.5).astype(np.float32)
    b = (rng.rand(100_000) - 0.5).astype(np.float32)
    exact = float(a.astype(np.float64) @ b.astype(np.float64))
    got = float(precise_dot(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(jax_precise_dot(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - exact) <= 1e-6 * np.abs(a * b).sum()
    assert abs(got - want) <= 1e-6 * np.abs(a * b).sum()


def test_jacobi_pcg_matches_jax():
    """Jacobi-preconditioned CG: the same iterate count and solution."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    A, flat, mask, b, x0 = _jax_system(mesh, topo)
    d = A.diagonal()
    Mj = JaxPrecond(data=(jnp.where(d != 0, 1.0 / d, 1.0),), kind="jacobi")
    xj, kj, _ = jax_pcg(A, b, Mj, x0, 1e-8, 0.0, 1000)
    At = BellMatrix.from_numpy(flat.reshape(topo.n_nodes, topo.width),
                               topo.ell_cols, topo.diag_slot, device="cpu",
                               dtype=torch.float64)
    x, k, rel = pcg(At, torch.tensor(np.asarray(b)), Precond.jacobi(At),
                    torch.tensor(np.asarray(x0)), 1e-8, 0.0, 1000)
    assert abs(k - int(kj)) <= 1 and rel <= 1e-8
    xj = np.asarray(xj)
    assert np.abs(x.numpy() - xj).max() <= 1e-6 * np.abs(xj).max()
