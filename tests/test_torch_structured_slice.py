"""The structured slice as a whole against the JAX package, float64 on the
CPU, at the 16^3 box of bench.py's system (two multigrid levels with
min_size 8): MG-PCG against a CG loop written here with the same
recurrence around the JAX ``DiaMatrix.spmv`` and ``build_mg(...).apply``
(called eagerly: XLA:CPU compiles the V-cycle under ``jit`` pathologically
slowly, tests/test_multigrid.py), the flat-vector V-cycle on stencil
levels against the same loop, Jacobi-PCG against the JAX ``pcg``, and all
against a sparse direct solve of the JAX-assembled system."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.mesh.structured import apply_penalty_dirichlet as jax_penalty
from arcanefem_tpu.solver.iterative import Precond as JaxPrecond
from arcanefem_tpu.solver.iterative import pcg as jax_pcg
from arcanefem_tpu.solver.iterative import precise_dot as jax_precise_dot
from arcanefem_tpu.solver.multigrid import build_mg as jax_build_mg
from arcanefem_tpu_torch.bench_structured import (
    PENALTY,
    REPLACE_EVERY,
    RTOL,
    box_system,
    solve_jacobi,
    solve_mg_flat,
    true_residual,
)
from arcanefem_tpu_torch.mesh.stencil_assembly import assemble_system
from arcanefem_tpu_torch.solver.iterative import pcg
from arcanefem_tpu_torch.solver.multigrid import build_mg_padded

N = 16


@pytest.fixture(scope="module")
def systems():
    """The port's f64 box system and the JAX-assembled one on the same
    coordinates: (port system, JAX A, b, x0, dense-free scipy CSR)."""
    s = box_system(N, "cpu", torch.float64)
    jbox = JaxBox(N, N, N)
    c = jnp.asarray(s.coords3d.numpy())
    A, b = jax_penalty(jbox.assemble_stiffness(c, backend="xla"), jbox.source_rhs(c, 1.0),
                       jnp.asarray(s.mask), jnp.asarray(s.g), PENALTY)
    x0 = jnp.where(jnp.asarray(s.mask), jnp.asarray(s.g), 0.0)
    return s, A, b, x0, sp.csr_matrix(A.todense())


def _jax_mg_cg(A, b, M, x0):
    """The port's pcg recurrence, residual replacement included, around the
    JAX operator and V-cycle."""
    x = np.asarray(x0)
    r = b - A.spmv(x0)
    z = M.apply(r)
    p, rz = z, jax_precise_dot(r, z)
    tol2 = RTOL * RTOL * abs(float(rz))
    k = 0
    while k < 5000 and abs(float(rz)) > tol2:
        Ap = A.spmv(p)
        alpha = rz / jax_precise_dot(p, Ap)
        x = x + float(alpha) * np.asarray(p)
        r = r - alpha * Ap
        k += 1
        if k % REPLACE_EVERY == 0:
            r = b - A.spmv(jnp.asarray(x))
        z = M.apply(r)
        rz_new = jax_precise_dot(r, z)
        p, rz = z + (rz_new / rz) * p, rz_new
    return x, k


@pytest.fixture(scope="module")
def jax_mg(systems):
    """(solution, iterations) of the CG loop around the JAX V-cycle."""
    s, A, b, x0, _ = systems
    Mj = jax_build_mg(JaxBox(N, N, N), jnp.asarray(s.coords3d.numpy()), s.mask,
                      PENALTY, nu=1, min_size=8)
    return _jax_mg_cg(A, b, Mj, x0)


def test_mg_pcg_matches_jax_loop_and_direct_solve(systems, jax_mg):
    s, A, b, x0, Acsr = systems
    Ap, rhs_p = assemble_system(s.box, s.coords3d, s.mask_p, s.pg_p, PENALTY, f=1.0)
    M = build_mg_padded(s.box, s.coords3d, s.mask, PENALTY, fine=Ap, nu=1,
                        min_size=8)
    assert len(M.mats) == 2
    xp, k, rel = pcg(Ap, rhs_p, M, s.x0_p, RTOL, 0.0, 5000, use_precise_dot=True,
                     replace_every=REPLACE_EVERY)
    x = Ap.unpad_vec(xp).numpy()

    xj, kj = jax_mg
    assert k == kj and rel <= RTOL
    scale = np.abs(xj).max()
    assert np.abs(x - xj).max() <= 1e-8 * scale

    xd = spla.spsolve(Acsr.tocsc(), np.asarray(b))
    assert np.abs(x - xd).max() <= 1e-8 * np.abs(xd).max()
    assert true_residual(s, {"A": Ap, "b": rhs_p, "x": torch.as_tensor(x)}) <= 1e-6


def test_flat_mg_pcg_matches_jax_loop(systems, jax_mg):
    """CG with the flat V-cycle on band-major stencil levels (K8b's path)
    takes the JAX loop's iteration count and reaches its solution (1e-8)
    and the direct solve's (1e-8)."""
    s, A, b, _, Acsr = systems
    res = solve_mg_flat(s)
    xj, kj = jax_mg
    assert res["iterations"] == kj and res["rel"] <= RTOL
    x = res["x"].numpy()
    assert np.abs(x - xj).max() <= 1e-8 * np.abs(xj).max()
    xd = spla.spsolve(Acsr.tocsc(), np.asarray(b))
    assert np.abs(x - xd).max() <= 1e-8 * np.abs(xd).max()
    assert true_residual(s, res) <= 1e-6


def test_jacobi_pcg_matches_jax(systems):
    """Jacobi-PCG on the band-major stencil operator (K8's path) takes the
    JAX pcg's iteration count and reaches its solution (1e-8).  Against the
    direct solve the tolerance is 1e-7: Jacobi's worse conditioning lets
    rtol 1e-8 on the preconditioned residual leave ~2e-8 of error, in the
    JAX solution as in the port's."""
    s, A, b, x0, Acsr = systems
    res = solve_jacobi(s)
    d = A.diagonal()
    Mj = JaxPrecond(data=(jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0),),
                    kind="jacobi")
    xj, kj, _ = jax_pcg(A, b, Mj, x0, RTOL, 0.0, 5000, use_precise_dot=True)
    assert res["iterations"] == int(kj) and res["rel"] <= RTOL
    x = res["x"].numpy()
    assert np.abs(x - np.asarray(xj)).max() <= 1e-8 * np.abs(np.asarray(xj)).max()
    xd = spla.spsolve(Acsr.tocsc(), np.asarray(b))
    for got in (x, np.asarray(xj)):
        assert np.abs(got - xd).max() <= 1e-7 * np.abs(xd).max()
