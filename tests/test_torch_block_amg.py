"""The block and rigid-body-mode AMG set-up (solver/amg_setup.py) against
the JAX ``build_amg`` on the CPU in float64.

Both sides get the same finalized elasticity system: the port's values,
handed to JAX as its (N, W, b, b) blocks.  Held exactly: ``rigid_body_modes``,
``_rbm_tentative`` and ``truncate_rows`` on the same inputs, and every
level's matrix, P (and P^T), ``rhos``, the coarse inverse and each
level's near-nullspace ``Bc`` (recorded from JAX's ``_rbm_tentative``),
with the rigid body modes (2D, two levels or more; 3D) and without them (the
component-preserving tentative).  AMG-CG iterations agree ± 1, and a
scalar system ignores a near-nullspace, as in JAX."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import arcanefem_tpu.solver.amg as jamg
from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.solver.linear_system import SolverOptions as JaxOptions
from arcanefem_tpu.solver.linear_system import solve_finalized as jax_solve
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.ops import elements as el
from arcanefem_tpu_torch.solver import amg_setup as tas
from arcanefem_tpu_torch.solver.iterative import make_precond
from arcanefem_tpu_torch.solver.linear_system import (
    SolverOptions,
    solve_finalized,
)

LAM, MU2 = 1.5, 2.0


def _system(b):
    """The port's finalized elasticity system (Penalty u = 0 on one side,
    a body force) and the JAX BellMatrix of the same values."""
    if b == 2:
        mesh, jmesh, face = rect_tria_mesh(80, 40, lx=2.0), jax_rect(80, 40, lx=2.0), "left"
        fn, jfn = el.elasticity_tria3, jel.elasticity_tria3
    else:
        mesh, jmesh, face = box_tetra_mesh(9, 7, 7), jax_box(9, 7, 7), "xmin"
        fn, jfn = el.elasticity_tetra4, jel.elasticity_tetra4
    prob, jprob = FemProblem(mesh, ndof=b, device="cpu"), JaxProblem(jmesh, ndof=b)
    s = prob.new_system(prob.assemble_matrix(lambda ct, x: fn(x, LAM, MU2)))
    s.rhs = prob.vector_source_rhs(s.rhs, (None,) * (b - 1) + (-1.0,))
    prob.apply_dirichlet_vector(s, mesh.group_nodes(face), (0.0,) * b)
    A, rhs = s.finalized()
    JA = jprob.assemble_matrix(lambda ct, x: jfn(x, LAM, MU2))
    values, cols = A.block_ell()
    assert np.array_equal(cols, JA.topo.ell_cols)
    return mesh, A, rhs, JA.with_values(jnp.asarray(values))


@pytest.fixture(scope="module", params=[2, 3], ids=["b2", "b3"])
def system(request):
    return request.param, *_system(request.param)


def test_rigid_body_modes_exact(system):
    b, mesh, *_ = system
    B = tas.rigid_body_modes(mesh.coords, b)
    assert B.shape == (mesh.n_nodes * b, 3 if b == 2 else 6)
    assert np.array_equal(B, jamg.rigid_body_modes(mesh.coords, b))
    with pytest.raises(ValueError):
        tas.rigid_body_modes(mesh.coords, 4)


@pytest.mark.parametrize("bl", [2, 3, 6])
def test_rbm_tentative_and_truncate_rows_exact(bl):
    """The per-aggregate SVD prolongator and its R factors, and the row
    truncation with and without rescaling, on random aggregates and
    matrices (singletons and unaggregated nodes included)."""
    rng = np.random.RandomState(bl)
    nn, na = 300, 40
    agg = rng.randint(-1, na, nn)
    agg[:na] = np.arange(na)  # every aggregate has a member
    B = rng.rand(nn * bl, 6 if bl == 6 else 3) - 0.5
    T, Bc = tas._rbm_tentative(agg, na, B, bl)
    JT, JBc = jamg._rbm_tentative(agg, na, B, bl)
    assert (T != JT).nnz == 0 and np.array_equal(T.toarray(), JT.toarray())
    assert np.array_equal(Bc, JBc)
    P = sp.random(200, 60, density=0.2, random_state=rng, format="csr")
    P.data -= 0.5
    for rescale in (True, False):
        # each gets its own copy: the result shares and compacts P's arrays
        Q = tas.truncate_rows(P.copy(), kmax=4, rel=0.05, rescale=rescale)
        JQ = jamg.truncate_rows(P.copy(), kmax=4, rel=0.05, rescale=rescale)
        assert np.array_equal(Q.indptr, JQ.indptr) and np.array_equal(Q.indices, JQ.indices)
        assert np.array_equal(Q.data, JQ.data)


def _hierarchies(A, JA, nullspace, monkeypatch):
    """(port dict, JAX AMGPrecond, JAX Bc of each level)."""
    recorded = []
    orig = jamg._rbm_tentative

    def record(*a):
        out = orig(*a)
        recorded.append(out[1])
        return out

    monkeypatch.setattr(jamg, "_rbm_tentative", record)
    JM = jamg.build_amg(JA, nullspace=nullspace)
    d = tas.amg_setup(A.ell_values().numpy(), tas.stored_graph(A.layout), theta=0.08,
                      smoother="jacobi", cheb_deg=2, dtype=np.float64, block=A.block,
                      nullspace=nullspace)
    return d, JM, recorded


@pytest.mark.parametrize("rbm", [True, False], ids=["rbm", "component"])
def test_block_hierarchy_exact(system, rbm, monkeypatch):
    """Every level's matrix and columns, P and P^T, the inverse diagonals,
    rhos, the coarse inverse and (with the modes) each level's Bc equal
    JAX's bit for bit."""
    b, mesh, A, _, JA = system
    B = tas.rigid_body_modes(mesh.coords, b) if rbm else None
    d, JM, recorded = _hierarchies(A, JA, B, monkeypatch)
    assert len(d["mats"]) == len(JM.mats) >= 1
    if b == 2 and rbm:
        assert len(d["mats"]) >= 2  # a coarse level with 3 dofs per aggregate
    assert d["rhos"] == tuple(JM.rhos)
    for (v, c), jm in zip(d["mats"], JM.mats):
        assert np.array_equal(c, jm.topo.ell_cols)
        assert np.array_equal(v, np.asarray(jm.values).reshape(v.shape))
    for l in range(len(d["pvals"])):
        for k in ("pvals", "pcols", "ptvals", "ptcols"):
            assert np.array_equal(d[k][l], np.asarray(getattr(JM, k)[l])), (k, l)
    for inv, jinv in zip(d["inv_diags"], JM.inv_diags):
        assert np.array_equal(inv, np.asarray(jinv))
    assert np.array_equal(d["coarse_inv"], np.asarray(JM.coarse_inv))
    if rbm:
        assert len(recorded) == len(d["mats"])
        for Bc, JBc in zip(d["nullspaces"][1:], recorded):
            assert np.array_equal(Bc, JBc)
    else:
        assert not recorded and all(n is None for n in d["nullspaces"])


def test_amg_rbm_cg_iterations_match_jax(system):
    """AMG-PCG with the rigid body modes, to 1e-10: iterations ± 1, x to
    1e-10 of max|x|; the port's hierarchy on the device equals its host
    dict's levels."""
    b, mesh, A, rhs, JA = system
    B = tas.rigid_body_modes(mesh.coords, b)
    x, info = solve_finalized(A, rhs, SolverOptions(preconditioner="amg", rtol=1e-10,
                                                    amg_nullspace=B))
    jx, jinfo = jax_solve(JA, jnp.asarray(rhs.numpy()),
                          JaxOptions(preconditioner="amg", rtol=1e-10, amg_nullspace=B))
    assert abs(info["iterations"] - int(jinfo["iterations"])) <= 1
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-10 * np.abs(jx).max())
    M = make_precond(A, "amg", nullspace=B)
    assert M.mats[0].n_nodes == A.n_dofs  # the levels are scalar


def test_scalar_system_ignores_nullspace():
    """make_precond(amg, nullspace=...) on a scalar matrix builds the
    hierarchy without it, as JAX does."""
    prob = FemProblem(rect_tria_mesh(40, 30), device="cpu")
    s = prob.new_system(prob.stiffness_matrix())
    prob.apply_dirichlet(s, prob.group_dofs("left"), 0.0)
    A, _ = s.finalized()
    M = make_precond(A, "amg")
    Mn = make_precond(A, "amg", nullspace=np.ones((A.n_dofs, 1)))
    assert M.rhos == Mn.rhos and torch.equal(M.coarse_inv, Mn.coarse_inv)
