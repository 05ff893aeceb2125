"""The FEM core's linear algebra against the JAX package on the CPU in
float64: ``FemProblem`` assembly and RHS, ``apply_bcs`` with each
Dirichlet method (and all four at once), the Chebyshev preconditioner,
``make_precond``'s AMG set-up, ``solve_finalized`` with the dense
back end and with CG under every preconditioner, and the three failure
actions.  The solver tests hand both packages the same finalized system:
the JAX package's values in the port's SELL storage."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.solver.iterative import make_precond as jax_make_precond
from arcanefem_tpu.solver.linear_system import SolverOptions as JaxOptions
from arcanefem_tpu.solver.linear_system import solve_finalized as jax_solve
from arcanefem_tpu.solver.poly import build_chebyshev as jax_chebyshev
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.solver.iterative import Precond, make_precond
from arcanefem_tpu_torch.solver.linear_system import (
    SolverOptions,
    apply_bcs,
    solve_finalized,
)
from arcanefem_tpu_torch.solver.poly import build_chebyshev
from arcanefem_tpu_torch.sparse.bell import BellMatrix

METHODS = ("Penalty", "WeakPenalty", "RowElimination", "RowColumnElimination")
GROUPS = {"rect": ("left", "right", "top", "bottom"),
          "box": ("xmin", "xmax", "ymax", "zmin")}


def _mesh_pair(name):
    if name == "rect":
        return rect_tria_mesh(32, 24, lx=1.5), jax_rect(32, 24, lx=1.5)
    return box_tetra_mesh(9, 8, 8), jax_box(9, 8, 8)


def _build(name, methods):
    """The Poisson system (f = 1) of both packages with Dirichlet groups
    GROUPS[name][k] set by methods[k] to values 1 + k (penalty 1e30), and a
    Neumann flux on the last group when it has no Dirichlet value."""
    mesh, jmesh = _mesh_pair(name)
    prob = FemProblem(mesh, device="cpu")
    jprob = JaxProblem(jmesh, dtype=np.float64)
    systems = []
    for p in (prob, jprob):
        s = p.new_system(p.stiffness_matrix())
        s.rhs = p.constant_source_rhs(1.0)
        if len(methods) < 4:
            s.rhs = p.neumann_rhs(s.rhs, GROUPS[name][3], value=0.25)
        for k, m in enumerate(methods):
            p.apply_dirichlet(s, p.group_dofs(GROUPS[name][k]), 1.0 + k, m, 1e30)
        systems.append(s)
    return prob, jprob, systems[0], systems[1]


def _dense_close(got: torch.Tensor, want, rtol=1e-14):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", ["rect", "box"])
@pytest.mark.parametrize("methods", [(m, m) for m in METHODS] + [METHODS],
                         ids=lambda m: "-".join(m))
def test_finalized_system_matches_jax(name, methods):
    """The port's assembly, RHS (source and Neumann) and apply_bcs give the
    JAX finalized dense A and b to 1e-14 of their largest entry, and the
    same initial guess; with all four methods at once the groups overlap
    at shared nodes."""
    _prob, _jprob, s, js = _build(name, methods)
    A, b = s.finalized()
    jA, jb = js.finalized()
    _dense_close(A.todense(), jA.todense())
    _dense_close(b, jb)
    np.testing.assert_array_equal(s.initial_guess().numpy(),
                                  np.asarray(js.initial_guess()))


def _port_matrix(prob, jA) -> BellMatrix:
    """The JAX BellMatrix's values in the port's SELL layout of the same
    topology."""
    lay = prob.layout
    vals = np.asarray(jA.values).reshape(prob.topo.n_nodes, prob.topo.width)
    diag = torch.as_tensor(lay.ell_to_sell[prob.topo.diag_slot.astype(np.int64)])
    return BellMatrix(lay.from_ell(vals), lay, diag)


@pytest.mark.parametrize("method", METHODS)
def test_apply_bcs_on_equal_inputs(method):
    """apply_bcs alone, on the JAX matrix and rhs in SELL storage and the
    same deferred ops: the finalized values equal JAX's to 1e-14."""
    prob, jprob, s, js = _build("rect", (method, method, method))
    A0 = _port_matrix(prob, js.matrix)
    A, b = apply_bcs(A0, torch.tensor(np.asarray(js.rhs)), s.ops)
    jA, jb = js.finalized()
    _dense_close(A.todense(), jA.todense())
    _dense_close(b, jb)
    assert torch.equal(A0.values, _port_matrix(prob, js.matrix).values)  # A0 untouched


@pytest.fixture(scope="module", params=["rect", "box"])
def finalized(request):
    """Both packages' finalized Poisson system (Penalty on three groups, a
    Neumann flux on the fourth): (port A, b, x0, JAX A, b, x0)."""
    prob, jprob, s, js = _build(request.param, ("Penalty", "Penalty", "Penalty"))
    jA, jb = js.finalized()
    A = _port_matrix(prob, jA)
    x0 = js.initial_guess()
    return (A, torch.tensor(np.asarray(jb)), torch.tensor(np.asarray(x0)),
            jA, jb, x0)


@pytest.fixture(scope="module", params=["rect", "box"])
def finalized_rc(request):
    """The same with RowColumnElimination (symmetric, no penalty rows)."""
    prob, jprob, s, js = _build(request.param, ("RowColumnElimination",) * 3)
    jA, jb = js.finalized()
    A = _port_matrix(prob, jA)
    x0 = js.initial_guess()
    return (A, torch.tensor(np.asarray(jb)), torch.tensor(np.asarray(x0)),
            jA, jb, x0)


def _solve_both(system, **opts):
    A, b, x0, jA, jb, jx0 = system
    x, info = solve_finalized(A, b, SolverOptions(**opts), x0)
    jx, jinfo = jax_solve(jA, jb, JaxOptions(**opts), jx0)
    jx = np.asarray(jx)
    err = np.abs(x.numpy() - jx).max() / np.abs(jx).max()
    return x, info, jx, jinfo, err


@pytest.mark.parametrize("pc", ["jacobi", "block-jacobi", "amg", "poly"])
def test_cg_matches_jax(finalized, pc):
    """CG to rtol 1e-10 under each preconditioner: x within 1e-9 of max|x|,
    iterations equal ± 1, the same info keys (the port adds
    precond_setup_s)."""
    x, info, jx, jinfo, err = _solve_both(finalized, preconditioner=pc, rtol=1e-10)
    assert err <= 1e-9, err
    assert abs(info["iterations"] - int(jinfo["iterations"])) <= 1
    assert set(jinfo) <= set(info)
    assert info["residual"] <= 1e-10 and x.dtype == torch.float64
    assert abs(info["true_residual"] - float(jinfo["true_residual"])) <= 1e-9


@pytest.mark.parametrize("pc", ["none", "jacobi", "block-jacobi", "amg", "poly"])
def test_cg_matches_jax_row_column_elimination(finalized_rc, pc):
    x, info, jx, jinfo, err = _solve_both(finalized_rc, preconditioner=pc, rtol=1e-10)
    assert err <= 1e-9, err
    assert abs(info["iterations"] - int(jinfo["iterations"])) <= 1


def test_dense_matches_jax(finalized):
    x, info, jx, jinfo, err = _solve_both(finalized, method="dense")
    assert err <= 1e-12, err
    assert info == {"iterations": 1, "residual": 0.0} == jinfo


def test_spmv_backends(finalized):
    """spmv="xla" runs the plain twin: the same x as "pallas" on the CPU
    (the CPU runs the plain twin either way); anything else raises."""
    A, b, x0 = finalized[:3]
    xp, ip = solve_finalized(A, b, SolverOptions(rtol=1e-10), x0)
    xx, ix = solve_finalized(A, b, SolverOptions(rtol=1e-10, spmv="xla"), x0)
    assert torch.equal(xp, xx) and ip["iterations"] == ix["iterations"]
    with pytest.raises(ValueError, match="spmv"):
        solve_finalized(A, b, SolverOptions(spmv="window"), x0)


@pytest.mark.parametrize("method", ["bicgstab", "bicgstab2", "gmres"])
def test_unported_methods_raise(finalized, method):
    """The three Krylov methods that raised until they were ported now run:
    solve_finalized with Jacobi to rtol 1e-12 gives JAX's x within 1e-9 of
    max|x| and its iterations ± 1; an unknown method still raises.  On these
    1e30 penalty rows BiCGStab's count is set by round-off in both packages
    (105-108 on the rect, 41-43 on the box, ROADMAP Queue 3; without
    penalty rows the two agree ± 1, test_torch_krylov.py): it is held to
    5% of JAX's."""
    A, b, x0, jA, jb, jx0 = finalized
    opts = dict(method=method, rtol=1e-12, preconditioner="jacobi")
    x, info = solve_finalized(A, b, SolverOptions(**opts), x0)
    jx, jinfo = jax_solve(jA, jb, JaxOptions(**opts), jx0)
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    jits = int(jinfo["iterations"])
    assert abs(info["iterations"] - jits) <= (jits // 20 if method == "bicgstab" else 1)
    assert info["residual"] <= 1e-12
    with pytest.raises(ValueError):
        solve_finalized(A, b, SolverOptions(method="lu"), x0)


def test_chebyshev_matches_jax(finalized):
    """build_chebyshev's interval and one apply equal JAX's to 1e-12."""
    A, b, x0, jA, jb, jx0 = finalized
    M, jM = build_chebyshev(A), jax_chebyshev(jA)
    np.testing.assert_allclose(float(M.theta), float(jM.theta), rtol=1e-12)
    np.testing.assert_allclose(float(M.delta), float(jM.delta), rtol=1e-12)
    r = np.random.RandomState(5).rand(b.shape[0]) - 0.5
    got, want = M.apply(torch.as_tensor(r)).numpy(), np.asarray(jM.apply(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_make_precond_matches_jax(finalized):
    """The AMG hierarchy of make_precond("amg") (theta 0.08, Jacobi) equals
    the JAX build_amg defaults' level for level, and one cycle agrees to
    1e-10; block-Jacobi equals Jacobi for b = 1; a near-nullspace is ignored, as
    on any scalar system."""
    A, b, x0, jA, jb, jx0 = finalized
    M, jM = make_precond(A, "amg"), jax_make_precond(jA, "amg")
    assert [m.n_nodes for m in M.mats] == [m.topo.n_nodes for m in jM.mats]
    assert M.coarse_inv.shape == jM.coarse_inv.shape
    assert (M.smoother, M.cheb_deg, M.nu, M.cycle) == (jM.smoother, jM.cheb_deg,
                                                       jM.nu, jM.cycle)
    np.testing.assert_allclose(M.rhos, jM.rhos, rtol=1e-12)
    np.testing.assert_allclose(M.coarse_inv.numpy(), np.asarray(jM.coarse_inv),
                               rtol=0, atol=1e-12 * np.abs(np.asarray(jM.coarse_inv)).max())
    r = np.random.RandomState(6).rand(b.shape[0]) - 0.5
    want = np.asarray(jM.apply(jnp.asarray(r)))
    np.testing.assert_allclose(M.apply(torch.as_tensor(r)).numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    bj, j = make_precond(A, "block-jacobi"), make_precond(A, "jacobi")
    assert isinstance(bj, Precond) and bj.kind == "block-jacobi"
    np.testing.assert_allclose(bj.apply(torch.as_tensor(r)).numpy(),
                               j.apply(torch.as_tensor(r)).numpy(), rtol=1e-15)
    # a near-nullspace is for block systems: this scalar one ignores it,
    # as JAX's build_amg does
    Mn = make_precond(A, "amg", nullspace=np.ones((b.shape[0], 1)))
    assert Mn.rhos == M.rhos and torch.equal(Mn.coarse_inv, M.coarse_inv)
    with pytest.raises(ValueError):
        make_precond(A, "ilu")


@pytest.mark.parametrize("action", ["dump", "raise", "ignore"])
def test_fail_actions_match_jax(finalized, tmp_path, monkeypatch, action):
    """max_iter 3 to rtol 1e-14: "dump" warns and writes the JAX dump's
    arrays into $AFEM_SOLVE_DEBUG_DIR, "raise" also raises, "ignore" does
    neither; x equals JAX's after the same 3 iterations."""
    A, b, x0, jA, jb, jx0 = finalized
    opts = dict(preconditioner="jacobi", rtol=1e-14, max_iter=3, fail_action=action)
    got = {}
    for who, solve, args, sub in (("port", solve_finalized, (A, b), "port"),
                                  ("jax", jax_solve, (jA, jb), "jax")):
        d = tmp_path / sub
        d.mkdir()
        monkeypatch.setenv("AFEM_SOLVE_DEBUG_DIR", str(d))
        Opts = SolverOptions if who == "port" else JaxOptions
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if action == "raise":
                with pytest.raises(RuntimeError, match="failed to converge"):
                    solve(*args, Opts(**opts), x0 if who == "port" else jx0)
            else:
                x, info = solve(*args, Opts(**opts), x0 if who == "port" else jx0)
                got[who + "_x"] = np.asarray(x)
        assert any("did NOT converge" in str(m.message) for m in w) == (action != "ignore")
        files = list(d.iterdir())
        assert [f.name for f in files] == ([] if action == "ignore"
                                           else ["SolveErrorMatrix.npz"])
        if files:
            got[who] = dict(np.load(files[0]))
    if action != "ignore":
        p, j = got["port"], got["jax"]
        assert sorted(p) == sorted(j)
        for k in j:
            if k == "residual":  # the monitored residual after 3 iterations
                np.testing.assert_allclose(p[k], j[k], rtol=1e-12)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    if action != "raise":
        np.testing.assert_allclose(got["port_x"], got["jax_x"], rtol=0,
                                   atol=1e-12 * np.abs(got["jax_x"]).max())


def test_solver_options_defaults_match_jax():
    """Every default of JAX's options, ``gmres_restart`` included since
    gmres is ported."""
    assert dataclasses.asdict(SolverOptions()) == dataclasses.asdict(JaxOptions())
