"""solver/iterative.py's bicgstab, bicgstab2, gmres (restart 5 and 30),
pcg_pair and pcg_flex, and their routing through solve_finalized, against
the JAX package on the CPU.

The systems are those of ``tests/test_solvers.py``: the Poisson system of
``_poisson_system`` (a 6x6 rect, f = 3, Dirichlet 1.5 on the left and
-0.5 on the right) with penalty rows (symmetric) and with row elimination
(nonsymmetric), and the skewed dense operator of
``test_bicgstab2_nonsymmetric_system``.  Both packages get the same
finalized system: the JAX package's values, here in the port's SELL
storage.  float64: x within 1e-10 of max|x| and iterations ± 1.  float32
with the compensated dots: iterations ± 1, the final monitored residual
below rtol on both sides and x within 1e-4 of max|x|.

Two float32 paths on the 6x6 penalty system take their counts from the
SpMV's rounding: the port's K1 and its plain twin accumulate each row in
float64, the JAX BellMatrix.spmv in float32.  On the port's SELL matrix
GMRES(5) takes 24 iterations to JAX's 34, and BiCGStab(2) reaches the
singular GCR(2) step that its ``bicgstab2`` docstring describes (JAX's
arithmetic would give NaN there).  Through an operator with JAX's float32
rounding both take JAX's iterations ± 1; through the SELL matrix both
converge, no less accurately than JAX."""

import warnings
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.solver import iterative as jit_
from arcanefem_tpu.solver.linear_system import SolverOptions as JaxOptions
from arcanefem_tpu.solver.linear_system import solve_finalized as jax_solve
from arcanefem_tpu_torch.fem.arc import parse_solver
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.solver import iterative as it
from arcanefem_tpu_torch.solver.linear_system import SolverOptions, solve_finalized
from arcanefem_tpu_torch.sparse.bell import BellMatrix


def _poisson(method: str, penalty: float):
    """(port A, b, x0, JAX A, b, x0) of test_solvers' _poisson_system."""
    jprob = JaxProblem(jax_rect(6, 6), ndof=1)
    prob = FemProblem(rect_tria_mesh(6, 6), device="cpu")
    js = jprob.new_system(jprob.assemble_matrix(lambda ct, xyz: jel.stiffness(ct, xyz)))
    js.rhs = jprob.constant_source_rhs(3.0)
    jprob.apply_dirichlet(js, jprob.group_dofs("left"), 1.5, method, penalty)
    jprob.apply_dirichlet(js, jprob.group_dofs("right"), -0.5, method, penalty)
    jA, jb = js.finalized()
    jx0 = js.initial_guess()
    lay = prob.layout
    vals = np.asarray(jA.values).reshape(prob.topo.n_nodes, prob.topo.width)
    diag = torch.as_tensor(lay.ell_to_sell[prob.topo.diag_slot.astype(np.int64)])
    A = BellMatrix(lay.from_ell(vals), lay, diag)
    np.testing.assert_array_equal(A.todense().numpy(), np.asarray(jA.todense()))
    return A, torch.tensor(np.asarray(jb)), torch.tensor(np.asarray(jx0)), jA, jb, jx0


class _Dense:
    """y = D x (the port's side of the JAX test's DenseOp)."""

    def __init__(self, D):
        self.D = D

    def spmv(self, x):
        return self.D @ x


@jax.tree_util.register_pytree_node_class
class _JaxDense:
    def __init__(self, D):
        self.D = jnp.asarray(D)

    def spmv(self, x):
        return self.D @ x

    def tree_flatten(self):
        return ((self.D,), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


def _nonsym():
    """test_bicgstab2_nonsymmetric_system's skewed operator, zero guess."""
    A, b, _x0, _jA, jb, _jx0 = _poisson("RowElimination", 1e30)
    dense = A.todense().numpy()
    n = dense.shape[0]
    rng = np.random.RandomState(3)
    skew = np.triu(rng.rand(n, n) * (np.abs(dense) > 0), 1) * 0.3
    D = dense + skew - skew.T
    return (_Dense(torch.tensor(D)), b, torch.zeros_like(b), _JaxDense(D), jb,
            jnp.zeros_like(jb))


def _system(name: str, dtype):
    if name == "nonsym":
        sysm = _nonsym()
    else:
        sysm = _poisson("Penalty" if name == "penalty" else "RowElimination",
                        1e30 if dtype == np.float64 else 1e12)
    A, b, x0, jA, jb, jx0 = sysm
    if dtype == np.float32:
        if name == "nonsym":
            A, jA = _Dense(A.D.float()), _JaxDense(np.asarray(jA.D, np.float32))
        else:
            A = A.with_values(A.values.float())
            jA = jA.with_values(jA.values.astype(jnp.float32))
        b, x0 = b.float(), x0.float()
        jb, jx0 = jb.astype(jnp.float32), jx0.astype(jnp.float32)
    if name == "nonsym":
        M, jM = it.Precond("none"), jit_.Precond(data=(), kind="none")
    else:
        M, jM = it.make_precond(A, "jacobi"), jit_.make_precond(jA, "jacobi")
    return A, b, x0, M, jA, jb, jx0, jM


SOLVERS = {
    "bicgstab": (it.bicgstab, jit_.bicgstab, {}),
    "bicgstab2": (it.bicgstab2, jit_.bicgstab2, {}),
    "gmres5": (it.gmres, jit_.gmres, {"restart": 5}),
    "gmres30": (it.gmres, jit_.gmres, {"restart": 30}),
    "pcg_pair": (it.pcg_pair, jit_.pcg_pair, None),
    "pcg_flex": (it.pcg_flex, jit_.pcg_flex, None),
}
CASES = [(s, m) for s in ("penalty", "rowelim", "nonsym") for m in SOLVERS
         if not (m.startswith("pcg") and s != "penalty")]


def _run(solver, name, dtype, rtol):
    A, b, x0, M, jA, jb, jx0, jM = _system(name, dtype)
    fn, jfn, kw = SOLVERS[solver]
    if kw is None:  # pcg_pair and pcg_flex: always the compensated dots
        args = {}
    else:
        args = dict(kw, use_precise_dot=dtype == np.float32)
    x, k, rel = fn(A, b, M, x0, rtol, 0.0, 2000, **args)
    jx, jk, jrel = jfn(jA, jb, jM, jx0, rtol, 0.0, 2000, **args)
    return x, k, rel, np.asarray(jx), int(jk), float(jrel)


@pytest.mark.parametrize("name,solver", CASES)
def test_krylov_matches_jax_float64(name, solver):
    x, k, rel, jx, jk, jrel = _run(solver, name, np.float64, 1e-11)
    assert x.dtype == torch.float64 and x.shape == jx.shape
    err = np.abs(x.numpy() - jx).max() / np.abs(jx).max()
    assert err <= 1e-10, err
    assert abs(k - jk) <= 1, (k, jk)
    assert rel <= 1e-11 and jrel <= 1e-11


# the two float32 paths whose counts the SpMV's rounding sets (module docstring)
SPMV_ROUNDING_PATHS = [("penalty", "bicgstab2"), ("penalty", "gmres5")]


class _JaxRoundingSpmv:
    """y = A x with the JAX BellMatrix.spmv's rounding: each row's
    products accumulated in the values' dtype, in slot order (bit-equal to
    the JAX einsum on these systems; K1 and its twin accumulate in
    float64)."""

    def __init__(self, jA, n_rows: int):
        self.values = torch.tensor(np.asarray(jA.values)).reshape(n_rows, -1)
        self.cols = torch.tensor(np.asarray(jA.topo.ell_cols)).long()

    def spmv(self, x):
        y = torch.zeros(self.values.shape[0], dtype=x.dtype)
        for w in range(self.values.shape[1]):
            y = y + self.values[:, w] * x[self.cols[:, w]]
        return y


@pytest.mark.parametrize("name,solver", [c for c in CASES if c not in SPMV_ROUNDING_PATHS])
def test_krylov_matches_jax_float32_precise(name, solver):
    rtol = 1e-6
    x, k, rel, jx, jk, jrel = _run(solver, name, np.float32, rtol)
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    assert abs(k - jk) <= 1, (k, jk)
    assert rel <= rtol and jrel <= rtol, (rel, jrel)
    assert np.abs(x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()


@pytest.mark.parametrize("name,solver", SPMV_ROUNDING_PATHS)
def test_float32_penalty_paths_match_jax_on_its_spmv_rounding(name, solver):
    """The two float32 paths of the module docstring.  Through JAX's SpMV
    rounding: JAX's iterations ± 1.  Through the port's SELL matrix and
    through it: the monitored residual below rtol, x finite and within 1e-4
    of max|x| of JAX's, and the true residual on the free rows (float64)
    no larger than that of JAX's x."""
    rtol = 1e-6
    A, b, x0, M, jA, jb, jx0, jM = _system(name, np.float32)
    fn, jfn, kw = SOLVERS[solver]
    jx, jk, jrel = jfn(jA, jb, jM, jx0, rtol, 0.0, 2000, use_precise_dot=True, **kw)
    jx = np.asarray(jx)
    assert float(jrel) <= rtol
    A64, b64 = A.with_values(A.values.double()), b.double()
    free = A.diagonal() < 1e6  # the rows without a penalty

    def free_residual(x):
        r = b64 - A64.spmv(torch.as_tensor(np.array(x)).double())
        return float(torch.linalg.vector_norm(r[free]) / torch.linalg.vector_norm(b64[free]))

    jax_rounding = _JaxRoundingSpmv(jA, A.n_nodes)
    np.testing.assert_array_equal(jax_rounding.spmv(b).numpy(), np.asarray(jA.spmv(jb)))
    for op in (jax_rounding, A):
        x, k, rel = fn(op, b, M, x0, rtol, 0.0, 2000, use_precise_dot=True, **kw)
        assert bool(torch.isfinite(x).all()) and rel <= rtol, (k, rel)
        assert np.abs(x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
        if op is A:
            assert free_residual(x) <= free_residual(jx), (k, int(jk))
        else:
            assert abs(k - int(jk)) <= 1, (k, int(jk))


def test_precise_dot_rows_is_precise_dot_per_row():
    rng = np.random.RandomState(4)
    for dtype in (torch.float32, torch.float64):
        V = torch.tensor(rng.standard_normal((7, 1000)), dtype=dtype)
        w = torch.tensor(rng.standard_normal(1000), dtype=dtype)
        rows = it.precise_dot_rows(V, w)
        for i in range(7):
            assert torch.equal(rows[i], it.precise_dot(V[i], w))


METHODS = ("bicgstab", "bicgstab2", "gmres")


@pytest.mark.parametrize("spmv", ["pallas", "xla"])
@pytest.mark.parametrize("method", METHODS)
def test_solve_finalized_routes_like_jax(method, spmv):
    """solve_finalized on the row-eliminated Poisson system with Jacobi, on
    the kernel route and on the plain SELL twin (the same on the CPU): in
    float64 x within 1e-10 of max|x| of JAX's solve_finalized, iterations
    ± 1; in float32 (compensated dots, gmres restart 5) iterations ± 1 and
    both monitored residuals below rtol; the true residual is reported."""
    for dtype, rtol in ((np.float64, 1e-11), (np.float32, 1e-6)):
        A, b, x0, _M, jA, jb, jx0, _jM = _system("rowelim", dtype)
        opts = dict(method=method, rtol=rtol, preconditioner="jacobi",
                    gmres_restart=5 if dtype == np.float32 else 30)
        x, info = solve_finalized(A, b, SolverOptions(spmv=spmv, **opts), x0)
        jx, jinfo = jax_solve(jA, jb, JaxOptions(**opts), jx0)
        jx = np.asarray(jx)
        assert abs(info["iterations"] - int(jinfo["iterations"])) <= 1
        assert info["residual"] <= rtol and float(jinfo["residual"]) <= rtol
        assert info["true_residual"] <= 100 * rtol
        assert {"precond_setup_s", "solve_s"} <= set(info)
        if dtype == np.float64:
            err = np.abs(x.numpy() - jx).max() / np.abs(jx).max()
            assert err <= 1e-10, err


@pytest.mark.parametrize("action", ["dump", "raise", "ignore"])
@pytest.mark.parametrize("method", ("cg",) + METHODS)
def test_non_finite_solve_fails(method, action, tmp_path, monkeypatch):
    """A residual that is not finite ends every Krylov loop at once, below
    max_iter; solve_finalized takes it as a failure under fail_action: "dump"
    warns and writes the system, "raise" also raises, "ignore" returns it."""
    monkeypatch.setenv("AFEM_SOLVE_DEBUG_DIR", str(tmp_path))
    A, b, x0, _M, *_ = _system("rowelim", np.float64)
    b = b.clone()
    b[3] = float("nan")
    opts = SolverOptions(method=method, preconditioner="jacobi", fail_action=action)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        if action == "raise":
            with pytest.raises(RuntimeError, match="not finite"):
                solve_finalized(A, b, opts, x0)
        else:
            _x, info = solve_finalized(A, b, opts, x0)
            assert info["iterations"] < opts.max_iter and np.isnan(info["residual"])
    assert any("not finite" in str(m.message) for m in w) == (action != "ignore")
    assert [f.name for f in tmp_path.iterdir()] == (
        [] if action == "ignore" else ["SolveErrorMatrix.npz"])


def test_gmres_restart_option_reaches_gmres():
    A, b, x0, *_ = _system("rowelim", np.float64)
    its = {m: solve_finalized(A, b, SolverOptions(method="gmres", rtol=1e-11,
                                                  gmres_restart=m), x0)[1]["iterations"]
           for m in (3, 60)}
    A64, b64 = A, b
    want = {m: it.gmres(A64, b64, it.make_precond(A64, "jacobi"), x0, 1e-11, 0.0,
                        1000, restart=m)[1] for m in (3, 60)}
    assert its == want and its[3] != its[60]


def _amg_system(n=8):
    """tests/test_amg.py's _poisson_system on the port: an n^3 box, penalty
    rows on every boundary node (1 on x = 1, else 0), f = 1 inside."""
    mesh = box_tetra_mesh(n, n, n)
    prob = FemProblem(mesh, device="cpu")
    A = prob.stiffness_matrix()
    bnodes = np.unique(np.concatenate([c.ravel() for c in mesh.boundary_faces().values()]))
    gv = np.zeros(mesh.n_nodes)
    gv[mesh.coords[:, 0] > 1.0 - 1e-9] = 1.0
    mask = np.zeros(mesh.n_nodes, bool)
    mask[bnodes] = True
    vals = A.values.clone()
    d = A.diag_slot
    vals[d] = torch.where(torch.as_tensor(mask), 1e30, vals[d])
    A = A.with_values(vals)
    rhs = torch.where(torch.as_tensor(mask), 1e30 * torch.as_tensor(gv), 1.0)
    return A, rhs, torch.as_tensor(np.where(mask, gv, 0.0))


def test_pcg_pair_and_flex_match_pcg():
    """The port's counterpart of tests/test_amg.py::
    test_pcg_pair_and_flex_match_pcg: with the AMG preconditioner both
    reformulations give pcg's solution and comparable iterations."""
    A, rhs, x0 = _amg_system()
    M = it.make_precond(A, "amg")
    x, k, _ = it.pcg(A, rhs, M, x0, 1e-10, 0.0, 3000, use_precise_dot=True)
    xp, kp, _ = it.pcg_pair(A, rhs, M, x0, 1e-10, 0.0, 3000)
    xf, kf, _ = it.pcg_flex(A, rhs, M, x0, 1e-10, 0.0, 3000)
    assert abs(kp - k) <= 2 and abs(kf - k) <= 2
    np.testing.assert_allclose(xp.numpy(), x.numpy(), atol=2e-7)
    np.testing.assert_allclose(xf.numpy(), x.numpy(), atol=2e-7)


def test_arc_solver_method_routing():
    """The port's counterpart of tests/test_solvers.py::
    test_arc_solver_method_routing: each Aleph solver-method selects its
    method, in the port's parse_solver and in solve_finalized."""
    def fem_with(method):
        return ET.fromstring(
            "<fem><linear-system name='AlephLinearSystem'>"
            f"<solver-method>{method}</solver-method>"
            "</linear-system></fem>"
        )

    for name in METHODS:
        assert parse_solver(fem_with(name)).method == name
    A, b, x0, *_ = _system("rowelim", np.float64)
    for name in METHODS:
        opts = parse_solver(fem_with(name))
        x, info = solve_finalized(A, b, opts, x0)
        fn = {"bicgstab": it.bicgstab, "bicgstab2": it.bicgstab2,
              "gmres": it.gmres}[name]
        xd, kd, _ = fn(A, b, it.make_precond(A, opts.preconditioner), x0, opts.rtol,
                       opts.atol, opts.max_iter)
        assert info["iterations"] == kd and torch.equal(x, xd)
