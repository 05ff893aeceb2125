"""The transient helpers (fem/casetable.py, fem/transient.py) and the
elastodynamics coefficients against the JAX package on the CPU in
float64: ``CaseTable.value`` and ``read_case_table`` bit for bit (inside,
at and outside the table's times, on repeated times), ``FrozenBC``
(``apply``, ``dirichlet_values``, ``warm_start``) for each Dirichlet
method bit for bit, ``anchor_atol`` for CG and GMRES, and
``newmark_coefficients`` for both schemes and damping formulations."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.fem.casetable import CaseTable as JaxTable
from arcanefem_tpu.fem.casetable import read_case_table as jax_read
from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.fem.transient import anchor_atol as jax_anchor
from arcanefem_tpu.fem.transient import freeze_bcs as jax_freeze
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.models import elastodynamics as jed
from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.solver.iterative import make_precond as jax_make_precond
from arcanefem_tpu_torch.fem.casetable import CaseTable, read_case_table
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.fem.transient import anchor_atol, freeze_bcs
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.models import elastodynamics as ed
from arcanefem_tpu_torch.ops import elements as el
from arcanefem_tpu_torch.solver.iterative import make_precond

METHODS = ("Penalty", "WeakPenalty", "RowElimination", "RowColumnElimination")


def _table(seed, repeat=False):
    rng = np.random.RandomState(seed)
    times = np.sort(rng.rand(9)) * 3.0
    if repeat:
        times[4] = times[3]  # a step in the series
    return times, rng.rand(9, 3) - 0.5


@pytest.mark.parametrize("repeat", [False, True], ids=["plain", "repeated_time"])
def test_case_table_matches_jax_bit_for_bit(repeat, tmp_path):
    times, values = _table(3, repeat)
    t = np.concatenate([np.linspace(-1.0, 4.0, 301), times, np.random.RandomState(4).rand(50) * 3])
    tab, jtab = CaseTable(times, values), JaxTable(times, values)
    for x in t:
        got, want = tab.value(float(x)), np.asarray(jtab.value(float(x)))
        assert got.dtype == np.float64 and got.shape == (3,)
        assert np.array_equal(got, want), (x, got, want)
    path = tmp_path / "table.txt"
    np.savetxt(path, np.column_stack([times, values]))
    r, jr = read_case_table(str(path), 3), jax_read(str(path), 3)
    assert np.array_equal(r.times, jr.times) and np.array_equal(r.values, jr.values)
    with pytest.raises(ValueError):
        read_case_table(str(path), 4)


def _systems(methods, values):
    """The elastodynamics LHS (c0 M + c1 D + c2 E) of both packages on a
    2D rect with Dirichlet groups set by ``methods``."""
    mesh, jmesh = rect_tria_mesh(12, 5, lx=3.0), jax_rect(12, 5, lx=3.0)
    prob, jprob = FemProblem(mesh, ndof=2, device="cpu"), JaxProblem(jmesh, ndof=2)
    out = []
    for p, elm in ((prob, el), (jprob, jel)):
        M = p.assemble_matrix(lambda ct, x: elm.mass_blocks(ct, x, 2))
        D = p.assemble_matrix(lambda ct, x: elm.divdiv(ct, x))
        E = p.assemble_matrix(lambda ct, x: elm.epseps(ct, x))
        s = p.new_system(M.with_values(40.0 * M.values + 1.5 * D.values + 2.5 * E.values))
        for k, m in enumerate(methods):
            g = ("left", "right", "top", "bottom")[k]
            p.apply_dirichlet_vector(s, p.mesh.group_nodes(g), values[k], m, 1e12)
        out.append((p, s))
    return out


@pytest.mark.parametrize("methods", [(m,) for m in METHODS] + [METHODS],
                         ids=[*METHODS, "all"])
def test_frozen_bc_matches_jax(methods):
    """freeze_bcs: the finalized matrix, and apply / dirichlet_values /
    warm_start on a random RHS and state, equal to JAX's bit for bit;
    anchor_atol for pcg and gmres to 1e-13."""
    values = [(0.0, 0.01), (None, -0.02), (0.03, None), (0.0, 0.0)]
    (prob, s), (jprob, js) = _systems(methods, values)
    # the same matrix values on both sides (assembly orders differ in ulps)
    js.matrix = js.matrix.with_values(jnp.asarray(s.matrix.block_ell()[0]))
    f, jf = freeze_bcs(s), jax_freeze(js)
    assert np.array_equal(f.A.todense().numpy(), np.asarray(jf.A.todense()))
    rng = np.random.RandomState(7)
    rhs, x = rng.rand(prob.n_dofs) - 0.5, rng.rand(prob.n_dofs) - 0.5
    for got, want in ((f.apply(torch.as_tensor(rhs)), jf.apply(jnp.asarray(rhs))),
                      (f.dirichlet_values, jf.dirichlet_values),
                      (f.warm_start(torch.as_tensor(x)), jf.warm_start(jnp.asarray(x)))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for mask in ("pen_mask", "elim_mask"):
        assert np.array_equal(getattr(f, mask).numpy(), np.asarray(getattr(jf, mask)))
    M, jM = make_precond(f.A, "jacobi"), jax_make_precond(jf.A, "jacobi")
    for method in ("pcg", "gmres"):
        a = anchor_atol(f.A, M, torch.as_tensor(rhs), torch.as_tensor(x), 1e-8, method)
        ja = jax_anchor(jf.A, jM, jnp.asarray(rhs), jnp.asarray(x), 1e-8, method)
        assert a == pytest.approx(ja, rel=1e-13, abs=0)


@pytest.mark.parametrize("scheme", ["Newmark-beta", "Generalized-alpha"])
@pytest.mark.parametrize("damping", ["stable", "reference"])
def test_newmark_coefficients_match_jax(scheme, damping):
    kw = dict(time_discretization=scheme, dt=0.03, rho=2.5, etam=0.02, etak=0.003,
              alpm=0.2, alpf=0.4, damping_formulation=damping)
    c, g, b = ed.newmark_coefficients(ed.ElastodynamicsConfig(**kw), 1.3, 0.7)
    jc, jg, jb = jed.newmark_coefficients(jed.ElastodynamicsConfig(**kw), 1.3, 0.7)
    assert c == jc and (g, b) == (jg, jb)
    with pytest.raises(ValueError):
        ed.newmark_coefficients(dataclasses.replace(ed.ElastodynamicsConfig(),
                                                    time_discretization="Euler"), 1.0, 1.0)
