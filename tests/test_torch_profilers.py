"""The port's iteration profilers and AMG set-up phase marks against the JAX
package on the CPU, in float64.

* ``tools/profile_unstr.py``: each probe's step (the component, then the
  renormalisation) on the JAX hierarchy of the h=8 bench sphere (8,324
  nodes), carried across with ``amg_from_numpy``, equals the step of JAX's
  ``tools/profile_unstr.py`` on the same hierarchy to 1e-12 of its largest
  value; ``components`` returns JAX's keys with finite, non-negative times.
* ``tools/profile_iter.py``: each op of both lists on the 16^3 bench box
  equals JAX's op to 1e-12, on all rows and on the free rows alone.  JAX's
  plain list runs its stencil operator on the TPU only, and its padded
  list reaches Pallas kernels with no CPU mode; as JAX's own tests hold
  them (tests/test_padded_mg.py), their reference here is the XLA
  ``DiaMatrix`` and the flat ``build_mg`` V-cycle (called eagerly, as
  tests/test_torch_multigrid.py does), with the padded vectors unpadded.
* ``AFEM_AMG_VERBOSE=1``: ``amg_setup`` then ``amg_from_numpy`` print the
  JAX ``build_amg``'s labels in its order (times not compared), plus the
  port's two host labels ``ell layouts`` and ``coarse_inv``.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.mesh.structured import apply_penalty_dirichlet as jax_penalty
from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.solver.iterative import precise_dot as jax_precise_dot
from arcanefem_tpu.solver.multigrid import build_mg as jax_build_mg
from arcanefem_tpu.solver.multigrid import prolong3 as jax_prolong3
from arcanefem_tpu.solver.multigrid import restrict3 as jax_restrict3
from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu_torch.bench_structured import PENALTY as BOX_PENALTY
from arcanefem_tpu_torch.bench_structured import Options, box_system
from arcanefem_tpu_torch.bench_unstructured import dirichlet_data, sphere_cut_system
from arcanefem_tpu_torch.solver.amg import amg_from_numpy
from arcanefem_tpu_torch.solver.amg_setup import amg_setup
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.tools import profile_amg_setup, profile_iter, profile_unstr

PENALTY = 1e30
TOL = 1e-12
BOX = 16


def _err(got, want, rows=None) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rows is not None:
        got, want = got[rows], want[rows]
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def sphere():
    """(JAX operator, flat values, topology) of the h=8 bench sphere (f64)."""
    mesh, topo = sphere_cut_system(8.0, 0, cache=False)
    vals = TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(mesh.coords.astype(np.float32)))
    mask, _, _ = dirichlet_data(mesh, PENALTY)
    flat = np.asarray(vals, np.float64).reshape(-1)
    flat[topo.diag_slot[mask]] = PENALTY
    A = JaxBell(values=jnp.asarray(flat.reshape(topo.n_nodes, topo.width, 1, 1)),
                topo=topo, block=1, cols=jnp.asarray(topo.ell_cols))
    return A, flat, topo


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


@pytest.fixture(scope="module")
def hierarchies(sphere):
    """(JAX A, JAX M, port A, port M, x0): one hierarchy in both packages."""
    A, flat, topo = sphere
    Mj = build_amg(A, smoother="chebyshev", cheb_deg=2, theta=0.03, values_np=flat)
    M = amg_from_numpy(_as_numpy(Mj), "cpu", torch.float64)
    Ap = BellMatrix.from_numpy(flat.reshape(topo.n_nodes, topo.width), topo.ell_cols,
                               device="cpu", dtype=torch.float64)
    x0 = np.random.RandomState(0).rand(topo.n_nodes)
    return A, Mj, Ap, M, x0


def _jax_unstr_steps(A, M) -> dict:
    """JAX's tools/profile_unstr.py probe bodies, by key."""
    def norm(y):
        return y / (jnp.linalg.norm(y) + 1e-30)

    steps = {"fine_spmv": lambda x: norm(A.spmv(x))}
    for l in range(1, len(M.mats)):
        steps[f"spmv_l{l}"] = lambda x, l=l: norm(M.mats[l].spmv(x))
    steps["transfer_pair_l0"] = lambda x: norm(M._transfer_up(0, M._transfer_down(0, x)))
    steps["cheb_smooth_l0"] = lambda x: norm(M._smooth_cheb(0, x))
    steps["vcycle"] = lambda x: norm(M.apply(x))
    steps["precise_dot"] = lambda x: norm(
        x * (jax_precise_dot(x, x) / (jax_precise_dot(x, x) + 1.0)))
    return steps


def test_profile_unstr_probes_match_jax(hierarchies):
    A, Mj, Ap, M, x0 = hierarchies
    want = _jax_unstr_steps(A, Mj)
    probes = profile_unstr.probes(Ap, M, torch.as_tensor(x0))
    assert [k for k, *_ in probes] == list(want)
    for key, _, fn, v in probes:
        got = profile_unstr.renormalised(fn)(v).numpy()
        assert _err(got, want[key](jnp.asarray(v.numpy()))) <= TOL, key


def test_profile_unstr_components_keys(hierarchies):
    _, _, Ap, M, x0 = hierarchies
    ms, model = profile_unstr.components(Ap, M, torch.as_tensor(x0), reps=1,
                                         verbose=False)
    assert list(ms) == ["fine_spmv", "spmv_l1", "transfer_pair_l0", "cheb_smooth_l0",
                        "vcycle", "precise_dot"]
    assert all(np.isfinite(v) and v >= 0 for v in ms.values()), ms
    assert model == pytest.approx(5 * ms["fine_spmv"] + ms["transfer_pair_l0"]
                                  + ms["spmv_l1"], rel=1e-12)


@pytest.fixture(scope="module")
def box():
    """The port's f64 16^3 bench box (no bf16 hierarchy bands) with both
    lists' systems, and the JAX operator, rhs and flat V-cycle on the same
    coordinates."""
    s = box_system(BOX, "cpu", torch.float64)
    systems = profile_iter.systems(s, Options(mg_bf16=False))
    jbox = JaxBox(BOX, BOX, BOX)
    c = jnp.asarray(s.coords3d.numpy())
    A, b = jax_penalty(jbox.assemble_stiffness(c, backend="xla"), jbox.source_rhs(c, 1.0),
                       jnp.asarray(s.mask), jnp.asarray(s.g), BOX_PENALTY)
    Mj = jax_build_mg(jbox, c, s.mask, BOX_PENALTY, nu=1, min_size=8)
    assert len(Mj.mats) == 2
    v = jnp.where(jnp.asarray(s.mask), jnp.asarray(s.g), 0.0) + 1e-3
    return s, systems, A, b, Mj, v


def _jax_iter_refs(A, b, Mj, v, mask) -> dict:
    """JAX's ops of both lists, on flat vectors (the XLA DiaMatrix and the
    flat V-cycle where JAX's reach a TPU kernel)."""
    Av = A.spmv(v)
    d = A.diagonal()
    invd = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0)
    s0, s1 = Mj.shapes[0], Mj.shapes[1]
    rc = jnp.where(Mj.masks[1], 0.0, jax_restrict3(v, s0, s1))
    xc = jnp.where(Mj.masks[1], 0.0, Mj._vcycle(1, rc))
    alpha = jax_precise_dot(v, Av) * 1e-9 + 1.0
    r = b - alpha * Av
    z = Mj.apply(r)
    common = {"precise_dot+axpy": v + jax_precise_dot(v, b) * 1e-9 * b,
              "plaindot+axpy": v + jnp.dot(v, b) * 1e-9 * b}
    plain = {"spmv A@x": Av, "residual b-Ax": b - Av,
             "jacobi sweep": v + 0.8 * (b - Av) / d, **common,
             "V-cycle apply": Mj.apply(v)}
    padded = {"cg body (no loop)": z + (jax_precise_dot(r, z) * 1e-9 + 1.0) * (v + alpha * Av),
              "vcycle apply": Mj.apply(v), "spmv_p": Av,
              "residual_p masked": (b - Av) * (1.0 - jnp.asarray(mask, v.dtype)),
              "jacobi_p sweep": v + 0.8 * invd * (b - Av),
              "smooth0 elementwise": 0.8 * invd * (b + 1e-9 * v),
              "restrict+prolong hop": v + 1e-9 * jax_prolong3(rc, s1, s0),
              "coarse chain (l>=1)": v + 1e-9 * jax_prolong3(xc, s1, s0), **common}
    return {"plain": plain, "padded": padded}


@pytest.mark.parametrize("which", ["plain", "padded"])
def test_profile_iter_ops_match_jax(box, which):
    s, systems, A, b, Mj, v = box
    want = _jax_iter_refs(A, b, Mj, v, s.mask)[which]
    ops = profile_iter.plain_ops() if which == "plain" else profile_iter.padded_ops()
    assert [name for name, _ in ops] == list(want)
    Ap, M, bp, vp, _ = systems[which]
    np.testing.assert_array_equal(
        (Ap.unpad_vec(vp) if which == "padded" else vp).numpy(), np.asarray(v))
    free = ~s.mask
    for name, op in ops:
        got = op(Ap, M, bp, vp)
        if which == "padded":
            got = Ap.unpad_vec(got)
        w = np.asarray(want[name])
        assert _err(got.numpy(), w) <= TOL, name
        assert _err(got.numpy(), w, free) <= TOL, name


def test_profile_iter_times_both_lists(box):
    s = box[0]
    out = profile_iter.run(s, Options(mg_bf16=False), verbose=False)
    for which, ops in (("plain", profile_iter.plain_ops()),
                       ("padded", profile_iter.padded_ops())):
        ms = out[which]["ms"]
        assert list(ms) == [name for name, _ in ops]
        assert all(np.isfinite(t) and t >= 0 for t in ms.values()), ms
        assert out[which]["measured_ms_per_iter"] > 0 and out[which]["iterations"] == 12


def _labels(text: str) -> list[str]:
    return [m.group(1) for m in map(re.compile(r"^\[amg\] +(\S.*?): [0-9.]+s$").match,
                                    text.splitlines()) if m]


def test_amg_verbose_labels_match_jax(sphere, monkeypatch):
    A, flat, topo = sphere
    monkeypatch.setenv("AFEM_AMG_VERBOSE", "1")
    jax_out, port_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        build_amg(A, smoother="chebyshev", cheb_deg=2, theta=0.03, values_np=flat)
    with contextlib.redirect_stdout(port_out):
        d = amg_setup(flat, topo, theta=0.03, smoother="chebyshev", cheb_deg=2)
        amg_from_numpy(d, "cpu", torch.float64)
    want, got = _labels(jax_out.getvalue()), _labels(port_out.getvalue())
    assert len(want) == 2 * 8 + 2 + 2  # two levels, their to_bell and transfers
    own = ["ell layouts", "coarse_inv"]
    assert [g for g in got if g not in own] == want
    assert got.index("ell layouts") == got.index("level 1 (642->52 dofs)") + 1
    assert got.index("coarse_inv") + 1 == got.index("to_bell[0] (n=8324)")
    rows, other = profile_amg_setup.phase_table(profile_amg_setup.parse(port_out.getvalue()))
    assert [r["level"] for r in rows] == [0, 1]
    assert all(set(r) == {"level", *profile_amg_setup.LEVEL_PHASES} for r in rows)
    assert set(other) == {"level 0 (8324->642 dofs)", "level 1 (642->52 dofs)", *own}


def test_amg_quiet_without_verbose(sphere, monkeypatch):
    _, flat, topo = sphere
    monkeypatch.delenv("AFEM_AMG_VERBOSE", raising=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        amg_from_numpy(amg_setup(flat, topo, theta=0.03, smoother="chebyshev",
                                 cheb_deg=2), "cpu", torch.float64)
    assert out.getvalue() == ""
