"""The Heat codename, checkpoint/resume, the temporal VTKHDF output and the
fixed-order sums of ``FemProblem`` on the CPU in float64, beside the JAX
package.

Cases written by the tests (``tools/write_msh.py``) run through the
port's ``run_case(device="cpu")`` and the JAX ``run_case``: Dirichlet by
Penalty and by RowElimination, convection (``add_face_matrix``), a
constant ``qdot``; both ``mass_rhs`` modes and a callable ``qdot`` through
each package's ``solve``.  T within 1e-10 of its largest magnitude, the
steps equal, each step's iterations within one of JAX's (read through a
wrapper of the JAX module's ``solve_finalized``).  Checkpoints cross the
two packages exactly, a resumed run equals the continuous one to 1e-9,
and the port's temporal file holds JAX's datasets to 1e-10.  The RHS and
face-matrix sums equal an ``index_add`` of the same contributions within
1e-15 of the largest entry and the JAX ``.at[].add`` within 1e-12."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.fem import checkpoint as jax_checkpoint
from arcanefem_tpu.fem.bcs import BoundaryConditions as JaxBCs
from arcanefem_tpu.fem.bcs import DirichletBC as JaxDirichlet
from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.models import heat as jax_heat
from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.solver.linear_system import SolverOptions as JaxOptions
from arcanefem_tpu_torch.fem import checkpoint
from arcanefem_tpu_torch.fem.bcs import BoundaryConditions, DirichletBC
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.models import heat
from arcanefem_tpu_torch.ops import elements as el
from arcanefem_tpu_torch.solver.linear_system import SolverOptions
from arcanefem_tpu_torch.tools import heat_floor
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

h5py = pytest.importorskip("h5py")

TOL = 1e-10
HEAT = {"lambda": 1.5, "dt": 0.05, "tmax": 0.3, "Tinit": 0.25}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("heat_cases") / "inputs"
    d.mkdir()
    write_msh(str(d / "rect.msh"), rect_tria_mesh(16, 10, lx=2.0, ly=1.0))
    return d


@pytest.fixture
def jax_iterations(monkeypatch):
    """Each step's iterations of the JAX heat solve."""
    its = []
    real = jax_heat.solve_finalized

    def wrapped(*a, **kw):
        x, info = real(*a, **kw)
        its.append(int(info["iterations"]))
        return x, info

    monkeypatch.setattr(jax_heat, "solve_finalized", wrapped)
    return its


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, (what, err)


HEAT_CASES = [  # name, values, dirichlet_bc, blocks
    ("penalty_qdot", {**HEAT, "qdot": 2.0}, [("left", 1.0)], []),
    ("rowelim_convection", {**HEAT, "enforce-Dirichlet-method": "RowElimination"},
     [("left", 1.0)],
     [("convection-boundary-condition", {"surface": "right", "h": 3.0, "Text": 0.5})]),
    ("penalty_convection_qdot", {**HEAT, "qdot": -1.0}, [("bottom", 0.0)],
     [("convection-boundary-condition", {"surface": "top", "h": 2.0, "Text": 1.5}),
      ("convection-boundary-condition", {"surface": "right", "h": 0.5, "Text": -1.0})]),
]


def _write(d, name, values, dirichlet_bc, blocks, **kw):
    path = str(d / f"{name}.arc")
    write_arc(path, "rect.msh", codename="Heat", values=values, dirichlet_bc=dirichlet_bc,
              blocks=blocks, **kw)
    return path


@pytest.mark.parametrize("name,values,dirichlet_bc,blocks", HEAT_CASES,
                         ids=[c[0] for c in HEAT_CASES])
def test_heat_case_matches_jax(case_dir, jax_iterations, name, values, dirichlet_bc, blocks):
    path = _write(case_dir, name, values, dirichlet_bc, blocks)
    res, jres = run_case(path, device="cpu"), jax_run_case(path)
    assert res.steps == jres.steps == 6
    assert res.T.dtype == np.float64
    _close(res.T, jres.T, f"{name} T")
    for ct in res.flux:
        _close(res.flux[ct], jres.flux[ct], f"{name} flux")
    assert len(res.step_iterations) == len(jax_iterations) == 6
    assert all(abs(a - b) <= 1 for a, b in zip(res.step_iterations, jax_iterations)), (
        res.step_iterations, jax_iterations)
    assert res.info["free_residual"] < 1e-6


def _q_torch(x, y, z, t):
    return (1.0 + x * y) * torch.exp(torch.as_tensor(-t, dtype=x.dtype)) * torch.sin(np.pi * x)


def _q_jax(x, y, z, t):
    return (1.0 + x * y) * jnp.exp(-t) * jnp.sin(np.pi * x)


@pytest.mark.parametrize("mass_rhs", ["lumped", "consistent"])
def test_heat_solve_matches_jax(mass_rhs, jax_iterations):
    """Both mass_rhs modes with a callable (manufactured) qdot, Dirichlet
    on all sides, and a convection side, through each package's solve."""
    mesh, jmesh = rect_tria_mesh(12, 9), jax_rect(12, 9)
    sides = ("left", "bottom", "top")
    cfg = heat.HeatConfig(
        lam=0.8, qdot=_q_torch, dt=0.02, tmax=0.1, mass_rhs=mass_rhs,
        bcs=BoundaryConditions(dirichlet=[DirichletBC(s, value=0.0) for s in sides]),
        convection=[heat.ConvectionBC("right", 2.0, 0.1)],
        solver=SolverOptions(rtol=1e-12))
    jcfg = jax_heat.HeatConfig(
        lam=0.8, qdot=_q_jax, dt=0.02, tmax=0.1, mass_rhs=mass_rhs,
        bcs=JaxBCs(dirichlet=[JaxDirichlet(s, value=0.0) for s in sides]),
        convection=[jax_heat.ConvectionBC("right", 2.0, 0.1)],
        solver=JaxOptions(rtol=1e-12))
    T0 = np.sin(np.pi * mesh.coords[:, 0]) * np.sin(np.pi * mesh.coords[:, 1])
    res = heat.solve(mesh, cfg, T0=T0, keep_history=True, device="cpu")
    jres = jax_heat.solve(jmesh, jcfg, T0=T0, keep_history=True)
    assert res.steps == jres.steps == 5 and len(res.history) == len(jres.history) == 5
    for (t, T), (jt, jT) in zip(res.history, jres.history):
        assert t == jt
        _close(T, jT, f"{mass_rhs} history")
    _close(res.T, jres.T, f"{mass_rhs} T")
    assert all(abs(a - b) <= 1 for a, b in zip(res.step_iterations, jax_iterations))
    with pytest.raises(ValueError, match="mass_rhs"):
        heat.solve(mesh, heat.HeatConfig(mass_rhs="bogus"), device="cpu")


def test_float32_free_residual_is_the_dtype_floor():
    """T2 (a)'s configuration (``tools/heat_floor.py``) on 64² and 128²
    rects: the float32 free-row residual and field error are the dtype's,
    not the solver's.  AMG and Jacobi give the same float32 free residual
    and field error (within 10%), which grow more than 2x from 64² to 128²
    (the mass term M/dt is ~h²/dt of the stiffness, so float32 keeps fewer
    of its digits as h falls); float64 with the same options stays below
    2e-5 free and 1e-6 of a 1e-13 solve; on 128² the port's float32 field
    error is of the order of the JAX package's float32 one (Jacobi, within
    a factor 4)."""
    lines = {n: heat_floor.measure(n, "cpu") for n in (64, 128)}
    for n, line in lines.items():
        f32a, f32j, f64 = line["float32_amg"], line["float32_jacobi"], line["float64_amg"]
        assert f64["free_residual"] <= 2e-5 and f64["field_error"] <= 1e-6, line
        for key in ("free_residual", "field_error"):
            assert abs(f32a[key] - f32j[key]) <= 0.1 * f32a[key], line
    for key in ("free_residual", "field_error"):
        assert lines[128]["float32_amg"][key] > 2 * lines[64]["float32_amg"][key], lines
    cfg = heat_floor.config()
    ref = heat.solve(rect_tria_mesh(128, 128), heat_floor.config(rtol=1e-13), device="cpu").T
    jcfg = jax_heat.HeatConfig(
        lam=cfg.lam, qdot=cfg.qdot, dt=cfg.dt, tmax=cfg.tmax,
        bcs=JaxBCs(dirichlet=[JaxDirichlet("left", value=0.0)]),
        convection=[jax_heat.ConvectionBC("right", 2.0, 0.5)],
        solver=JaxOptions(method="cg", preconditioner="jacobi", rtol=1e-6, max_iter=50_000))
    j32 = jax_heat.solve(jax_rect(128, 128), jcfg, dtype=np.float32).T
    jax_err = float(np.abs(j32.astype(np.float64) - ref).max() / np.abs(ref).max())
    assert lines[128]["float32_jacobi"]["field_error"] <= 4 * jax_err, (lines[128], jax_err)


def test_checkpoint_crosses_packages(tmp_path):
    """The port's npz restored by JAX's restore exactly, JAX's npz by the
    port's, and tensors saved from the host in their dtype."""
    state = {"T": np.arange(7.0) / 3.0, "U": np.random.RandomState(0).rand(4, 3)}
    checkpoint.save(str(tmp_path / "port"), 0.75, 3,
                    {"T": torch.as_tensor(state["T"]), "U": state["U"]})
    t, step, got = jax_checkpoint.restore(str(tmp_path / "port"))
    assert (t, step) == (0.75, 3) and sorted(got) == ["T", "U"]
    for k in state:
        assert got[k].dtype == state[k].dtype and np.array_equal(got[k], state[k])
    # an npz in the JAX layout (its fallback form, which it writes where
    # orbax is missing)
    meta = {"t": 1.25, "step": 5, "keys": sorted(state)}
    np.savez(str(tmp_path / "jax.npz"), __meta__=json.dumps(meta), **state)
    t, step, got = checkpoint.restore(str(tmp_path / "jax"))
    assert (t, step) == (1.25, 5)
    for k in state:
        assert np.array_equal(got[k], state[k])


def test_heat_resume_matches_continuous(tmp_path):
    """Half a run, a checkpoint, the other half from the restored field:
    equal to the continuous run (as the JAX test_cli_checkpoint), and the
    JAX package resumes from the port's checkpoint to the same field."""
    mesh = rect_tria_mesh(8, 5)
    bcs = BoundaryConditions(dirichlet=[DirichletBC("left", 1.0)])

    def cfg(tmax):
        return heat.HeatConfig(lam=1.0, Tinit=0.0, dt=0.25, tmax=tmax, bcs=bcs,
                               solver=SolverOptions(rtol=1e-12))

    full = heat.solve(mesh, cfg(2.0), device="cpu")
    half = heat.solve(mesh, cfg(1.0), device="cpu")
    checkpoint.save(str(tmp_path / "ck"), 1.0, half.steps, {"T": half.T})
    t0, _s, st = checkpoint.restore(str(tmp_path / "ck"))
    resumed = heat.solve(mesh, cfg(2.0 - t0), T0=st["T"], device="cpu")
    np.testing.assert_allclose(resumed.T, full.T, rtol=1e-9, atol=1e-12)
    t0, _s, jst = jax_checkpoint.restore(str(tmp_path / "ck"))
    jres = jax_heat.solve(jax_rect(8, 5), jax_heat.HeatConfig(
        lam=1.0, Tinit=0.0, dt=0.25, tmax=2.0 - t0,
        bcs=JaxBCs(dirichlet=[JaxDirichlet("left", 1.0)]), solver=JaxOptions(rtol=1e-12)),
        T0=jst["T"])
    _close(resumed.T, jres.T, "resumed")


def test_temporal_vtkhdf_matches_jax(case_dir, tmp_path):
    """run_case(output_dir=...) of a heat case: one temporal VTKHDF file
    (the port keeps the history itself), its datasets equal to the JAX
    package's file (run with keep_history=True) to 1e-10, NSteps ==
    len(history), the last slab the final T."""
    path = _write(case_dir, "temporal", {**HEAT, "qdot": 1.0}, [("left", 0.0)], [],
                  post_processing=["NodeTemperature"])
    res = run_case(path, device="cpu", output_dir=str(tmp_path / "port"))
    jres = jax_run_case(path, output_dir=str(tmp_path / "jax"), keep_history=True)
    assert len(res.history) == len(jres.history) == 6
    with h5py.File(tmp_path / "port" / "temporal.hdf") as f, \
            h5py.File(tmp_path / "jax" / "temporal.hdf") as jf:
        g, jg = f["VTKHDF"], jf["VTKHDF"]
        assert g["Steps"].attrs["NSteps"] == jg["Steps"].attrs["NSteps"] == 6
        for name in ("Points", "Connectivity", "Offsets", "Types", "Steps/Values",
                     "Steps/PointDataOffsets/NodeTemperature"):
            assert np.array_equal(g[name][()], jg[name][()]), name
        data, jdata = g["PointData/NodeTemperature"][()], jg["PointData/NodeTemperature"][()]
        _close(data, jdata, "NodeTemperature")
        n = int(g["NumberOfPoints"][0])
        assert np.array_equal(data[-n:], res.T)


# --------------------------------------------------------------------------
# the fixed-order sums of FemProblem

def _problems(kind):
    if kind == "tria3":
        return (FemProblem(rect_tria_mesh(9, 7, lx=1.3), ndof=2, device="cpu"),
                JaxProblem(jax_rect(9, 7, lx=1.3), ndof=2), ("left", "top"))
    from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box

    return (FemProblem(box_tetra_mesh(4, 3, 3), ndof=3, device="cpu"),
            JaxProblem(jax_box(4, 3, 3), ndof=3), ("xmin", "ymax"))


def _index_add(prob, entries):
    """The old form: one index_add per (dofs, contributions)."""
    rhs = torch.zeros(prob.n_dofs, dtype=torch.float64)
    for dofs, contrib in entries:
        rhs = rhs.index_add(0, torch.as_tensor(dofs), contrib)
    return rhs


@pytest.mark.parametrize("kind", ["tria3", "tetra4"])
def test_fixed_order_sums_match(kind):
    prob, jprob, (g1, g2) = _problems(kind)
    b = prob.ndof
    f = (0.5, -1.25, 2.0)[:b]
    t = (1.5, None, -0.75)[:b]
    def check(got, old, want, what):
        got = got.numpy()
        top = np.abs(want).max()
        assert np.abs(got - old.numpy()).max() <= 1e-15 * top, what
        assert np.abs(got - np.asarray(want)).max() <= 1e-12 * top, what

    zeros, jzeros = torch.zeros(prob.n_dofs, dtype=torch.float64), jnp.zeros(prob.n_dofs)
    # constant source, body force
    entries = []
    for ct, conn in prob.mesh.cells.items():
        meas = el.measure(ct, prob.cell_xyz(ct))
        npc = conn.shape[1]
        entries.append((prob.dof_ids(conn.reshape(-1), 1),
                        torch.repeat_interleave(3.0 * meas / npc, npc)))
    check(prob.constant_source_rhs(3.0, comp=1), _index_add(prob, entries),
          jprob.constant_source_rhs(3.0, comp=1), "constant source")
    old = []
    for ct, conn in prob.mesh.cells.items():
        meas = el.measure(ct, prob.cell_xyz(ct))
        npc = conn.shape[1]
        old += [(prob.dof_ids(conn.reshape(-1), c), torch.repeat_interleave(fc * meas / npc, npc))
                for c, fc in enumerate(f)]
    check(prob.vector_source_rhs(zeros, f), _index_add(prob, old),
          jprob.vector_source_rhs(jzeros, f), "body force")
    # traction and Neumann (outward-oriented faces)
    from arcanefem_tpu_torch.fem.problem import _FACE_MEASURE, _FACE_NORMAL

    old = []
    for ftype, conn in prob.mesh.face_groups[g1].items():
        meas = _FACE_MEASURE[ftype](prob.face_xyz(conn))
        nfn = conn.shape[1]
        old += [(prob.dof_ids(conn.reshape(-1), c), torch.repeat_interleave(tc * meas / nfn, nfn))
                for c, tc in enumerate(t) if tc is not None]
    check(prob.traction_rhs(zeros, g1, t), _index_add(prob, old),
          jprob.traction_rhs(jzeros, g1, t), "traction")
    v = (0.3, -0.2, 0.9)
    old = []
    for ftype, conn in prob.oriented_group(g2).items():
        xyz = prob.face_xyz(conn)
        normal = _FACE_NORMAL[ftype](xyz)
        per = (normal @ torch.tensor(v[:normal.shape[1]], dtype=torch.float64)
               * _FACE_MEASURE[ftype](xyz))
        nfn = conn.shape[1]
        old.append((prob.dof_ids(conn.reshape(-1), 0), torch.repeat_interleave(per / nfn, nfn)))
    check(prob.neumann_rhs(zeros, g2, vector=v), _index_add(prob, old),
          jprob.neumann_rhs(jzeros, g2, vector=v), "neumann")


def test_face_matrix_sum_matches():
    """add_face_matrix (scalar blocks at a component and full b×b blocks)
    against an index_add into the SELL slots and against JAX's
    add_face_matrix, read back as (N, W, b, b) blocks."""
    mesh, jmesh = rect_tria_mesh(7, 5), jax_rect(7, 5)
    prob, jprob = FemProblem(mesh, ndof=2, device="cpu"), JaxProblem(jmesh, ndof=2)
    A = prob.assemble_matrix(lambda ct, xyz: el.mass_blocks(ct, xyz, 2))
    jA = jprob.assemble_matrix(lambda ct, xyz: jel.mass_blocks(ct, xyz, 2))

    def full(ft, xyz):
        em = 3.0 * el.edge2_mass(xyz)
        return em[:, :, :, None, None] * torch.tensor([[1.0, 0.5], [0.25, 2.0]],
                                                      dtype=xyz.dtype)[None, None, None]

    def jfull(ft, xyz):
        em = 3.0 * jel.edge2_mass(xyz)
        return em[:, :, :, None, None] * jnp.array([[1.0, 0.5], [0.25, 2.0]])[None, None, None]

    B = prob.add_face_matrix(A, "right", lambda ft, xyz: 2.0 * el.edge2_mass(xyz), comp=1)
    B = prob.add_face_matrix(B, "top", full)
    jB = jprob.add_face_matrix(jA, "right", lambda ft, xyz: 2.0 * jel.edge2_mass(xyz), comp=1)
    jB = jprob.add_face_matrix(jB, "top", jfull)
    vals, _cols = B.block_ell()
    want = np.asarray(jB.values)
    top = np.abs(want).max()
    assert np.abs(vals - want).max() <= 1e-12 * top
    # the old index_add into the SELL slots (the same slots as the new sum)
    s = prob._sums[("face-matrix", ("top", "line2"), "full")]
    slots = s.ids.new_empty(s.ids.shape)
    slots[s.ids.long()] = torch.repeat_interleave(
        torch.arange(len(s.ptr) - 1, dtype=torch.int32), (s.ptr[1:] - s.ptr[:-1]).long())
    C = prob.add_face_matrix(A, "right", lambda ft, xyz: 2.0 * el.edge2_mass(xyz), comp=1)
    ke = full("line2", prob.face_xyz(mesh.face_groups["top"]["line2"])).reshape(-1)
    old = C.values.index_add(0, slots.long(), ke)
    assert torch.abs(B.values - old).max() <= 1e-15 * top
