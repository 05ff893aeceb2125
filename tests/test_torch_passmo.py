"""The Passmo codename and its modules (``ops/faces.py``,
``ops/gauss_state.py``, ``quadrature.stiffness_blocks_iso`` /
``mass_blocks_iso``) on the CPU in float64, beside the JAX package.

Faces, Gauss state and block integrals on every cell type of the zoo to
1e-12.  ``solve`` on each configuration of the JAX
``tests/test_passmo_features.py`` and ``test_passmo.py``'s Generalized-α
checks (paraxial with outer and inner-cell properties, the incident wave
on and off, imposed U/V/A/F with constant values and curves, initial node
conditions, a double couple, recovery with initial cell tensors; some
runs cut to fewer steps), and a mixed hexa8 + pyramid5 + penta6 + tetra4
case file through both ``run_case``s (imposed U/V/A curves, paraxial with
a Ricker incident wave, Generalized-α, initial node conditions, the
recovered fields): u, v, a and the recovered fields within 1e-10 of their
largest magnitude."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.fem import casetable as jax_ct
from arcanefem_tpu.fem.bcs import BoundaryConditions as JaxBCs
from arcanefem_tpu.fem.bcs import DirichletBC as JaxDirichlet
from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.models import passmo as jax_pm
from arcanefem_tpu.ops import faces as jax_faces
from arcanefem_tpu.ops import quadrature as jax_q
from arcanefem_tpu.ops.gauss_state import GaussState as JaxGaussState
from arcanefem_tpu_torch.fem import casetable as ct
from arcanefem_tpu_torch.fem.bcs import BoundaryConditions, DirichletBC
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.core import read_msh
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.models import passmo as pm
from arcanefem_tpu_torch.ops import faces
from arcanefem_tpu_torch.ops import quadrature as Q
from arcanefem_tpu_torch.ops.gauss_state import GaussState
from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh, write_arc, write_msh

TOL = 1e-10
SQRT3 = math.sqrt(3.0)

# one reference element per cell type (ops/quadrature.py's zoo), and the
# face types of ops/faces.py
_H8 = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], float)
_HE = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3), (2, 6), (3, 7), (4, 5), (4, 7),
       (5, 6), (6, 7)]
NODES = {
    "line2": [[-1], [1]], "line3": [[-1], [1], [0]],
    "tria3": [[0, 0], [1, 0], [0, 1]],
    "tria6": [[0, 0], [1, 0], [0, 1], [0.5, 0], [0.5, 0.5], [0, 0.5]],
    "quad4": [[-1, -1], [1, -1], [1, 1], [-1, 1]],
    "quad8": [[-1, -1], [1, -1], [1, 1], [-1, 1], [0, -1], [1, 0], [0, 1], [-1, 0]],
    "tetra4": [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
    "tetra10": [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0, 0], [0.5, 0.5, 0],
                [0, 0.5, 0], [0, 0, 0.5], [0, 0.5, 0.5], [0.5, 0, 0.5]],
    "hexa8": _H8.tolist(),
    "hexa20": np.vstack([_H8] + [0.5 * (_H8[a] + _H8[b]) for a, b in _HE]).tolist(),
    "penta6": [[0, 0, -1], [1, 0, -1], [0, 1, -1], [0, 0, 1], [1, 0, 1], [0, 1, 1]],
    "pyramid5": [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0], [0, 0, 1]],
}
CELL_TYPES = [t for t in NODES if Q.REF_DIM[t] >= 2]
FACE_TYPES = ["line2", "line3", "tria3", "tria6", "quad4", "quad8"]


def _elements(t, n=5, seed=0):
    """n perturbed copies of t's reference element, in 3D."""
    nodes = np.asarray(NODES[t], float)
    xyz = np.zeros((n, len(nodes), 3))
    xyz[:, :, :nodes.shape[1]] = nodes
    rng = np.random.RandomState(seed)
    return xyz + 0.05 * rng.rand(*xyz.shape) * (np.arange(3) < max(nodes.shape[1], 2))


def _close(got, want, what, tol=TOL):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("t", CELL_TYPES)
def test_block_integrals_and_gauss_state_match_jax(t):
    """stiffness_blocks_iso / mass_blocks_iso with scalar and per-cell
    material, and GaussState (chunked) against JAX's, to 1e-12."""
    xyz = _elements(t)
    dim = Q.REF_DIM[t]
    lam = np.linspace(1.0, 2.0, len(xyz))
    x, jx = torch.as_tensor(xyz), jnp.asarray(xyz)
    for lm, mu in ((3.7, 1.9), (lam, 0.5 * lam)):
        _close(Q.stiffness_blocks_iso(t, x, lm, mu, dim),
               jax_q.stiffness_blocks_iso(t, jx, lm, mu, dim), f"{t} K", 1e-12)
    _close(Q.mass_blocks_iso(t, x, 2.5, dim), jax_q.mass_blocks_iso(t, jx, 2.5, dim),
           f"{t} M", 1e-12)
    # GaussState on a one-bucket mesh of these elements, two cells a chunk
    from arcanefem_tpu.mesh.core import Mesh as JaxMesh
    from arcanefem_tpu_torch.mesh.core import Mesh

    coords = xyz.reshape(-1, 3)
    conn = np.arange(len(coords), dtype=np.int32).reshape(len(xyz), -1)
    uids = np.arange(1, len(coords) + 1)
    st = GaussState.build(Mesh(coords, uids, {t: conn}, dim), torch.as_tensor(coords),
                          dim=dim, chunk=2)
    jst = JaxGaussState.build(JaxMesh(coords, uids, {t: conn}, dim), jnp.asarray(coords),
                              dim=dim)
    _close(st.buckets[t].grads, jst.buckets[t].grads, f"{t} grads", 1e-12)
    _close(st.buckets[t].wdet, jst.buckets[t].wdet, f"{t} wdet", 1e-12)
    lamc = torch.as_tensor(lam)[None]
    _close(st.stiffness_blocks(t, lamc, 0.5 * lamc),
           jst.stiffness_blocks(t, jnp.asarray(lam)[None], 0.5 * jnp.asarray(lam)[None]),
           f"{t} state K", 1e-12)
    _close(st.mass_blocks(t, 1.5 * lamc), jst.mass_blocks(t, 1.5 * jnp.asarray(lam)[None]),
           f"{t} state M", 1e-12)
    u = np.random.RandomState(1).rand(len(coords) * dim)
    _close(st.strain(t, conn, torch.as_tensor(u)), jst.strain(t, conn, jnp.asarray(u)),
           f"{t} strain", 1e-12)
    _close(st.stress(t, conn, torch.as_tensor(u), 2.0, 0.7),
           jst.stress(t, conn, jnp.asarray(u), 2.0, 0.7), f"{t} stress", 1e-12)


@pytest.mark.parametrize("t", FACE_TYPES)
def test_face_integrals_match_jax(t):
    xyz = _elements(t, seed=2)
    x, jx = torch.as_tensor(xyz), jnp.asarray(xyz)
    _close(faces.face_mass(t, x), jax_faces.face_mass(t, jx), f"{t} mass", 1e-12)
    _close(faces.face_load(t, x), jax_faces.face_load(t, jx), f"{t} load", 1e-12)
    _close(faces.face_gauss(t, x)[1], jax_faces.face_gauss(t, jx)[1], f"{t} wdet", 1e-12)


def _strip(mod, nx=20, ny=4, lx=2.0, ly=0.4):
    mesh = (rect_tria_mesh if mod is pm else jax_rect)(nx, ny, lx, ly)
    mesh.cell_groups["vol"] = {"tria3": mesh.cells["tria3"]}
    mesh.node_groups["all"] = np.arange(mesh.n_nodes)
    return mesh


def test_face_frames_and_cells_match_jax():
    """boundary_cells, face_frames and outward_normals on a strip and on
    the mixed box (whose prism and pyramid faces have no adjacent cell in
    either package), and paraxial_direction_matrix."""
    for mesh in (_strip(pm), mixed_box_mesh()):
        for name, groups in mesh.face_groups.items():
            for ft, conn in groups.items():
                assert faces.boundary_cells(mesh, conn) == jax_faces.boundary_cells(mesh, conn)
                for a, b in zip(faces.face_frames(mesh, ft, conn),
                                jax_faces.face_frames(mesh, ft, conn)):
                    assert np.array_equal(a, b), (name, ft)
    n = np.random.RandomState(3).randn(6, 3)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    rho = np.linspace(1.0, 2.0, 6)
    assert np.array_equal(faces.paraxial_direction_matrix(n, rho, 1.5, 3.0, 3),
                          jax_faces.paraxial_direction_matrix(n, rho, 1.5, 3.0, 3))


def _table(mod, times, values):
    return (ct if mod is pm else jax_ct).CaseTable(times=np.asarray(times),
                                                   values=np.asarray(values))


def _dc_mesh(mod):
    mesh = _strip(mod, 8, 8, lx=1.0, ly=1.0)
    for name, (x, y) in {"N": (0.5, 0.625), "S": (0.5, 0.375), "E": (0.625, 0.5),
                         "W": (0.375, 0.5)}.items():
        mesh.node_groups[name] = np.array(
            [int(np.linalg.norm(mesh.coords[:, :2] - [x, y], axis=1).argmin())])
    return mesh


def _tip_mesh(mod):
    mesh = _strip(mod, 10, 2, lx=1.0, ly=0.2)
    mesh.node_groups["tip"] = mesh.group_nodes("right")
    return mesh


# each configuration: the mesh and the PassmoConfig keywords, built from
# one package's module (pm or jax_pm); the JAX tests' long runs are cut
# to fewer steps (their tmax in the comment)
FEATURES = {
    "free_translation": (_strip, lambda P: dict(  # tmax 4.0
        init_nodes=[P.InitNodeCond("all", V=(1e-3, 0.0, 0.0))], tmax=0.4, dt=0.02)),
    "paraxial_outer": (_strip, lambda P: dict(  # tmax 4.0
        init_nodes=[P.InitNodeCond("all", V=(1e-3, 0.0, 0.0))],
        paraxial=[P.ParaxialCond("right", rho=1.0, cs=1.0, cp=SQRT3)], tmax=0.4, dt=0.02)),
    "paraxial_inner": (_strip, lambda P: dict(  # tmax 4.0
        init_nodes=[P.InitNodeCond("all", V=(1e-3, 0.0, 0.0))],
        paraxial=[P.ParaxialCond("right")], tmax=0.4, dt=0.02)),
    "incident_on": (_strip, lambda P: dict(
        paraxial=[P.ParaxialCond("left", rho=1.0, cs=1.0, cp=SQRT3, input_type=1,
                                 analytic=P.AnalyticInput(tp=0.2, amplit=1e-3))],
        tmax=0.3, dt=0.02)),
    "incident_off": (_strip, lambda P: dict(
        paraxial=[P.ParaxialCond("left", rho=1.0, cs=1.0, cp=SQRT3, input_type=1,
                                 analytic=P.AnalyticInput(tp=0.2, amplit=1e-3))],
        paraxial_incident=False, tmax=0.3, dt=0.02)),
    "imposed_acceleration": (lambda m: _strip(m, 6, 2), lambda P: dict(
        conditions=[P.ImposedCond("all", is_surface=False, A=(2.0, None, None))],
        init_nodes=[P.InitNodeCond("all", A=(2.0, 0.0, 0.0))], tmax=0.1, dt=0.02)),
    "imposed_velocity": (lambda m: _strip(m, 6, 2), lambda P: dict(
        conditions=[P.ImposedCond("all", is_surface=False, V=(3.0, None, None))],
        tmax=0.1, dt=0.02)),
    "imposed_displacement_curve": (lambda m: _strip(m, 8, 3), lambda P: dict(
        conditions=[P.ImposedCond("left", is_surface=True, U=(0.0, 0.0, None)),
                    P.ImposedCond("right", is_surface=True,
                                  u_curve=_table(P, [0.0, 1.0], [[0, 0, 0], [0.01, 0, 0]]),
                                  axes=(True, False, False))],
        tmax=0.1, dt=0.02)),
    "imposed_force": (_tip_mesh, lambda P: dict(
        conditions=[P.ImposedCond("tip", is_surface=False, Fv=(1e-3 / 3, None, None))],
        tmax=0.2, dt=0.02)),
    "initial_velocity": (lambda m: _strip(m, 5, 2), lambda P: dict(
        init_nodes=[P.InitNodeCond("all", V=(0.0, 1e-2, 0.0))], tmax=0.1, dt=0.02)),
    "double_couple": (_dc_mesh, lambda P: dict(
        double_couple=[P.PassmoDoubleCouple(
            north="N", south="S", east="E", west="W", source_plane=0,
            moment_table=_table(P, [0.0, 1.0], [[0.0], [1e-3]]), dew=0.25, dns=0.25)],
        tmax=0.1, dt=0.02)),
    "recovery_init_cells": (lambda m: _strip(m, 4, 2), lambda P: dict(
        conditions=[P.ImposedCond("left", is_surface=True, U=(0.0, 0.0, None))],
        init_cells=[P.InitCellCond("vol", vol_stress=(1.0, 2.0, 3.0),
                                   dev_strain=(0.5, 0.0, 0.0))],
        init_nodes=[P.InitNodeCond("all", V=(0.0, -1e-2, 0.0))], tmax=0.04, dt=0.02)),
}


def _dyn(mod, **kw):
    """test_passmo.py's Generalized-α set-up: Penalty Dirichlet on left and
    right of a 6x3 rect."""
    B, D = (BoundaryConditions, DirichletBC) if mod is pm else (JaxBCs, JaxDirichlet)
    bcs = B(dirichlet=[D(surface="left", values=(0.0, 0.0), method="Penalty"),
                       D(surface="right", values=(1e-3, None), method="Penalty")])
    return dict(tmax=kw.pop("tmax", 0.05), dt=kw.pop("dt", 0.005),
                lam={"vol": 50.0}, mu={"vol": 30.0}, bcs=bcs, **kw)


_RINF = 0.5
_AM, _AF = (2 * _RINF - 1) / (_RINF + 1), _RINF / (_RINF + 1)
GENALPHA = {
    "newmark": {},
    "alfa_zero": dict(alfa_method=True, alfam=0.0, alfaf=0.0),
    "alfa_dissipative": dict(alfa_method=True, alfam=_AM, alfaf=_AF,
                             beta=0.25 * (1 - _AM + _AF) ** 2, gamma=0.5 - _AM + _AF,
                             tmax=0.5, dt=0.02),
}


def _solve_both(mesh_fn, kw_fn):
    out = []
    for mod in (pm, jax_pm):
        kw = kw_fn(mod)
        cfg = mod.PassmoConfig(**{"rho": {"vol": 1.0}, "lam": {"vol": 1.0},
                                  "mu": {"vol": 1.0}, **kw})
        mesh = mesh_fn(mod)
        out.append(mod.solve(mesh, cfg, device="cpu") if mod is pm else mod.solve(mesh, cfg))
    return out


def _compare(res, jres, name, dt):
    """u, v·dt and a·dt² (the Newmark state in displacement units) against
    the largest of the three: a free flight's a, a fixed velocity's
    update, are round-off of a solve and held at that scale."""
    assert res.steps == jres.steps
    fields = {"u": 1.0, "v": dt, "a": dt * dt}
    scale = max(float(np.abs(np.asarray(getattr(jres, f))).max()) * w
                for f, w in fields.items())
    for f, w in fields.items():
        got, want = getattr(res, f), np.asarray(getattr(jres, f))
        assert got.shape == want.shape and got.dtype == np.float64, (name, f)
        if scale == 0:
            assert np.abs(got).max() == 0, (name, f)
            continue
        err = np.abs(got - want).max() * w / scale
        assert err <= TOL, (name, f, err)
    # the recovered fields against their largest magnitude, or where that
    # is round-off (a rigid motion's strain) against 1e3·max|u|, the scale
    # of λ·∇u on these meshes
    floor = 1e3 * float(np.abs(np.asarray(jres.u)).max())
    for f in ("strain_vol", "strain_dev", "stress_vol", "stress_dev"):
        for t, want in (getattr(jres, f) or {}).items():
            got, want = getattr(res, f)[t], np.asarray(want)
            assert got.shape == want.shape, (name, f)
            err = np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-300)
            assert err <= TOL, (name, f, err)


@pytest.mark.parametrize("name", list(FEATURES))
def test_passmo_features_match_jax(name):
    mesh_fn, kw_fn = FEATURES[name]
    res, jres = _solve_both(mesh_fn, kw_fn)
    _compare(res, jres, name, kw_fn(pm)["dt"])


@pytest.mark.parametrize("name", list(GENALPHA))
def test_passmo_generalized_alpha_matches_jax(name):
    res, jres = _solve_both(lambda m: _strip(m, 6, 3, 1.0, 1.0),
                            lambda P: _dyn(P, **GENALPHA[name]))
    _compare(res, jres, name, GENALPHA[name].get("dt", 0.005))


def test_recover_fields_matches_jax():
    """_recover_fields on a manufactured u (test_passmo_features'
    closed-form case) against JAX's."""
    outs = []
    for mod in (pm, jax_pm):
        mesh = _strip(mod, 4, 3)
        xp = torch if mod is pm else jnp
        coords = xp.asarray(mesh.coords) if mod is jax_pm else torch.as_tensor(mesh.coords)
        G = GaussState if mod is pm else JaxGaussState
        prob = (FemProblem(mesh, ndof=2, device="cpu") if mod is pm
                else JaxProblem(mesh, ndof=2))
        gstate = G.build(mesh, coords, 2, 2)
        u = np.zeros(prob.n_dofs)
        u[0::2] = 1e-3 * mesh.coords[:, 0] + 2e-3 * mesh.coords[:, 1] ** 2
        nc = mesh.cells["tria3"].shape[0]
        cfg = mod.PassmoConfig(init_cells=[mod.InitCellCond(
            cell_group="vol", vol_stress=(1.0, 2.0, 3.0), dev_strain=(0.5, 0.0, 0.0))])
        res = mod.PassmoResult(u=None, v=None, a=None, steps=0, problem=prob)
        mod._recover_fields(res, mesh, gstate, prob,
                            torch.as_tensor(u) if mod is pm else jnp.asarray(u),
                            {"tria3": np.full(nc, 2.0)}, {"tria3": np.full(nc, 1.5)}, cfg)
        outs.append(res)
    for f in ("strain_vol", "strain_dev", "stress_vol", "stress_dev"):
        _close(getattr(outs[0], f)["tria3"], getattr(outs[1], f)["tria3"], f)


def test_analytic_inputs_match_jax():
    a = pm.AnalyticInput(tp=2.0, ts=1.0, coef=3.0, amplit=1.5, phase=0.25)
    ja = jax_pm.AnalyticInput(tp=2.0, ts=1.0, coef=3.0, amplit=1.5, phase=0.25)
    for order in (0, 1, 2, 3):
        a.order = ja.order = order
        for typ in (1, 2, 3, 4, 5):
            for t in (0.0, 0.3, 1.0, 2.0, 2.04):
                assert a.value(typ, t, 0.1) == ja.value(typ, t, 0.1)


@pytest.fixture(scope="module")
def mixed_case(tmp_path_factory):
    """The mixed mesh and a case file of every route the full-width run
    does not take: imposed U/V/A curves, paraxial with a Ricker incident
    wave (outer properties; the prism and pyramid faces have no adjacent
    cell), Generalized-α, initial node conditions, a timed traction, the
    recovered fields and a golden file written from JAX's run."""
    root = tmp_path_factory.mktemp("passmo_cases")
    d = root / "inputs"
    d.mkdir()
    write_msh(str(d / "mixed.msh"), mixed_box_mesh())
    np.savetxt(root / "curve.txt", np.array([[0.0, 0.0, 0.0, 0.0], [0.05, 1e-3, -2e-3, 0.0],
                                             [1.0, 0.0, 1e-3, 5e-4]]))
    blocks = [
        ("dirichlet-surface-condition", {"surface": "zmin", "Ux": 0.0, "Uy": 0.0, "Uz": 0.0}),
        ("dirichlet-surface-condition", {"surface": "xmax", "V-curve": "curve.txt",
                                         "x-axis": "true", "z-axis": "true"}),
        ("dirichlet-point-condition", {"node": "top_corner", "A-curve": "curve.txt",
                                       "y-axis": "true"}),
        ("paraxial-boundary-condition", {"surface": "ymin", "rhopar": 2.0, "cp": 3.0,
                                         "cs": 1.7, "input-motion-type": 2, "tp": 0.05,
                                         "ts": 0.04, "amplit": 1e-3, "normal-angle": 30.0}),
        ("paraxial-boundary-condition", {"surface": "xmin", "E-par": 40.0, "nu-par": 0.25}),
        ("neumann-condition", {"surface": "zmax", "curve": "curve.txt"}),
        ("initial-node-condition", {"node-group": "all", "V": "0.0 0.0 -1e-3"}),
        ("init-cell-condition", {"cell-group": "upper", "vol-stress": "1.0 2.0 3.0"}),
    ]
    path = str(d / "mixed.arc")
    write_arc(path, "mixed.msh", codename="Passmo", blocks=blocks,
              mesh_init=[("Rho", "lower", 2.0), ("Lambda", "lower", 30.0),
                         ("Mu", "lower", 20.0), ("Rho", "upper", 1.5),
                         ("Lambda", "upper", 50.0), ("Mu", "upper", 25.0)],
              values={"analysis-type": "3D", "final-time": 0.1, "deltat": 0.01,
                      "alfa_method": "true", "alfam": _AM, "alfaf": _AF,
                      "beta": 0.25 * (1 - _AM + _AF) ** 2, "gamma": 0.5 - _AM + _AF},
              post_processing=["U", "StrainVol", "StressDev"])
    return path


def test_mixed_mesh_case_matches_jax(mixed_case, tmp_path):
    res = run_case(mixed_case, device="cpu", output_dir=str(tmp_path))
    jres = jax_run_case(mixed_case)
    assert res.steps == jres.steps == 10
    assert set(res.problem.mesh.cells) == {"hexa8", "pyramid5", "penta6", "tetra4"}
    _compare(res, jres, "mixed", 0.01)
    assert np.abs(res.u).max() > 0
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "mixed.hdf") as f:
        g = f["VTKHDF"]
        assert np.array_equal(g["PointData/U"][()], res.u)
        assert g["CellData/StrainVol"].shape == (sum(len(c) for c in res.problem.mesh.cells.values()), 3)


def test_mixed_mesh_blocks_match_jax(mixed_case):
    """The mixed mesh's assembled mass and stiffness (several buckets
    through one block_slot_reduce, node slots of many contributors)
    against JAX's, read back as (N, W, 3, 3) blocks."""
    mesh = read_msh(mixed_case.replace("mixed.arc", "mixed.msh"))
    prob, jprob = FemProblem(mesh, ndof=3, device="cpu"), JaxProblem(mesh, ndof=3)
    st = GaussState.build(mesh, prob.coords, 2, 3)
    jst = JaxGaussState.build(mesh, jnp.asarray(mesh.coords), 2, 3)
    K = prob.assemble_matrix(lambda t, xyz: st.stiffness_blocks(t, 2.0, 1.0))
    jK = jprob.assemble_matrix(lambda t, xyz: jst.stiffness_blocks(t, 2.0, 1.0))
    vals, cols = K.block_ell()
    assert np.array_equal(cols, prob.topo.ell_cols)
    _close(vals, jK.values, "mixed K", 1e-12)
    # node slots where three or four buckets' entries meet
    asm = prob.block_assembly
    ends = np.cumsum([c.shape[0] * c.shape[1] ** 2 for c in mesh.cells.values()])
    bucket = np.searchsorted(ends, asm.ids.numpy(), side="right")
    slot = np.repeat(np.arange(len(asm.ptr) - 1), np.diff(asm.ptr.numpy()))
    assert len(np.unique(np.stack([slot, bucket]), axis=1)[0]) < len(slot)
    per_slot = np.bincount(np.unique(np.stack([slot, bucket]), axis=1)[0])
    assert per_slot.max() >= 3
