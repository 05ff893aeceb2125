"""The Soildynamics codename on the CPU in float64, beside the JAX
package: case files the tests write (``tools/write_msh.py``) through the
port's ``run_case(device="cpu")`` and the JAX ``run_case``.  Paraxial
boundaries (the EDGE2 LHS blocks through ``add_face_matrix`` and the
per-step paraxial RHS sum), a CaseTable traction, a constant traction, the
double-couple source at four node groups, Dirichlet by Penalty, the E/ν,
λ/μ and cp/cs material precedence, the Aleph default (Jacobi-CG) and
AMG.  u, v and a within 1e-10 of their largest magnitude, the steps
equal, each step's iterations within one of JAX's (read through a
wrapper of the JAX module's ``solve_finalized``)."""

import numpy as np
import pytest

from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.models import soildynamics as jax_sd
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.models import soildynamics as sd
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

TOL = 1e-10
SOIL = {"tmax": 0.3, "dt": 0.05, "rho": 2.0}


def nearest(mesh, x, y):
    return np.array([int(np.argmin(np.hypot(mesh.coords[:, 0] - x, mesh.coords[:, 1] - y)))])


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("soil_cases")
    d = root / "inputs"
    d.mkdir()
    mesh = rect_tria_mesh(16, 12, lx=2.0, ly=1.5)
    for name, (x, y) in {"N": (1.0, 0.875), "S": (1.0, 0.625), "E": (1.125, 0.75),
                         "W": (0.875, 0.75)}.items():
        mesh.node_groups[name] = nearest(mesh, x, y)
    write_msh(str(d / "rect.msh"), mesh)
    np.savetxt(root / "traction.txt", np.array(
        [[0.0, 0.0, 0.0, 0.0], [0.1, 0.0, -1.0, 0.2], [0.2, 0.5, -0.5, 0.0],
         [1.0, 0.0, 0.0, 0.0]]))
    np.savetxt(root / "source.txt", np.array([[0.0, 0.0], [0.1, 1.0], [0.2, -0.5],
                                              [1.0, 0.0]]))
    return d


@pytest.fixture
def jax_iterations(monkeypatch):
    its = []
    real = jax_sd.solve_finalized

    def wrapped(*a, **kw):
        x, info = real(*a, **kw)
        its.append(int(info["iterations"]))
        return x, info

    monkeypatch.setattr(jax_sd, "solve_finalized", wrapped)
    return its


PARAX = [("paraxial-boundary-condition", {"surface": s}) for s in ("left", "right", "bottom")]
DC = ("double-couple", {"north-node-name": "N", "south-node-name": "S",
                        "east-node-name": "E", "west-node-name": "W",
                        "double-couple-input-file": "source.txt", "method": "force-based"})
SOIL_CASES = [  # name, values, dirichlet_vector, traction, blocks, solver
    ("paraxial_table", {**SOIL, "E": 50.0, "nu": 0.25}, [],
     [("top", None, "traction.txt")], PARAX, None),
    ("paraxial_double_couple", {**SOIL, "lambda": 30.0, "mu": 20.0}, [],
     [("top", (0.0, -0.5))], PARAX + [DC], None),
    ("dirichlet_cp_cs_amg", {**SOIL, "cp": 6.0, "cs": 3.5, "E": 1.0},
     [("bottom", (0.0, 0.0))], [("top", None, "traction.txt")],
     PARAX[:2] + [DC], {"name": "AlephLinearSystem", "preconditioner": "amg",
                        "epsilon": "1e-11"}),
]


@pytest.mark.parametrize("name,values,dirv,traction,blocks,solver", SOIL_CASES,
                         ids=[c[0] for c in SOIL_CASES])
def test_soildynamics_matches_jax(case_dir, jax_iterations, name, values, dirv, traction,
                                  blocks, solver):
    path = str(case_dir / f"{name}.arc")
    write_arc(path, "rect.msh", codename="Soildynamics", values=values,
              dirichlet_vector=dirv, traction=traction, blocks=blocks,
              linear_system=solver, component_tags=True)
    res, jres = run_case(path, device="cpu"), jax_run_case(path)
    assert res.steps == jres.steps == 6
    for f in ("u", "v", "a"):
        got, want = getattr(res, f), np.asarray(getattr(jres, f))
        assert got.dtype == np.float64 and got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL, (name, f, err)
    assert np.abs(res.u).max() > 0
    assert len(res.step_iterations) == len(jax_iterations) == 6
    assert all(abs(a - b) <= 1 for a, b in zip(res.step_iterations, jax_iterations)), (
        res.step_iterations, jax_iterations)


@pytest.mark.parametrize("kw", [{"E": 3.0, "nu": 0.2}, {"lam": 2.0, "mu": 1.0},
                                {"cp": 4.0, "cs": 2.0},
                                {"lam": 2.0, "mu": 1.0, "cp": 5.0, "cs": 3.0}])
def test_coefficients_match_jax(kw):
    """The Newmark set of each material precedence (E/ν, λ/μ, cp/cs over
    both) equal to JAX's for the same λ and μ; the precedence itself is
    held end to end by the case tests above."""
    cfg, jcfg = sd.SoildynamicsConfig(rho=1.5, **kw), jax_sd.SoildynamicsConfig(rho=1.5, **kw)
    lam, mu, cp, cs = sd.materials(cfg)
    assert lam > 0 and mu > 0 and cp > cs > 0
    assert sd.coefficients(cfg, lam, mu) == jax_sd.coefficients(jcfg, lam, mu)
