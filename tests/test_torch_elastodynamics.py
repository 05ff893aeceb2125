"""The Elastodynamics codename end to end on the CPU in float64, beside the
JAX package: ``run_case(device="cpu")`` against the JAX ``run_case`` on
case files the tests write (``tools/write_msh.py``), and the consistent
initial acceleration through each package's ``solve`` (no .arc field
selects it).

Newmark-β and Generalized-α, Rayleigh damping in both formulations, a
CaseTable traction (``<traction-input-file>``) and a constant one, a body
force, Penalty and RowColumnElimination, 2D and 3D, the Aleph default
(Jacobi-CG).  u, v and a agree with JAX's to 1e-10 of their largest
magnitude, the step counts exactly."""

import numpy as np
import pytest

from arcanefem_tpu.fem.arc import load_case as jax_load_case
from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.mesh.core import read_msh as jax_read_msh
from arcanefem_tpu.models import elastodynamics as jax_ed
from arcanefem_tpu_torch.fem.arc import load_case
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.core import read_msh
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.models import elastodynamics as ed
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

TOL = 1e-10


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastodynamics_cases")
    d = root / "inputs"
    d.mkdir()
    write_msh(str(d / "rect.msh"), rect_tria_mesh(20, 5, lx=4.0, ly=1.0))
    write_msh(str(d / "box.msh"), box_tetra_mesh(6, 3, 3, lx=2.0))
    # a CaseTable series: time, t1, t2, t3 (beside inputs/, the module root)
    np.savetxt(root / "traction.txt", np.array(
        [[0.0, 0.0, 0.0, 0.0], [0.1, 0.0, -1.0, 0.2], [0.25, 0.5, -0.5, 0.0], [1.0, 0.0, 0.0, 0.0]]))
    return d


def _write(d, name, mesh, **kw):
    path = str(d / f"{name}.arc")
    write_arc(path, mesh, codename="Elastodynamics", component_tags=True, **kw)
    return path


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= TOL, (what, err)


ELASTODYNAMICS = [  # name, mesh, fields, solver
    ("newmark_table", "rect.msh",
     dict(values={"time-discretization": "Newmark-beta"},
          dirichlet_vector=[("left", (0.0, 0.0))],
          traction=[("right", None, "traction.txt")]), None),
    ("genalpha_rayleigh", "rect.msh",
     dict(values={"time-discretization": "Generalized-alpha", "alpm": 0.2, "alpf": 0.4,
                  "etam": 0.01, "etak": 0.001,
                  "enforce-Dirichlet-method": "RowColumnElimination"},
          dirichlet_vector=[("left", (0.0, 0.0))], traction=[("right", (0.0, -0.5))]), None),
    ("newmark_3d", "box.msh",
     dict(values={"f1": 0.0, "f2": -1.0, "etak": 0.002},
          dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))],
          traction=[("xmax", None, "traction.txt")]), None),
]


@pytest.mark.parametrize("name,mesh,fields,solver", ELASTODYNAMICS,
                         ids=[c[0] for c in ELASTODYNAMICS])
def test_elastodynamics_matches_jax(case_dir, name, mesh, fields, solver):
    values = {"E": 100.0, "nu": 0.25, "rho": 1.0, "tmax": 0.4, "dt": 0.05,
              **fields.pop("values")}
    path = _write(case_dir, name, mesh, linear_system=solver, values=values, **fields)
    res, jres = run_case(path, device="cpu"), jax_run_case(path)
    assert res.steps == jres.steps == 8
    assert res.iterations > 0
    for f in ("u", "v", "a"):
        _close(getattr(res, f), getattr(jres, f), f"{name} {f}")


@pytest.mark.parametrize("scheme", ["Newmark-beta", "Generalized-alpha"])
def test_elastodynamics_consistent_start_matches_jax(case_dir, scheme):
    """initial_acceleration="consistent" (ρM·A0 = F(0) − K·U0 first), with
    Rayleigh damping in its "reference" formulation, through each
    package's solve on the same parsed case."""
    path = _write(case_dir, f"consistent_{scheme}", "rect.msh",
                  values={"E": 50.0, "nu": 0.3, "rho": 2.0, "tmax": 0.3, "dt": 0.05,
                          "f1": 0.0, "f2": -1.0, "time-discretization": scheme,
                          "alpm": 0.1, "alpf": 0.3, "etam": 0.02, "etak": 0.002},
                  dirichlet_vector=[("left", (0.0, 0.0))],
                  traction=[("right", None, "traction.txt")])
    case, jcase = load_case(path), jax_load_case(path)
    cfg = ed.parse_config(case, case.base_dir)
    jcfg = jax_ed.parse_config(jcase, jcase.base_dir)
    for c in (cfg, jcfg):
        c.initial_acceleration, c.damping_formulation = "consistent", "reference"
    res = ed.solve(read_msh(case.mesh_file), cfg, device="cpu")
    jres = jax_ed.solve(jax_read_msh(jcase.mesh_file), jcfg)
    for f in ("u", "v", "a"):
        _close(getattr(res, f), getattr(jres, f), f"{scheme} {f}")
