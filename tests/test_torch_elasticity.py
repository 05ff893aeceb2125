"""The Bilaplacian and Elasticity codenames end to end on the CPU in
float64, beside the JAX package: ``run_case(device="cpu")`` against the
JAX ``run_case`` on case files the tests write (``tools/write_msh.py``),
and one elasticity case through the CLI.  (Elastodynamics:
``tests/test_torch_elastodynamics.py``.)

Meshes: a tria3 rect with a node group (point Dirichlet) and a tetra4 box.
Elasticity runs each Dirichlet method, with body force and traction, on
the Aleph default (Jacobi-CG; bicgstab under RowElimination), Aleph's
gmres and the Hypre route (both with AMG and the rigid body modes).  Fields (u, or
u1 and u2) agree with JAX's to 1e-10 of their largest magnitude,
iterations ± 1 (BiCGStab within 5%, whose counts round-off sets)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10
HYPRE = {"name": "HypreLinearSystem", "rtol": "1e-12"}
GMRES = {"name": "AlephLinearSystem", "solver-method": "gmres", "preconditioner": "amg",
         "epsilon": "1e-12"}
DENSE = {"name": "SequentialBasicLinearSystem"}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("block_cases")
    d = root / "inputs"
    d.mkdir()
    rect = rect_tria_mesh(24, 16, lx=3.0, ly=2.0)
    rect.node_groups["corner"] = np.array([int(np.argmax(rect.coords[:, 0] + rect.coords[:, 1]))])
    write_msh(str(d / "rect.msh"), rect)
    write_msh(str(d / "box.msh"), box_tetra_mesh(8, 5, 5, lx=2.0))
    return d


def _write(d, name, mesh, codename, **kw):
    path = str(d / f"{name}.arc")
    write_arc(path, mesh, codename=codename, **kw)
    return path


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= TOL, (what, err)


def _iters_close(a, b, bicgstab=False):
    tol = max(1, b // 20) if bicgstab else 1
    assert abs(a - b) <= tol, (a, b)


ELASTICITY = [  # name, mesh, method, solver, extra write_arc fields
    ("tria_penalty", "rect.msh", "Penalty", None, {}),
    ("tria_weak", "rect.msh", "WeakPenalty", None, {}),
    ("tria_rowelim", "rect.msh", "RowElimination", None, {}),
    ("tria_rowcol_gmres", "rect.msh", "RowColumnElimination", GMRES, {}),
    ("tria_penalty_hypre", "rect.msh", "Penalty", HYPRE, {}),
    ("tetra_rowcol", "box.msh", "RowColumnElimination", None, {}),
]


@pytest.mark.parametrize("name,mesh,method,solver,extra", ELASTICITY,
                         ids=[c[0] for c in ELASTICITY])
def test_elasticity_matches_jax(case_dir, name, mesh, method, solver, extra):
    if mesh == "rect.msh":
        kw = dict(f=(None, -1.0), dirichlet_vector=[("left", (0.0, 0.0))],
                  dirichlet_point=[("corner", (None, -0.01))],
                  traction=[("right", (0.5, None))])
    else:
        kw = dict(f=(0.0, 0.0, -1.0), dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))],
                  traction=[("xmax", (None, 0.25, None))])
    path = _write(case_dir, name, mesh, "Elasticity", linear_system=solver,
                  values={"E": 21.0, "nu": 0.28, "enforce-Dirichlet-method": method},
                  **kw, **extra)
    res, jres = run_case(path, device="cpu"), jax_run_case(path)
    assert type(res).__name__ == type(jres).__name__ == "ElasticityResult"
    _close(res.u, jres.u, name)
    _iters_close(res.iterations, jres.iterations, bicgstab=method == "RowElimination")
    assert res.info["free_residual"] <= 1e-9


def test_bilaplacian_matches_jax(case_dir):
    """The mixed system through the dense back end (the model forces it
    whatever the case asks)."""
    for name, solver in (("bilap_dense", DENSE), ("bilap_aleph", None)):
        path = _write(case_dir, name, "rect.msh", "Bilaplacian", f=-1.0,
                      dirichlet_bc=[("left", 0.0), ("right", 0.0), ("top", 0.0)],
                      linear_system=solver)
        res, jres = run_case(path, device="cpu"), jax_run_case(path)
        _close(res.u1, jres.u1, name)
        _close(res.u2, jres.u2, name)
        assert res.iterations == jres.iterations == 1


def test_elasticity_cli_on_cpu(case_dir):
    """python -m arcanefem_tpu_torch run --device cpu: the phase lines and
    the done line with the iterations of the in-process run."""
    path = _write(case_dir, "cli_elasticity", "box.msh", "Elasticity",
                  f=(0.0, 0.0, -1.0), values={"E": 10.0, "nu": 0.3},
                  dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))])
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch", "run", path,
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[ArcaneFem-Timer] lhs-matrix-assembly" in proc.stdout
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("done: ")][-1]
    name, _, info = line[len("done: "):].partition(" ")
    assert name == "ElasticityResult"
    assert ast.literal_eval(info)["iterations"] == run_case(path, device="cpu").iterations
