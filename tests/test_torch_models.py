"""The Fourier, Electrostatics, Acoustics and Aerodynamics codenames end to
end on the CPU in float64, beside the JAX package: ``run_case(device=
"cpu")`` against the JAX ``run_case`` on case files the tests write
(``tools/write_msh.py``), and one case through the CLI with
``--output-dir``.

Meshes: a tria3 rect, a quad4 rect with two λ regions (``rect_quad_mesh``),
a tetra4 box, and tria6 and tetra10 meshes from ``quadratize``.  Solvers:
dense, the Aleph default (Jacobi-CG), Hypre (AMG-CG), and Aleph's gmres,
bicgstab and bicgstab2.  u (φ) agrees with JAX's to 1e-10 of max|u|,
iterations ± 1, E and ψ to 1e-10 of their largest magnitude.  Where the
JAX model raises (electrostatics and aerodynamics derive their cell
fields from P1 gradients only, acoustics has P1 mass matrices only), the
port raises the same error."""

import os
import subprocess
import sys

import numpy as np
import pytest

from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, quadratize, rect_tria_mesh
from arcanefem_tpu_torch.models import fourier
from arcanefem_tpu_torch.tools.write_msh import rect_quad_mesh, write_arc, write_msh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10

SOLVERS = {
    "aleph": None,  # Jacobi-CG, rtol 1e-12
    "hypre": {"name": "HypreLinearSystem", "rtol": "1e-12"},
    "dense": {"name": "SequentialBasicLinearSystem"},
    "gmres": {"name": "AlephLinearSystem", "solver-method": "gmres", "epsilon": "1e-12"},
    "bicgstab": {"name": "AlephLinearSystem", "solver-method": "bicgstab",
                 "epsilon": "1e-12"},
    "bicgstab2": {"name": "AlephLinearSystem", "solver-method": "bicgstab2",
                  "epsilon": "1e-12"},
}
# mesh file -> (left, right, other) boundary groups
MESHES = {"rect": ("left", "right", "top"), "quad": ("left", "right", "top"),
          "box": ("xmin", "xmax", "ymax"), "tria6": ("left", "right", "top"),
          "tetra10": ("xmin", "xmax", "ymax")}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model_cases")
    write_msh(str(d / "rect.msh"), rect_tria_mesh(20, 14, lx=1.0, ly=0.7))
    write_msh(str(d / "quad.msh"), rect_quad_mesh(16, 12, lx=1.2, regions=True))
    write_msh(str(d / "box.msh"), box_tetra_mesh(6, 5, 5))
    write_msh(str(d / "tria6.msh"), quadratize(rect_tria_mesh(8, 6)))
    write_msh(str(d / "tetra10.msh"), quadratize(box_tetra_mesh(3, 3, 3)))
    return d


def _case(d, name, mesh, codename, solver, **kw):
    left, right, other = MESHES[mesh]
    kw.setdefault("dirichlet", [(left, 0.0), (right, 1.0)])
    kw = {k: [tuple(g.replace("OTHER", other) if isinstance(g, str) else g for g in t)
              if isinstance(t, tuple) else t for t in v] if isinstance(v, list) else v
          for k, v in kw.items()}
    path = str(d / f"{name}.arc")
    write_arc(path, f"{mesh}.msh", codename=codename, linear_system=SOLVERS[solver], **kw)
    return path


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= TOL, (what, err)


def _against_jax(path, fields=("u",), its_tol=1):
    res = run_case(path, device="cpu")
    jres = jax_run_case(path)
    assert type(res).__name__ == type(jres).__name__
    assert abs(res.iterations - int(jres.iterations)) <= its_tol, (res.iterations,
                                                                  jres.iterations)
    for f in fields:
        got, want = getattr(res, f), getattr(jres, f)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for ct in want:
                _close(got[ct], want[ct], f"{f}[{ct}]")
        else:
            _close(got, want, f)
    return res, jres


ELECTRO = {"values": {"rho": 1.0, "epsilon": 2.0}}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_electrostatics_matches_jax(case_dir, solver):
    path = _case(case_dir, f"es_{solver}", "rect", "Electrostatics", solver, **ELECTRO)
    res, _ = _against_jax(path, ("phi", "E"))
    assert res.E["tria3"].shape == (res.problem.mesh.cells["tria3"].shape[0], 2)


def test_electrostatics_3d_with_neumann_matches_jax(case_dir):
    path = _case(case_dir, "es_box", "box", "Electrostatics", "hypre",
                 neumann=[("OTHER", 0.3)], **ELECTRO)
    _against_jax(path, ("phi", "E"))


FOURIER = [
    # name, mesh, solver, write_arc fields
    ("quad_regions_aleph", "quad", "aleph",
     dict(values={"lambda": 1.5, "qdot": 1.0}, materials=[("west", 2.0), ("east", 0.5)])),
    ("quad_regions_hypre", "quad", "hypre",
     dict(values={"lambda": 1.5, "qdot": 1.0}, materials=[("west", 2.0), ("east", 0.5)])),
    ("rect_manufactured", "rect", "aleph",
     dict(values={"lambda": 1.0}, dirichlet=[],
          manufactured={"dirichlet": "manufacturedDirichlet",
                        "source": "manufacturedSource"})),
    ("box_qdot_neumann", "box", "bicgstab",
     dict(values={"lambda": 0.8, "qdot": 2.0}, neumann=[("OTHER", -0.5)])),
    ("tria6_hypre", "tria6", "hypre", dict(values={"lambda": 2.0})),
    ("tria6_gmres", "tria6", "gmres", dict(values={"lambda": 2.0})),
    ("tetra10_hypre", "tetra10", "hypre", dict(values={"lambda": 1.0})),
    ("tetra10_bicgstab2", "tetra10", "bicgstab2", dict(values={"lambda": 1.0})),
    ("tria6_dense", "tria6", "dense", dict(values={"lambda": 3.0})),
]


@pytest.mark.parametrize("name,mesh,solver,kw", FOURIER, ids=[c[0] for c in FOURIER])
def test_fourier_matches_jax(case_dir, name, mesh, solver, kw):
    _against_jax(_case(case_dir, f"fo_{name}", mesh, "Fourier", solver, **kw))


def test_fourier_region_lambda_and_rows_in_bucket(case_dir):
    """The regions reach the assembly (λ 2 west, 0.5 east: u differs from a
    uniform λ run), and the vectorised _rows_in_bucket equals the JAX
    loop, duplicate bucket rows (the last index wins) and a missing row
    (KeyError) included."""
    from arcanefem_tpu.models.fourier import _rows_in_bucket as jax_rows

    args = dict(values={"lambda": 1.5, "qdot": 1.0})
    u_reg = run_case(_case(case_dir, "fo_reg", "quad", "Fourier", "aleph",
                           materials=[("west", 2.0), ("east", 0.5)], **args), device="cpu").u
    u_uni = run_case(_case(case_dir, "fo_uni", "quad", "Fourier", "aleph", **args),
                     device="cpu").u
    assert np.abs(u_reg - u_uni).max() > 1e-2
    rng = np.random.RandomState(0)
    bucket = rng.randint(0, 50, (300, 4)).astype(np.int32)
    bucket[17] = bucket[200]  # a repeated row
    sel = bucket[rng.permutation(300)[:120]]
    np.testing.assert_array_equal(fourier._rows_in_bucket(bucket, sel), jax_rows(bucket, sel))
    with pytest.raises(KeyError):
        fourier._rows_in_bucket(bucket, np.array([[99, 99, 99, 99]], np.int32))
    with pytest.raises(KeyError):
        jax_rows(bucket, np.array([[99, 99, 99, 99]], np.int32))


AERO = dict(farfield=[("left", 0.1), ("right", 0.1), ("OTHER", 0.1)], dirichlet=[],
            dirichlet_bc=[("bottom", 0.0)])


@pytest.mark.parametrize("solver", ["gmres", "bicgstab", "bicgstab2", "hypre"])
def test_aerodynamics_matches_jax(case_dir, solver):
    res, _ = _against_jax(_case(case_dir, f"ae_{solver}", "rect", "aerodynamics", solver,
                                **AERO), ("u", "psi"))
    assert res.psi["tria3"].shape == (res.problem.mesh.cells["tria3"].shape[0],)


def test_aerodynamics_3d_matches_jax(case_dir):
    path = _case(case_dir, "ae_box", "box", "Aerodynamics", "gmres", dirichlet=[],
                 farfield=[("xmin", 0.2), ("xmax", 0.2)], dirichlet_bc=[("zmin", 0.0)],
                 values={"penalty": 1e20})
    _against_jax(path, ("u", "psi"))


@pytest.mark.parametrize("mesh,solver", [("rect", "dense"), ("rect", "aleph"),
                                         ("box", "aleph"), ("box", "hypre")])
def test_acoustics_matches_jax(case_dir, mesh, solver):
    """−K + kc2·M with a Neumann source; every method but dense is forced to
    unpreconditioned BiCGStab, as in JAX.  On the 2D rect that solve's
    iteration count is set by round-off (ROADMAP Queue 3: 95-118
    iterations, the packages up to 7 apart, at kc2 1-10 and rtol 1e-10 and
    1e-12, the solutions within 2e-10): there the count is held to 10% of
    JAX's, u to 1e-10 as everywhere."""
    left, _r, _o = MESHES[mesh]
    path = _case(case_dir, f"ac_{mesh}_{solver}", mesh, "Acoustics", solver, dirichlet=[],
                 neumann=[(left, 1.0)], values={"kc2": 3.0})
    jits = int(jax_run_case(path).iterations)
    res, _ = _against_jax(path, its_tol=jits // 10 if mesh == "rect" else 1)
    if solver != "dense":
        assert res.problem is not None and res.iterations > 1


@pytest.mark.parametrize("codename,mesh", [("Electrostatics", "tria6"),
                                           ("Electrostatics", "tetra10"),
                                           ("Aerodynamics", "tetra10"),
                                           ("Acoustics", "tria6")])
def test_p2_cell_fields_raise_as_in_jax(case_dir, codename, mesh):
    left, right, _o = MESHES[mesh]
    kw = dict(dirichlet=[], farfield=[(left, 0.0)], dirichlet_bc=[(right, 1.0)]) \
        if codename == "Aerodynamics" else {}
    path = _case(case_dir, f"p2_{codename}_{mesh}", mesh, codename, "hypre", **kw)
    with pytest.raises(ValueError) as jerr:
        jax_run_case(path)
    with pytest.raises(ValueError) as err:
        run_case(path, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_cli_output_dir_on_cpu(case_dir):
    """python -m arcanefem_tpu_torch run --device cpu --output-dir: the
    done line, and the case's post-processing file (VTKHDF here, where
    h5py is installed) holding φ and E of the in-process run."""
    h5py = pytest.importorskip("h5py")
    path = _case(case_dir, "es_cli", "rect", "Electrostatics", "hypre",
                 post_processing=["Phi", "E"], **ELECTRO)
    out = case_dir / "cli_out"
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch", "run", path,
                           "--device", "cpu", "--output-dir", str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "done: ElectrostaticsResult {'iterations': " in proc.stdout
    assert "[post-processing] wrote" in proc.stdout
    res = run_case(path, device="cpu")
    with h5py.File(out / "es_cli.hdf", "r") as f:
        np.testing.assert_array_equal(f["VTKHDF/PointData/Phi"][()], res.phi)
        np.testing.assert_array_equal(f["VTKHDF/CellData/E"][()], res.E["tria3"])
