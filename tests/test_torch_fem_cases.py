"""The Poisson/Laplace slice end to end on the CPU in float64, beside the
JAX package: ``run_case(device="cpu")`` against the JAX ``run_case`` on
case files the tests write (``tools/write_msh.py``), the model API for
the block-Jacobi route (no ``.arc`` mapping selects it), and the CLI
against the JAX CLI.

Laplace u = x on a 2D and a 3D mesh (Dirichlet 0 on the left face, 1 on
the right one, natural conditions elsewhere: P1 reproduces u = x, so u is
also held to x to 1e-8) with each Dirichlet method; the solver routes
(AMG, dense, Jacobi, poly, block-Jacobi) on it; and a Poisson case with f
and a Neumann group.  u agrees with JAX's to 1e-9 of max|u|, iterations
± 1, and a golden file written from the JAX run passes the port's
``check_node_results``."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.models import poisson as jax_poisson
from arcanefem_tpu.solver.linear_system import SolverOptions as JaxOptions
from arcanefem_tpu_torch.fem.bcs import BoundaryConditions, DirichletBC
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.fem.validation import check_node_results
from arcanefem_tpu_torch.mesh.core import read_msh
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.models import poisson
from arcanefem_tpu_torch.solver.linear_system import SolverOptions
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("Penalty", "WeakPenalty", "RowElimination", "RowColumnElimination")
# mesh file, left and right faces, Neumann face
MESHES = {"2d": ("rect.msh", "left", "right", "top"),
          "3d": ("box.msh", "xmin", "xmax", "ymax")}
SOLVERS = {
    "aleph": None,  # no <linear-system>: Aleph default, Jacobi, rtol 1e-12
    "hypre": {"name": "HypreLinearSystem", "rtol": "1e-11"},
    "dense": {"name": "SequentialBasicLinearSystem"},
    "poly": {"name": "AlephLinearSystem", "preconditioner": "poly",
             "epsilon": "1e-11"},
}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fem_cases")
    write_msh(str(d / "rect.msh"), rect_tria_mesh(24, 17, lx=1.0, ly=0.7))
    write_msh(str(d / "box.msh"), box_tetra_mesh(9, 7, 6))
    return d


def _write_case(d, name, dim, method="Penalty", solver="aleph", f=None,
                neumann=False, codename="Laplace"):
    mesh_file, left, right, top = MESHES[dim]
    path = str(d / f"{name}.arc")
    write_arc(path, mesh_file, codename=codename, f=f,
              dirichlet=[(left, 0.0, method), (right, 1.0, method)],
              neumann=[(top, 0.5)] if neumann else [],
              linear_system=SOLVERS[solver])
    return path


def _against_jax(d, path, tag):
    """Both runs of ``path``; u held to JAX's to 1e-9 of max|u|,
    iterations ± 1, JAX's u as a golden file through the port's check."""
    res = run_case(path, device="cpu")
    jres = jax_run_case(path)
    ju = np.asarray(jres.u)
    assert res.u.dtype == np.float64 and res.u.shape == ju.shape
    err = np.abs(res.u - ju).max() / np.abs(ju).max()
    assert err <= 1e-9, err
    assert abs(res.iterations - int(jres.iterations)) <= 1
    golden = str(d / f"{tag}.golden.txt")
    mesh = res.problem.mesh
    np.savetxt(golden, np.column_stack([mesh.node_uids, ju]), fmt=["%d", "%.17g"])
    assert check_node_results(mesh.node_uids, res.u, golden, 1e-4) == 0
    return res, jres, mesh


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_laplace_u_equals_x(case_dir, dim, method):
    path = _write_case(case_dir, f"laplace_{dim}_{method}", dim, method)
    res, _jres, mesh = _against_jax(case_dir, path, f"laplace_{dim}_{method}")
    np.testing.assert_allclose(res.u, mesh.coords[:, 0], rtol=0, atol=1e-8)
    assert res.info["free_residual"] <= 1e-8


@pytest.mark.parametrize("solver", ["hypre", "dense", "poly"])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_solver_routes(case_dir, dim, solver):
    path = _write_case(case_dir, f"route_{dim}_{solver}", dim, solver=solver)
    res, jres, mesh = _against_jax(case_dir, path, f"route_{dim}_{solver}")
    np.testing.assert_allclose(res.u, mesh.coords[:, 0], rtol=0, atol=1e-8)
    if solver == "hypre":
        assert len(res.problem.mesh.coords) > 400  # AMG has a level to smooth


@pytest.mark.parametrize("method", ["Penalty", "RowColumnElimination"])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_poisson_source_and_neumann(case_dir, dim, method):
    path = _write_case(case_dir, f"poisson_{dim}_{method}", dim, method,
                       solver="hypre", f=2.5, neumann=True, codename="Poisson")
    res, _jres, mesh = _against_jax(case_dir, path, f"poisson_{dim}_{method}")
    assert res.u.max() > 1.0  # the source and the flux lift u above u = x


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_block_jacobi_through_the_model(case_dir, dim):
    """The block-Jacobi route, which no .arc mapping selects, through the
    model API of both packages."""
    mesh = read_msh(str(case_dir / MESHES[dim][0]))
    from arcanefem_tpu.fem.bcs import BoundaryConditions as JBcs
    from arcanefem_tpu.fem.bcs import DirichletBC as JDir
    from arcanefem_tpu.mesh.core import read_msh as jax_read_msh

    left, right = MESHES[dim][1:3]
    opts = dict(preconditioner="block-jacobi", rtol=1e-11)
    res = poisson.solve(mesh, poisson.PoissonConfig(
        f=1.0, bcs=BoundaryConditions(dirichlet=[DirichletBC(left, 0.0), DirichletBC(right, 1.0)]),
        solver=SolverOptions(**opts)), device="cpu")
    jres = jax_poisson.solve(jax_read_msh(str(case_dir / MESHES[dim][0])), jax_poisson.PoissonConfig(
        f=1.0, bcs=JBcs(dirichlet=[JDir(left, 0.0), JDir(right, 1.0)]),
        solver=JaxOptions(**opts)))
    ju = np.asarray(jres.u)
    assert np.abs(res.u - ju).max() / np.abs(ju).max() <= 1e-9
    assert abs(res.iterations - int(jres.iterations)) <= 1


def test_manufactured_solution_through_the_model():
    """A manufactured Dirichlet value on every exterior node and a source
    (callables of torch tensors in the port, of jnp arrays and floats in
    JAX): u = x² + y, −Δu = −2."""
    from arcanefem_tpu.fem.bcs import BoundaryConditions as JBcs
    from arcanefem_tpu.fem.bcs import ManufacturedSolution as JMs
    from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
    from arcanefem_tpu_torch.fem.bcs import ManufacturedSolution

    def exact(x, y, z):
        return x * x + y

    def source(x, y, z):
        return -2.0 + 0.0 * x

    opts = dict(preconditioner="amg", rtol=1e-12)
    res = poisson.solve(rect_tria_mesh(30, 20), poisson.PoissonConfig(
        bcs=BoundaryConditions(manufactured=ManufacturedSolution(exact, source)),
        solver=SolverOptions(**opts)), device="cpu")
    jres = jax_poisson.solve(jax_rect(30, 20), jax_poisson.PoissonConfig(
        bcs=JBcs(manufactured=JMs(exact, source)), solver=JaxOptions(**opts)))
    ju = np.asarray(jres.u)
    assert np.abs(res.u - ju).max() / np.abs(ju).max() <= 1e-9
    xy = res.problem.mesh.coords
    assert np.abs(res.u - exact(xy[:, 0], xy[:, 1], 0)).max() < 1e-3


def test_result_file_validation_and_rcm(case_dir):
    """The case's <result-file> is checked inside the run (a golden file of
    JAX's u passes, a perturbed one raises), and rcm renumbering gives the
    same u by node uid."""
    path = _write_case(case_dir, "golden_2d", "2d", "Penalty", solver="hypre",
                       f=1.0, neumann=True, codename="Poisson")
    jres = jax_run_case(path)
    mesh = read_msh(str(case_dir / "rect.msh"))
    for name, scale in (("ok", 1.0), ("bad", 1.001)):
        golden = case_dir / f"golden_{name}.txt"
        np.savetxt(golden, np.column_stack([mesh.node_uids, np.asarray(jres.u) * scale]),
                   fmt=["%d", "%.17g"])
        text = open(path).read().replace(
            "</fem>", f"<result-file>{golden}</result-file></fem>")
        p = str(case_dir / f"golden_{name}.arc")
        with open(p, "w") as f:
            f.write(text)
        if scale == 1.0:
            run_case(p, device="cpu")
            assert run_case(p, device="cpu", check=False).iterations > 0
        else:
            with pytest.raises(AssertionError, match="golden-file check failed"):
                run_case(p, device="cpu")
    a = run_case(path, device="cpu")
    b = run_case(path, device="cpu", rcm=True)
    order = np.argsort(b.problem.mesh.node_uids)
    assert not np.array_equal(order, np.arange(len(order)))
    np.testing.assert_allclose(b.u[order], a.u, rtol=0, atol=1e-9 * np.abs(a.u).max())


def test_float32_and_deferred_features(case_dir):
    """float32 on the CPU (penalty clamped to 1e12, compensated dots)
    returns float32 u within 1e-5 of the float64 run; ``output_dir`` (ported
    since) writes nothing for a case without an <arcane-post-processing>
    block, as in JAX; the Testlab codename (ported since) solves the same
    case, Poisson with its default format, to the float64 run's u."""
    path = _write_case(case_dir, "f32_3d", "3d", solver="hypre", f=1.0,
                       codename="Poisson")
    u64 = run_case(path, device="cpu").u
    r32 = run_case(path, dtype=torch.float32, device="cpu")
    assert r32.u.dtype == np.float32
    assert np.abs(r32.u - u64).max() <= 1e-5 * np.abs(u64).max()
    assert r32.problem.layout.n_rows == len(u64)
    out = case_dir / "out_f32"
    assert run_case(path, dtype=torch.float32, device="cpu",
                    output_dir=str(out)).u.dtype == np.float32
    assert not out.exists()
    other = str(case_dir / "testlab.arc")
    with open(other, "w") as f:
        f.write(open(path).read().replace('codename="Poisson"', 'codename="Testlab"')
                .replace("<boundary-conditions>", "<dirichlet-boundary-condition>"
                         "<surface>xmin</surface><value>0.0</value>"
                         "</dirichlet-boundary-condition><dirichlet-boundary-condition>"
                         "<surface>xmax</surface><value>1.0</value>"
                         "</dirichlet-boundary-condition><boundary-conditions>"))
    lab = run_case(other, device="cpu")
    assert type(lab).__name__ == "PoissonResult" and lab.iterations > 0
    assert np.abs(lab.u - u64).max() <= 1e-9 * np.abs(u64).max()


def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def _done(stdout: str) -> tuple[str, dict]:
    line = [ln for ln in stdout.splitlines() if ln.startswith("done: ")][-1]
    name, _, info = line[len("done: "):].partition(" ")
    return name, ast.literal_eval(info)


def test_cli_without_cuda_exits_1(case_dir):
    """No --device: the card, which this machine lacks; exit 1, no solve."""
    path = _write_case(case_dir, "cli_cuda", "2d")
    proc = _cli("arcanefem_tpu_torch", "run", path)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert "done:" not in proc.stdout and "ArcaneFem-Timer" not in proc.stdout


def test_cli_on_cpu_prints_what_jax_prints(case_dir):
    path = _write_case(case_dir, "cli_cpu", "3d", solver="hypre", f=1.0,
                       neumann=True, codename="Poisson")
    proc = _cli("arcanefem_tpu_torch", "run", path, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    jproc = _cli("arcanefem_tpu", "run", path)
    assert jproc.returncode == 0, jproc.stderr[-2000:]
    (name, info), (jname, jinfo) = _done(proc.stdout), _done(jproc.stdout)
    assert name == jname == "PoissonResult"
    assert sorted(info) == sorted(jinfo) == ["iterations", "residual"]
    assert abs(info["iterations"] - jinfo["iterations"]) <= 1
    assert info["residual"] <= 1e-7
    labels = {ln.split()[1] for ln in proc.stdout.splitlines()
              if ln.startswith("[ArcaneFem-Timer]")}
    jlabels = {ln.split()[1] for ln in jproc.stdout.splitlines()
               if ln.startswith("[ArcaneFem-Timer]")}
    assert labels == jlabels and "solve-linear-system" in labels


@pytest.mark.parametrize("args", [["testlab", "--rect", "8", "--device", "cpu"],
                                  ["run", "CASE", "--device", "cpu",
                                   "--output-dir", "OUT"]])
def test_cli_deferred_features_raise(case_dir, args):
    """The once-deferred features run: testlab (ported since) prints the
    lab's JSON; --output-dir (ported since) writes the case's
    post-processing file, u under "U"."""
    path = _write_case(case_dir, "cli_deferred", "2d")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("  <fem>", "  <arcane-post-processing><output>"
                             "<variable>U</variable></output></arcane-post-processing>\n"
                             "  <fem>"))
    out = case_dir / "out_cli"
    args = [a.replace("CASE", path).replace("OUT", str(out)) for a in args]
    proc = _cli("arcanefem_tpu_torch", *args)
    if args[0] == "testlab":
        assert proc.returncode == 0, proc.stderr[-2000:]
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        assert stats["nbNode"] == 81 and stats["cache_warming"] == 5
        assert list(stats["formats"]) == ["bell-segsum", "bell-sorted", "bell-scatter",
                                          "csr-segsum", "coo", "coo-sorted"]
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    written = sorted(p.name for p in out.iterdir())
    assert written == ["cli_deferred.hdf" if _have_h5py() else "cli_deferred.vtk"]
    assert f"[post-processing] wrote {out / written[0]}" in proc.stdout


def _have_h5py() -> bool:
    from arcanefem_tpu_torch.fem import vtkhdf

    return vtkhdf.HAVE_H5PY
