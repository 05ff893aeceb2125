"""The port runs where jax is not installed: neither the package nor
chip_smoke.py imports jax, anything of arcanefem_tpu or the root bench.py
(the port keeps its own copies of the host code it needs)."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN = ("jax", "jaxlib", "arcanefem_tpu", "bench")


def _port_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "arcanefem_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, name


_PRELUDE = """
import json, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["arcanefem_tpu"] = None  # and so does any of the JAX package
sys.modules["bench"] = None  # and of the root bench.py
import torch
"""
_REPORT = """
print(json.dumps({"iterations": res["iterations"], "rel": res["rel"],
                  "true_residual": tr,
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench")
                             and sys.modules[m] is not None]}))
"""
_SCRIPT = _PRELUDE + """
from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
mesh, topo = sphere_cut_system(14.0, 0, cache=False)
res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64, penalty=1e30)
tr = res["true_residual"]
""" + _REPORT
_SUPERNODE_SCRIPT = _PRELUDE + """
from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
mesh, topo = sphere_cut_system(14.0, 0, cache=False)
res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64, penalty=1e30,
                       spmv="supernode", sn_block=True)
assert res["spmv_path"] == "SupernodeMatrix", res["spmv_path"]
tr = res["true_residual"]
""" + _REPORT
_COMPACT_SCRIPT = _PRELUDE + """
from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
mesh, topo = sphere_cut_system(14.0, 0, cache=False)
res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64, penalty=1e30,
                       spmv="compact", band_pre=True, asm_compact=True,
                       asm_coords="batched")
assert res["spmv_path"] == "CompactMatrix", res["spmv_path"]
tr = res["true_residual"]
""" + _REPORT
_DIAG_SCRIPT = _PRELUDE + """
from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
mesh, topo = sphere_cut_system(14.0, 0, cache=False, order="rcm")
res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64, penalty=1e30,
                       order="rcm", spmv="diag")
assert res["spmv_path"] == "DiagEllMatrix", res["spmv_path"]
tr = res["true_residual"]
""" + _REPORT
_STRUCTURED_SCRIPT = _PRELUDE + """
from arcanefem_tpu_torch.bench_structured import box_system, solve_mg, true_residual
s = box_system(16, "cpu", torch.float64)
res = solve_mg(s)
tr = true_residual(s, res)
""" + _REPORT


def _run_blocked(script: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["rel"] <= 1e-8 and out["true_residual"] <= 1e-6
    assert out["iterations"] > 0
    return out


def test_slice_runs_without_jax():
    """The h=14 unstructured slice on the CPU in a process where neither jax
    nor arcanefem_tpu can be imported."""
    _run_blocked(_SCRIPT)


def test_supernode_route_runs_without_jax():
    """The h=14 supernode route (supernode operator and fine level,
    block-Jacobi fine smoother) the same way."""
    _run_blocked(_SUPERNODE_SCRIPT)


def test_compact_band_route_runs_without_jax():
    """The h=14 compact route with banded pre-gathers and the compact
    batched coordinate gather the same way."""
    _run_blocked(_COMPACT_SCRIPT)


def test_diag_route_runs_without_jax():
    """The h=14 RCM-ordered diag route the same way."""
    _run_blocked(_DIAG_SCRIPT)


def test_structured_slice_runs_without_jax():
    """The 16^3 structured slice (MG-PCG, float64) the same way."""
    assert _run_blocked(_STRUCTURED_SCRIPT)["iterations"] == 12


_BENCH_SCRIPT = _PRELUDE + """
import runpy
from arcanefem_tpu_torch import bench
line = bench.final_json({"metric": "m", "value": 1e-6, "n_dofs": 10, "nnz_stored": 50,
                         "platform": "cuda"}, None)
args = bench.primary_args({}), bench.secondary_args({})
try:  # the module as `python -m` runs it: without CUDA it exits 1
    runpy.run_module("arcanefem_tpu_torch.bench", run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code
print(json.dumps({"code": code, "vs_baseline": line["vs_baseline"],
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench")
                             and sys.modules[m] is not None]}))
"""


def test_bench_runs_without_jax():
    """arcanefem_tpu_torch.bench (its line, its knobs and its entry point,
    which exits 1 without CUDA) in a process where neither jax,
    arcanefem_tpu nor the root bench can be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BENCH_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["code"] == 1 and out["loaded"] == [] and out["vs_baseline"] > 0


_CLI_SCRIPT = _PRELUDE + """
import runpy
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh
d = sys.argv[1]
write_msh(d + "/box.msh", box_tetra_mesh(6, 5, 4))
write_arc(d + "/case.arc", "box.msh", codename="Poisson", f=1.0,
          dirichlet=[("xmin", 0.0), ("xmax", 1.0, "RowColumnElimination")],
          neumann=[("ymax", 0.5)], linear_system={"name": "HypreLinearSystem"})
codes = []
for args in (["run", d + "/case.arc"], ["run", d + "/case.arc", "--device", "cpu"],
             ["testlab", "--rect", "8"],
             ["testlab", "--rect", "8", "--device", "cpu", "--cross-validate"]):
    # without CUDA: exit 1, then the CPU
    sys.argv = ["arcanefem_tpu_torch", *args]
    try:
        runpy.run_module("arcanefem_tpu_torch", run_name="__main__")
        codes.append(0)
    except SystemExit as e:
        codes.append(e.code)
print(json.dumps({"codes": codes,
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench")
                             and sys.modules[m] is not None]}))
"""


def test_cli_runs_without_jax(tmp_path):
    """python -m arcanefem_tpu_torch run on a Poisson case (AMG, penalty and
    row-column elimination, a Neumann flux) and testlab --rect 8 in a
    process where neither jax, arcanefem_tpu nor the root bench can be
    imported: each exits 1 without --device (no CUDA here); with --device
    cpu, a solve and the lab's cross-validation."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CLI_SCRIPT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["codes"] == [1, 0, 1, 0] and out["loaded"] == []
    assert sum(ln.startswith("done: PoissonResult {'iterations': ") for ln in lines) == 1
    report = json.loads(lines[-2])["cross_validation_max_rel"]
    assert len(report) == 6 and max(report.values()) < 1e-12


_MODELS_SCRIPT = _PRELUDE + """
import os, runpy
from arcanefem_tpu_torch.mesh.generate import quadratize, rect_tria_mesh
from arcanefem_tpu_torch.tools.write_msh import rect_quad_mesh, write_arc, write_msh
d = sys.argv[1]
write_msh(d + "/rect.msh", rect_tria_mesh(10, 8))
write_msh(d + "/quad.msh", rect_quad_mesh(8, 6, regions=True))
write_msh(d + "/tria6.msh", quadratize(rect_tria_mesh(5, 4)))
aleph = lambda m: {"name": "AlephLinearSystem", "solver-method": m, "epsilon": "1e-10"}
cases = {
    "Fourier": ("quad.msh", dict(values={"lambda": 1.5, "qdot": 1.0},
                                 materials=[("west", 2.0)],
                                 dirichlet=[("left", 0.0), ("right", 1.0)],
                                 linear_system={"name": "HypreLinearSystem"})),
    "Electrostatics": ("rect.msh", dict(values={"rho": 1.0, "epsilon": 2.0},
                                        dirichlet=[("left", 0.0), ("right", 1.0)],
                                        linear_system=aleph("bicgstab2"),
                                        post_processing=["Phi", "E"])),
    "Acoustics": ("rect.msh", dict(values={"kc2": 2.0}, neumann=[("left", 1.0)])),
    "Aerodynamics": ("rect.msh", dict(farfield=[("left", 0.1), ("right", 0.1)],
                                      dirichlet_bc=[("bottom", 0.0)],
                                      linear_system=aleph("gmres"))),
    "Fourier_p2": ("tria6.msh", dict(values={"lambda": 2.0},
                                     dirichlet=[("left", 0.0), ("right", 1.0)],
                                     linear_system=aleph("bicgstab"))),
}
codes, done = {}, []
for name, (mesh, kw) in cases.items():
    write_arc(d + f"/{name}.arc", mesh, codename=name.split("_")[0], **kw)
    extra = ["--output-dir", d + "/out"] if name == "Electrostatics" else []
    sys.argv = ["arcanefem_tpu_torch", "run", d + f"/{name}.arc", "--device", "cpu", *extra]
    try:
        runpy.run_module("arcanefem_tpu_torch", run_name="__main__")
        codes[name] = 0
    except SystemExit as e:
        codes[name] = e.code
print(json.dumps({"codes": codes, "out": sorted(os.listdir(d + "/out")),
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench")
                             and sys.modules[m] is not None]}))
"""


def test_models_cli_runs_without_jax(tmp_path):
    """python -m arcanefem_tpu_torch run --device cpu on one case of each
    codename ported since the Poisson slice (Fourier on quads with a λ
    region, Electrostatics with bicgstab2 and --output-dir, Acoustics,
    Aerodynamics with gmres, Fourier on tria6 with bicgstab) in a process
    where neither jax, arcanefem_tpu nor the root bench can be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _MODELS_SCRIPT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["loaded"] == [] and set(out["codes"].values()) == {0}
    assert out["out"] in (["Electrostatics.hdf"], ["Electrostatics.vtk"])
    for name in ("FourierResult", "ElectrostaticsResult", "AcousticsResult",
                 "AerodynamicsResult"):
        assert any(ln.startswith(f"done: {name} {{'iterations': ") for ln in lines), name


_BLOCKS_SCRIPT = _PRELUDE + """
import os, runpy
import numpy as np
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh
d = sys.argv[1]
os.makedirs(d + "/inputs")
write_msh(d + "/inputs/rect.msh", rect_tria_mesh(12, 4, lx=3.0))
write_msh(d + "/inputs/box.msh", box_tetra_mesh(9, 6, 6))
np.savetxt(d + "/traction.txt", [[0.0, 0.0, 0.0, 0.0], [0.2, 0.0, -1.0, 0.0]])
cases = {
    "Elasticity": ("box.msh", dict(f=(0.0, 0.0, -1.0), values={"E": 10.0, "nu": 0.3},
                                   dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))],
                                   linear_system={"name": "HypreLinearSystem"})),
    "Bilaplacian": ("rect.msh", dict(f=-1.0, dirichlet_bc=[("left", 0.0), ("right", 0.0)])),
    "Elastodynamics": ("rect.msh", dict(component_tags=True,
                                        values={"tmax": 0.2, "dt": 0.05, "E": 50.0},
                                        dirichlet_vector=[("left", (0.0, 0.0))],
                                        traction=[("right", None, "traction.txt")])),
}
codes = {}
for name, (mesh, kw) in cases.items():
    write_arc(d + f"/inputs/{name}.arc", mesh, codename=name, **kw)
    sys.argv = ["arcanefem_tpu_torch", "run", d + f"/inputs/{name}.arc", "--device", "cpu"]
    try:
        runpy.run_module("arcanefem_tpu_torch", run_name="__main__")
        codes[name] = 0
    except SystemExit as e:
        codes[name] = e.code
print(json.dumps({"codes": codes,
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench")
                             and sys.modules[m] is not None]}))
"""


def test_block_models_cli_runs_without_jax(tmp_path):
    """python -m arcanefem_tpu_torch run --device cpu on an Elasticity case
    (tetra4, the Hypre route: AMG with the rigid body modes), a Bilaplacian
    case and an Elastodynamics case with a CaseTable traction, in a process
    where neither jax, arcanefem_tpu nor the root bench can be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKS_SCRIPT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["loaded"] == [] and set(out["codes"].values()) == {0}
    for name in ("ElasticityResult", "BilaplacianResult"):
        assert any(ln.startswith(f"done: {name} {{'iterations': ") for ln in lines), name
    assert any(ln.startswith("done: ElastodynamicsResult {'steps': 4") for ln in lines)


_TRANSIENT_SCRIPT = _PRELUDE + """
import os, runpy
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh, write_arc, write_msh
d = sys.argv[1]
write_msh(d + "/rect.msh", rect_tria_mesh(10, 6))
write_msh(d + "/mixed.msh", mixed_box_mesh(2, 2))
write_arc(d + "/heat.arc", "rect.msh", codename="Heat",
          values={"lambda": 1.0, "qdot": 1.0, "dt": 0.1, "tmax": 0.3},
          dirichlet_bc=[("left", 0.0)],
          blocks=[("convection-boundary-condition", {"surface": "right", "h": 2.0, "Text": 1.0})],
          post_processing=["NodeTemperature"])
write_arc(d + "/passmo.arc", "mixed.msh", codename="Passmo",
          values={"analysis-type": "3D", "final-time": 0.03, "deltat": 0.01},
          mesh_init=[("Rho", g, 2.0) for g in ("lower", "upper")]
          + [("Lambda", g, 30.0) for g in ("lower", "upper")]
          + [("Mu", g, 20.0) for g in ("lower", "upper")],
          blocks=[("dirichlet-surface-condition", {"surface": "zmin", "Ux": 0.0, "Uy": 0.0,
                                                   "Uz": 0.0}),
                  ("paraxial-boundary-condition", {"surface": "xmax", "rhopar": 2.0,
                                                   "cp": 3.0, "cs": 1.5}),
                  ("initial-node-condition", {"node-group": "all", "V": "0.0 1e-3 0.0"})],
          post_processing=["U", "StressVol"])
codes = {}
for name in ("heat", "passmo"):
    sys.argv = ["arcanefem_tpu_torch", "run", d + f"/{name}.arc", "--device", "cpu",
                "--output-dir", d + "/out"]
    try:
        runpy.run_module("arcanefem_tpu_torch", run_name="__main__")
        codes[name] = 0
    except SystemExit as e:
        codes[name] = e.code
print(json.dumps({"codes": codes, "out": sorted(os.listdir(d + "/out")),
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench")
                             and sys.modules[m] is not None]}))
"""


def test_transient_cli_runs_without_jax(tmp_path):
    """python -m arcanefem_tpu_torch run --device cpu --output-dir on a heat
    case (convection, a temporal output file) and a passmo case on the
    mixed hexa8/pyramid5/penta6/tetra4 box (paraxial, initial velocity,
    the recovered stress) in a process where neither jax, arcanefem_tpu nor
    the root bench can be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _TRANSIENT_SCRIPT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["codes"] == {"heat": 0, "passmo": 0} and out["loaded"] == []
    assert sum(ln.startswith("done: HeatResult {") for ln in lines) == 1
    assert sum(ln.startswith("done: PassmoResult {") for ln in lines) == 1
    assert len(out["out"]) == 2


def test_scan_covers_the_transient_modules():
    """The source scan above reads the modules of the transient slice."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("fem/checkpoint.py", "models/heat.py", "models/soildynamics.py",
                "models/passmo.py", "ops/faces.py", "ops/gauss_state.py",
                "testlab.py", "models/testlab_model.py", "sparse/coo.py",
                "sparse/pallas_assembly.py", "sparse/blocked.py"):
        assert os.path.join("arcanefem_tpu_torch", mod) in scanned, mod


def test_scan_covers_the_parallel_modules():
    """The source scan above reads every module of the sharded solves."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("__init__.py", "__main__.py", "partition.py", "comm.py", "sharded.py",
                "sharded_amg.py", "sharded_window.py", "block_sharded.py",
                "structured_sharded.py", "structured_mg.py", "dryrun.py"):
        assert os.path.join("arcanefem_tpu_torch", "parallel", mod) in scanned, mod


def _blocking_path(root) -> str:
    """A directory of stand-ins for jax, arcanefem_tpu and the root bench:
    importing one records its name in ``<root>/imported`` and raises.
    First on PYTHONPATH, it reaches the ranks a command spawns too."""
    block = os.path.join(root, "block")
    os.makedirs(os.path.join(block, "jax"))
    os.makedirs(os.path.join(block, "arcanefem_tpu"))
    stub = ("import os\n"
            f"open(os.path.join({str(root)!r}, 'imported'), 'a').write(__name__ + '\\n')\n"
            "raise ImportError(__name__ + ' is not importable here')\n")
    for path in (("jax", "__init__.py"), ("arcanefem_tpu", "__init__.py"), ("bench.py",)):
        with open(os.path.join(block, *path), "w") as fh:
            fh.write(stub)
    return block


def test_parallel_cli_runs_without_jax(tmp_path):
    """python -m arcanefem_tpu_torch.parallel --nproc 2 --device cpu: two
    gloo ranks run every path of the dryrun (float32), in processes where
    neither jax, arcanefem_tpu nor the root bench can be imported."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_blocking_path(tmp_path), REPO]))
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch.parallel",
                           "--nproc", "2", "--device", "cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not os.path.exists(tmp_path / "imported"), (tmp_path / "imported").read_text()
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("parallel(2): ")]
    assert len(lines) == 8 and all(" ok — {" in ln for ln in lines), proc.stdout
    for ln in lines:
        rec = json.loads(ln.split(" ok — ", 1)[1])
        assert rec["max_diff"] <= 2e-3


def test_parallel_cli_without_cuda_exits_1(tmp_path):
    """--device cuda (the default) on a machine without CUDA exits 1 before
    any rank starts, with no line of results; so do more ranks than cards."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_blocking_path(tmp_path), REPO]))
    for args in (["--nproc", "1", "--device", "cuda"], ["--nproc", "2"]):
        proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch.parallel", *args],
                              cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 1, (args, proc.stderr[-2000:])
        assert "parallel(" not in proc.stdout, proc.stdout
        assert "CUDA" in proc.stderr


def test_scan_covers_the_harness_modules():
    """The source scan above reads the sweep and the profilers."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("bench_sweep.py", "tools/profile_unstr.py", "tools/profile_iter.py",
                "tools/profile_amg_setup.py"):
        assert os.path.join("arcanefem_tpu_torch", mod) in scanned, mod


def test_sweep_runs_without_jax(tmp_path):
    """python -m arcanefem_tpu_torch.bench --sweep --device cpu (box 4, P = 1
    and 2 on gloo, no headline) in processes, ranks included, where
    neither jax, arcanefem_tpu nor the root bench can be imported: six
    assembly rows, two invariant devices rows, bench.py's TSV header."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_blocking_path(tmp_path), REPO]))
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch.bench", "--sweep",
                           "--device", "cpu", "--sizes", "4", "--devices", "1,2",
                           "--no-headline", "--cache-warming", "1"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not os.path.exists(tmp_path / "imported"), (tmp_path / "imported").read_text()
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [r["axis"] for r in rows] == ["assembly"] * 6 + ["devices"] * 2
    assert [r["devices"] for r in rows[6:]] == [1, 2] and all(r["invariant"] for r in rows[6:])
    with open(tmp_path / "bench_sweep.tsv") as f:
        assert f.readline().rstrip("\n").split("\t") == [
            "axis", "size", "nodes", "elements", "format", "devices",
            "lhs_matrix_assembly_s", "mdof_per_s", "solve_s", "iterations", "invariant"]


def test_scan_covers_the_last_tools():
    """The source scan above reads the ILU decision tool and the cache gate."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("tools/ilu_decision.py", "tools/verify_caches.py"):
        assert os.path.join("arcanefem_tpu_torch", mod) in scanned, mod


_TOOLS_SCRIPT = _PRELUDE + """
import runpy
sys.modules["tools"] = None  # nor the root tools/
from arcanefem_tpu_torch.tools import ilu_decision
small = {"poisson2d_8k": (8, 8), "poisson3d_11k": (4, 4, 4), "elasticity2d_5k": (6, 6)}
rows = [ilu_decision.decision_row(s.name, s.A, s.rhs) for s in ilu_decision.systems("cpu", small)]
codes = []
for mod in ("ilu_decision", "verify_caches"):
    sys.argv = [mod]
    try:  # without CUDA the first exits 1; on an empty cache the gate exits 1
        runpy.run_module("arcanefem_tpu_torch.tools." + mod, run_name="__main__")
        codes.append(0)
    except SystemExit as e:
        codes.append(e.code)
print(json.dumps({"rows": rows, "codes": codes,
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu", "bench", "tools")
                             and sys.modules[m] is not None]}))
"""


def test_last_tools_run_without_jax(tmp_path):
    """tools/ilu_decision.py (its systems and rows at a small size on the
    CPU; its entry point, which exits 1 without CUDA) and
    tools/verify_caches.py (exit 1 on an empty cache directory, every file
    MISSING) in a process where neither jax, arcanefem_tpu, the root bench
    nor the root tools can be imported."""
    env = dict(os.environ, PYTHONPATH=REPO, AFEM_CACHE_DIR=str(tmp_path / "empty"))
    for k in [k for k in env if k.startswith("BENCH_")]:
        del env[k]
    proc = subprocess.run([sys.executable, "-c", _TOOLS_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    out = json.loads(lines[-1])
    assert out["codes"] == [1, 1] and out["loaded"] == []
    assert [r["system"] for r in out["rows"]] == ["poisson2d_8k", "poisson3d_11k",
                                                  "elasticity2d_5k"]
    assert all(0 < r["ic0_iters"] < 2000 for r in out["rows"])
    assert sum(ln.startswith("  MISSING ") for ln in lines) == 4
