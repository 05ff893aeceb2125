"""The port runs where jax is not installed: it imports no jax, and of
arcanefem_tpu only the framework-free host modules."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the arcanefem_tpu modules that import neither jax nor a module that does
HOST_MODULES = {
    "arcanefem_tpu.mesh.core", "arcanefem_tpu.mesh.gmsh",
    "arcanefem_tpu.mesh.generate", "arcanefem_tpu.mesh.unstructured",
    "arcanefem_tpu.sparse.topology", "arcanefem_tpu.utils.ordering",
    "arcanefem_tpu.utils.native", "arcanefem_tpu.utils.cache",
}


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
            assert name.split(".")[0] not in ("jax", "jaxlib"), name
            if name.split(".")[0] == "arcanefem_tpu":
                assert name in HOST_MODULES, name


_SCRIPT = """
import json, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import torch
from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
mesh, topo = sphere_cut_system(14.0, 0, cache=False)
res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64, penalty=1e30)
print(json.dumps({"iterations": res["iterations"], "rel": res["rel"],
                  "true_residual": res["true_residual"],
                  "jax_loaded": [m for m in sys.modules if m.startswith("jax")
                                 and sys.modules[m] is not None]}))
"""


def test_slice_runs_without_jax():
    """The h=14 slice on the CPU in a process where jax cannot be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_loaded"] == []
    assert out["rel"] <= 1e-8 and out["true_residual"] <= 1e-6
    assert out["iterations"] > 0
