"""The port runs where jax is not installed: neither the package nor
chip_smoke.py imports jax or anything of arcanefem_tpu (the port keeps its
own copies of the host code it needs)."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN = ("jax", "jaxlib", "arcanefem_tpu")


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
import torch
"""
_REPORT = """
print(json.dumps({"iterations": res["iterations"], "rel": res["rel"],
                  "true_residual": tr,
                  "loaded": [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "arcanefem_tpu")
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
