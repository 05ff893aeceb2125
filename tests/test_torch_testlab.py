"""The assembly-format laboratory (arcanefem_tpu_torch/testlab.py, the
Testlab codename) against the JAX package's, on the CPU in float64.

cross_validate on a tetra box, on a StructuredBox with its dia-stencil
(SpMV equivalence) and on the mixed hexa8/pyramid5/penta6/tetra4 box of
``tools/write_msh.py`` (in place of the reference's absent
bar_hybrid_quad_tria.msh); each format's values against JAX's at 1e-12 of
the largest; the five fixed-order formats equal bit for bit; run_lab's
and the CLI's JSON keys equal to JAX's; and each flag of
``_FLAG_TO_FORMAT`` through run_case on a written case against the JAX
run_case (fields at 1e-9, iterations ± 1) and against the Poisson
codename's field of the same case."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arcanefem_tpu import testlab as jax_testlab
from arcanefem_tpu.fem.runner import run_case as jax_run_case
from arcanefem_tpu.mesh.core import read_msh as jax_read_msh
from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box
from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.sparse.topology import build_topology as jax_build_topology
from arcanefem_tpu_torch import testlab
from arcanefem_tpu_torch.fem.runner import run_case
from arcanefem_tpu_torch.mesh.core import read_msh
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.mesh.structured import StructuredBox
from arcanefem_tpu_torch.models.testlab_model import _FLAG_TO_FORMAT
from arcanefem_tpu_torch.sparse.topology import build_topology
from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh, write_arc, write_msh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED_ORDER = ("bell-segsum", "bell-sorted", "csr-segsum", "coo", "coo-sorted")


@pytest.fixture(scope="module")
def mixed_msh(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("testlab_mixed") / "mixed.msh")
    write_msh(path, mixed_box_mesh(2, 2))
    return path


def test_cross_validation_box():
    report = testlab.cross_validate(box_tetra_mesh(6, 5, 4), device="cpu")
    assert set(report) == set(testlab.FORMATS) == set(jax_testlab.FORMATS)
    assert max(report.values()) < 1e-12


def test_cross_validation_dia_stencil():
    box = StructuredBox(6, 5, 4)
    mesh = box.to_mesh()
    jmesh = JaxBox(6, 5, 4).to_mesh()
    assert np.array_equal(mesh.coords, jmesh.coords)
    assert np.array_equal(mesh.cells["tetra4"], jmesh.cells["tetra4"])
    report = testlab.cross_validate(mesh, box=box, device="cpu")
    jreport = jax_testlab.cross_validate(jmesh, box=JaxBox(6, 5, 4))
    assert set(report) == set(jreport) and "dia-stencil" in report
    assert max(report.values()) < 1e-12
    coords = box.grid_coords(np.float64, jitter=0.2, seed=3)
    moved = box.to_mesh(coords)
    assert np.array_equal(moved.coords, coords.reshape(-1, 3))
    assert max(testlab.cross_validate(moved, box=box, device="cpu").values()) < 1e-12


def test_cross_validation_mixed_mesh(mixed_msh):
    mesh = read_msh(mixed_msh)
    assert {"hexa8", "pyramid5", "penta6", "tetra4"} <= set(mesh.cells)
    report = testlab.cross_validate(mesh, device="cpu")
    assert set(report) == set(jax_testlab.cross_validate(jax_read_msh(mixed_msh)))
    assert max(report.values()) < 1e-12


def _meshes(which, mixed_msh):
    if which == "box":
        return box_tetra_mesh(6, 5, 4), jax_box(6, 5, 4)
    return read_msh(mixed_msh), jax_read_msh(mixed_msh)


@pytest.mark.parametrize("which", ["box", "mixed"])
@pytest.mark.parametrize("name", list(testlab.FORMATS))
def test_format_values_match_jax(name, which, mixed_msh):
    """Each format's (N, W) values against JAX's on the same topology, at
    1e-12 of the largest."""
    mesh, jmesh = _meshes(which, mixed_msh)
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    jtopo = jax_build_topology(jmesh.n_nodes, jmesh.cells, pad_width_to=8)
    A = testlab.FORMATS[name](topo, testlab.element_matrices(mesh, torch.float64, "cpu"),
                              torch.float64)
    want = np.asarray(jax_testlab.FORMATS[name](
        jtopo, jax_testlab.element_matrices(jmesh, np.float64), np.float64).values
    ).reshape(topo.n_nodes, topo.width)
    got = A.ell_values().numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert torch.equal(A.diagonal(), A.ell_values().reshape(-1)[
        torch.as_tensor(topo.diag_slot).long()])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fixed_order_formats_bit_equal(dtype, mixed_msh):
    """The five fixed-order formats sum each slot's entries in entry order
    in float64: equal bit for bit with each other and from call to call;
    bell-scatter within round-off."""
    for mesh in (box_tetra_mesh(6, 5, 4), read_msh(mixed_msh)):
        topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
        mats = testlab.element_matrices(mesh, dtype, "cpu")
        vals = [testlab.FORMATS[n](topo, mats, dtype).values for n in FIXED_ORDER]
        for v in vals + [testlab.FORMATS[n](topo, mats, dtype).values for n in FIXED_ORDER]:
            assert v.dtype == dtype and torch.equal(v, vals[0])
        scatter = testlab.FORMATS["bell-scatter"](topo, mats, dtype).values
        eps = torch.finfo(dtype).eps
        assert float((scatter - vals[0]).abs().max()) <= 64 * eps * float(vals[0].abs().max())


def test_run_lab_keys_match_jax():
    box = StructuredBox(5, 4, 3)
    stats = testlab.run_lab(box.to_mesh(), cache_warming=2, dtype=torch.float64,
                            box=box, device="cpu")
    jbox = JaxBox(5, 4, 3)
    jstats = jax_testlab.run_lab(jbox.to_mesh(), cache_warming=2, dtype=np.float64,
                                 box=jbox)
    assert list(stats) == list(jstats)
    assert list(stats["formats"]) == list(jstats["formats"])
    for name, entry in stats["formats"].items():
        assert sorted(entry) == sorted(jstats["formats"][name])
        assert entry["lhs-matrix-assembly"] > 0
    for k in ("nbNode", "nbElement", "nnz", "ell_width", "cache_warming",
              "strategies_not_applicable_on_tpu"):
        assert stats[k] == jstats[k], k
    assert "build-topology" in stats["time_stats"]
    assert {f"plan:{n}" for n in testlab.FORMATS} <= set(stats["time_stats"])
    # structured formats alone: no topology, nnz and width from the box
    alone = testlab.run_lab(box.to_mesh(), formats=["dia-stencil"], cache_warming=1,
                            box=box, device="cpu")
    assert (alone["nnz"], alone["ell_width"]) == (stats["nnz"], stats["ell_width"])
    assert "build-topology" not in alone["time_stats"]
    with pytest.raises(ValueError, match="structured mesh"):
        testlab.run_lab(rect_tria_mesh(4, 4), formats=["dia-stencil"], device="cpu")


def test_cli_cross_validate_keys_match_jax(capsys):
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch", "testlab",
                           "--rect", "12", "--device", "cpu", "--cross-validate"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_testlab.main(["--rect", "12", "--cross-validate", "--f64"])
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == list(jout) == ["cross_validation_max_rel"]
    assert list(out["cross_validation_max_rel"]) == list(jout["cross_validation_max_rel"])
    assert max(out["cross_validation_max_rel"].values()) < 1e-12


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("testlab_cases")
    write_msh(str(d / "rect.msh"), rect_tria_mesh(14, 11, lx=1.0, ly=0.8))
    write_msh(str(d / "box.msh"), box_tetra_mesh(6, 5, 4))
    return d


def _case(d, name, mesh_file, codename, flag=None):
    """A Poisson problem, f = 1.5, u = 0 and 1 on two opposite faces by
    penalty: Testlab reads them as <dirichlet-boundary-condition>
    blocks (the JAX model's form), Poisson from <boundary-conditions>."""
    left, right = ("left", "right") if mesh_file == "rect.msh" else ("xmin", "xmax")
    path = str(d / f"{name}.arc")
    bcs = [(left, 0.0), (right, 1.0)]
    if codename == "Testlab":
        write_arc(path, mesh_file, codename=codename, f=1.5,
                  values={flag: "true"} if flag else None, dirichlet_bc=bcs)
    else:
        write_arc(path, mesh_file, codename=codename, f=1.5, dirichlet=bcs)
    return path


@pytest.mark.parametrize("flag", list(_FLAG_TO_FORMAT))
def test_flag_runs_like_jax(flag, case_dir):
    """Each format flag through run_case on a written case (the 2D rect
    for half of the flags, the tetra box for the others) against the JAX
    run_case and the port's Poisson run of the same case."""
    mesh_file = "rect.msh" if list(_FLAG_TO_FORMAT).index(flag) % 2 else "box.msh"
    path = _case(case_dir, f"flag_{flag}", mesh_file, "Testlab", flag)
    res = run_case(path, device="cpu")
    jres = jax_run_case(path)
    ju = np.asarray(jres.u)
    assert type(res).__name__ == type(jres).__name__ == "PoissonResult"
    assert res.u.dtype == np.float64 and res.u.shape == ju.shape
    assert np.abs(res.u - ju).max() <= 1e-9 * np.abs(ju).max()
    assert abs(res.iterations - int(jres.iterations)) <= 1
    poisson = run_case(_case(case_dir, f"poisson_{flag}", mesh_file, "Poisson"),
                       device="cpu")
    assert np.abs(res.u - poisson.u).max() <= 1e-9 * np.abs(poisson.u).max()


def test_timer_dump_json_as_jax(tmp_path):
    """PhaseTimer.meta and dump_json write the JAX timer's payload: meta,
    the call's keywords, then time_stats."""
    from arcanefem_tpu.fem.timer import PhaseTimer as JaxTimer
    from arcanefem_tpu_torch.fem.timer import PhaseTimer

    out = {}
    for name, cls in (("port", PhaseTimer), ("jax", JaxTimer)):
        t = cls(verbose=False)
        t.meta["nbNode"] = 12
        with t.phase("lhs-matrix-assembly"):
            pass
        t.dump_json(str(tmp_path / f"{name}.json"), format="coo", nbNode=13)
        with open(tmp_path / f"{name}.json") as f:
            out[name] = json.load(f)
    assert list(out["port"]) == list(out["jax"]) == ["nbNode", "format", "time_stats"]
    assert out["port"]["nbNode"] == 13
    assert list(out["port"]["time_stats"]) == ["lhs-matrix-assembly"]
