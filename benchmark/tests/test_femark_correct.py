"""``correct`` at a small size on the CPU, with the port's plain twins:
the reference passes the program, fails the bf16 control, and fails the
run when the timed path is broken underneath (the h = 14 sphere and the
16³ box; the measuring command itself still refuses to run without a
card)."""

import os
import subprocess
import sys

import pytest
import torch

import arcanefem_tpu_torch.bench_structured as bench_structured
import arcanefem_tpu_torch.solver.iterative as iterative
from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
from benchmark import control, core, run

SMALL = {"sphere_cut": {"mesh": {"h": 14, "refine": 0}},
         "kuhn_box": {"mesh": {"n": 16, "jitter": 0.1}}}
CELLS = [w["name"] for w in core.spec()["workloads"]]
SEED = 2**31 + 11


def small(cell):
    return SMALL[core.cell(cell)[1]["system"]]


def go(cell, trace=False, seconds=0.2):
    return run.run(cell, SEED, seconds, trace, device="cpu", plain=True, mesh_cache=False,
                   config_overrides=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_the_control_is_not(cell):
    w = core.load("workloads", cell)
    recs = list(control.readings(cell, [SEED, 5], 0.2, device="cpu", plain=True,
                                 mesh_cache=False, config_overrides=small(cell)))
    for rec in recs:
        assert rec["attempted"] > 0 and rec["failed"] == 0
        assert all(v <= w["limits"][k] for k, v in rec["program"].items()), rec
        assert any(not v <= w["limits"][k] for k, v in rec["control"].items()), rec


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_reports_its_checks_and_metrics(cell):
    result, checks = go(cell)
    assert result["correct"] is True
    assert set(checks) == set(core.load("workloads", cell)["limits"]) | {"failed_cases"}
    assert "setup_s" in result["metrics"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _x0_unchanged(orig):
    def pcg(A, b, M, x0, *args, **kw):
        orig(A, b, M, x0, *args, **kw)
        return x0.to(torch.float64), 1, 0.0
    return pcg


def _answer_altered(orig):
    def pcg(A, b, M, x0, *args, **kw):
        x, k, rel = orig(A, b, M, x0, *args, **kw)
        x = x.clone()
        flat = x.view(-1)
        free = torch.nonzero((x0.reshape(-1) == 0) & (flat != 0)).view(-1)
        i = int(free[len(free) // 2])  # a free node of the mesh, not a pad
        flat[i] = flat[i] * 1.1
        return x, k, rel
    return pcg


def _stops_early(orig):
    def pcg(A, b, M, x0, rtol, *args, **kw):
        return orig(A, b, M, x0, rtol * 100.0, *args, **kw)
    return pcg


def _half_the_cells(orig):
    def element_table(self, coords):
        t = orig(self, coords).clone()
        t[t.shape[0] // 2:] = 0
        return t
    return element_table


def _half_the_planes(orig):
    def assemble_system(box, coords3d, *args, **kw):
        Ap, rhs = orig(box, coords3d, *args, **kw)
        Ap.bands_p[: (box.nx + 1) // 2] = 0
        return Ap, rhs
    return assemble_system


def _stale(orig):
    first = {}

    def call(self, coords):
        if "vals" not in first:
            first["vals"] = orig(self, coords)
        return first["vals"].clone()
    return call


def _one_value_altered(orig):
    def call(self, coords):
        vals = orig(self, coords)
        vals[int(torch.argmin(vals))] *= 1.01  # the most negative (off-diagonal) entry
        return vals
    return call


FAULTS = {
    # a step that returns its state unchanged
    ("sphere-1.9m.amg-pcg", "unchanged"): (iterative, "pcg", _x0_unchanged),
    ("box-224-r0.mg-pcg", "unchanged"): (bench_structured, "pcg_chunked", _x0_unchanged),
    ("sphere-1.9m.assembly", "unchanged"): (TetraAssembler, "__call__", _stale),
    # half of the batch (of cells) left out
    ("sphere-1.9m.amg-pcg", "half"): (TetraAssembler, "element_table", _half_the_cells),
    ("box-224-r0.mg-pcg", "half"): (bench_structured, "assemble_system", _half_the_planes),
    ("sphere-1.9m.assembly", "half"): (TetraAssembler, "element_table", _half_the_cells),
    # an answer altered where it is produced
    ("sphere-1.9m.amg-pcg", "altered"): (iterative, "pcg", _answer_altered),
    ("box-224-r0.mg-pcg", "altered"): (bench_structured, "pcg_chunked", _answer_altered),
    ("sphere-1.9m.assembly", "altered"): (TetraAssembler, "__call__", _one_value_altered),
    # CG stopped 100x above the configuration's rtol
    ("sphere-1.9m.amg-pcg", "early"): (iterative, "pcg", _stops_early),
    ("box-224-r0.mg-pcg", "early"): (bench_structured, "pcg_chunked", _stops_early),
}


@pytest.mark.parametrize("cell,fault", [k for k in FAULTS if k[0] in CELLS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    owner, attr, make = FAULTS[(cell, fault)]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    # a broken box stalls CG; 60 iterations are enough to be judged
    capped = bench_structured.pcg_chunked
    monkeypatch.setattr(bench_structured, "pcg_chunked",
                        lambda A, b, M, x0, rtol, atol, n, **kw:
                        capped(A, b, M, x0, rtol, atol, min(n, 60), **kw))
    result, checks = go(cell)
    assert result["correct"] is False, checks


def test_the_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=core.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    import shutil

    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".data", "__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card(cell, cuda):
    result, checks = run.run(cell, SEED, 0.5, True, device=cuda, mesh_cache=False,
                             config_overrides=small(cell))
    assert result["correct"] is True, checks
    assert result["device"]["busy_s"] > 0
