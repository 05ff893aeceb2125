"""The port's bench line (arcanefem_tpu_torch/bench.py) against the root
``bench.py`` on the CPU: the roofline estimate and the merged JSON equal
bench.py's (exactly), the knobs map onto the port's routes or raise, and
nothing falls back (no CUDA: non-zero exit and no line; a failed child:
the line of what completed, its error, a non-zero exit)."""

import json
import os
import subprocess
import sys

import pytest

import bench as root_bench
from arcanefem_tpu_torch import bench
from arcanefem_tpu_torch.bench_structured import Options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRIMARY = {"metric": "poisson3d_sphere_cut_8.9MDoF_assembly+amgpcg_to_1e-08_s",
           "value": 0.3125, "assembly_s": 0.0054, "n_dofs": 8865969,
           "nnz_stored": 131608209, "iterations": 41, "platform": "tpu",
           "gpu": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
SECONDARY = {"metric": "poisson3d_box_11.4MDoF_assembly+cg_to_1e-08_s",
             "value": 0.0912, "assembly_mdofs": 16446.2, "iterations": 13,
             "n_dofs": 11390625, "nnz_stored": 170859375, "platform": "tpu"}


@pytest.mark.parametrize("n,nnz", [(8865969, 131608209), (1892689, 27894865),
                                   (11390625, 170859375), (1, 1), (0, 0)])
def test_roofline_estimate_equals_bench(n, nnz):
    assert bench.reference_roofline_estimate(n, nnz) == \
        root_bench.reference_roofline_estimate(n, nnz)


@pytest.mark.parametrize("p,s", [(PRIMARY, SECONDARY), (PRIMARY, None),
                                 (None, SECONDARY), (None, None),
                                 ({**PRIMARY, "platform": "cpu"}, SECONDARY)])
def test_final_json_equals_bench(p, s):
    """Key for key and value for value, with bench.py's platforms: the
    secondary is promoted when the primary is missing, and both missing
    give the error dict."""
    assert bench.final_json(p, s) == root_bench._final_json(p, s)


def test_final_json_promotes_and_errors():
    out = bench.final_json(None, SECONDARY)
    assert out["metric"] == SECONDARY["metric"] and "secondary_metric" not in out["extra"]
    out = bench.final_json(None, None)
    assert out["value"] is None and out["extra"]["error"]


def test_final_json_cuda_has_vs_baseline():
    """On "cuda" the port computes vs_baseline = round(estimate / value, 3),
    where bench.py gives None (it computes it on "tpu" only)."""
    p = {**PRIMARY, "platform": "cuda"}
    out = bench.final_json(p, {**SECONDARY, "platform": "cuda"})
    est = bench.reference_roofline_estimate(p["n_dofs"], p["nnz_stored"])
    assert out["vs_baseline"] == round(est / p["value"], 3)
    assert out["extra"]["baseline_estimate_s"] == round(est, 4)
    assert root_bench._final_json(p, SECONDARY)["vs_baseline"] is None
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert {"secondary_metric", "secondary_value", "secondary_assembly_mdofs",
            "baseline_kind", "baseline_estimate_s", "gpu",
            "power_limit"} <= set(out["extra"])


def test_no_cuda_exits_nonzero_without_a_line():
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_a_failing_child_is_reported():
    """A real child process that fails (here: no CUDA device) gives no
    result and says why."""
    assert bench._run_child("primary", 300) == (
        None, "primary: exit code 1, no JSON line")


@pytest.mark.parametrize("name", sorted(bench.NO_COUNTERPART))
def test_knob_without_counterpart_raises(name):
    bench.check_knobs({name: bench.NO_COUNTERPART[name]})  # the default passes
    with pytest.raises(ValueError, match=name):
        bench.check_knobs({name: "7"})


def test_primary_knobs_map_to_the_port_routes():
    h, refine, rtol, opts = bench.primary_args({})
    assert (h, refine, rtol) == (6.0, 3, 1e-8)
    assert opts == {"spmv": "ell", "sn_block": False, "sn_bf16": False,
                    "vcycle_bf16": False, "asm_coords": "split",
                    "asm_compact": False, "band_pre": False,
                    "asm_reduce": "window", "order": "sn",
                    "smoother": "chebyshev", "cheb_deg": 2, "cycle": "V",
                    "theta": 0.03, "cheb_apply": None}
    env = {"BENCH_UNSTR_H": "5", "BENCH_UNSTR_REFINE": "2", "BENCH_RTOL": "1e-6",
           "BENCH_UNSTR_SPMV": "supernode", "BENCH_SN_BLOCK": "1",
           "BENCH_SN_BF16": "1", "AFEM_ASM_COORDS": "batched",
           "BENCH_AMG_SMOOTHER": "jacobi", "BENCH_AMG_CHEB_DEG": "2,4",
           "BENCH_AMG_CYCLE": "W"}
    h, refine, rtol, opts = bench.primary_args(env)
    assert (h, refine, rtol) == (5.0, 2, 1e-6)
    assert opts["spmv"] == "supernode" and opts["sn_block"] and opts["sn_bf16"]
    assert (opts["asm_coords"], opts["smoother"], opts["cheb_deg"], opts["cycle"]) \
        == ("batched", "jacobi", (2, 4), "W")
    assert bench.primary_args({"BENCH_UNSTR_SPMV": "window"})[3]["spmv"] == "ell"
    assert bench.primary_args({"AFEM_SPMV": "diag", "BENCH_UNSTR_ORDER": "rcm"}
                              )[3]["spmv"] == "diag"
    opts = bench.primary_args({"AFEM_SPMV": "compact", "AFEM_BAND_PRE": "1",
                               "AFEM_ASM_COMPACT": "1", "BENCH_UNSTR_BF16": "0"})[3]
    assert (opts["spmv"], opts["band_pre"], opts["asm_compact"]) == ("compact", True, True)
    # AFEM_UNSTR_ASM (refused until the reorder and segsum orders were
    # ported) picks the assembly's list order; the compact V-cycle takes
    # the bf16 weights as the JAX bench combines them
    for order in ("window", "segsum", "reorder"):
        assert "AFEM_UNSTR_ASM" not in bench.NO_COUNTERPART
        assert bench.primary_args({"AFEM_UNSTR_ASM": order})[3]["asm_reduce"] == order
    opts = bench.primary_args({"AFEM_SPMV": "compact", "BENCH_UNSTR_BF16": "1"})[3]
    assert (opts["spmv"], opts["vcycle_bf16"]) == ("compact", True)


@pytest.mark.parametrize("env", [
    {"BENCH_UNSTR_SPMV": "blocked"},
    {"BENCH_UNSTR_SPMV": "supernode", "AFEM_SPMV": "compact"},
    {"AFEM_SPMV": "window"},
    {"BENCH_SN_BLOCK": "yes"},
    {"BENCH_SN_BF16": "1"},  # needs the supernode operator
    {"BENCH_UNSTR_ORDER": "rcm", "BENCH_UNSTR_SPMV": "supernode"},
    {"BENCH_AMG_SMOOTHER": "gauss-seidel"},
    {"AFEM_UNSTR_ASM": "atomic"},
])
def test_bad_primary_knobs_raise(env):
    with pytest.raises(ValueError):
        bench.primary_args(env)


def test_secondary_knobs():
    assert bench.secondary_args({}) == (224, "mg", Options())
    env = {"BENCH_N": "64", "BENCH_PRECOND": "jacobi", "BENCH_NU": "2",
           "BENCH_SMOOTHER": "cheb", "BENCH_MG_BF16": "0", "BENCH_FUSED": "0",
           "BENCH_CHUNK": "4", "BENCH_RTOL": "1e-6"}
    assert bench.secondary_args(env) == (
        64, "jacobi", Options(nu=2, smoother="cheb", mg_bf16=False, fused=False,
                              chunk=4, rtol=1e-6))
    for bad in ({"BENCH_PRECOND": "amg"}, {"BENCH_SMOOTHER": "sor"},
                {"BENCH_CHUNK": "0"}, {"BENCH_FUSED": "2"}):
        with pytest.raises(ValueError):
            bench.secondary_args(bad)


def _fake_main(monkeypatch, env, results):
    """main() with a card reported and children replaced by ``results``
    (role -> (result, error)); returns (exit code, the timeouts the
    children got)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for k in list(os.environ):
        if k.startswith(("BENCH_", "AFEM_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    timeouts = {}

    def run_child(role, timeout):
        timeouts[role] = timeout
        return results[role]

    monkeypatch.setattr(bench, "_run_child", run_child)
    return bench.main([]), timeouts


def test_failed_child_leaves_the_line_and_exits_nonzero(monkeypatch, capsys):
    p = {**PRIMARY, "platform": "cuda"}
    rc, _ = _fake_main(monkeypatch, {}, {"primary": (p, None),
                                         "secondary": (None, "secondary: exit code 1")})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert line["metric"] == p["metric"] and line["extra"]["error"] == "secondary: exit code 1"
    rc, _ = _fake_main(monkeypatch, {}, {"primary": (None, "primary: timed out after 9 s"),
                                         "secondary": ({**SECONDARY, "platform": "cuda"},
                                                       None)})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["metric"] == SECONDARY["metric"]
    assert line["extra"]["error"] == "primary: timed out after 9 s"


def test_both_children_succeed(monkeypatch, capsys):
    p, s = {**PRIMARY, "platform": "cuda"}, {**SECONDARY, "platform": "cuda"}
    rc, timeouts = _fake_main(monkeypatch, {}, {"primary": (p, None),
                                                "secondary": (s, None)})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line == bench.final_json(p, s) and "error" not in line["extra"]
    assert timeouts["primary"] > 1500 and timeouts["secondary"] <= 900 + 180


def test_budget_zero_is_no_limit(monkeypatch, capsys):
    """BENCH_BUDGET_S=0 runs the children without a timeout (bench.py's
    int(inf) fault is not inherited)."""
    p, s = {**PRIMARY, "platform": "cuda"}, {**SECONDARY, "platform": "cuda"}
    rc, timeouts = _fake_main(monkeypatch, {"BENCH_BUDGET_S": "0"},
                              {"primary": (p, None), "secondary": (s, None)})
    assert rc == 0 and timeouts == {"primary": None, "secondary": None}


def test_skipped_secondary_is_an_error(monkeypatch, capsys):
    p = {**PRIMARY, "platform": "cuda"}
    rc, timeouts = _fake_main(monkeypatch, {"BENCH_BUDGET_S": "100"},
                              {"primary": (p, None)})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and "secondary" not in timeouts
    assert line["extra"]["error"].startswith("secondary: skipped")


def test_skip_flags(monkeypatch, capsys):
    s = {**SECONDARY, "platform": "cuda"}
    rc, timeouts = _fake_main(monkeypatch, {"BENCH_UNSTR": "0"},
                              {"secondary": (s, None)})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and list(timeouts) == ["secondary"] and line["metric"] == s["metric"]
    rc, timeouts = _fake_main(monkeypatch, {"BENCH_UNSTR": "0", "BENCH_BOX": "0"}, {})
    assert rc == 1 and timeouts == {} and capsys.readouterr().out == ""


def test_knob_without_counterpart_stops_main(monkeypatch):
    with pytest.raises(ValueError, match="AFEM_ASM_MAX_GB"):
        _fake_main(monkeypatch, {"AFEM_ASM_MAX_GB": "12"}, {})


def test_prime_host_caches_the_host_set_up(monkeypatch, tmp_path):
    """``bench_unstructured --prime``: the mesh, orders and topologies are
    built once into the cache directory and loaded the second time, with
    the same system."""
    from arcanefem_tpu_torch import bench_unstructured as bu

    monkeypatch.setattr(bu, "CACHE_DIR", str(tmp_path))
    first = bu.prime_host(14.0, 0)
    assert sorted(os.listdir(tmp_path)) == [
        "sphere_cut_v3_h14_r0.npz", "sphere_cut_v3_h14_r0_snmesh.npz",
        "topo_sphere_cut_v3_h14_r0.npz", "topo_sphere_cut_v3_h14_r0_sn.npz"]
    second = bu.prime_host(14.0, 0)
    keys = ("mesh_key", "n_dofs", "n_cells", "nnz_stored", "width")
    assert {k: first[k] for k in keys} == {k: second[k] for k in keys}
    assert first["mesh_key"] == "sphere_cut_v3_h14_r0_sn" and first["n_dofs"] == 1887


def test_amg_knobs_map_to_the_port():
    """BENCH_AMG_THETA and BENCH_AMG_CHEB_APPLY are honoured (no longer
    refused): the build theta and the apply-time degree reach the route
    options; the defaults leave both where they were."""
    for name in ("BENCH_AMG_THETA", "BENCH_AMG_CHEB_APPLY"):
        assert name not in bench.NO_COUNTERPART
        bench.check_knobs({name: "7"})
    opts = bench.primary_args({"BENCH_AMG_THETA": "0.08",
                               "BENCH_AMG_CHEB_APPLY": "3"})[3]
    assert (opts["theta"], opts["cheb_apply"], opts["cheb_deg"]) == (0.08, 3, 2)
    opts = bench.primary_args({"BENCH_AMG_CHEB_APPLY": "2,4"})[3]
    assert (opts["theta"], opts["cheb_apply"]) == (0.03, (2, 4))
    assert bench.primary_args({"BENCH_AMG_CHEB_APPLY": ""})[3]["cheb_apply"] is None
    with pytest.raises(ValueError):
        bench.primary_args({"BENCH_AMG_THETA": "loose"})


def test_amg_cache_is_keyed_by_build_theta_and_degree(tmp_path):
    """The AMG cache file carries the build theta (as bench.py's pickle
    name does) and the build degree; an apply-time degree solves exactly as
    a hierarchy built at that degree, from the file of the build degree."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.bench_unstructured import (
        amg_cache_entry,
        solve_sphere_cut,
        sphere_cut_system,
    )

    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    flat = np.zeros(topo.n_nodes * topo.width)
    kw = dict(smoother="chebyshev", cheb_deg=2, penalty=1e30, device="cpu",
              dtype=torch.float64)
    p3, m3 = amg_cache_entry(str(tmp_path / "k"), topo, flat, **kw)
    p8, m8 = amg_cache_entry(str(tmp_path / "k"), topo, flat, theta=0.08, **kw)
    assert "_t0.03_" in p3 and "_t0.08_" in p8 and (m3["theta"], m8["theta"]) == (0.03, 0.08)
    run = dict(device="cpu", dtype=torch.float64, penalty=1e30)
    built3 = solve_sphere_cut(mesh, topo, cheb_deg=3, **run)
    applied = solve_sphere_cut(mesh, topo, cheb_deg=2, cheb_apply=3,
                               cache=str(tmp_path / "k"), **run)
    assert applied["iterations"] == built3["iterations"]
    assert torch.equal(applied["x"], built3["x"])
    names = [f.name for f in tmp_path.iterdir()]
    assert any(n.startswith("amg_k_chebyshev2_t0.03_cpu") for n in names), names
    loose = solve_sphere_cut(mesh, topo, theta=0.08, cache=str(tmp_path / "k"), **run)
    assert any("_t0.08_" in f.name for f in tmp_path.iterdir())
    assert loose["rel"] <= 1e-8 and loose["true_residual"] <= 1e-6
    with pytest.raises(ValueError, match="theta"):
        solve_sphere_cut(mesh, topo, theta=0.03, system=loose["system"], **run)

