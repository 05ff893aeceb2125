"""The cache gate (arcanefem_tpu_torch/tools/verify_caches.py and
bench.py::default_cache_paths) on the CPU, on the bench system at h=14,
refine=0 in the bench's float32 with penalty 1e12: the files it lists are
exactly those a run reads, in each node order; it exits 0 when they are all
there with their key fields, 1 when one is missing, stale or of another
set-up branch, and warns on an interrupted write and on another key
version."""

import os
import shutil

import numpy as np
import pytest

from arcanefem_tpu_torch import bench_unstructured as bu
from arcanefem_tpu_torch.bench import default_cache_paths
from arcanefem_tpu_torch.sparse.sell import SellLayout
from arcanefem_tpu_torch.tools import verify_caches
from arcanefem_tpu_torch.utils.cache import read_meta, save_npz

H, REFINE = 14.0, 0


def _env(d, **kw) -> dict:
    return {"AFEM_CACHE_DIR": str(d), "BENCH_UNSTR_H": "14", "BENCH_UNSTR_REFINE": "0",
            **kw}


def _run(d, order: str, monkeypatch) -> dict:
    """sphere_cut_system and solve_sphere_cut as the bench runs them, on
    the CPU, with the cache directory ``d``."""
    monkeypatch.setattr(bu, "CACHE_DIR", str(d))
    mesh, topo = bu.sphere_cut_system(H, REFINE, order=order)
    return bu.solve_sphere_cut(mesh, topo, device="cpu", dtype=bu.DTYPE, penalty=bu.PENALTY,
                               order=order, cache=os.path.join(str(d), bu.mesh_key(H, REFINE, order)))


def _files(d) -> dict:
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module", params=["sn", "rcm"])
def cold(request, tmp_path_factory):
    """(order, the directory of one cold run, the files it wrote)."""
    d = tmp_path_factory.mktemp(f"cache_{request.param}")
    with pytest.MonkeyPatch.context() as mp:
        _run(d, request.param, mp)
    return request.param, d, _files(d)


def _gate(env, capsys) -> tuple[int, str]:
    code = verify_caches.main(env, "cpu")
    return code, capsys.readouterr().out


def test_listed_files_are_the_files_read(cold, tmp_path, monkeypatch):
    """default_cache_paths names only files the cold run wrote; with every
    other file removed a second run builds nothing and writes nothing: it
    loads the mesh, topology, SELL layout and hierarchy from those files."""
    order, src, written = cold
    d = tmp_path / "c"
    shutil.copytree(src, d)
    env = _env(d, BENCH_UNSTR_ORDER=order)
    paths = default_cache_paths(env, "cpu")
    assert list(paths) == ["mesh", "topology", "sell", "amg"]
    listed = {os.path.basename(p) for p, _ in paths.values()}
    assert listed <= set(written)
    if order == "rcm":  # the RCM run writes exactly what it reads
        assert listed == set(written)
    for f in set(written) - listed:  # the sn run's RCM stage
        os.remove(d / f)
    before, builds = _files(d), SellLayout.builds
    res = _run(d, order, monkeypatch)
    assert res["amg_setup_cached"] and SellLayout.builds == builds
    assert _files(d) == before


def test_gate_exit_codes(cold, tmp_path, capsys):
    """Exit 0 on the cold run's directory, with one ok line per listed file;
    exit 1 once a file is removed, which its MISSING line names; exit 1 on
    an empty directory, every file MISSING."""
    order, src, _ = cold
    d = tmp_path / "c"
    shutil.copytree(src, d)
    env = _env(d, BENCH_UNSTR_ORDER=order)
    code, out = _gate(env, capsys)
    assert code == 0, out
    assert sum(ln.startswith("  ok ") for ln in out.splitlines()) == 4
    gone = default_cache_paths(env, "cpu")["sell"][0]
    os.remove(gone)
    code, out = _gate(env, capsys)
    assert code == 1 and "MISSING sell" in out and gone in out
    code, out = _gate(_env(tmp_path / "empty", BENCH_UNSTR_ORDER=order), capsys)
    missing = [ln for ln in out.splitlines() if ln.startswith("  MISSING ")]
    assert code == 1 and len(missing) == 4


def test_gate_warns_on_tmp_and_other_versions(cold, tmp_path, capsys):
    """A planted ``.tmp<pid>`` file and a ``_v0`` file beside the SELL
    layout are warned about; the exit code stays 0."""
    order, src, _ = cold
    d = tmp_path / "c"
    shutil.copytree(src, d)
    env = _env(d, BENCH_UNSTR_ORDER=order)
    paths = default_cache_paths(env, "cpu")
    tmp = paths["amg"][0] + ".tmp4242"
    old = paths["sell"][0].replace("_v1.npz", "_v0.npz")
    for f in (tmp, old):
        with open(f, "wb") as fh:
            fh.write(b"partial")
    code, out = _gate(env, capsys)
    assert code == 0, out
    warns = [ln for ln in out.splitlines() if ln.startswith("  warn: ")]
    assert any(tmp in w and "interrupted" in w for w in warns), out
    assert any(old in w and "another key version" in w for w in warns), out


def test_gate_fails_on_another_key(cold, tmp_path, capsys):
    """An AMG file whose meta record holds another theta (or is unreadable)
    is STALE, with the fields that differ, and the gate exits 1."""
    order, src, _ = cold
    d = tmp_path / "c"
    shutil.copytree(src, d)
    env = _env(d, BENCH_UNSTR_ORDER=order)
    path = default_cache_paths(env, "cpu")["amg"][0]
    meta = read_meta(path)
    save_npz(path, {"x": np.zeros(1)}, {**meta, "theta": 0.08})
    code, out = _gate(env, capsys)
    assert code == 1 and "STALE   amg" in out and "(theta differ)" in out, out
    with open(path, "wb") as fh:
        fh.write(b"not a zip")
    code, out = _gate(env, capsys)
    assert code == 1 and "meta record unreadable" in out, out


def test_gate_follows_the_knobs(cold, tmp_path, capsys):
    """BENCH_NO_CACHE=1 lists the mesh and topology files only (exit 0
    here); AFEM_NATIVE_AMG=0 expects a scipy-branch hierarchy, so the
    native one is STALE; a knob the port does not run fails; BENCH_UNSTR=0
    lists nothing."""
    order, d, _ = cold
    env = _env(d, BENCH_UNSTR_ORDER=order)
    assert list(default_cache_paths({**env, "BENCH_NO_CACHE": "1"}, "cpu")) == \
        ["mesh", "topology"]
    code, out = _gate({**env, "BENCH_NO_CACHE": "1"}, capsys)
    assert code == 0 and "BENCH_NO_CACHE=1" in out
    code, out = _gate({**env, "AFEM_NATIVE_AMG": "0"}, capsys)
    assert code == 1 and "(amg_setup differ)" in out, out
    for bad in ({"AFEM_SPMV_WCAP": "8"}, {"AFEM_NATIVE_AMG": "2"},
                {"BENCH_UNSTR_ORDER": "bfs"}):
        code, out = _gate({**env, **bad}, capsys)
        assert code == 1 and out.startswith("FAIL: "), (bad, out)
    assert default_cache_paths({**env, "BENCH_UNSTR": "0"}, "cpu") == {}


def test_names_come_from_the_writers(tmp_path):
    """The listed names are those of mesh_files, sell_cache_key and
    amg_cache_key under the bench's defaults: the 8.9M sphere, cuda,
    float32, penalty 1e12, theta 0.03, degree-2 Chebyshev."""
    paths = default_cache_paths({"AFEM_CACHE_DIR": str(tmp_path)})
    names = {k: os.path.basename(p) for k, (p, _) in paths.items()}
    assert names == {
        "mesh": "sphere_cut_v3_h6_r3_snmesh.npz",
        "topology": "topo_sphere_cut_v3_h6_r3_sn.npz",
        "sell": "sell_sphere_cut_v3_h6_r3_sn_v1.npz",
        "amg": "amg_sphere_cut_v3_h6_r3_sn_chebyshev2_t0.03_cuda_p1e+12_float32_v1.npz"}
    assert paths["amg"][1] == {"what": "AMG hierarchy", "mesh": "sphere_cut_v3_h6_r3_sn",
                               "smoother": "chebyshev", "cheb_deg": 2, "theta": 0.03,
                               "platform": "cuda", "penalty": 1e12, "dtype": "float32"}
    assert paths["sell"][1] == {"what": "fine SELL layout"}
    assert paths["mesh"][1] is None and paths["topology"][1] is None
