"""The host cache of the AMG hierarchy and of SELL layouts
(arcanefem_tpu_torch/utils/cache.py, solver/amg.py::amg_cached,
sparse/sell.py::SellLayout.to_arrays/from_arrays) on the CPU, in float64,
on the bench system at h=14, refine=0: a saved and loaded hierarchy equals
the built one array for array and applies and solves bit for bit like it;
any change of the key or of the inputs' digests, and a truncated file,
rebuild instead of loading."""

import os

import numpy as np
import pytest
import torch

from arcanefem_tpu_torch.bench_unstructured import (
    amg_cache_entry,
    mesh_key,
    solve_sphere_cut,
    sphere_cut_system,
)
from arcanefem_tpu_torch.solver.amg import (
    amg_cached,
    amg_from_numpy,
    hierarchy_arrays,
    hierarchy_from_arrays,
)
from arcanefem_tpu_torch.solver.amg_setup import amg_setup
from arcanefem_tpu_torch.solver.iterative import pcg
from arcanefem_tpu_torch.sparse.sell import SellLayout
from arcanefem_tpu_torch.utils import cache

PENALTY = 1e30
OPTS = dict(smoother="chebyshev", cheb_deg=2, penalty=PENALTY, device="cpu",
            dtype=torch.float64)


@pytest.fixture(scope="module")
def system():
    """The h=14 system (f64, penalty rows) and its host values."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                           penalty=PENALTY)
    return mesh, topo, res, res["A"].ell_values().numpy()


def _build(flat, topo):
    return lambda: amg_setup(flat, topo, theta=0.03, smoother="chebyshev",
                             cheb_deg=2, dtype=np.float64)


def _equal_arrays(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_saved_hierarchy_loads_equal(system, tmp_path):
    """Save, then load: every array (values, inverse diagonals, coarse
    inverse, each level's and transfer's SELL layout) and every scalar of
    the hierarchy equal, exactly; no layout is built on the load."""
    _, topo, _, flat = system
    path, meta = amg_cache_entry(str(tmp_path / "k"), topo, flat, **OPTS)
    M, hit = amg_cached(path, meta, _build(flat, topo), "cpu", torch.float64)
    assert not hit and os.path.exists(path)
    builds = SellLayout.builds
    M2, hit2 = amg_cached(path, meta, _build(flat, topo), "cpu", torch.float64)
    assert hit2 and SellLayout.builds == builds
    d = amg_setup(flat, topo, theta=0.03, smoother="chebyshev", cheb_deg=2,
                  dtype=np.float64)
    _equal_arrays(hierarchy_arrays(d, M), hierarchy_arrays(d, M2))
    for role in ("mats", "P", "Pt"):
        for a, b in zip(getattr(M, role), getattr(M2, role), strict=True):
            assert torch.equal(a.values, b.values)
            _equal_arrays(a.layout.to_arrays(), b.layout.to_arrays())
    for a, b in zip(M.inv_diags, M2.inv_diags, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(M.coarse_inv, M2.coarse_inv)
    assert (M.omegas, M.rhos, M.smoother, M.cheb_deg, M.nu, M.cycle) == \
        (M2.omegas, M2.rhos, M2.smoother, M2.cheb_deg, M2.nu, M2.cycle)
    # the dict round trip alone: hierarchy_from_arrays gives amg_setup's dict
    d2 = hierarchy_from_arrays(hierarchy_arrays(d, M))
    for k in ("inv_diags", "pvals", "pcols", "ptvals", "ptcols"):
        for a, b in zip(d[k], d2[k], strict=True):
            np.testing.assert_array_equal(a, b)
    for (va, ca), (vb, cb) in zip(d["mats"], d2["mats"], strict=True):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(ca, cb)


def test_loaded_hierarchy_applies_and_solves_bit_equal(system, tmp_path):
    """One V-cycle apply and one PCG solve (tolerance: equal bit for bit)
    with the loaded hierarchy equal the built one's."""
    _, topo, res, flat = system
    path, meta = amg_cache_entry(str(tmp_path / "k"), topo, flat, **OPTS)
    M, _ = amg_cached(path, meta, _build(flat, topo), "cpu", torch.float64)
    M2, hit = amg_cached(path, meta, _build(flat, topo), "cpu", torch.float64)
    assert hit
    r = torch.as_tensor(np.random.RandomState(5).rand(topo.n_nodes))
    assert torch.equal(M.apply(r), M2.apply(r))
    s = res["system"]
    x, k, rel = pcg(s["A"], s["b"], M, s["x0"], 1e-8, 0.0, 1000, True)
    x2, k2, rel2 = pcg(s["A"], s["b"], M2, s["x0"], 1e-8, 0.0, 1000, True)
    assert k == k2 and rel == rel2 and torch.equal(x, x2)


def test_solve_sphere_cut_cold_then_warm(system, tmp_path):
    """solve_sphere_cut with a cache prefix: the cold run builds and saves
    the fine layout and the hierarchy, the warm run loads both (no SELL
    layout build) and solves bit for bit like the cold one and like a run
    without the cache."""
    mesh, topo, res, _ = system
    prefix = str(tmp_path / mesh_key(14.0, 0))
    runs = []
    for _ in range(2):
        builds = SellLayout.builds
        r = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                             penalty=PENALTY, cache=prefix)
        runs.append((r, SellLayout.builds - builds))
    (cold, nb_cold), (warm, nb_warm) = runs
    assert (cold["amg_setup_cached"], warm["amg_setup_cached"]) == (False, True)
    assert nb_cold > 0 and nb_warm == 0
    assert sorted(os.listdir(tmp_path)) == [
        "amg_sphere_cut_v3_h14_r0_sn_chebyshev2_t0.03_cpu_p1e+30_float64_v1.npz",
        "sell_sphere_cut_v3_h14_r0_sn_v1.npz"]
    assert cold["iterations"] == warm["iterations"] == res["iterations"]
    assert torch.equal(cold["x"], warm["x"]) and torch.equal(cold["x"], res["x"])


@pytest.mark.parametrize("field", ["theta", "smoother", "cheb_deg", "penalty",
                                   "dtype", "values", "cols"])
def test_changed_key_or_digest_misses(system, tmp_path, field, capsys):
    """A hierarchy saved under one meta is not served for another that
    differs in one field: the load misses with one line saying why, and
    amg_cached rebuilds and rewrites the file."""
    _, topo, _, flat = system
    path, meta = amg_cache_entry(str(tmp_path / "k"), topo, flat, **OPTS)
    amg_cached(path, meta, _build(flat, topo), "cpu", torch.float64)
    changed = dict(meta, **{field: {"theta": 0.08, "smoother": "jacobi",
                                    "cheb_deg": [2, 4], "penalty": 1e12,
                                    "dtype": "float32", "values": "0" * 64,
                                    "cols": "1" * 64}[field]})
    capsys.readouterr()
    assert cache.load_npz(path, changed, "AMG hierarchy") is None
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and field in err and "rebuilding" in err
    M, hit = amg_cached(path, changed, _build(flat, topo), "cpu", torch.float64)
    assert not hit
    assert cache.load_npz(path, changed, "AMG hierarchy") is not None
    assert cache.load_npz(path, meta, "AMG hierarchy") is None


@pytest.mark.parametrize("change", [dict(smoother="jacobi"), dict(cheb_deg=(2, 4)),
                                    dict(penalty=1e12), dict(dtype=torch.float32)])
def test_changed_key_changes_the_file_name(system, change):
    """The key fields also name the file, as bench.py names its pickle."""
    _, topo, _, flat = system
    path, _ = amg_cache_entry("/c/k", topo, flat, **OPTS)
    path2, _ = amg_cache_entry("/c/k", topo, flat, **{**OPTS, **change})
    assert path != path2 and os.path.dirname(path2) == "/c"


def test_changed_values_change_the_digest(system):
    _, topo, _, flat = system
    f2 = flat.copy()
    f2.reshape(-1)[np.flatnonzero(f2)[7]] *= 1 + 1e-15
    _, meta = amg_cache_entry("/c/k", topo, flat, **OPTS)
    _, meta2 = amg_cache_entry("/c/k", topo, f2, **OPTS)
    assert meta["values"] != meta2["values"] and meta["cols"] == meta2["cols"]


@pytest.mark.parametrize("keep", [0.5, 0.0])
def test_truncated_file_is_rebuilt(system, tmp_path, keep, capsys):
    """A truncated (or empty) cache file is a miss with one line saying
    so, not an error; the run rebuilds, rewrites it and solves as before."""
    mesh, topo, res, _ = system
    prefix = str(tmp_path / mesh_key(14.0, 0))
    solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                     penalty=PENALTY, cache=prefix)
    for f in os.listdir(tmp_path):
        p = os.path.join(tmp_path, f)
        with open(p, "r+b") as fh:
            fh.truncate(int(os.path.getsize(p) * keep))
    capsys.readouterr()
    r = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                         penalty=PENALTY, cache=prefix)
    err = capsys.readouterr().err
    assert err.count("unreadable") == 2, err
    assert not r["amg_setup_cached"] and torch.equal(r["x"], res["x"])
    r2 = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                          penalty=PENALTY, cache=prefix)
    assert r2["amg_setup_cached"] and torch.equal(r2["x"], res["x"])


@pytest.mark.parametrize("sigma", [1, 1024])
def test_sell_layout_arrays_round_trip(system, sigma):
    """to_arrays/from_arrays gives the same layout (every array, σ, the
    permutation) and the same SpMV, bit for bit, without a build."""
    _, topo, res, flat = system
    lay = SellLayout.build(topo.ell_cols, topo.ell_valid, device="cpu", sigma=sigma)
    builds = SellLayout.builds
    lay2 = SellLayout.from_arrays(lay.to_arrays(), device="cpu")
    assert SellLayout.builds == builds
    _equal_arrays(lay.to_arrays(), lay2.to_arrays())
    assert (lay2.perm is None) == (sigma == 1)
    x = torch.as_tensor(np.random.RandomState(1).rand(topo.n_nodes))
    v = lay.from_ell(flat)
    from arcanefem_tpu_torch.sparse.sell import sell_spmv

    assert torch.equal(sell_spmv(v, lay, x), sell_spmv(lay2.from_ell(flat), lay2, x))


def test_from_arrays_rejects_inconsistent_arrays(system):
    _, topo, _, _ = system
    a = SellLayout.build(topo.ell_cols, topo.ell_valid, device="cpu").to_arrays()
    with pytest.raises(ValueError, match="inconsistent"):
        SellLayout.from_arrays({**a, "cols": a["cols"][:-1]}, device="cpu")
    with pytest.raises(KeyError, match="src"):
        SellLayout.from_arrays({k: v for k, v in a.items() if k != "src"}, device="cpu")


def test_no_cache_env(monkeypatch):
    monkeypatch.setenv("BENCH_NO_CACHE", "1")
    assert not cache.cache_enabled()
    monkeypatch.setenv("BENCH_NO_CACHE", "0")
    assert cache.cache_enabled()
    monkeypatch.delenv("BENCH_NO_CACHE")
    assert cache.cache_enabled()


def test_save_npz_leaves_no_temporary(tmp_path):
    p = str(tmp_path / "a.npz")
    cache.save_npz(p, {"x": np.arange(5)}, {"k": 1})
    assert os.listdir(tmp_path) == ["a.npz"]
    np.testing.assert_array_equal(cache.load_npz(p, {"k": 1}, "x")["x"], np.arange(5))
    assert cache.load_npz(p, {"k": 2}, "x") is None
    assert cache.load_npz(str(tmp_path / "b.npz"), {"k": 1}, "x") is None


def test_amg_from_numpy_rejects_a_layout_that_does_not_fit(system):
    _, topo, _, flat = system
    d = amg_setup(flat, topo, theta=0.03, smoother="chebyshev", cheb_deg=2,
                  dtype=np.float64)
    M = amg_from_numpy(d, "cpu", torch.float64)
    d2 = hierarchy_from_arrays(hierarchy_arrays(d, M))
    d2["layouts"]["P"] = d2["layouts"]["Pt"]
    with pytest.raises(ValueError, match="does not fit"):
        amg_from_numpy(d2, "cpu", torch.float64)


def test_cached_hierarchy_keeps_its_setup_branch(tmp_path, monkeypatch):
    """A hierarchy cached by the scipy branch (``AFEM_NATIVE_AMG=0``, in
    its meta record) is not loaded for the native one, nor the reverse: each
    switch rebuilds, and the same branch twice loads."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    prefix = str(tmp_path / mesh_key(14.0, 0))
    cached = []
    for knob in ("0", "1", "1", "0", "0"):
        monkeypatch.setenv("AFEM_NATIVE_AMG", knob)
        res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                               penalty=PENALTY, cache=prefix)
        cached.append(res["amg_setup_cached"])
    assert cached == [False, False, True, False, True]
