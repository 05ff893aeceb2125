"""``python -m arcanefem_tpu_torch.bench --sweep`` (arcanefem_tpu_torch/
bench_sweep.py) against the root ``bench.py --sweep`` on the CPU.

* axis 1 (``--device cpu --sizes 4,6 --no-devices --no-headline
  --cache-warming 1``): the same rows as ``bench.bench_sweep`` with the same
  arguments, key for key, with the same ``size``, ``nodes``, ``elements``
  and format list (the times differ);
* axis 2: the sharded Poisson solve on P = 1, 2 and 4 gloo ranks (box 6)
  is ``invariant``, takes ``bench._sweep_child_devices``'s iterations at
  the same P (conftest's 8 virtual devices) within 1, and its gathered
  solution is within 1e-10 of JAX's sharded step's, of its largest value;
* the TSV writer, given the JSON rows ``bench.bench_sweep`` printed, writes
  the file ``bench.bench_sweep`` wrote, byte for byte;
* the refusals: ``--device cpu`` without ``--no-headline`` and ``--devices
  2`` on ``cuda`` with fewer cards (here: none) exit 2 before any row.

``BENCH_CPU=1`` keeps the root bench from probing for a backend in a
subprocess.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest

import bench as root_bench
from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box
from arcanefem_tpu.parallel import partition as jpart
from arcanefem_tpu.parallel import sharded as jsh
from arcanefem_tpu_torch import bench, bench_sweep

BOX_N = 6
AXIS1 = ["--sizes", "4,6", "--no-devices", "--no-headline", "--cache-warming", "1"]


def _rows(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture
def cpu_bench(monkeypatch):
    monkeypatch.setenv("BENCH_CPU", "1")


def test_assembly_rows_match_root_bench(cpu_bench, capsys, tmp_path):
    root_bench.bench_sweep([*AXIS1, "--tsv", str(tmp_path / "jax.tsv")])
    want = _rows(capsys.readouterr().out)
    assert bench.main(["--sweep", "--device", "cpu", *AXIS1,
                       "--tsv", str(tmp_path / "port.tsv")]) == 0
    got = _rows(capsys.readouterr().out)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want, strict=True):
        assert list(g) == list(w)
        for k in ("axis", "size", "nodes", "elements", "format", "devices"):
            assert g[k] == w[k], k
        assert g["lhs_matrix_assembly_s"] > 0 and np.isfinite(g["mdof_per_s"])
    with open(tmp_path / "port.tsv") as f:
        assert f.read() == bench_sweep.tsv_text(got)


def test_tsv_writer_is_byte_equal(cpu_bench, capsys, tmp_path):
    """Assembly rows and a devices row (the root bench's subprocess at one
    virtual device), written by both writers."""
    path = tmp_path / "jax.tsv"
    root_bench.bench_sweep(["--sizes", "4", "--devices", "1", "--no-headline",
                            "--cache-warming", "1", "--tsv", str(path)])
    rows = _rows(capsys.readouterr().out)
    assert [r["axis"] for r in rows] == ["assembly"] * 6 + ["devices"]
    with open(path, "rb") as f:
        assert bench_sweep.tsv_text(rows).encode() == f.read()
    assert bench_sweep.tsv_text([]) == "\n"


@functools.cache
def _jax_sharded(P: int):
    """(gathered solution, iterations) of the JAX sharded step of the
    devices axis at P devices on box BOX_N."""
    mesh = jax_box(BOX_N, BOX_N, BOX_N)
    sp = jpart.build_sharded(mesh, P)
    dmesh = jsh.device_mesh(P)
    arrs = jsh.put_sharded(sp, dmesh, dtype=jnp.float64)
    xmin, xmax = mesh.group_nodes("xmin"), mesh.group_nodes("xmax")
    mask, val = jsh.stacked_node_mask(sp, np.concatenate([xmin, xmax]), np.concatenate(
        [np.zeros(len(xmin)), np.ones(len(xmax))]))
    x, it, _ = jsh.make_poisson_step(sp, dmesh, rtol=1e-10, max_iter=2000)(
        arrs, 1.0, mask, val, 1.0e12)
    return sp.scatter_global(np.asarray(x)), int(it)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_devices_axis_matches_jax(P, capsys):
    rec, arrays = bench_sweep.run_devices(P, device="cpu", box_n=BOX_N, reps=1,
                                          timeout_s=300)
    assert rec is not None, "a rank failed"
    assert rec["invariant"] and rec["partition_rel_err"] < 1e-6
    assert rec["devices"] == P and rec["nodes"] == (BOX_N + 1) ** 3
    root_bench._sweep_child_devices(P, BOX_N, 1)
    child = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert child["invariant"] and abs(rec["iterations"] - child["iterations"]) <= 1
    want, it = _jax_sharded(P)
    assert it == child["iterations"]
    err = np.abs(arrays["x"] - want).max() / np.abs(want).max()
    assert err <= 1e-10, err


def test_devices_row_has_root_bench_keys(monkeypatch):
    rec = {"devices": 2, "nodes": 1331, "solve_s": 0.5, "iterations": 54,
           "residual": 1e-11, "partition_rel_err": 1e-9, "invariant": True,
           "launches": {"sell_spmv": 110, "slot_reduce": 2}}
    monkeypatch.setattr(bench_sweep, "run_devices", lambda P, **kw: (rec, {}))
    assert bench_sweep.devices_row(2, "cpu", 10, 2) == {
        "axis": "devices", "size": "box10", "nodes": 1331, "format": "sharded-rcb-pcg",
        "devices": 2, "solve_s": 0.5, "iterations": 54, "invariant": True}
    assert list(bench_sweep.devices_row(2, "cpu", 10, 2)) == [
        "axis", "size", "nodes", "format", "devices", "solve_s", "iterations", "invariant"]


def test_cpu_needs_no_headline(capsys):
    assert bench.main(["--sweep", "--device", "cpu", "--no-devices"]) == 2
    err = capsys.readouterr()
    assert "--no-headline" in err.err and err.out == ""


def test_more_ranks_than_cards_are_refused(capsys, tmp_path):
    tsv = tmp_path / "s.tsv"
    assert bench.main(["--sweep", "--devices", "2", "--no-headline",
                       "--tsv", str(tsv)]) == 2
    err = capsys.readouterr()
    assert "--devices 2 refused" in err.err and "--device cpu" in err.err
    assert err.out == ""
    assert not tsv.exists()


def test_failed_devices_child_leaves_the_error_row(monkeypatch, capsys, tmp_path):
    """A rank that fails leaves bench.py's error row; the sweep runs on to
    its end and exits 1."""
    monkeypatch.setattr(bench_sweep, "run_devices", lambda P, **kw: (None, {}))
    tsv = tmp_path / "s.tsv"
    rc = bench.main(["--sweep", "--device", "cpu", "--sizes", "3", "--formats", "coo",
                     "--devices", "2", "--no-headline", "--cache-warming", "1",
                     "--tsv", str(tsv)])
    rows = _rows(capsys.readouterr().out)
    assert rc == 1
    assert rows[-1] == {"axis": "devices", "devices": 2, "error": True}
    assert len(tsv.read_text().splitlines()) == len(rows) + 1
