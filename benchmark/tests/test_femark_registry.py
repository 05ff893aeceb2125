"""Every file of the benchmark parses and is found by its name, and
BENCHMARK.json agrees with them."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import core

BENCH = core.spec()
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic"])
def test_json_files_parse_and_carry_their_name(kind):
    found = core.names(kind)
    assert found
    for name in found:
        data = core.load(kind, name)
        if kind != "traffic":
            assert data["name"] == name


def test_every_workload_resolves():
    for name in core.names("workloads"):
        w, config, mix = core.cell(name)
        assert os.path.isfile(os.path.join(core.BENCH_DIR, "systems", config["system"] + ".py"))
        assert os.path.isfile(os.path.join(core.BENCH_DIR, "traffic", mix["kind"] + ".py"))
        assert w["chips"] in (1, 4)
        assert w["limits"] and all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_benchmark_cells_match_their_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = core.load("workloads", cell)
    for key in ("config", "traffic", "chips", "why"):
        assert entry[key] == w[key]
    assert len(w["why"]) <= 200
    config = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert config["file"] == f"benchmark/configs/{w['config']}.json"
    for key in ("source", "reduced", "why"):
        assert core.load("configs", w["config"])[key] == config[key]


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m["name"]) <= NAME_CHARS
        assert hasattr(core.module("metrics", m["name"]), "read")
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in core.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        assert core.cell_metrics(BENCH, w["name"], True)


def _is_name(s):
    return 1 <= len(s) <= 64 and s[0] not in ".-" and set(s) <= NAME_CHARS


def _is_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _is_line(word) and not word.startswith("/") and ".." not in word.split("/")
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert 1 <= len(path) <= 200 and set(path) <= NAME_CHARS | {"/"}
        assert not path.startswith("/") and ".." not in path.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200

    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _is_name(c["name"]) and c["name"] in used
        assert _is_line(c["source"]) and _is_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert os.path.isfile(os.path.join(core.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(_is_name(k) for k in c["reduced"])

    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _is_name(w["name"]) and _is_name(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and _is_line(w["why"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)

    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _is_line(m["layer"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert _is_name(m["name"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m["unit"]) <= 16
        assert set(m["unit"]) <= NAME_CHARS | {"/", "%"}
        assert set(m.get("workloads", [])) <= cells


def test_a_new_workload_file_is_listed_without_other_edits(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".data", "__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    new = dict(core.load("workloads", "sphere-1.9m.assembly"), name="sphere-1.9m.assembly2")
    (tmp_path / "benchmark" / "workloads" / "sphere-1.9m.assembly2.json").write_text(
        json.dumps(new))
    code = ("from benchmark import core; import json; "
            "print(json.dumps([core.names('workloads'), "
            "core.cell('sphere-1.9m.assembly2')[2]['kind']]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    names, kind = json.loads(out)
    assert "sphere-1.9m.assembly2" in names and kind == "stream"
