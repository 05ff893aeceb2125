"""arcanefem_tpu_torch/tools/ilu_decision.py against the JAX tool
tools/ilu_decision.py on the CPU, at small sizes: the JAX tool's own
``systems()`` and ``main()`` with its mesh generators cut to a 16x16 rect, a
5^3 box and a 10x10 elasticity rect, and the port's ``systems`` at the same
sizes.  The CSR matrices agree in pattern exactly and in value to 1e-12 of
the largest, the IC(0) factors to 1e-12, the depths exactly, the
Jacobi/Chebyshev/IC(0) counts within 1 and the ILUT counts within 10% (or
both at the iteration cap)."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

import arcanefem_tpu.mesh.generate as jax_gen
from arcanefem_tpu_torch.tools import ilu_decision as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX tool's mesh sizes -> the sizes the tests run at
SMALL = {(90, 90): (16, 16), (22, 22, 22): (5, 5, 5), (50, 50): (10, 10)}
PORT_SMALL = {"poisson2d_8k": (16, 16), "poisson3d_11k": (5, 5, 5),
              "elasticity2d_5k": (10, 10)}
NAMES = list(PORT_SMALL)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ilu_decision", os.path.join(REPO, "tools", "ilu_decision.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(the JAX tool's systems, its printed rows) at the small sizes."""
    tool = _jax_tool()
    rect, box = jax_gen.rect_tria_mesh, jax_gen.box_tetra_mesh
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gen, "rect_tria_mesh", lambda *a: rect(*SMALL[a]))
        mp.setattr(jax_gen, "box_tetra_mesh", lambda *a: box(*SMALL[a]))
        mp.chdir(tmp_path_factory.mktemp("jax_ilu"))  # main writes .cache/ here
        systems = tool.systems()
        with contextlib.redirect_stdout(out):
            tool.main()
    rows = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return tool, systems, rows


@pytest.fixture(scope="module")
def port_systems():
    return port.systems("cpu", PORT_SMALL)


@pytest.fixture(scope="module")
def port_rows(port_systems):
    return [port.decision_row(s.name, s.A, s.rhs) for s in port_systems]


@pytest.mark.parametrize("i", range(3), ids=NAMES)
def test_csr_matches_jax(jax_run, port_systems, i):
    """The same pattern, values within 1e-12 of the largest, the same rhs."""
    name, A, rhs = jax_run[1][i]
    s = port_systems[i]
    assert s.name == name
    np.testing.assert_array_equal(s.A.indptr, A.indptr)
    np.testing.assert_array_equal(s.A.indices, A.indices)
    assert np.abs(s.A.data - A.data).max() <= 1e-12 * np.abs(A.data).max()
    np.testing.assert_array_equal(s.rhs, rhs)


@pytest.mark.parametrize("i", range(3), ids=NAMES)
def test_ic0_factor_matches_jax(jax_run, port_systems, i):
    """IC(0) of the port's matrix equals the JAX tool's IC(0) of its own
    matrix: the same pattern, values within 1e-12 of the largest, the same
    level depth."""
    tool = jax_run[0]
    L_jax = tool.ic0(jax_run[1][i][1])
    L = port.ic0(port_systems[i].A)
    assert (L is None) == (L_jax is None)
    if L is None:
        return
    np.testing.assert_array_equal(L.indptr, L_jax.indptr)
    np.testing.assert_array_equal(L.indices, L_jax.indices)
    assert np.abs(L.data - L_jax.data).max() <= 1e-12 * np.abs(L_jax.data).max()
    assert port.level_depth(L) == tool.level_depth(L_jax)


@pytest.mark.parametrize("i", range(3), ids=NAMES)
def test_rows_match_jax(jax_run, port_rows, i):
    """The port's row beside the row the JAX tool's main() printed: the same
    keys, n, nnz and depths, counts within 1 and ILUT within 10%."""
    want, got = jax_run[2][i], port_rows[i]
    assert list(got) == list(want)
    for k in ("system", "n", "nnz", "ic0_depth", "ilut_depth", "ic0_error", "ilut_error"):
        assert got.get(k) == want.get(k), k
    for k in ("jacobi", "cheb3", "ic0_iters"):
        assert abs(got[k] - want[k]) <= 1, (k, got[k], want[k])
    a, b = got["ilut_iters"], want["ilut_iters"]
    assert a == b == port.MAXITER or abs(a - b) <= 0.1 * b, (a, b)


def test_rows_are_the_experiment(port_rows):
    """Every row converged below the cap, Chebyshev(3) in no more
    iterations than Jacobi, and each factor has a depth of at least 2 (it
    has off-diagonal entries)."""
    for row in port_rows:
        counts = [row[k] for k in ("jacobi", "cheb3", "ic0_iters", "ilut_iters")]
        assert all(0 < c < port.MAXITER for c in counts), row
        assert row["cheb3"] <= row["jacobi"]
        assert row["ic0_depth"] >= 2 and row["ilut_depth"] >= 2


def test_main_cpu_writes_rows(monkeypatch, tmp_path, capsys, port_rows):
    """``main(["--device", "cpu", "--out", F])`` prints one JSON row per
    system and writes the list to F; those rows are :func:`decision_row`'s."""
    monkeypatch.setattr(port, "SIZES", PORT_SMALL)
    out = tmp_path / "sub" / "ilu.json"
    assert port.main(["--device", "cpu", "--out", str(out)]) == 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == port_rows
    assert json.loads(out.read_text()) == port_rows


def test_main_without_cuda_exits_1(monkeypatch, tmp_path, capsys):
    """The card is the default; without CUDA main exits 1 and prints no row."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "ilu.json"
    assert port.main(["--out", str(out)]) == 1
    assert capsys.readouterr().out == "" and not out.exists()


def test_csr_of_block_expands_nodes(port_systems):
    """The b = 2 export: the CSR of the block BellMatrix is its dense form
    (``todense`` of the scalar expansion), penalty rows aside."""
    s = port_systems[2]
    dense = s.bell.todense().numpy()
    A = s.A.toarray()
    pen = np.abs(A - dense) > 0
    assert np.all(np.abs(np.diag(A - dense))[np.diag(pen)] >= 1e11)
    np.fill_diagonal(pen, False)
    assert not pen.any()
