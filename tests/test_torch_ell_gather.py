"""ELL gather-reduce (arcanefem_tpu_torch/sparse/ell_gather.py) against the
JAX package: its BellMatrix SpMV, and its Pallas window plans evaluated on
the CPU the way the JAX package's own tests evaluate them
(arcanefem_tpu/utils/emulate.py).  The CUDA kernels themselves are held to
their plain twins in tests/test_torch_kernels.py, which needs no jax."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu.sparse.pallas_spmv import ChainedGather, PlannedGather
from arcanefem_tpu.utils.emulate import emulate_gather
from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.ell_gather import (
    ell_gather_sum,
    ell_gather_sum_batched,
    ell_spmv_plain,
)
from arcanefem_tpu_torch.sparse.sell import SellLayout, sell_spmv, sell_spmv_batched


@pytest.fixture(scope="module")
def h14():
    return sphere_cut_system(14.0, 0, cache=False)


def test_spmv_matches_jax_bell_f64(h14):
    """The SELL BellMatrix's plain K1 == JAX BellMatrix.spmv in f64 on the
    sphere_cut h=14 topology with random values (rtol 1e-12: only the sum
    order differs)."""
    _, topo = h14
    rng = np.random.RandomState(0)
    n, W = topo.n_nodes, topo.width
    vals = np.where(topo.ell_valid, rng.rand(n, W) - 0.5, 0.0)
    x = rng.rand(n) - 0.5
    want = np.asarray(JaxBell(
        values=jnp.asarray(vals.reshape(n, W, 1, 1)), topo=topo, block=1,
        cols=jnp.asarray(topo.ell_cols)).spmv(jnp.asarray(x)))
    A = BellMatrix.from_numpy(vals, topo.ell_cols, topo.diag_slot,
                              device="cpu", dtype=torch.float64)
    got = A.spmv(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(A.diagonal().numpy(),
                                  vals.reshape(-1)[topo.diag_slot])


def _weighted_case(name):
    """(cols, weights, table) shaped like the JAX package's plan tests;
    zero weights are padding."""
    if name == "plain":
        rng = np.random.RandomState(0)
        n, W = 2000, 8
        cols = (np.arange(n)[:, None] * 3 + rng.randint(0, 40, (n, W))) % (3 * n)
        w = rng.rand(n, W).astype(np.float32)
        w[rng.rand(n, W) < 0.3] = 0.0
        return cols, w, rng.rand(3 * n).astype(np.float32)
    if name == "wide_split":
        rng = np.random.RandomState(1)
        n, W = 3000, 37
        cols = (np.arange(n)[:, None] * 7 + rng.randint(0, 64, (n, W))) % (7 * n)
        deg = rng.randint(1, W + 1, n)
        w = rng.rand(n, W).astype(np.float32)
        w[np.arange(W)[None, :] >= deg[:, None]] = 0.0
        return cols, w, rng.rand(7 * n).astype(np.float32)
    rng = np.random.RandomState(2)  # empty_rows
    n, W = 1500, 4
    cols = (np.arange(n)[:, None] + rng.randint(0, 16, (n, W))) % n
    w = rng.rand(n, W).astype(np.float32)
    w[::7] = 0.0
    return cols, w, rng.rand(n).astype(np.float32)


@pytest.mark.parametrize("name", ["plain", "wide_split", "empty_rows"])
def test_spmv_matches_pallas_plan(name):
    """K1 in its SELL layout (plain) and the (n, W) definition
    ell_spmv_plain == the weighted Pallas plan (K1), wide rows split into a
    chained plan included; the JAX tests' tolerance."""
    cols, w, table = _weighted_case(name)
    g = PlannedGather.build(cols, w)
    if name == "wide_split":
        assert isinstance(g, ChainedGather)
    want = emulate_gather(g, table)
    A = BellMatrix.from_numpy(w, cols, n_cols=table.size, device="cpu",
                              dtype=torch.float32)
    for got in (A.spmv(torch.as_tensor(table)),
                ell_spmv_plain(torch.as_tensor(w),
                               torch.as_tensor(cols, dtype=torch.int32),
                               torch.as_tensor(table))):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["plain", "wide_split", "empty_rows"])
def test_gather_sum_matches_unit_pallas_plan(name):
    """Plain ell_gather_sum == the unit-weight Pallas plan (K2): padding is
    a negative column in the port, a zero weight in the plan."""
    cols, w, table = _weighted_case(name)
    real = w != 0.0
    g = PlannedGather.build(cols, real.astype(np.float32))
    assert g is not None
    ucols = torch.as_tensor(np.where(real, cols, -1), dtype=torch.int32)
    got = ell_gather_sum(ucols, torch.as_tensor(table)).numpy()
    np.testing.assert_allclose(got, emulate_gather(g, table),
                               rtol=2e-5, atol=1e-5)


def test_gather_w1_matches_compact_coords_plan(h14):
    """W=1 unit gather == the assembly coordinate plan, built as
    lane_assembly.py builds it (corner-major, bool weights, compact)."""
    mesh, topo = h14
    conn = mesh.cells["tetra4"]
    cols = np.asarray(conn, np.int32).T.reshape(-1, 1)
    g = PlannedGather.build(cols, np.ones((cols.shape[0], 1), np.bool_),
                            wcap=0, compact=True)
    table = mesh.coords[:, 0].astype(np.float32)
    got = ell_gather_sum(torch.as_tensor(cols), torch.as_tensor(table)).numpy()
    np.testing.assert_allclose(got, emulate_gather(g, table),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(got, table[cols[:, 0]])


@pytest.mark.parametrize("layout", ["table_major", "channel_minor"])
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("name", ["plain", "wide_split", "empty_rows"])
def test_batched_match_pallas_plans(name, B, layout):
    """The batched twins (K3b weighted, on the SELL layout of the real
    slots; K3a unit) == the JAX weighted and unit plans emulated table by
    table, as PlannedGather.call_batched applies one plan to a (B, n)
    stack, and each table == the single-table twin (K1's for K3b) exactly.
    ``channel_minor`` passes the tables as the transpose of an (n, B)
    row-major array and asks for the result in that layout; both are read
    and written through their strides."""
    cols, w, table = _weighted_case(name)
    rng = np.random.RandomState(4)
    tables = np.stack([table] + [rng.rand(table.size).astype(np.float32)
                                 for _ in range(B - 1)])
    real = w != 0.0
    plans = {"weighted": PlannedGather.build(cols, w),
             "unit": PlannedGather.build(cols, real.astype(np.float32))}
    if layout == "channel_minor":
        t = torch.as_tensor(np.ascontiguousarray(tables.T)).T
        out = {k: torch.empty((cols.shape[0], B)).T for k in plans}
    else:
        t, out = torch.as_tensor(tables), {k: None for k in plans}
    lay = SellLayout.build(cols, real, n_cols=table.size, device="cpu")
    sv = lay.from_ell(w)
    got = {
        "weighted": sell_spmv_batched(sv, lay, t, out=out["weighted"]),
        "unit": ell_gather_sum_batched(
            torch.as_tensor(np.where(real, cols, -1), dtype=torch.int32), t,
            out=out["unit"]),
    }
    for k, g in plans.items():
        assert got[k].shape == (B, cols.shape[0])
        if out[k] is not None:
            assert got[k] is out[k] and got[k].stride() == (1, B)
        want = np.stack([emulate_gather(g, tb) for tb in tables])
        np.testing.assert_allclose(got[k].numpy(), want, rtol=2e-5, atol=1e-5)
        # each table exactly as the single-table twin reduces it
        for b in range(B):
            single = (sell_spmv(sv, lay, t[b].contiguous())
                      if k == "weighted" else
                      ell_gather_sum(torch.as_tensor(np.where(real, cols, -1),
                                                     dtype=torch.int32),
                                     t[b].contiguous()))
            assert torch.equal(got[k][b], single)


@pytest.mark.parametrize("layout", ["table_major", "channel_minor", "row_strided"])
@pytest.mark.parametrize("B", list(range(1, 9)))
def test_batched_w1_gather_matches_unit_plan(B, layout):
    """The W=1 batched gather (K3a's coordinate and remap role) for every B
    in 1..8 == the JAX unit plan (compact, as the assembly builds it)
    emulated table by table, and == numpy's take, exactly: a copy, with -1
    pads giving 0.  ``channel_minor`` reads an (n_t, B) row-major array in
    place and writes the result into an (n, B) one; ``row_strided`` reads
    and writes through a row stride of B + 2 (every other column of a wider
    array)."""
    rng = np.random.RandomState(10 + B)
    n_t, n = 700, 2500
    cols = rng.randint(0, n_t, (n, 1)).astype(np.int32)
    real = rng.rand(n, 1) > 0.1
    ucols = np.where(real, cols, -1).astype(np.int32)
    tables = rng.rand(B, n_t).astype(np.float32)
    if layout == "table_major":
        t, out = torch.as_tensor(tables), None
    elif layout == "channel_minor":
        t = torch.as_tensor(np.ascontiguousarray(tables.T)).T
        out = torch.empty((n, B)).T
    else:
        wide = np.zeros((n_t, B + 2), np.float32)
        wide[:, :B] = tables.T
        t = torch.as_tensor(wide)[:, :B].T
        out = torch.empty((n, B + 2))[:, :B].T
    got = ell_gather_sum_batched(torch.as_tensor(ucols), t, out=out)
    assert got.shape == (B, n)
    if out is not None:
        assert got is out
    want = np.where(real[:, 0], tables[:, cols[:, 0]], 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    g = PlannedGather.build(cols, real.astype(np.bool_), wcap=0, compact=True)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([emulate_gather(g, tb) for tb in tables]))
