"""The banded tile gather (sparse/band_gather.py) and the compact two-stage
gather (sparse/compact.py) of the port against the JAX package's planners
and their numpy emulation, on the CPU.

Off the TPU the JAX package runs the plain BellMatrix for AFEM_SPMV=compact
and AFEM_BAND_PRE=1, so what those knobs do is held here through the JAX
host planners (BandedGather.build, _compact_columns, PlannedGather.build)
and utils/emulate.py, which executes a plan exactly as its Pallas kernel
would.  A gather does no arithmetic, so the band gather's plain twins must
equal the emulation bit for bit.
"""

import numpy as np
import pytest
import torch

from arcanefem_tpu.sparse.band_gather import BandedGather as JaxBand
from arcanefem_tpu.sparse.band_gather import BandedRowSum as JaxRowSum
from arcanefem_tpu.sparse.pallas_spmv import (
    ChainedGather,
    PlannedGather,
    _adaptive_block_rows,
    _compact_columns,
)
from arcanefem_tpu.utils.emulate import emulate_gather
from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
from arcanefem_tpu_torch.sparse.band_gather import (
    BandedGather,
    BandedRowSum,
    band_gather,
    band_gather_batched,
    banded_gather_batched_plain,
    banded_gather_plain,
)
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.compact import (
    CompactMatrix,
    adaptive_block_rows,
    compact_columns,
)


def _mixed_stream():
    """Sorted runs with mixed strides (tests/test_pallas_spmv.py:687-697):
    dense runs give narrow tiles, sparse ones and run boundaries wide."""
    rng = np.random.RandomState(5)
    runs, base = [], 0
    for stride, ln in ((3, 2000), (200, 400), (5, 1500), (90, 500)):
        r = base + np.cumsum(rng.randint(1, stride + 1, ln))
        runs.append(r)
        base = int(r[-1] // 3)
    return np.concatenate(runs).astype(np.int64), None


def _sphere_pre_stream():
    """The compact pre stream (per-block distinct columns, R = 640) of the
    CG operator at sphere_cut h=8."""
    _, topo = sphere_cut_system(8.0, 0, cache=False)
    pre, _ = compact_columns(topo.ell_cols, topo.ell_valid, 640, False,
                             device="cpu")
    return pre.cols[:, 0].numpy().astype(np.int64), None


def _valid_stream():
    """A split plan's stage-2 stream (pallas_spmv.py::_split_stage2):
    consecutive subrow ids with W2-wide rows, pads marked invalid."""
    rng = np.random.RandomState(2)
    nsub = rng.randint(1, 5, 3000)
    W2 = 4
    start = np.concatenate([[0], np.cumsum(nsub)])
    base = start[:-1, None] + np.arange(W2)[None, :]
    valid = np.arange(W2)[None, :] < nsub[:, None]
    return base.reshape(-1).astype(np.int64), valid.reshape(-1)


STREAMS = {"mixed": _mixed_stream, "sphere_h8_pre": _sphere_pre_stream,
           "valid_masks": _valid_stream}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_banded_build_matches_jax(name):
    req, valid = STREAMS[name]()
    kw = {} if valid is None else dict(valid=valid, min_narrow_frac=0.999)
    gj, pj = JaxBand.build(req, K=16, **kw)
    gp, pp = BandedGather.build(req, device="cpu", **kw)
    assert gj is not None and gp is not None
    np.testing.assert_array_equal(gp.bases.numpy(), np.asarray(gj.bases))
    np.testing.assert_array_equal(gp.lcols.numpy(), np.asarray(gj.lcols))
    np.testing.assert_array_equal(pp, pj)
    assert (gp.n_narrow, gp.n_tiles, gp.n_rows) == (gj.n_narrow, gj.n_tiles, gj.n_rows)
    # the port's need_rows is the narrow bands' reach; the JAX one adds the
    # wide window plan's, which the port does not have
    reach = int(np.asarray(gj.bases).reshape(-1)[: gj.n_narrow].max()) + 16
    assert gp.need_rows == reach
    if gj.wide is None:
        assert gp.wide_cols is None and gp.need_rows == gj.need_rows
    else:
        assert gp.wide_cols.shape == ((gp.n_tiles - gp.n_narrow) * 128,)
    if name == "mixed":
        assert 0 < gp.n_narrow < gp.n_tiles
    # the plain twins equal the kernel's emulation bit for bit, on one table
    # and on a stack of strided tables
    rng = np.random.RandomState(1)
    table = rng.rand(int(req.max()) + 7).astype(np.float32)
    want = gj.emulate(table)
    np.testing.assert_array_equal(gp(torch.as_tensor(table)).numpy(), want)
    tb = np.stack([table, 2.0 * table + 1.0, table[::-1].copy()])
    got = gp.call_batched(torch.as_tensor(tb.T.copy()).T).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], gj.emulate(tb[b]))
    # every real request lands at its tile_perm position
    m = len(req)
    pos = pp[np.arange(m) // 128] * 128 + np.arange(m) % 128
    ok = np.ones(m, bool) if valid is None else valid
    np.testing.assert_array_equal(want[pos][ok], table[req][ok])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["mixed", "valid_masks"])
def test_banded_gather_one_call_matches_jax_emulate(name, dtype):
    """The whole plan, narrow and wide tiles, in one call: the fused twin,
    ``__call__`` and ``call_batched`` (B = 1, and B = 3 over an (N, 3)
    table read in place as three strided tables) equal the JAX class's
    emulation exactly, on a plan with wide tiles (mixed) and one without
    (valid_masks).  The JAX class gathers in float32 whatever the table's
    type, so the float64 tables hold float32 values: a gather is exact,
    and the indices are what is compared."""
    req, valid = STREAMS[name]()
    kw = {} if valid is None else dict(valid=valid, min_narrow_frac=0.999)
    gj, _ = JaxBand.build(req, K=16, **kw)
    gp, _ = BandedGather.build(req, device="cpu", **kw)
    assert (gj.wide is None) == (gp.wide_cols is None) == (name == "valid_masks")
    rng = np.random.RandomState(11)
    tab3 = rng.rand(int(req.max()) + 7, 3).astype(np.float32)
    want = [gj.emulate(np.ascontiguousarray(tab3[:, b])) for b in range(3)]
    t3 = torch.as_tensor(tab3).to(dtype)  # (N, 3), row-major
    x = t3[:, 0].contiguous()
    for got in (gp(x), banded_gather_plain(*gp._narrow(), gp.wide_cols, x, gp.K),
                gp.call_batched(x[None])[0]):
        assert got.dtype == dtype and got.shape == (gp.n_rows,)
        np.testing.assert_array_equal(got.numpy(), want[0].astype(got.numpy().dtype))
    for got in (gp.call_batched(t3.T),
                banded_gather_batched_plain(*gp._narrow(), gp.wide_cols, t3.T, gp.K)):
        assert got.shape == (3, gp.n_rows)
        for b in range(3):
            np.testing.assert_array_equal(got[b].numpy(),
                                          want[b].astype(got.numpy().dtype))


def test_banded_gather_checks_plan_once_and_table_per_call():
    """BandedGather raises at construction on plan arrays that do not fit
    together, and per call on a table the kernel does not take; a band that
    reaches past the table's end gives 0 there."""
    req, _ = _mixed_stream()
    g, _ = BandedGather.build(req, device="cpu")
    args = dict(K=g.K, G=g.G, wide_cols=g.wide_cols, n_tiles=g.n_tiles,
                n_narrow=g.n_narrow, need_rows=g.need_rows, tile_perm=g.tile_perm)

    def make(**kw):
        return BandedGather(**{"bases": g.bases, "lcols": g.lcols, **args, **kw})

    assert make().n_rows == g.n_rows
    with pytest.raises(TypeError):
        make(lcols=g.lcols.long())
    with pytest.raises(TypeError):
        make(wide_cols=g.wide_cols.long())
    with pytest.raises(ValueError):  # one base group too few
        make(bases=g.bases[:-1])
    with pytest.raises(ValueError):
        make(lcols=g.lcols[..., :64])
    with pytest.raises(ValueError):  # wide requests of another tile count
        make(wide_cols=g.wide_cols[:-128])
    with pytest.raises(ValueError):  # wide tiles without their requests
        make(wide_cols=None)
    with pytest.raises(ValueError):
        make(K=12)
    with pytest.raises(ValueError):
        make(lcols=g.lcols.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):  # plan arrays on two devices
        make(bases=g.bases.to("meta"))
    x = torch.rand(int(req.max()) + 1)
    with pytest.raises(TypeError):
        g(x.int())
    with pytest.raises(ValueError):
        g(x[None])
    with pytest.raises(ValueError):  # a table off the plan's device
        g(x.to("meta"))
    with pytest.raises(ValueError):  # B > 8 tables
        g.call_batched(torch.rand(9, x.shape[0]))
    with pytest.raises(ValueError):
        g.call_batched(x)
    # a table shorter than the bands reach: 0 past its end, narrow and wide
    short = x[: len(x) // 2]
    got = g(short)
    full = g(torch.cat([short, torch.zeros(len(x) - len(short))]))
    assert torch.equal(got, full)


def test_banded_row_sum_matches_jax():
    req, valid = _valid_stream()
    W2, n = 4, len(req) // 4
    gj, _ = JaxBand.build(req, K=16, valid=valid, min_narrow_frac=0.999)
    gp, _ = BandedGather.build(req, device="cpu", valid=valid,
                               min_narrow_frac=0.999)
    table = np.random.RandomState(4).rand(int(req.max()) + 1).astype(np.float32)
    want = JaxRowSum(gj, W2, n).emulate(table)
    got = BandedRowSum(gp, W2, n)(torch.as_tensor(table)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    got_b = BandedRowSum(gp, W2, n).call_batched(torch.as_tensor(table[None]))
    np.testing.assert_array_equal(got_b[0].numpy(), got)
    exact = (table[req] * valid).reshape(n, W2).astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got, exact, rtol=1e-6)


def _random_ell():
    """tests/test_pallas_spmv.py:713-717: banded random columns, 30% zero
    weights."""
    rng = np.random.RandomState(7)
    n, W = 4000, 8
    cols = (np.arange(n)[:, None] * 3 + rng.randint(0, 40, (n, W))) % (3 * n)
    w = rng.rand(n, W).astype(np.float32)
    w[rng.rand(n, W) < 0.3] = 0.0
    return cols, w, 3 * n


def _sphere_ell():
    _, topo = sphere_cut_system(8.0, 0, cache=False)
    rng = np.random.RandomState(3)
    w = (rng.rand(topo.n_nodes, topo.width) * topo.ell_valid).astype(np.float32)
    return topo.ell_cols, w, topo.n_nodes


ELLS = {"random": _random_ell, "sphere_h8": _sphere_ell}


def test_adaptive_block_rows_copy():
    for W in (1, 3, 8, 16, 25, 60, 136, 300):
        assert adaptive_block_rows(W) == _adaptive_block_rows(W)
    assert adaptive_block_rows(25) == 640 and adaptive_block_rows(1) == 16384


@pytest.mark.parametrize("band_pre", [False, True])
@pytest.mark.parametrize("name", sorted(ELLS))
def test_compact_columns_remap_matches_jax(name, band_pre, monkeypatch):
    cols, w, _ = ELLS[name]()
    real = w != 0
    R = adaptive_block_rows(cols.shape[1])
    monkeypatch.setenv("AFEM_BAND_PRE", "1" if band_pre else "0")
    pj, rj = _compact_columns(np.asarray(cols), real, R)
    pp, rp = compact_columns(cols, real, R, band_pre, device="cpu")
    assert pj is not None
    np.testing.assert_array_equal(rp, rj)
    assert isinstance(pp, BandedGather) == isinstance(pj, JaxBand) == band_pre
    if band_pre:
        np.testing.assert_array_equal(pp.tile_perm, pj.tile_perm)


@pytest.mark.parametrize("band_pre", [False, True])
@pytest.mark.parametrize("name", sorted(ELLS))
def test_compact_gather_matches_jax_chain(name, band_pre, monkeypatch):
    """CompactMatrix.spmv (the compact two stages, K1 on the SELL remap) ==
    the JAX compact chain's emulation to 2e-5 in f32, and ==
    (w·x[cols]).sum to 1e-12 in f64.  wcap=0: the JAX chain without its
    wide-row split, which the port does not have."""
    cols, w, n_t = ELLS[name]()
    monkeypatch.setenv("AFEM_BAND_PRE", "1" if band_pre else "0")
    g = PlannedGather.build(np.asarray(cols), w, compact=True, wcap=0)
    assert isinstance(g, ChainedGather)
    assert isinstance(g.stage1, JaxBand) == band_pre
    A = BellMatrix.from_numpy(w, cols, n_cols=n_t, device="cpu",
                              dtype=torch.float32)
    cm = CompactMatrix.from_bell(A, band_pre=band_pre)
    assert cm.band == band_pre
    table = np.random.RandomState(9).rand(n_t).astype(np.float32)
    got = cm.spmv(torch.as_tensor(table)).numpy()
    np.testing.assert_allclose(got, emulate_gather(g, table), rtol=2e-5, atol=1e-5)
    t64 = torch.as_tensor(table.astype(np.float64))
    got64 = cm.with_values(A.values.double()).spmv(t64).numpy()
    exact = (w.astype(np.float64) * table.astype(np.float64)[cols]).sum(axis=1)
    np.testing.assert_allclose(got64, exact, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("band_pre", [False, True])
def test_compact_coordinate_gather_equals_split(band_pre, monkeypatch):
    """The compact coordinate gather (AFEM_ASM_COMPACT=1), split and
    batched, fetches exactly the split gather's corners, and the JAX plan
    of the same requests (corner-major, PlannedGather.build compact) emulates
    to the same values."""
    mesh, topo = sphere_cut_system(8.0, 0, cache=False)
    conn = mesh.cells["tetra4"]
    coords = torch.as_tensor(mesh.coords)
    ref = TetraAssembler(topo, conn, device="cpu").gather_corners(coords)
    for batched in (False, True):
        asm = TetraAssembler(topo, conn, device="cpu", coords_batched=batched,
                             coords_compact=True, band_pre=band_pre)
        assert asm.compact.band == band_pre
        got = asm.gather_corners(coords)
        for k in range(3):
            assert torch.equal(got[k], ref[k])
    creq = np.ascontiguousarray(conn.astype(np.int32).T).reshape(-1, 1)
    monkeypatch.setenv("AFEM_BAND_PRE", "1" if band_pre else "0")
    g = PlannedGather.build(creq, np.ones(creq.shape, np.bool_), wcap=0,
                            compact=True)
    assert isinstance(g, ChainedGather)
    x = mesh.coords[:, 0].astype(np.float32)
    np.testing.assert_array_equal(emulate_gather(g, x), ref[0].numpy())


def test_band_wrappers_check_operands():
    bases = torch.zeros(2, dtype=torch.int32)
    lcols = torch.zeros((2, 128), dtype=torch.int32)
    x = torch.zeros(300)
    assert band_gather(bases, lcols, x, 16).shape == (256,)
    with pytest.raises(TypeError):
        band_gather(bases.long(), lcols, x, 16)
    with pytest.raises(ValueError):  # more tiles than bases
        band_gather(bases[:1], lcols, x, 16)
    with pytest.raises(ValueError):
        band_gather(bases, lcols, x[None], 16)
    with pytest.raises(ValueError):  # B > 8 tables
        band_gather_batched(bases, lcols, torch.zeros(9, 300), 16)
    with pytest.raises(ValueError):  # no kernel off CPU and CUDA
        band_gather(bases.to("meta"), lcols.to("meta"), x.to("meta"), 16)
    # pads (outside [0, K·128)) and reads past the table give 0
    lc = torch.full((1, 128), 1 << 28, dtype=torch.int32)
    lc[0, :3] = torch.tensor([0, 5, 2047], dtype=torch.int32)
    t = torch.arange(1.0, 301.0)
    out = band_gather(torch.tensor([2], dtype=torch.int32), lc, t, 16)
    assert out[:3].tolist() == [257.0, 262.0, 0.0] and not out[3:].any()
