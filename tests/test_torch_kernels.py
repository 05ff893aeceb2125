"""The CUDA kernels (arcanefem_tpu_torch/csrc/*.cu) against their plain
twins.  This file imports no jax, so on the card's machine, which has
none, it runs without the tests' conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Without a CUDA device the card cases skip."""

import numpy as np
import pytest
import torch

from arcanefem_tpu_torch.bench_unstructured import (
    solve_sphere_cut,
    sphere_cut_system,
)
from arcanefem_tpu_torch.bench_structured import (
    box_system,
    solve_jacobi,
    solve_mg,
    solve_mg_flat,
    true_residual,
)
from arcanefem_tpu_torch.mesh import stencil_assembly as sa
from arcanefem_tpu_torch.mesh.structured import StructuredBox
from arcanefem_tpu_torch.ops import lane_assembly as la
from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
from arcanefem_tpu_torch.sparse import dia_stencil as ds
from arcanefem_tpu_torch.sparse import sell
from arcanefem_tpu_torch.sparse import slot_reduce as sr
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.ell_gather import (
    ell_gather_sum,
    ell_gather_sum_batched,
    ell_gather_sum_batched_plain,
    ell_gather_sum_plain,
    ell_spmv_batched_plain,
    ell_spmv_plain,
    launch_counts,
    reset_launch_counts,
)
from arcanefem_tpu_torch.sparse.sell import (
    SellLayout,
    sell_spmv,
    sell_spmv_batched,
    sell_spmv_batched_plain,
    sell_spmv_plain,
)
from arcanefem_tpu_torch.sparse import band_gather as band
from arcanefem_tpu_torch.sparse import diag_spmv as dsp
from arcanefem_tpu_torch.sparse.band_gather import BandedGather
from arcanefem_tpu_torch.sparse.diag_spmv import DiagEllMatrix
from arcanefem_tpu_torch.sparse import blocked as blk
from arcanefem_tpu_torch.sparse import supernode as snm
from arcanefem_tpu_torch.sparse.supernode import SupernodeSpmv, bsr8_spmv, bsr8_spmv_plain
from arcanefem_tpu_torch.tools import probe_gather as pg

NO_LAUNCHES = {"ell_gather_sum": 0, "ell_gather_sum_batched": 0}
NO_SELL = {"sell_spmv": 0, "sell_spmv_bf16": 0, "sell_spmv_batched": 0}


def _reset():
    reset_launch_counts()
    sell.reset_launch_counts()


def _counts():
    return {**launch_counts(), **sell.launch_counts()}


def _sell_case(gen, n, W, dtype, device, sigma=None):
    """Random (n, W) columns, ~20% of the slots padding, values in dtype
    and the SELL layout of the real slots on ``device``: (layout, SELL
    values, (n, W) values on device, (n, W) int32 columns on device)."""
    cols = torch.randint(0, n, (n, W), generator=gen, dtype=torch.int32)
    pad = torch.rand((n, W), generator=gen) < 0.2
    vals = ((torch.rand((n, W), generator=gen, dtype=torch.float64) * 2 - 1)
            .masked_fill(pad, 0.0))
    lay = SellLayout.build(cols.numpy(), (~pad).numpy(), device=device, sigma=sigma)
    v = vals.to(dtype)
    return lay, lay.from_ell(v).to(device), v.to(device), cols.to(device)


def _sigma_layout(topo, b, device, sigma):
    """block_layout's SELL layout of the scalar expansion, built with the
    given σ instead of the one SellLayout.build chooses."""
    N, W = topo.n_nodes, topo.width
    cols = (topo.ell_cols.astype(np.int32)[:, None, :, None] * b
            + np.arange(b, dtype=np.int32)[None, None, None, :])
    cols = np.broadcast_to(cols, (N, b, W, b)).reshape(N * b, W * b)
    real = np.broadcast_to(topo.ell_valid[:, None, :, None], (N, b, W, b))
    return SellLayout.build(cols, real.reshape(N * b, W * b), device=device, sigma=sigma)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def test_wrappers_check_operands():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.zeros(4)
    lay = SellLayout.build(cols.numpy(), np.ones((4, 2), bool), device="cpu")
    with pytest.raises(TypeError):
        ell_gather_sum(cols.long(), x)
    with pytest.raises(ValueError):
        sell_spmv(torch.zeros(lay.n_slots + 1), lay, x)
    with pytest.raises(ValueError):
        sell_spmv(torch.zeros(lay.n_slots), lay, torch.zeros(5))
    with pytest.raises(TypeError):
        sell_spmv(torch.zeros(lay.n_slots, dtype=torch.float64), lay, x)
    with pytest.raises(ValueError):
        sell_spmv(torch.zeros(lay.n_slots).to("meta"), lay, x.to("meta"))
    with pytest.raises(ValueError):
        ell_gather_sum(cols, torch.zeros(4, 1))
    with pytest.raises(ValueError):
        ell_gather_sum(cols.to("meta"), x.to("meta"))
    with pytest.raises(ValueError):
        BellMatrix.from_numpy(np.zeros((4, 2)), np.full((4, 2), 4),
                              device="cpu", dtype=torch.float64)
    # bf16 weights go with float32 x or tables only
    with pytest.raises(TypeError):
        sell_spmv(torch.zeros(lay.n_slots, dtype=torch.bfloat16), lay,
                  x.double())
    with pytest.raises(TypeError):
        sell_spmv_batched(torch.zeros(lay.n_slots, dtype=torch.bfloat16), lay,
                          torch.zeros(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError):  # B > 8 tables
        sell_spmv_batched(torch.zeros(lay.n_slots), lay, torch.zeros(9, 4))
    with pytest.raises(ValueError):  # an out of the wrong shape
        sell_spmv_batched(torch.zeros(lay.n_slots), lay, torch.zeros(3, 4),
                          out=torch.zeros(4, 3))
    with pytest.raises(ValueError):  # B > 8 tables
        ell_gather_sum_batched(cols, torch.zeros(9, 4))
    with pytest.raises(ValueError):  # an out of the wrong shape
        ell_gather_sum_batched(cols, torch.zeros(3, 4), out=torch.zeros(4, 3))


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers run the plain twin and count nothing."""
    _reset()
    cols = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    x = torch.tensor([2.0, 3.0])
    vals = torch.tensor([[1.0, 0.5], [2.0, 0.0]])
    A = BellMatrix.from_numpy(vals.numpy(), cols.clamp(min=0).numpy(),
                              device="cpu", dtype=torch.float32)
    assert A.spmv(x).tolist() == [3.5, 6.0]
    assert ell_gather_sum(cols, x).tolist() == [5.0, 3.0]
    assert A.with_values(A.values.bfloat16()).spmv(x).tolist() == [3.5, 6.0]
    t = torch.stack([x, 2 * x])
    assert ell_gather_sum_batched(cols, t).tolist() == [[5.0, 3.0], [10.0, 6.0]]
    assert sell_spmv_batched(A.values, A.layout, t.T.contiguous().T).tolist() \
        == [[3.5, 6.0], [7.0, 12.0]]
    assert _counts() == {**NO_LAUNCHES, **NO_SELL}


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_kernels_match_plain_on_cuda(cuda, dtype, rtol):
    """K1 (SELL, σ chosen and σ = 1024) and K2 == their plain twins and the
    (n, W) definition on the card, with padding, empty rows and wide rows;
    the error is measured against sum |v·x| of each row."""
    gen = torch.Generator().manual_seed(0)
    _reset()
    for W in (1, 8, 25, 136):
        n = 50_001  # not a multiple of 32
        for sigma in (None, sell.SIGMA):
            lay, sv, vals, cols = _sell_case(gen, n, W, dtype, cuda, sigma)
            x = (torch.rand(n, generator=gen, dtype=dtype) * 2 - 1).to(cuda)
            y = sell_spmv(sv, lay, x)
            torch.cuda.synchronize()
            assert y.dtype == dtype
            scale = ell_spmv_plain(vals.abs(), cols, x.abs())
            for want in (sell_spmv_plain(sv, lay, x), ell_spmv_plain(vals, cols, x)):
                assert bool(((y - want).abs() <= rtol * scale).all()), (W, sigma)
        ucols = torch.where(vals == 0, -1, cols)
        u = ell_gather_sum(ucols, x)
        uscale = ell_gather_sum_plain(ucols, x.abs())
        assert bool(((u - ell_gather_sum_plain(ucols, x)).abs()
                     <= rtol * uscale).all())
    assert _counts() == {**NO_LAUNCHES, **NO_SELL, "sell_spmv": 8,
                         "ell_gather_sum": 4}


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_batched_kernels_match_plain_on_cuda(cuda, dtype, rtol):
    """K3b (on the SELL layout of the real slots) and K3a == their plain
    twins on the card, K3b also == the (n, W) definition, for B in 1, 3, 8
    and W in 1, 8, 25, 136 with padding, tables and results contiguous or
    channel-minor (strided: 16-byte rows at B = 8); error against each
    row's sum |v·x|."""
    gen = torch.Generator().manual_seed(2)
    _reset()
    n = 20_000
    launches = 0
    for W in (1, 8, 25, 136):
        cols = torch.randint(0, n, (n, W), generator=gen, dtype=torch.int32)
        vals = torch.rand((n, W), generator=gen, dtype=dtype) * 2 - 1
        pad = torch.rand((n, W), generator=gen) < 0.2
        vals[pad] = 0
        ucols = torch.where(pad, -1, cols)
        lay = SellLayout.build(cols.numpy(), (~pad).numpy(), device=cuda)
        cols, vals, ucols = (t.to(cuda) for t in (cols, vals, ucols))
        sv = lay.from_ell(vals)
        for B in (1, 3, 8):
            tab = torch.rand((B, n), generator=gen, dtype=dtype) * 2 - 1
            for minor in (False, True):
                t = tab.to(cuda)
                if minor:
                    t = t.T.contiguous().T
                out = (torch.empty((n, B), dtype=dtype, device=cuda).T
                       if minor else None)
                y = sell_spmv_batched(sv, lay, t, out=out)
                u = ell_gather_sum_batched(ucols, t)
                torch.cuda.synchronize()
                launches += 1
                assert out is None or y is out
                scale = ell_spmv_batched_plain(vals.abs(), cols, t.abs())
                uscale = ell_gather_sum_batched_plain(ucols, t.abs())
                for want in (sell_spmv_batched_plain(sv, lay, t),
                             ell_spmv_batched_plain(vals, cols, t)):
                    assert bool(((y - want).abs() <= rtol * scale).all()), (W, B, minor)
                assert bool(((u - ell_gather_sum_batched_plain(ucols, t)).abs()
                             <= rtol * uscale).all()), (W, B, minor)
    assert _counts() == {**NO_LAUNCHES, **NO_SELL, "sell_spmv_batched": launches,
                         "ell_gather_sum_batched": launches}


def test_bf16_spmv_matches_plain_on_cuda(cuda):
    """K1 with bf16 weights and f32 x == its twin (1e-5 of sum |v·x|), and
    K3b with bf16 weights and 8 channel-minor f32 tables likewise."""
    gen = torch.Generator().manual_seed(3)
    _reset()
    for W in (1, 25, 136):
        n = 30_000
        lay, sv, vals, cols = _sell_case(gen, n, W, torch.bfloat16, cuda)
        x = (torch.rand(n, generator=gen) * 2 - 1).to(cuda)
        y = sell_spmv(sv, lay, x)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32
        scale = ell_spmv_plain(vals.abs(), cols, x.abs())
        assert bool(((y - sell_spmv_plain(sv, lay, x)).abs() <= 1e-5 * scale).all())
        assert bool(((y - ell_spmv_plain(vals, cols, x)).abs() <= 1e-5 * scale).all())
        t = (torch.rand((n, 8), generator=gen) * 2 - 1).to(cuda).T
        yb = sell_spmv_batched(sv, lay, t, out=torch.empty((n, 8), device=cuda).T)
        bscale = ell_spmv_batched_plain(vals.abs(), cols, t.abs())
        assert bool(((yb - sell_spmv_batched_plain(sv, lay, t)).abs()
                     <= 1e-5 * bscale).all())
    assert _counts() == {**NO_LAUNCHES, **NO_SELL, "sell_spmv_bf16": 3,
                         "sell_spmv_batched": 3}


def test_supernode_spmv_on_cuda_matches_cpu(cuda):
    """The supernode SpMV of the h=14 operator through bsr8_spmv on the card
    (one launch, no K3a) == its CPU twin (f32 blocks: 1e-5 of each row's
    sum |a·x|), and the f64 operator to 1e-12; bf16 blocks with f32 x too."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                           penalty=1e12)
    A = res["A"]
    x = torch.rand(topo.n_nodes, generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    scale = A.with_values(A.values.abs()).spmv(x)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        Ad = A.with_values(A.values.to(dtype))
        cpu = SupernodeSpmv.build(Ad, topo)
        dev = SupernodeSpmv.build(BellMatrix.from_numpy(
            Ad.ell_values().numpy(), topo.ell_cols, topo.diag_slot, device=cuda,
            dtype=dtype), topo)
        # bf16 blocks take f32 x and sum their exact products in f64
        for a, b, tol, xd in ((cpu, dev, rtol, dtype),
                              (cpu.as_bf16(), dev.as_bf16(), 1e-5, torch.float32)):
            reset_launch_counts()
            snm.reset_launch_counts()
            y = b(x.to(xd).to(cuda)).cpu()
            bf16 = b.blocks.dtype == torch.bfloat16
            assert snm.launch_counts() == {"bsr8_spmv": int(not bf16),
                                           "bsr8_spmv_bf16": int(bf16)}
            assert launch_counts()["ell_gather_sum_batched"] == 0
            want = a(x.to(xd))
            assert bool(((y.double() - want.double()).abs() <= tol * scale).all())
        assert bool(((y.double() - A.spmv(x)).abs() <= 2e-2 * scale.max()).all())


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.float64, 1e-12),
                                        (torch.bfloat16, 1e-6)])
def test_bsr8_spmv_matches_plain_on_cuda(cuda, dtype, rtol):
    """bsr8_spmv == its plain twin on the card, to rtol of each row's sum
    |a·x| (f32 and bf16 blocks: one f32 rounding of y; f64: the sum
    order), on random block rows of 0 to 44 blocks (44 is the 1.9M
    sphere's largest degree) with an empty block row and one at 44, n not a
    multiple of 8, x 16-byte aligned and not (a view at offset 1);
    SupernodeSpmv and the public wrapper agree bit for bit, one launch per
    call, and the empty block row gives zeros."""
    rng = np.random.RandomState(11)
    n_sup = 3000
    n = 8 * n_sup - 3
    deg = rng.randint(0, 45, n_sup)
    deg[1], deg[2] = 0, 44
    bptr = np.concatenate([[0], np.cumsum(deg)])
    bcol = np.concatenate([np.sort(rng.choice(n_sup, d, replace=False)) for d in deg])
    blocks = rng.rand(bptr[-1], 8, 8) * 2 - 1
    sn = SupernodeSpmv.from_numpy(blocks, bcol, bptr, np.repeat(np.arange(n_sup), deg),
                                  n, device=cuda, dtype=dtype)
    xd = torch.float32 if dtype == torch.bfloat16 else dtype
    base = torch.as_tensor(rng.rand(n + 1) * 2 - 1, dtype=xd, device=cuda)
    snm.reset_launch_counts()
    for x in (base[:n], base[1:]):
        y = sn(x)
        yk = bsr8_spmv(sn.blocks, sn.cols, sn.ptr, x)
        torch.cuda.synchronize()
        assert y.dtype == xd and y.shape == (n,) and torch.equal(y, yk)
        want = bsr8_spmv_plain(sn.blocks, sn.cols, sn.ptr, x)
        scale = bsr8_spmv_plain(sn.blocks.abs(), sn.cols, sn.ptr, x.abs())
        assert bool(((y.double() - want.double()).abs() <= rtol * scale.double()).all())
        assert not bool(y[8:16].any())
    bf16 = dtype == torch.bfloat16
    assert snm.launch_counts() == {"bsr8_spmv": 0 if bf16 else 4,
                                   "bsr8_spmv_bf16": 4 if bf16 else 0}


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.float64, 1e-12),
                                        (torch.bfloat16, 1e-6)])
def test_bsr_spmv_matches_plain_on_cuda(cuda, b, dtype, rtol):
    """The BSR-b kernel (b = 2, 4; BlockedGather) == its plain twin on the
    card, to rtol of each row's sum |a·x|, on a random rectangular CSR
    (n_rows and n_cols not multiples of b, an empty row band), x 16-byte
    aligned and not; one launch per call.  At b = 2 (the sliced kernel)
    also == the twin on its slices."""
    import scipy.sparse as sp

    rng = np.random.RandomState(12)
    A = sp.random(4099, 3001, density=0.004, random_state=rng, format="csr")
    A[8:16] = 0
    A.eliminate_zeros()
    blocks, bcol, bptr, _ = blk.csr_to_bsr(A.indices, A.indptr, A.data, A.shape[1], b=b,
                                           device=cuda, dtype=torch.float32
                                           if dtype == torch.bfloat16 else dtype)
    g = blk.BlockedGather(blocks, bcol, bptr, A.shape[0], A.shape[1], A.nnz)
    if dtype == torch.bfloat16:
        g, blocks = g.with_weights_dtype(torch.bfloat16), blocks.to(torch.bfloat16)
    xd = torch.float32 if dtype == torch.bfloat16 else dtype
    base = torch.as_tensor(rng.rand(A.shape[1] + 1) * 2 - 1, dtype=xd, device=cuda)
    blk.reset_launch_counts()
    for x in (base[:-1], base[1:]):
        y = g(x)
        torch.cuda.synchronize()
        assert y.dtype == xd and y.shape == (A.shape[0],)
        want = blk.bsr_spmv_plain(blocks, bcol, bptr, x, g.n_rows)
        scale = blk.bsr_spmv_plain(blocks.abs(), bcol, bptr, x.abs(), g.n_rows)
        assert bool(((y.double() - want.double()).abs() <= rtol * scale.double()).all())
        if b == 2:
            ys = blk.bsr2_slices_plain(g.slices, x, g.n_rows)
            assert bool(((y.double() - ys.double()).abs() <= rtol * scale.double()).all())
        assert not bool(y[8:16].any())
    bf16 = dtype == torch.bfloat16
    assert blk.launch_counts() == {"bsr_spmv": 0 if bf16 else 2,
                                   "bsr_spmv_bf16": 2 if bf16 else 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_w1_matches_plain_on_cuda(cuda, dtype):
    """K3a (and K3b) at W=1 for every B in 1..8, with -1 pads, tables and
    results table-major, channel-minor and row-strided (a stride of B + 2):
    equal to their plain twins bit for bit (a copy; one rounded product).
    K3b runs on the SELL layout of the (n, 1) columns."""
    gen = torch.Generator().manual_seed(12)
    _reset()
    n_t, n = 70_001, 300_007
    calls = 0
    for B in range(1, 9):
        cols = torch.randint(0, n_t, (n, 1), generator=gen, dtype=torch.int32)
        ucols = torch.where(torch.rand((n, 1), generator=gen) < 0.1, -1, cols)
        vals = torch.rand((n, 1), generator=gen, dtype=dtype)
        lay = SellLayout.build(cols.numpy(), np.ones((n, 1), bool), device=cuda,
                               n_cols=n_t)
        cols, ucols, vals = (t.to(cuda) for t in (cols, ucols, vals))
        sv = lay.from_ell(vals)
        tab = torch.rand((B, n_t), generator=gen, dtype=dtype).to(cuda)
        for layout in ("table_major", "channel_minor", "row_strided"):
            if layout == "table_major":
                t, outs = tab, (None, None)
            elif layout == "channel_minor":
                t = tab.T.contiguous().T
                outs = [torch.empty((n, B), dtype=dtype, device=cuda).T for _ in range(2)]
            else:
                t = torch.zeros((n_t, B + 2), dtype=dtype, device=cuda)[:, :B].T
                t.copy_(tab)
                outs = [torch.empty((n, B + 2), dtype=dtype, device=cuda)[:, :B].T
                        for _ in range(2)]
            u = ell_gather_sum_batched(ucols, t, out=outs[0])
            y = sell_spmv_batched(sv, lay, t, out=outs[1])
            torch.cuda.synchronize()
            calls += 1
            assert torch.equal(u, ell_gather_sum_batched_plain(ucols, t)), (B, layout)
            assert torch.equal(y, ell_spmv_batched_plain(vals, cols, t)), (B, layout)
            assert torch.equal(y, sell_spmv_batched_plain(sv, lay, t)), (B, layout)
    assert _counts() == {**NO_LAUNCHES, **NO_SELL, "sell_spmv_batched": calls,
                         "ell_gather_sum_batched": calls}


def test_slice_on_cuda_matches_plain_and_cpu(cuda):
    """The h=14 slice in f32 through the kernels == the same slice on the
    plain twins, and == the f64 CPU solve to 1e-4 of max|x|."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    _reset()
    la.reset_launch_counts()
    sr.reset_launch_counts()
    k = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32,
                         penalty=1e12)
    counts = {**_counts(), **la.launch_counts(), **sr.launch_counts()}
    assert counts["sell_spmv"] > 0 and counts["ell_gather_sum"] == 0
    assert counts["tet_assemble"] == 1 and counts["tet_element"] == counts["slot_reduce"] == 0
    p = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32,
                         penalty=1e12, plain=True)
    c = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                         penalty=1e30)
    xk = k["x"].cpu()
    for other in (p, c):
        assert abs(other["iterations"] - k["iterations"]) <= 1
        xo = other["x"].cpu()
        assert float((xk - xo).abs().max()) <= 1e-4 * float(xo.abs().max())
    assert k["rel"] <= 1e-8 and k["true_residual"] <= 1e-4


def _sphere_assembler(cuda, **kw):
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device=cuda, **kw)
    return mesh, topo, asm, torch.as_tensor(mesh.coords, device=cuda).float()


def test_tet_element_matches_plain_on_cuda(cuda):
    """tet_element, on the coordinates and on gathered corners ((3, 4nc)
    or three rows), == its plain twin to 4 float32 ulps of each cell's
    max |ke|; its input modes agree exactly."""
    _, _, asm, coords = _sphere_assembler(cuda)
    la.reset_launch_counts()
    corners = la.tet_corners_plain(coords, asm.corner_cols)
    got = [la.tet_element(coords, asm.corner_cols), la.tet_element_gathered(corners),
           la.tet_element_gathered(list(corners))]
    torch.cuda.synchronize()
    assert la.launch_counts() == {"tet_element": 3, "tet_assemble": 0}
    with pytest.raises(ValueError, match="no corner gather"):
        asm.gather_corners(coords)
    want = la.tet_element_plain(corners)
    m = want.abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(m, 2 * m + 1) - m
    for g in got:
        assert g.shape == want.shape and g.dtype == torch.float32
        assert bool(((g - want).abs() <= 4 * ulp).all())
        assert torch.equal(g, got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_reduce_matches_plain_on_cuda(cuda, dtype):
    """slot_reduce == its plain twin bit for bit on the same table, on the
    card and on the CPU; padding slots exactly 0 (the window lists of the
    batched route: the default route keeps patch lists instead)."""
    _, _, asm, _ = _sphere_assembler(cuda, coords_batched=True)
    gen = torch.Generator().manual_seed(9)
    table = torch.rand(10 * asm.n_cells, generator=gen, dtype=torch.float64).to(dtype) - 0.5
    sr.reset_launch_counts()
    y = sr.slot_reduce(asm.ptr, asm.ids, table.to(cuda))
    torch.cuda.synchronize()
    assert sr.launch_counts() == {"slot_reduce": 1, "block_slot_reduce": 0}
    assert y.dtype == dtype
    assert torch.equal(y, sr.slot_reduce_plain(asm.ptr, asm.ids, table.to(cuda)))
    assert torch.equal(y.cpu(), sr.slot_reduce(asm.ptr.cpu(), asm.ids.cpu(), table))
    assert not y[torch.as_tensor(~asm.layout.real, device=cuda)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [2, 3])
def test_block_slot_reduce_matches_plain_on_cuda(cuda, dtype, b):
    """block_slot_reduce == its plain twin bit for bit on the same table,
    on the card and on the CPU, and from run to run; one launch each; the
    expanded layout's padding exactly 0, with no memset."""
    from arcanefem_tpu_torch.fem.problem import FemProblem
    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh

    mesh = rect_tria_mesh(40, 30) if b == 2 else box_tetra_mesh(14, 11, 9)
    prob = FemProblem(mesh, ndof=b, device=cuda, dtype=dtype)
    asm = prob.block_assembly
    gen = torch.Generator().manual_seed(b)
    table = (torch.rand(asm.ids.numel() * b * b, generator=gen, dtype=torch.float64)
             - 0.5).to(dtype)
    sr.reset_launch_counts()
    y = asm.reduce(table.to(cuda))
    y2 = asm.reduce(table.to(cuda))
    torch.cuda.synchronize()
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 2}
    assert y.dtype == dtype and torch.equal(y, y2)
    assert torch.equal(y, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table.to(cuda),
                                                     asm.row_ptr, asm.layout, b))
    cpu_layout = SellLayout.from_arrays(asm.layout.to_arrays(), device="cpu")
    assert torch.equal(y.cpu(), sr.block_slot_reduce(asm.ptr.cpu(), asm.ids.cpu(), table,
                                                     asm.row_ptr.cpu(), cpu_layout, b))
    assert not y[torch.as_tensor(~prob.layout.real, device=cuda)].any()


@pytest.mark.parametrize("sigma", [None, 1, 7], ids=["default", "sigma1", "sigma7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh_name", ["rect", "box", "mixed"])
def test_block_slot_reduce_layouts_on_cuda(cuda, mesh_name, dtype, sigma):
    """The kernel on the layout cases of the CPU tests (σ = 1024, σ = 1,
    σ = 7 with node rows across windows and slices; b = 2 in f64; the
    mixed passmo mesh, lists across buckets): equal to its twin and to
    itself from run to run, bit for bit, into an output that held NaN
    before, so that every slot, padding included, is written."""
    from arcanefem_tpu_torch.fem.problem import FemProblem
    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
    from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh

    mesh, b = {"rect": (rect_tria_mesh(9, 7), 2), "box": (box_tetra_mesh(4, 3, 3), 3),
               "mixed": (mixed_box_mesh(), 3)}[mesh_name]
    prob = FemProblem(mesh, ndof=b, device=cuda, dtype=dtype)
    asm = prob.block_assembly
    lay = asm.layout if sigma is None else _sigma_layout(prob.topo, b, cuda, sigma)
    gen = torch.Generator().manual_seed(5)
    table = ((torch.rand(asm.ids.numel() * b * b, generator=gen, dtype=torch.float64)
              - 0.5).to(dtype).to(cuda))
    # fill the caching allocator's next block of this size with NaN
    torch.full((lay.n_slots,), float("nan"), dtype=dtype, device=cuda)
    sr.reset_launch_counts()
    y = sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr, lay, b)
    y2 = sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr, lay, b)
    torch.cuda.synchronize()
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 2}
    assert torch.equal(y, y2)
    assert torch.equal(y, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table, asm.row_ptr,
                                                     lay, b))


def _star_topology(m):
    """The topology of 2m tetrahedra around node 0 (a ring of m nodes and
    two apexes): node 0 has m + 3 node slots, wider than the block kernel's
    shared-memory stage holds at b = 3 in float64 when m >= 60."""
    from arcanefem_tpu_torch.sparse.topology import build_topology

    ring = 1 + np.arange(m)
    nxt = 1 + (np.arange(m) + 1) % m
    top, bottom = m + 1, m + 2
    conn = np.concatenate([np.stack([np.zeros(m, int), ring, nxt, np.full(m, top)], 1),
                           np.stack([np.zeros(m, int), nxt, ring, np.full(m, bottom)], 1)])
    return build_topology(m + 3, {"tetra4": conn.astype(np.int32)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_slot_reduce_wide_slice_and_offset_table_on_cuda(cuda, dtype):
    """A slice wider than the stage (node 0 of an 80-tet star has 83 node
    slots) is written in chunks, and a table that does not start on 16
    bytes is taken too: equal to the twin bit for bit."""
    from arcanefem_tpu_torch.sparse.bell import BlockAssembly

    topo = _star_topology(80)
    asm = BlockAssembly(topo, ["tetra4"], 3, cuda)
    assert int(asm.layout.slice_width.max()) // 3 == 83
    gen = torch.Generator().manual_seed(11)
    big = (torch.rand(asm.ids.numel() * 9 + 1, generator=gen, dtype=torch.float64)
           - 0.5).to(dtype).to(cuda)
    for table in (big[:-1], big[1:]):
        sr.reset_launch_counts()
        y = sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr, asm.layout, 3)
        torch.cuda.synchronize()
        assert sr.launch_counts()["block_slot_reduce"] == 1
        assert torch.equal(y, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table, asm.row_ptr,
                                                         asm.layout, 3))


@pytest.mark.parametrize("h,refine", [(14.0, 0), (14.0, 1)])
def test_tet_assembly_deterministic_on_cuda(cuda, h, refine):
    """Two assemblies on each route are bit-equal, and equal across the
    four routes: the default route's one fused launch (tet_assemble) is so
    held to tet_element + slot_reduce on the window lists of the others.
    Its patch lists equal the CPU build's, a patch holds more cells than a
    block has threads, and only the default route counts tet_assemble."""
    mesh, topo = sphere_cut_system(h, refine, cache=False)
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device=cuda)
    coords = torch.as_tensor(mesh.coords, device=cuda).float()
    cpu = la.TetPatches.build(topo, mesh.cells["tetra4"], asm.layout, "cpu",
                              max_bytes=min(la.PATCH_BYTES, la._smem_limit(coords.device)))
    for name in ("lconn", "nodes", "meta", "blob"):
        assert torch.equal(getattr(asm.patches, name).cpu(), getattr(cpu, name)), name
    assert asm.patches.smem_bytes == cpu.smem_bytes
    cell0 = cpu.meta[0]
    assert int((cell0[1:] - cell0[:-1]).max()) > la._ASSEMBLE_THREADS
    assert not hasattr(asm, "ptr") and not hasattr(asm, "ids")
    _reset()
    la.reset_launch_counts()
    sr.reset_launch_counts()
    ref = asm(coords)
    torch.cuda.synchronize()
    assert _counts() == {**NO_LAUNCHES, **NO_SELL}
    assert la.launch_counts() == {"tet_element": 0, "tet_assemble": 1}
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 0}
    assert not ref[torch.as_tensor(~asm.layout.real, device=cuda)].any()
    for kw in ({}, dict(coords_batched=True), dict(coords_compact=True),
               dict(coords_compact=True, coords_batched=True, band_pre=True)):
        other = TetraAssembler(topo, mesh.cells["tetra4"], device=cuda,
                               layout=asm.layout, **kw)
        la.reset_launch_counts()
        assert torch.equal(other(coords), ref) and torch.equal(other(coords), ref), kw
        assert la.launch_counts()["tet_assemble"] == (0 if kw else 2), kw


@pytest.mark.parametrize("max_bytes", [20_000, 50_000])
def test_tet_assemble_small_patches_on_cuda(cuda, max_bytes):
    """Smaller patches (a slice alone where one passes the cap; patches
    that cut through σ windows) give the values of the window route's two
    kernels bit for bit."""
    mesh, topo = sphere_cut_system(14.0, 1, cache=False)
    ref_asm = TetraAssembler(topo, mesh.cells["tetra4"], device=cuda, coords_batched=True)
    coords = torch.as_tensor(mesh.coords, device=cuda).float()
    P = la.TetPatches.build(topo, mesh.cells["tetra4"], ref_asm.layout, cuda,
                            max_bytes=max_bytes)
    assert P.n_patches > ref_asm.layout.n_slices // 8
    assert torch.equal(la.tet_assemble(P, coords), ref_asm(coords))


def test_tet_assemble_refuses_a_table_past_shared_memory(cuda):
    """Patches that pass the shared memory a block may have are refused
    by the wrapper before any launch."""
    mesh, topo = sphere_cut_system(14.0, 1, cache=False)
    lay = TetraAssembler(topo, mesh.cells["tetra4"], device=cuda,
                         coords_batched=True).layout
    P = la.TetPatches.build(topo, mesh.cells["tetra4"], lay, cuda, max_bytes=300_000)
    coords = torch.as_tensor(mesh.coords, device=cuda).float()
    assert P.smem_bytes > la._smem_limit(coords.device)
    la.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        la.tet_assemble(P, coords)
    assert la.launch_counts()["tet_assemble"] == 0


def _padded(box, gen, dtype, nan_pads=False):
    """A random (nx+1, ny', nz') plane vector, zero (or NaN) on the pads."""
    nyp, nzp = ds._pads(box)
    x = torch.rand((box.nx + 1, nyp, nzp), generator=gen, dtype=torch.float64) * 2 - 1
    pad = torch.ones_like(x, dtype=torch.bool)
    pad[:, 1 : box.ny + 2, 1 : box.nz + 2] = False
    x[pad] = float("nan") if nan_pads else 0.0
    return x.to(dtype)


@pytest.mark.parametrize("band_dtype,dtype,rtol", [
    (torch.float32, torch.float32, 1e-5), (torch.bfloat16, torch.float32, 1e-5),
    (torch.float32, torch.float64, 1e-12), (torch.float64, torch.float64, 1e-12)])
@pytest.mark.parametrize("band_major", [False, True])
def test_dia_stencil_matches_plain_on_cuda(cuda, band_dtype, dtype, rtol, band_major):
    """Every mode of the stencil kernel == its plain twin, error against
    sum |band·x| (+|b|); pads exactly 0; NaN in the vectors' pads ignored."""
    box = StructuredBox(20, 13, 130)
    gen = torch.Generator().manual_seed(1)
    nyp, nzp = ds._pads(box)
    shape = (15, box.nx + 1, nyp, nzp) if band_major else (box.nx + 1, 15, nyp, nzp)
    bands = (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1).to(band_dtype)
    x, b, aux = (_padded(box, gen, dtype) for _ in range(3))
    bands, x, b, aux = (t.to(cuda) for t in (bands, x, b, aux))
    kw = dict(band_major=band_major, ny=box.ny, nz=box.nz)
    ds.reset_launch_counts()
    for mode, extra in (("spmv", {}), ("jacobi", dict(b=b, aux=aux, omega=0.8)),
                        ("residual", dict(b=b, aux=aux)), ("residual", dict(b=b))):
        y = ds.dia_stencil(mode, bands, x, **kw, **extra)
        torch.cuda.synchronize()
        want = ds.dia_stencil_plain(mode, bands, x, **kw, **extra)
        scale = ds.dia_stencil_plain("spmv", bands.abs(), x.abs(), **kw) + b.abs() + x.abs()
        assert bool(((y - want).abs() <= rtol * scale).all()), mode
        real = torch.zeros_like(y, dtype=torch.bool)
        real[:, 1 : box.ny + 2, 1 : box.nz + 2] = True
        assert bool((y[~real] == 0).all()), mode
    xn = _padded(box, torch.Generator().manual_seed(1), dtype, nan_pads=True).to(cuda)
    xn[:, 1 : box.ny + 2, 1 : box.nz + 2] = x[:, 1 : box.ny + 2, 1 : box.nz + 2]
    assert torch.equal(ds.dia_stencil("spmv", bands, xn, **kw),
                       ds.dia_stencil("spmv", bands, x, **kw))
    counts = ds.launch_counts()
    assert sum(counts.values()) == 6
    assert counts["dia_spmv" if band_major else "dia_spmv_p"] == 3


def _bc_case(box, dtype):
    """Coordinates (jitter 0.1), the Dirichlet mask (the x faces; only xmin
    on a box one hex thick) and the padded mask and penalty·g planes."""
    c3 = torch.as_tensor(box.grid_coords(np.float64, jitter=0.1)).to(dtype)
    mask = box.boundary_mask(("xmin", "xmax") if box.nx > 1 else ("xmin",))
    g = np.where(box.boundary_mask(("xmax",)), 1.0, 0.0)
    mask_p = torch.as_tensor(ds.pad_host_vec(box, mask, np.float64)).to(dtype)
    pg_p = torch.as_tensor(ds.pad_host_vec(box, 1e12 * g * mask, np.float64)).to(dtype)
    return c3, mask, mask_p, pg_p


# shapes that cut K4's 8 x 32 tiles and 16-plane slabs unevenly: one hex
# thick (the wrapper takes no box thinner than 2 hexes in y and z), one
# node beyond a tile in y and z and beyond a slab in x, a z of 130
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("dims", [(6, 5, 4), (17, 9, 130), (1, 2, 2), (16, 8, 32)])
def test_stencil_assembly_matches_plain_on_cuda(cuda, dtype, rtol, dims):
    """Stiffness-only and fused assembly == their plain twins to rtol of the
    largest band entry; the fused form's pads exactly 0."""
    box = StructuredBox(*dims)
    c3, mask, mask_p, pg_p = _bc_case(box, dtype)
    sa.reset_launch_counts()
    A = sa.assemble_stiffness_kernel(box, c3.to(cuda))
    Ap_ = sa.assemble_stiffness_plain(box, c3)
    scale = float(Ap_.bands.abs().max())
    assert float((A.bands.cpu() - Ap_.bands).abs().max()) <= rtol * scale
    Ak, rk = sa.assemble_system(box, c3.to(cuda), mask_p.to(cuda), pg_p.to(cuda), 1e12, 1.0)
    Ap, rp = sa.assemble_system_plain(box, c3, mask_p, pg_p, 1e12, 1.0)
    torch.cuda.synchronize()
    bk, bp = Ak.bands_p.cpu(), Ap.bands_p
    assert float((bk - bp).abs().max()) <= rtol * 1e12
    free = ~torch.as_tensor(mask)
    for d in range(15):
        got, want = Ak.unpad_vec(bk[:, d]), Ap.unpad_vec(bp[:, d])
        assert float((got - want)[free].abs().max()) <= rtol * scale
    assert float((rk.cpu() - rp).abs().max()) <= rtol * 1e12
    assert float((Ak.unpad_vec(rk.cpu()) - Ap.unpad_vec(rp))[free].abs().max()) \
        <= rtol * float(rp.abs().max() / 1e12 + Ap.unpad_vec(rp)[free].abs().max())
    real = torch.zeros_like(rk, dtype=torch.bool)
    real[:, 1 : box.ny + 2, 1 : box.nz + 2] = True
    assert bool((rk[~real] == 0).all())
    assert bool((Ak.bands_p.movedim(1, 0)[:, ~real] == 0).all())
    assert sa.launch_counts() == {"stencil_assembly": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_assembly_deterministic_on_cuda(cuda, dtype):
    """Two launches of each form are equal bit for bit: every band entry
    is one thread's sum in a fixed order, with no atomics."""
    box = StructuredBox(40, 33, 70)
    c3, _, mask_p, pg_p = (t.to(cuda) if torch.is_tensor(t) else t
                           for t in _bc_case(box, dtype))
    a1, a2 = (sa.assemble_stiffness_kernel(box, c3) for _ in range(2))
    (b1, r1), (b2, r2) = (sa.assemble_system(box, c3, mask_p, pg_p, 1e12, 1.0)
                          for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a1.bands, a2.bands)
    assert torch.equal(b1.bands_p, b2.bands_p) and torch.equal(r1, r2)


def test_structured_slice_on_cuda_matches_cpu(cuda):
    """The 16^3 box in f32 through the kernels == the f64 CPU solve: MG,
    flat MG and Jacobi iterations within 1, solutions within 1e-4 of
    max|x|; every stencil kernel count moves."""
    ds.reset_launch_counts()
    sa.reset_launch_counts()
    sk, sc = box_system(16, cuda), box_system(16, "cpu", torch.float64)
    for solve in (solve_mg, solve_mg_flat, solve_jacobi):
        k, c = solve(sk), solve(sc)
        assert abs(k["iterations"] - c["iterations"]) <= 1
        xk, xc = k["x"].cpu(), c["x"]
        assert float((xk - xc).abs().max()) <= 1e-4 * float(xc.abs().max())
        assert k["rel"] <= 1e-8 and true_residual(sk, k) <= 1e-4
    assert all(v > 0 for v in ds.launch_counts().values())
    assert sa.launch_counts()["stencil_assembly"] > 0


def _band_stream():
    """Sorted runs with mixed strides: narrow and wide tiles."""
    rng = np.random.RandomState(5)
    runs, base = [], 0
    for stride, ln in ((3, 20000), (200, 4000), (5, 15000), (90, 5000)):
        r = base + np.cumsum(rng.randint(1, stride + 1, ln))
        runs.append(r)
        base = int(r[-1] // 3)
    return np.concatenate(runs).astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_gather_matches_plain_on_cuda(cuda, dtype):
    """K9a and K9b (B 1, 3, 8; contiguous and channel-minor tables) equal
    their plain twins exactly, and the band pre-gather with its wide tiles
    equals its CPU twin."""
    req = _band_stream()
    g, _ = BandedGather.build(req, device=cuda)
    gc, _ = BandedGather.build(req, device="cpu")
    assert 0 < g.n_narrow < g.n_tiles
    gen = torch.Generator().manual_seed(6)
    bases, lcols = g._narrow()
    band.reset_launch_counts()
    n_t = int(req.max()) + 3
    for B in (1, 3, 8):
        tab = torch.rand((B, n_t), generator=gen, dtype=dtype)
        for minor in (False, True):
            t = tab.to(cuda)
            if minor:
                t = t.T.contiguous().T
            want = band.band_gather_batched_plain(bases, lcols, t, g.K)
            y = band.band_gather_batched(bases, lcols, t, g.K)
            assert torch.equal(y, want)
            # into a channel-minor (n, B) result, as the coordinates are kept
            out = torch.empty((want.shape[1], B), dtype=dtype, device=cuda).T
            assert torch.equal(band.band_gather_batched(bases, lcols, t, g.K, out=out),
                               want)
            assert torch.equal(g.call_batched(t).cpu(), gc.call_batched(tab))
        y1 = band.band_gather(bases, lcols, tab[0].to(cuda), g.K)
        assert torch.equal(y1, band.band_gather_plain(bases, lcols, tab[0].to(cuda), g.K))
        assert torch.equal(g(tab[0].to(cuda)).cpu(), gc(tab[0]))
    assert band.launch_counts() == {"band_gather": 6, "band_gather_batched": 18}


def _narrow_stream():
    """One dense sorted run: every tile narrow, no wide requests."""
    rng = np.random.RandomState(4)
    return np.cumsum(rng.randint(1, 4, 60000)).astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stream", ["mixed", "narrow"])
def test_banded_gather_one_launch_matches_twin_on_cuda(cuda, stream, dtype):
    """A whole band plan, narrow and wide tiles, is one launch of the band
    kernel (B 1, 3, 8; contiguous and channel-minor tables; a table shorter
    than the bands reach) equal to its fused plain twin bit for bit, with
    no K2 or K3a launch."""
    req = _band_stream() if stream == "mixed" else _narrow_stream()
    g, _ = BandedGather.build(req, device=cuda)
    assert (g.wide_cols is None) == (stream == "narrow")
    assert (g.n_narrow < g.n_tiles) == (stream == "mixed")
    nar = g._narrow()
    gen = torch.Generator().manual_seed(9)
    n_t = int(req.max()) + 3
    band.reset_launch_counts()
    _reset()
    for B in (1, 3, 8):
        tab = torch.rand((B, n_t), generator=gen, dtype=dtype).to(cuda)
        for t in (tab, tab.T.contiguous().T):
            want = band.banded_gather_batched_plain(*nar, g.wide_cols, t, g.K)
            assert torch.equal(g.call_batched(t), want)
        x = tab[0]
        assert torch.equal(g(x), band.banded_gather_plain(*nar, g.wide_cols, x, g.K))
        short = x[: n_t // 2]
        assert torch.equal(g(short),
                           band.banded_gather_plain(*nar, g.wide_cols, short, g.K))
    torch.cuda.synchronize()
    assert band.launch_counts() == {"band_gather": 6, "band_gather_batched": 6}
    assert launch_counts() == NO_LAUNCHES


def test_compact_band_route_launches_no_k2_on_cuda(cuda):
    """CompactMatrix with band_pre: each SpMV is one band-kernel launch
    (its plan has wide tiles) and one K1, no K2, and equals the ELL
    product to 1e-5 of each row's sum |a·x| and the CPU compact product."""
    from arcanefem_tpu_torch.sparse.compact import CompactMatrix

    rng = np.random.RandomState(7)
    n, W = 4000, 8
    cols = (np.arange(n)[:, None] * 3 + rng.randint(0, 40, (n, W))) % (3 * n)
    w = rng.rand(n, W).astype(np.float32)
    w[rng.rand(n, W) < 0.3] = 0.0
    A = BellMatrix.from_numpy(w, cols, n_cols=3 * n, device=cuda, dtype=torch.float32)
    cm = CompactMatrix.from_bell(A, band_pre=True)
    assert cm.band and cm.pre.wide_cols is not None
    cc = CompactMatrix.from_bell(BellMatrix.from_numpy(
        w, cols, n_cols=3 * n, device="cpu", dtype=torch.float32), band_pre=True)
    x = torch.rand(3 * n, generator=torch.Generator().manual_seed(3))
    band.reset_launch_counts()
    _reset()
    y = cm.spmv(x.to(cuda))
    torch.cuda.synchronize()
    counts = {**band.launch_counts(), **_counts()}
    assert counts["band_gather"] == 1 and counts["sell_spmv"] == 1
    assert counts["ell_gather_sum"] == 0 and counts["ell_gather_sum_batched"] == 0
    ct = torch.as_tensor(cols.astype(np.int32))
    wt = torch.as_tensor(w)
    scale = ell_spmv_plain(wt.abs(), ct, x.abs()).double()
    for want in (ell_spmv_plain(wt, ct, x), cc.spmv(x)):
        assert bool(((y.cpu().double() - want.double()).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_diag_spmv_matches_plain_on_cuda(cuda, dtype, rtol):
    """K10 == its plain twin on an RCM box (two row blocks, a padded last
    one), error against each row's sum |a·x|."""
    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh
    from arcanefem_tpu_torch.sparse.topology import build_topology
    from arcanefem_tpu_torch.utils.ordering import rcm_order, renumber_mesh

    mesh = box_tetra_mesh(22, 20, 18)
    t = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    mesh = renumber_mesh(mesh, rcm_order(mesh.n_nodes, t.row_ptr, t.csr_cols))
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    gen = torch.Generator().manual_seed(7)
    vals = (torch.rand((topo.n_nodes, topo.width), generator=gen, dtype=dtype) * 2 - 1) \
        * torch.as_tensor(topo.ell_valid)
    x = torch.rand(topo.n_nodes, generator=gen, dtype=dtype) * 2 - 1
    A = DiagEllMatrix(vals.to(cuda), topo.ell_cols)
    dsp.reset_launch_counts()
    y = A.spmv(x.to(cuda))
    torch.cuda.synchronize()
    assert dsp.launch_counts() == {"diag_spmv": 1}
    cols = torch.as_tensor(topo.ell_cols.astype(np.int32))
    scale = ell_spmv_plain(vals.abs(), cols, x.abs()).double()
    want = DiagEllMatrix(vals, topo.ell_cols).spmv(x)
    assert bool(((y.cpu().double() - want.double()).abs() <= rtol * scale).all())
    # the plain twin on the card's inputs, and the public wrapper's full
    # checks in front of the same kernel
    xc = x.to(cuda)
    plan = (A.lo, A.c0, A.scnt, A.lcols, A.vals_tiled)
    twin = dsp.diag_spmv_plain(*plan, xc, topo.width)
    assert bool(((y.double() - twin.double()).abs() <= rtol * scale.to(cuda)).all())
    assert torch.equal(dsp.diag_spmv(*plan, xc, topo.width), y)


@pytest.mark.parametrize("K,G,nb", [(160, 64, 1), (1024, 64, 3), (16, 8, 256)])
def test_window_take_matches_plain_on_cuda(cuda, K, G, nb):
    """P1-P3: both modes of the window take equal their plain twins."""
    pg.reset_launch_counts()
    for mode in ("column", "flat"):
        win, idx = pg._inputs(nb, K, G, mode, cuda)
        assert torch.equal(pg.window_take(win, idx, mode),
                           pg.window_take_plain(win, idx, mode))
    assert pg.probe_A(K, G, cuda) and pg.probe_B(K, G, cuda)
    assert pg.launch_counts() == {"window_take": 4}


@pytest.mark.parametrize("K", [448, 449])
def test_window_take_cutover_on_cuda(cuda, K):
    """The window take at the shared-memory cut-over K = 448 and at 449
    (the L1/L2 path): both modes, one window (chunked), 3 and 140 windows,
    indices out of range on both sides (negative, >= K, >= K·128) and a
    window array that is not 16-byte aligned (a view at offset 1, which
    the shared-memory path does not take), equal to the twin bit for bit."""
    gen = torch.Generator().manual_seed(13)
    pg.reset_launch_counts()
    calls = 0
    for nb, G in ((1, 64), (3, 5), (140, 3)):
        buf = torch.rand(nb * K * 128 + 1, generator=gen).to(cuda)
        for win in (buf[:-1].view(nb, K, 128), buf[1:].view(nb, K, 128)):
            for mode, hi in (("column", K), ("flat", K * 128)):
                idx = torch.randint(-3, hi + 3, (nb, G, 128), generator=gen,
                                    dtype=torch.int32).to(cuda)
                got = pg.window_take(win, idx, mode)
                torch.cuda.synchronize()
                calls += 1
                assert torch.equal(got, pg.window_take_plain(win, idx, mode)), \
                    (nb, G, mode, win.data_ptr() % 16)
    assert pg.launch_counts() == {"window_take": calls}


def test_slice4_routes_on_cuda_match_cpu(cuda):
    """The h=14 compact route (band pre-gathers, compact batched coordinate
    gather) and the RCM diag route in f32 through the kernels: the same
    iterations as the f64 CPU solve (±1), solutions within 1e-4 of max|x|,
    and K9a, K9b and K10 launched."""
    for order, opts in (("sn", dict(spmv="compact", band_pre=True, asm_compact=True,
                                     asm_coords="batched")),
                        ("rcm", dict(spmv="diag"))):
        mesh, topo = sphere_cut_system(14.0, 0, cache=False, order=order)
        band.reset_launch_counts()
        dsp.reset_launch_counts()
        k = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32,
                             penalty=1e12, order=order, **opts)
        counts = {**band.launch_counts(), **dsp.launch_counts()}
        c = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                             penalty=1e30, order=order, **opts)
        assert abs(k["iterations"] - c["iterations"]) <= 1
        xk, xc = k["x"].cpu(), c["x"]
        assert float((xk - xc).abs().max()) <= 1e-4 * float(xc.abs().max())
        assert k["rel"] <= 1e-8 and k["true_residual"] <= 1e-4
        if order == "sn":
            assert counts["band_gather"] > 0 and counts["band_gather_batched"] > 0
        else:
            assert counts["diag_spmv"] > 0


def test_every_k1_operator_launches_sell_on_cuda(cuda):
    """Every operator K1 runs on in the h=14 solve (the CG operator, each
    level, P and P^T, the bf16 copies, the compact route's CG operator and
    compact levels and transfers) launches the SELL kernel once per SpMV,
    each equal to its plain twin (1e-5 of each row's sum |a·x|)."""
    from arcanefem_tpu_torch.solver.amg import with_bf16_vcycle

    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    res = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32, penalty=1e12)
    cm = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32, penalty=1e12,
                          spmv="compact", system=res["system"])
    M = res["system"]["M"]
    Mb = with_bf16_vcycle(M)
    Mc = res["system"][("compact", False)][1]
    ops = [res["A"], *M.mats, *M.P, *M.Pt, *(v for v in Mb.vmats if v is not None),
           *Mb.P, *Mb.Pt, *(o for o in Mc.vmats + Mc.p_apply + Mc.pt_apply
                            if o is not None)]
    gen = torch.Generator().manual_seed(8)
    for op in ops:
        A = getattr(op, "op", op)  # a CompactMatrix's SELL operator
        x = (torch.rand(A.layout.n_cols, generator=gen) * 2 - 1).to(cuda)
        _reset()
        y = A.spmv(x)
        torch.cuda.synchronize()
        bf16 = A.values.dtype == torch.bfloat16
        assert _counts() == {**NO_LAUNCHES, **NO_SELL,
                             "sell_spmv_bf16" if bf16 else "sell_spmv": 1}
        scale = sell_spmv_plain(A.values.abs(), A.layout, x.abs())
        want = sell_spmv_plain(A.values, A.layout, x)
        assert bool(((y - want).abs() <= 1e-5 * scale).all())
    assert cm["iterations"] == res["iterations"]


def test_sell_spmv_float64_rounds_each_product_on_cuda(cuda):
    """K1 in float64 rounds each product as its plain twin does: on 1e30
    penalty rows with x at their Dirichlet values, b − A x is exactly 0 on
    every penalty row (b = fl(P·g)), as on the CPU, not one ulp of 1e30·g
    where a fused multiply-add rounded
    P·g + the row's other terms once (which made GMRES, whose monitored
    norm is that residual, stop after one step).  The batched kernel's
    tables agree with it bit for bit."""
    from arcanefem_tpu_torch.fem.problem import FemProblem
    from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh

    mesh = rect_tria_mesh(96, 96)
    prob = FemProblem(mesh, device=cuda)
    system = prob.new_system(prob.stiffness_matrix())
    nodes = mesh.group_nodes("left")
    g = mesh.coords[nodes, 1] - 0.1 * mesh.coords[nodes, 0] + 0.37
    prob.apply_dirichlet(system, prob.dof_ids(nodes), g, "Penalty", 1e30)
    A, b = system.finalized()
    x0 = system.initial_guess()
    y = sell.sell_spmv(A.values, A.layout, x0)
    yp = sell.sell_spmv_plain(A.values, A.layout, x0)
    torch.cuda.synchronize()
    assert float((y - yp).abs().max()) <= 1e-15 * float(yp.abs().max())
    pen = torch.as_tensor(prob.dof_ids(nodes), device=cuda)
    assert bool(((b - y)[pen] == 0).all())
    gen = torch.Generator().manual_seed(5)
    T = (torch.rand((4, mesh.n_nodes), generator=gen, dtype=torch.float64) * 2 - 1).to(cuda)
    Y = sell_spmv_batched(A.values, A.layout, T)
    for k in range(4):
        assert torch.equal(Y[k], sell.sell_spmv(A.values, A.layout, T[k]))
