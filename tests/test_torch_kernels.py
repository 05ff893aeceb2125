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
    ell_spmv_batched,
    ell_spmv_batched_plain,
    ell_spmv_plain,
    launch_counts,
    reset_launch_counts,
)
from arcanefem_tpu_torch.sparse.sell import SellLayout, sell_spmv, sell_spmv_plain
from arcanefem_tpu_torch.sparse import band_gather as band
from arcanefem_tpu_torch.sparse import diag_spmv as dsp
from arcanefem_tpu_torch.sparse.band_gather import BandedGather
from arcanefem_tpu_torch.sparse.diag_spmv import DiagEllMatrix
from arcanefem_tpu_torch.sparse.supernode import SupernodeSpmv
from arcanefem_tpu_torch.tools import probe_gather as pg

NO_LAUNCHES = {"ell_gather_sum": 0, "ell_spmv_batched": 0,
               "ell_gather_sum_batched": 0}
NO_SELL = {"sell_spmv": 0, "sell_spmv_bf16": 0}


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
    # bf16 weights go with float32 x only, and not in the batched form
    with pytest.raises(TypeError):
        sell_spmv(torch.zeros(lay.n_slots, dtype=torch.bfloat16), lay,
                  x.double())
    with pytest.raises(TypeError):
        ell_spmv_batched(torch.zeros(4, 2, dtype=torch.bfloat16), cols,
                         torch.zeros(2, 4))
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
    assert ell_spmv_batched(vals, cols.clamp(min=0), t.T.contiguous().T).tolist() \
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
    """K3b and K3a == their plain twins on the card, for B in 1, 3, 8 and
    W in 1, 8, 25, 136 with padding, tables and results contiguous or
    channel-minor (strided); error against each row's sum |v·x|."""
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
        cols, vals, ucols = (t.to(cuda) for t in (cols, vals, ucols))
        for B in (1, 3, 8):
            tab = torch.rand((B, n), generator=gen, dtype=dtype) * 2 - 1
            for minor in (False, True):
                t = tab.to(cuda)
                if minor:
                    t = t.T.contiguous().T
                out = (torch.empty((n, B), dtype=dtype, device=cuda).T
                       if minor else None)
                y = ell_spmv_batched(vals, cols, t, out=out)
                u = ell_gather_sum_batched(ucols, t)
                torch.cuda.synchronize()
                launches += 1
                scale = ell_spmv_batched_plain(vals.abs(), cols, t.abs())
                uscale = ell_gather_sum_batched_plain(ucols, t.abs())
                assert bool(((y - ell_spmv_batched_plain(vals, cols, t)).abs()
                             <= rtol * scale).all()), (W, B, minor)
                assert bool(((u - ell_gather_sum_batched_plain(ucols, t)).abs()
                             <= rtol * uscale).all()), (W, B, minor)
    assert _counts() == {**NO_LAUNCHES, **NO_SELL, "ell_spmv_batched": launches,
                         "ell_gather_sum_batched": launches}


def test_bf16_spmv_matches_plain_on_cuda(cuda):
    """K1 with bf16 weights and f32 x == its twin (1e-5 of sum |v·x|)."""
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
    assert _counts() == {**NO_LAUNCHES, **NO_SELL, "sell_spmv_bf16": 3}


def test_supernode_spmv_on_cuda_matches_cpu(cuda):
    """The supernode SpMV of the h=14 operator through K3a on the card ==
    its CPU twin (f32 blocks, f64 row reduce: 1e-5 of each row's sum
    |a·x|), and the f64 operator to 1e-12; bf16 blocks too."""
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
        # bf16 blocks sum their products in f32 whatever x's dtype
        for a, b, tol in ((cpu, dev, rtol), (cpu.as_bf16(), dev.as_bf16(), 1e-5)):
            reset_launch_counts()
            y = b(x.to(dtype).to(cuda)).cpu()
            assert launch_counts()["ell_gather_sum_batched"] == 2
            want = a(x.to(dtype))
            assert bool(((y.double() - want.double()).abs() <= tol * scale).all())
        assert bool(((y.double() - A.spmv(x)).abs() <= 2e-2 * scale.max()).all())


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
    assert counts["tet_element"] == counts["slot_reduce"] == 1
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
    assert la.launch_counts() == {"tet_element": 3}
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
    card and on the CPU; padding slots exactly 0."""
    _, _, asm, _ = _sphere_assembler(cuda)
    gen = torch.Generator().manual_seed(9)
    table = torch.rand(10 * asm.n_cells, generator=gen, dtype=torch.float64).to(dtype) - 0.5
    sr.reset_launch_counts()
    y = sr.slot_reduce(asm.ptr, asm.ids, table.to(cuda))
    torch.cuda.synchronize()
    assert sr.launch_counts() == {"slot_reduce": 1} and y.dtype == dtype
    assert torch.equal(y, sr.slot_reduce_plain(asm.ptr, asm.ids, table.to(cuda)))
    assert torch.equal(y.cpu(), sr.slot_reduce(asm.ptr.cpu(), asm.ids.cpu(), table))
    assert not y[torch.as_tensor(~asm.layout.real, device=cuda)].any()


def test_tet_assembly_deterministic_on_cuda(cuda):
    """Two assemblies on each route are bit-equal, and equal across the
    four routes; the default route launches the two assembly kernels and
    no K2, and its contributor lists equal the CPU build's."""
    mesh, topo, asm, coords = _sphere_assembler(cuda)
    cpu = TetraAssembler(topo, mesh.cells["tetra4"], device="cpu")
    assert torch.equal(asm.ptr.cpu(), cpu.ptr) and torch.equal(asm.ids.cpu(), cpu.ids)
    _reset()
    la.reset_launch_counts()
    sr.reset_launch_counts()
    ref = asm(coords)
    torch.cuda.synchronize()
    assert _counts() == {**NO_LAUNCHES, **NO_SELL}
    assert la.launch_counts() == {"tet_element": 1} and sr.launch_counts() == {"slot_reduce": 1}
    for kw in ({}, dict(coords_batched=True), dict(coords_compact=True),
               dict(coords_compact=True, coords_batched=True, band_pre=True)):
        other = TetraAssembler(topo, mesh.cells["tetra4"], device=cuda,
                               layout=asm.layout, **kw)
        assert torch.equal(other(coords), ref) and torch.equal(other(coords), ref), kw


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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("dims", [(6, 5, 4), (17, 9, 130)])
def test_stencil_assembly_matches_plain_on_cuda(cuda, dtype, rtol, dims):
    """Stiffness-only and fused assembly == their plain twins to rtol of the
    largest band entry; the fused form's pads exactly 0."""
    box = StructuredBox(*dims)
    c3 = torch.as_tensor(box.grid_coords(np.float64, jitter=0.1)).to(dtype)
    mask = box.boundary_mask(("xmin", "xmax"))
    g = np.where(box.boundary_mask(("xmax",)), 1.0, 0.0)
    mask_p = torch.as_tensor(ds.pad_host_vec(box, mask, np.float64)).to(dtype)
    pg_p = torch.as_tensor(ds.pad_host_vec(box, 1e12 * g * mask, np.float64)).to(dtype)
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
