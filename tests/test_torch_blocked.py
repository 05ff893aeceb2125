"""The blocked scalar SpMV (arcanefem_tpu_torch/sparse/blocked.py, BSR-b)
against the JAX package's BlockedGather, on the CPU: the port's plain twin
against ``BlockedGather.build_csr(...).emulate(x)`` (the numpy emulation
of the TPU plan) and scipy, on the shapes of tests/test_blocked.py (the
RCM-ordered rect's CSR, b in 2 and 4, and the rectangular 4:1 column
fold), and with bfloat16 blocks; at b = 2 also the slices the kernel
reads (``BlockSlices``: their invariants, and their twin against the BSR
twin, JAX and scipy, at σ = 1 and σ = 1024, with an odd n_rows and n_cols
and an empty band of block rows).  The kernel's card cases are in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arcanefem_tpu.sparse.blocked import BlockedGather as JaxBlockedGather
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.sparse import blocked as blk
from arcanefem_tpu_torch.sparse.blocked import BlockedGather, BlockSlices
from arcanefem_tpu_torch.sparse.sell import SIGMA, choose_sigma
from arcanefem_tpu_torch.sparse.topology import build_topology
from arcanefem_tpu_torch.utils.ordering import rcm_order, renumber_mesh


def _csr(n=72, seed=0):
    """RCM-ordered FEM-graph CSR with random values, as tests/test_blocked.py."""
    mesh = rect_tria_mesh(n, n)
    t0 = build_topology(mesh.n_nodes, mesh.cells)
    mesh = renumber_mesh(mesh, rcm_order(mesh.n_nodes, t0.row_ptr, t0.csr_cols))
    t = build_topology(mesh.n_nodes, mesh.cells)
    data = np.random.RandomState(seed).randn(len(t.csr_cols)).astype(np.float32)
    return t.csr_cols, t.row_ptr, data, mesh.n_nodes


def _hold(g, jg, A, x):
    """The port's f32 product against JAX's emulation (f64 sums of the f32
    products) and scipy's f64 product."""
    y = g(torch.as_tensor(x)).numpy()
    assert y.dtype == np.float32 and y.shape == (A.shape[0],)
    exact = A @ x.astype(np.float64)
    scale = abs(A) @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(y - jg.emulate(x)) <= 1e-6 * scale + 1e-30)
    assert np.all(np.abs(y - exact) <= 1e-6 * scale + 1e-30)


@pytest.mark.parametrize("b", [2, 4])
def test_blocked_matches_jax_emulation_and_scipy(b):
    cols, indptr, data, n = _csr()
    g = BlockedGather.build_csr(cols, indptr, data, n, b=b, device="cpu")
    jg = JaxBlockedGather.build_csr(cols, indptr, data, n, b=b)
    A = sp.csr_matrix((data, cols, indptr), shape=(n, n))
    x = np.random.RandomState(1).randn(n).astype(np.float32)
    _hold(g, jg, A, x)
    # the blocks it is built from: every nonzero once, the rest exact zeros
    blocks, bcol, bptr, n_cols = blk.csr_to_bsr(cols, indptr, data, n, b=b, device="cpu")
    assert n_cols == n and g.n_blocks == blocks.shape[0] and g.b == b
    assert g.fill == blocks.shape[0] * b * b / len(cols) >= 1.0
    dense = np.zeros((-(-n // b) * b, -(-n // b) * b), np.float32)
    brow = np.repeat(np.arange(bptr.numel() - 1), np.diff(bptr.numpy()))
    for e, (I, J) in enumerate(zip(brow, bcol.numpy())):
        dense[I * b:(I + 1) * b, J * b:(J + 1) * b] = blocks[e].numpy()
    assert np.array_equal(dense[:n, :n], A.toarray())
    # b = 4 holds the BSR arrays, b = 2 only their slices
    assert (g.blocks is None) == (g.slices is not None) == (b == 2)
    blk.reset_launch_counts()
    g(torch.as_tensor(x))
    assert blk.launch_counts() == {"bsr_spmv": 0, "bsr_spmv_bf16": 0}  # the CPU twin


def test_blocked_rectangular():
    """Coarse-side blocking on a rectangular (prolongator-like) map."""
    cols, indptr, data, n = _csr()
    A = sp.csr_matrix((data, cols // 4, indptr), shape=(n, n // 4 + 1))
    A.sum_duplicates()
    g = BlockedGather.build_csr(A.indices, A.indptr, A.data, A.shape[1], b=2,
                                device="cpu")
    jg = JaxBlockedGather.build_csr(A.indices, A.indptr, A.data, A.shape[1], b=2)
    x = np.random.RandomState(2).randn(A.shape[1]).astype(np.float32)
    _hold(g, jg, A, x)
    with pytest.raises(ValueError, match="x must be"):
        g(torch.zeros(n))


@pytest.mark.parametrize("b", [2, 4])
def test_blocked_bf16_weights_and_f64(b):
    """with_weights_dtype(bfloat16): blocks rounded to bf16 and x rounded to
    bf16, the exact products summed in f64 (the JAX class casts its block
    values the same way); float64 blocks give scipy's product to 1e-14."""
    cols, indptr, data, n = _csr(40)
    g = BlockedGather.build_csr(cols, indptr, data, n, b=b, device="cpu")
    gb = g.with_weights_dtype(torch.bfloat16)
    assert gb.dtype == torch.bfloat16 and gb.nbytes * 2 == g.nbytes
    x = np.random.RandomState(3).randn(n).astype(np.float32)
    xb = torch.as_tensor(x).to(torch.bfloat16).double().numpy()
    vb = torch.as_tensor(data).to(torch.bfloat16).double().numpy()
    Ab = sp.csr_matrix((vb, cols, indptr), shape=(n, n))
    y = gb(torch.as_tensor(x)).numpy()
    scale = abs(Ab) @ np.abs(xb)
    assert np.all(np.abs(y - Ab @ xb) <= 1e-6 * scale + 1e-30)
    g64 = BlockedGather.build_csr(cols, indptr, data.astype(np.float64), n, b=b,
                                  device="cpu", dtype=torch.float64)
    x64 = x.astype(np.float64)
    A = sp.csr_matrix((data.astype(np.float64), cols, indptr), shape=(n, n))
    y64 = g64(torch.as_tensor(x64)).numpy()
    assert y64.dtype == np.float64
    assert np.abs(y64 - A @ x64).max() <= 1e-14 * (abs(A) @ np.abs(x64)).max()


def test_blocked_build_raises():
    cols, indptr, data, n = _csr(12)
    with pytest.raises(ValueError, match="b must be"):
        BlockedGather.build_csr(cols, indptr, data, n, b=8, device="cpu")
    with pytest.raises(ValueError, match="column outside"):
        BlockedGather.build_csr(cols, indptr, data, n - 5, b=2, device="cpu")
    blocks, bcol, bptr, _ = blk.csr_to_bsr(cols, indptr, data, n, b=2, device="cpu")
    with pytest.raises(ValueError, match="bptr"):
        BlockedGather(blocks, bcol, bptr[:-1], n, n, len(cols))


def _slice_case(case):
    """A scipy CSR (float32 values) for the slice tests: the RCM rect
    (5329 rows, odd), its 4:1 column fold, or a random 1001 x 777 CSR whose
    rows 200-329 (block rows 100-164, a whole slice of them) are empty."""
    if case == "odd_band":
        A = sp.random(1001, 777, density=0.01, random_state=np.random.RandomState(7),
                      format="lil", dtype=np.float32)
        A[200:330] = 0
        return A.tocsr()
    cols, indptr, data, n = _csr()
    if case == "rcm_rect":
        return sp.csr_matrix((data, cols, indptr), shape=(n, n))
    A = sp.csr_matrix((data, cols // 4, indptr), shape=(n, n // 4 + 1))
    A.sum_duplicates()
    return A


def _sliced(A, sigma, dtype=torch.float32):
    """The b = 2 operator of A, its slices built at ``sigma`` in place of
    ``choose_sigma``'s, and A's BSR-2 arrays (blocks, bcol, bptr) of the
    operator's dtype."""
    blocks, bcol, bptr, n_cols = blk.csr_to_bsr(
        A.indices, A.indptr, A.data.astype(np.float64), A.shape[1], b=2, device="cpu",
        dtype=torch.float32 if dtype == torch.bfloat16 else dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blk, "choose_sigma", lambda lens, slot_bytes: sigma)
        g = BlockedGather(blocks, bcol, bptr, A.shape[0], n_cols, A.nnz)
    if dtype == torch.bfloat16:
        g, blocks = g.with_weights_dtype(torch.bfloat16), blocks.to(torch.bfloat16)
    return g, blocks, bcol, bptr


@pytest.mark.parametrize("sigma", [1, SIGMA])
@pytest.mark.parametrize("case", ["rcm_rect", "fold4", "odd_band"])
def test_block_slices_invariants(case, sigma):
    """Every stored block in exactly one slot, with its column; padding
    slots zero with an in-range column (their block row's last); the
    permutation a bijection that sorts each σ window by block count; each
    slice as wide as its longest block row; the default σ by K1's rule at
    20 bytes per slot."""
    A = _slice_case(case)
    g, blocks, bcol, bptr = _sliced(A, sigma)
    sl, nb = g.slices, bptr.numel() - 1
    bptr = bptr.numpy().astype(np.int64)
    lens = np.diff(bptr)
    perm = np.arange(nb) if sl.perm is None else sl.perm.numpy()
    assert (sl.perm is None) == (sigma == 1)
    assert np.array_equal(np.sort(perm), np.arange(nb))
    for w in range(0, nb, sigma):
        assert np.all(np.diff(lens[perm[w:w + sigma]]) <= 0)
    sptr, width = sl.slice_ptr.numpy(), sl.slice_width
    assert len(width) == -(-nb // 32) and np.array_equal(np.diff(sptr), width * 32)
    plens = np.zeros(len(width) * 32, np.int64)
    plens[:nb] = lens[perm]
    assert np.array_equal(width, plens.reshape(-1, 32).max(axis=1))
    q = np.arange(sl.n_slots)
    s = np.repeat(np.arange(len(width)), width * 32)
    pos, k = s * 32 + (q - sptr[s]) % 32, (q - sptr[s]) // 32
    rows = sl.slot_rows().numpy()
    assert np.array_equal(rows, np.where(pos < nb, perm[np.minimum(pos, nb - 1)], nb))
    real = (rows < nb) & (k < lens[np.minimum(rows, nb - 1)])
    e = bptr[rows[real]] + k[real]
    assert np.array_equal(np.sort(e), np.arange(bcol.numel()))
    assert torch.equal(sl.blocks[torch.as_tensor(real)], blocks[torch.as_tensor(e)])
    cols = sl.cols.numpy()
    assert np.array_equal(cols[real], bcol.numpy()[e])
    assert not sl.blocks[torch.as_tensor(~real)].any()
    assert cols.min() >= 0 and cols.max() < -(-A.shape[1] // 2)
    pad = ~real & (rows < nb)
    pr = rows[pad]
    want = np.where(lens[pr] > 0, bcol.numpy()[np.maximum(bptr[pr + 1] - 1, 0)], 0)
    assert np.array_equal(cols[pad], want)
    assert g.slots_per_block == sl.n_slots / bcol.numel() >= 1.0
    assert BlockSlices.build(blocks, bcol, torch.as_tensor(bptr, dtype=torch.int32)).sigma \
        == choose_sigma(lens, 20)


@pytest.mark.parametrize("sigma", [1, SIGMA])
@pytest.mark.parametrize("case", ["rcm_rect", "fold4", "odd_band"])
def test_block_slices_product_f32(case, sigma):
    """The b = 2 twin on the slices == the BSR twin, JAX's emulation and
    scipy to 1e-6 of each row's sum |a·x| (``_hold``); one CPU call
    launches nothing."""
    A = _slice_case(case)
    g, blocks, bcol, bptr = _sliced(A, sigma)
    jg = JaxBlockedGather.build_csr(A.indices, A.indptr, A.data, A.shape[1], b=2)
    x = np.random.RandomState(4).randn(A.shape[1]).astype(np.float32)
    _hold(g, jg, A, x)
    xt = torch.as_tensor(x)
    y = g(xt).double()
    want = blk.bsr_spmv_plain(blocks, bcol, bptr, xt, g.n_rows).double()
    scale = blk.bsr_spmv_plain(blocks.abs(), bcol, bptr, xt.abs(), g.n_rows).double()
    assert bool(((y - want).abs() <= 1e-6 * scale).all())
    blk.reset_launch_counts()
    g(xt)
    assert blk.launch_counts() == {"bsr_spmv": 0, "bsr_spmv_bf16": 0}


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", ["rcm_rect", "fold4", "odd_band"])
def test_block_slices_product_f64_bf16(case, dtype):
    """float64 blocks and x: scipy's f64 product and the BSR twin to 1e-12
    of each row's sum |a·x|; bfloat16 blocks with float32 x rounded to
    bfloat16: the f64 product of the rounded values and the BSR twin to
    1e-6."""
    A = _slice_case(case)
    g, blocks, bcol, bptr = _sliced(A, SIGMA, dtype)
    rng = np.random.RandomState(5)
    x = rng.randn(A.shape[1])
    if dtype == torch.bfloat16:
        x = x.astype(np.float32)
        xr = torch.as_tensor(x).to(torch.bfloat16).double().numpy()
        vals = torch.as_tensor(A.data).to(torch.bfloat16).double().numpy()
        rtol = 1e-6
    else:
        xr, vals, rtol = x, A.data.astype(np.float64), 1e-12
    Ar = sp.csr_matrix((vals, A.indices, A.indptr), shape=A.shape)
    xt = torch.as_tensor(x)
    y = g(xt)
    assert y.dtype == xt.dtype and y.shape == (A.shape[0],)
    y = y.double().numpy()
    scale = abs(Ar) @ np.abs(xr)
    assert np.all(np.abs(y - Ar @ xr) <= rtol * scale + 1e-300)
    want = blk.bsr_spmv_plain(blocks, bcol, bptr, xt, g.n_rows).double().numpy()
    assert np.all(np.abs(y - want) <= rtol * scale + 1e-300)
