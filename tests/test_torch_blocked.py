"""The blocked scalar SpMV (arcanefem_tpu_torch/sparse/blocked.py, BSR-b)
against the JAX package's BlockedGather, on the CPU: the port's plain twin
against ``BlockedGather.build_csr(...).emulate(x)`` (the numpy emulation
of the TPU plan) and scipy, on the shapes of tests/test_blocked.py (the
RCM-ordered rect's CSR, b in 2 and 4, and the rectangular 4:1 column
fold), and with bfloat16 blocks.  The kernel's card cases are in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arcanefem_tpu.sparse.blocked import BlockedGather as JaxBlockedGather
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.sparse import blocked as blk
from arcanefem_tpu_torch.sparse.blocked import BlockedGather
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
    # the stored blocks: every nonzero once, the rest exact zeros
    assert g.fill >= 1.0 and g.b == b
    dense = np.zeros((-(-n // b) * b, -(-n // b) * b), np.float32)
    brow = np.repeat(np.arange(g.bptr.numel() - 1), np.diff(g.bptr.numpy()))
    for e, (I, J) in enumerate(zip(brow, g.bcol.numpy())):
        dense[I * b:(I + 1) * b, J * b:(J + 1) * b] = g.blocks[e].numpy()
    assert np.array_equal(dense[:n, :n], A.toarray())
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
    assert gb.blocks.dtype == torch.bfloat16 and gb.nbytes * 2 == g.nbytes
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
