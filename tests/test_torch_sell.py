"""SELL-32-σ storage and K1's plain twin (arcanefem_tpu_torch/sparse/sell.py,
sparse/bell.py) against the JAX package on the CPU, in f64: every operator
K1 runs on in the AMG-PCG solve (the CG operator, each level, P and P^T,
the bf16 copies, the compact remap), the assembly into SELL slots, the
diagonal, and random row-length structures.  The CUDA kernel is held to
this twin in tests/test_torch_kernels.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu_torch.bench_unstructured import dirichlet_data, sphere_cut_system
from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
from arcanefem_tpu_torch.solver.amg import amg_from_numpy, with_bf16_vcycle
from arcanefem_tpu_torch.sparse.bell import BellMatrix, assemble_bell, fine_layout
from arcanefem_tpu_torch.sparse.compact import CompactMatrix
from arcanefem_tpu_torch.sparse.ell_gather import ell_spmv_plain
from arcanefem_tpu_torch.sparse.sell import (
    C,
    SIGMA,
    SellLayout,
    choose_sigma,
    launch_counts,
    reset_launch_counts,
    sell_spmv,
    sell_spmv_plain,
    stored_slots,
)

PENALTY = 1e30


def _as_numpy(M) -> dict:
    """The JAX hierarchy as the dict amg_from_numpy takes."""
    return {
        "mats": [(np.asarray(m.values).reshape(m.topo.n_nodes, m.topo.width),
                  np.asarray(m.cols)) for m in M.mats],
        **{k: [np.asarray(a) for a in getattr(M, k)]
           for k in ("inv_diags", "pcols", "pvals", "ptcols", "ptvals")},
        "coarse_inv": np.asarray(M.coarse_inv),
        "omegas": M.omegas, "rhos": M.rhos, "smoother": M.smoother,
        "cheb_deg": M.cheb_deg, "nu": M.nu, "cycle": M.cycle,
    }


@pytest.fixture(scope="module", params=[14.0, 8.0])
def bench(request):
    """The JAX bench operator at sphere_cut h (f64, penalty rows), its
    host values and its JAX AMG hierarchy."""
    mesh, topo = sphere_cut_system(request.param, 0, cache=False)
    vals = TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(mesh.coords.astype(np.float32)))
    mask, _, _ = dirichlet_data(mesh, PENALTY)
    flat = np.asarray(vals, np.float64).reshape(-1)
    flat[topo.diag_slot[mask]] = PENALTY
    A = JaxBell(values=jnp.asarray(flat.reshape(topo.n_nodes, topo.width, 1, 1)),
                topo=topo, block=1, cols=jnp.asarray(topo.ell_cols))
    M = build_amg(A, smoother="chebyshev", cheb_deg=2, theta=0.03, values_np=flat)
    return mesh, topo, A, flat, M


def _hold(got, want, absvals, cols, x, tol):
    """|got - want| <= tol · Σ|a·x| of each row."""
    scale = (np.abs(absvals) * np.abs(x)[cols]).sum(axis=1)
    assert np.all(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                  <= tol * scale + 1e-300)


def test_sell_twin_matches_jax_operators(bench):
    """The SELL twin == the JAX package to 1e-12 of each row's Σ|a·x| on
    the CG operator (the fine layout: ell_valid), every AMG level, P and
    P^T (wide rows); the compact remap equals the CG operator exactly."""
    _, topo, A, flat, M = bench
    rng = np.random.RandomState(0)
    n, W = topo.n_nodes, topo.width
    lay = fine_layout(topo, "cpu")
    assert lay.nnz == int(topo.ell_valid.sum()) and lay.n_slots % C == 0
    Ap = BellMatrix(lay.from_ell(flat.reshape(n, W)), lay)
    x = rng.rand(n) - 0.5
    y = Ap.spmv(torch.as_tensor(x)).numpy()
    _hold(y, A.spmv(jnp.asarray(x)), flat.reshape(n, W), topo.ell_cols, x, 1e-12)
    for band_pre in (False, True):
        cm = CompactMatrix.from_bell(Ap, band_pre=band_pre, real=topo.ell_valid)
        assert cm.op.layout.slice_ptr is lay.slice_ptr
        assert np.array_equal(cm.spmv(torch.as_tensor(x)).numpy(), y)
    P = amg_from_numpy(_as_numpy(M), "cpu", torch.float64)
    for l, m in enumerate(M.mats):
        xl = rng.rand(m.topo.n_nodes) - 0.5
        vl = np.asarray(m.values).reshape(m.topo.n_nodes, -1)
        _hold(P.mats[l].spmv(torch.as_tensor(xl)).numpy(), m.spmv(jnp.asarray(xl)),
              vl, np.asarray(m.cols), xl, 1e-12)
    for l in range(len(M.pvals)):
        xc = rng.rand(P.P[l].layout.n_cols) - 0.5
        _hold(P.P[l].spmv(torch.as_tensor(xc)).numpy(), M._transfer_up(l, jnp.asarray(xc)),
              np.asarray(M.pvals[l]), np.asarray(M.pcols[l]), xc, 1e-12)
        r = rng.rand(P.Pt[l].layout.n_cols) - 0.5
        _hold(P.Pt[l].spmv(torch.as_tensor(r)).numpy(), M._transfer_down(l, jnp.asarray(r)),
              np.asarray(M.ptvals[l]), np.asarray(M.ptcols[l]), r, 1e-12)
    assert max(p.layout.width for p in P.Pt) > 2 * W  # the wide rows of P^T


def test_bf16_copies_match_rounded_jax(bench):
    """with_bf16_vcycle's copies keep their operator's SELL layout; their
    f32 twin == the JAX f32 product on bf16-rounded values, to f32
    round-off (1e-5 of each row's Σ|a·x|)."""
    _, _, _, _, M = bench
    P = amg_from_numpy(_as_numpy(M), "cpu", torch.float32)
    Pb = with_bf16_vcycle(P)
    rng = np.random.RandomState(1)

    def rounded(v):
        return np.asarray(v, np.float32).astype(jnp.bfloat16).astype(np.float32)

    pairs = [(Pb.vmats[l], np.asarray(m.values).reshape(m.topo.n_nodes, -1),
              np.asarray(m.cols)) for l, m in enumerate(M.mats) if Pb.vmats[l] is not None]
    pairs += [(Pb.P[l], np.asarray(M.pvals[l]), np.asarray(M.pcols[l]))
              for l in range(len(M.pvals)) if Pb.P[l].values.dtype == torch.bfloat16]
    pairs += [(Pb.Pt[l], np.asarray(M.ptvals[l]), np.asarray(M.ptcols[l]))
              for l in range(len(M.ptvals)) if Pb.Pt[l].values.dtype == torch.bfloat16]
    assert len(pairs) >= 3
    for op, vals, cols in pairs:
        assert op.values.dtype == torch.bfloat16
        x = (rng.rand(op.layout.n_cols) - 0.5).astype(np.float32)
        rv = rounded(vals)
        want = np.asarray(jnp.einsum("nw,nw->n", jnp.asarray(rv), jnp.asarray(x)[cols]))
        got = op.spmv(torch.as_tensor(x))
        assert got.dtype == torch.float32
        _hold(got.numpy(), want, rv, cols, x, 1e-5)


def test_assembly_into_sell_equals_gathered_ell():
    """Assembly through the remapped slot maps (assemble_bell,
    TetraAssembler) == the (N, W) assembly gathered into SELL, bit for bit
    on the CPU; every dropped slot of the (N, W) assembly is zero."""
    mesh, topo = sphere_cut_system(8.0, 0, cache=False)
    nc = mesh.cells["tetra4"].shape[0]
    ke = torch.as_tensor(np.random.RandomState(2).rand(nc, 4, 4))
    A = assemble_bell(topo, {"tetra4": ke}, device="cpu")
    ell = torch.zeros(topo.n_nodes * topo.width, dtype=ke.dtype)
    ell.index_add_(0, torch.as_tensor(np.asarray(topo.slot_maps["tetra4"],
                                                 np.int64).reshape(-1)), ke.reshape(-1))
    ell = ell.reshape(topo.n_nodes, topo.width)
    assert torch.equal(A.values, A.layout.from_ell(ell))
    assert torch.equal(A.ell_values(), ell)
    # the element assembly: the same index_add_ order through either map
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device="cpu")
    coords = torch.as_tensor(mesh.coords.astype(np.float32))
    got = asm(coords)
    assert got.shape == (asm.layout.n_slots,)
    ref = asm.layout.to_ell(got)
    assert torch.equal(asm.layout.from_ell(ref), got)
    assert not ref[torch.as_tensor(~topo.ell_valid)].any()


@pytest.mark.parametrize("sigma", [1, 32, SIGMA])
def test_diagonal_unchanged(sigma):
    """diagonal() reads the same values as the (N, W) diag_slot, at every
    σ, for from_numpy (which keeps a zero diagonal) and for assemble_bell."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    rng = np.random.RandomState(3)
    vals = np.where(topo.ell_valid, rng.rand(topo.n_nodes, topo.width) - 0.5, 0.0)
    vals.reshape(-1)[topo.diag_slot[::5]] = 0.0
    want = vals.reshape(-1)[topo.diag_slot]
    lay = SellLayout.build(topo.ell_cols, topo.ell_valid, device="cpu", sigma=sigma)
    assert lay.sigma == sigma
    A = BellMatrix(lay.from_ell(vals), lay,
                   torch.as_tensor(lay.ell_to_sell[topo.diag_slot]))
    np.testing.assert_array_equal(A.diagonal().numpy(), want)
    np.testing.assert_array_equal(A.ell_values().numpy(), vals)
    F = BellMatrix.from_numpy(vals, topo.ell_cols, topo.diag_slot, device="cpu",
                              dtype=torch.float64)
    assert (F.layout.ell_to_sell[topo.diag_slot] >= 0).all()
    np.testing.assert_array_equal(F.diagonal().numpy(), want)
    nc = mesh.cells["tetra4"].shape[0]
    B = assemble_bell(topo, {"tetra4": torch.as_tensor(rng.rand(nc, 4, 4))}, device="cpu")
    np.testing.assert_array_equal(
        B.diagonal().numpy(), B.ell_values().numpy().reshape(-1)[topo.diag_slot])


def test_sigma_choice_and_counts():
    """σ = 1 where sorting saves little; SIGMA where it saves more slot
    bytes than the permutation costs; stored slots as counted."""
    even = np.full(4096, 7)
    assert stored_slots(even, 1) == 4096 * 7 and choose_sigma(even) == 1
    mixed = np.tile(np.r_[np.full(31, 2), 40], 128)  # one long row per slice
    assert stored_slots(mixed, 1) == 128 * 32 * 40
    assert stored_slots(mixed, SIGMA) < stored_slots(mixed, 1) // 4
    assert choose_sigma(mixed) == SIGMA
    reset_launch_counts()
    lay = SellLayout.build(np.zeros((5, 2), np.int64), np.ones((5, 2), bool),
                           device="cpu")
    y = sell_spmv(torch.ones(lay.n_slots), lay, torch.full((5,), 2.0))
    assert y.tolist() == [4.0] * 5
    assert launch_counts() == {"sell_spmv": 0, "sell_spmv_bf16": 0,
                               "sell_spmv_batched": 0}


@st.composite
def _structures(draw):
    n = draw(st.integers(1, 300))
    W = draw(st.sampled_from([1, 3, 25, 136]))
    n_cols = draw(st.integers(1, 400))
    seed = draw(st.integers(0, 2**31 - 1))
    sigma = draw(st.sampled_from([1, 32, SIGMA]))
    holes = draw(st.booleans())
    return n, W, n_cols, seed, sigma, holes


@settings(max_examples=50, deadline=2000)
@given(_structures())
def test_random_structures_match_definition(case):
    """Random row lengths (empty rows, n not a multiple of 32, W 1 and
    136, real slots with holes or as a prefix), σ in {1, 32, 1024}: the
    twin == ell_spmv_plain of the masked (n, W) pair to 1e-12 of Σ|a·x|;
    from_ell/to_ell round-trip; ell_to_sell is one-to-one onto the real
    slots; the remapped layout gives the same product."""
    n, W, n_cols, seed, sigma, holes = case
    rng = np.random.RandomState(seed)
    cols = rng.randint(0, n_cols, (n, W))
    lens = rng.randint(0, W + 1, n)
    lens[rng.rand(n) < 0.1] = 0
    real = np.arange(W)[None, :] < lens[:, None]
    if holes:
        real = rng.rand(n, W) < 0.6
    vals = np.where(real, rng.rand(n, W) - 0.5, 0.0)
    x = rng.rand(n_cols) - 0.5
    lay = SellLayout.build(cols, real, device="cpu", n_cols=n_cols, sigma=sigma)
    assert lay.n_slots == stored_slots(real.sum(1), sigma) and lay.nnz == real.sum()
    sv = lay.from_ell(vals)
    y = sell_spmv_plain(sv, lay, torch.as_tensor(x)).numpy()
    ct = torch.as_tensor(cols.astype(np.int32))
    want = ell_spmv_plain(torch.as_tensor(vals), ct, torch.as_tensor(x)).numpy()
    _hold(y, want, vals, cols, x, 1e-12)
    np.testing.assert_array_equal(lay.to_ell(sv).numpy(), vals)
    e2s = lay.ell_to_sell.reshape(n, W)
    assert np.array_equal(e2s >= 0, real)
    assert np.array_equal(np.sort(e2s[real]), np.flatnonzero(lay.real))
    assert (lay.cols.numpy() < n_cols).all() and (lay.cols.numpy() >= 0).all()
    assert not sv.numpy()[~lay.real].any()
    # a remap of the columns through x2 = x[perm] gives the same product
    shuffle = rng.permutation(n_cols)
    inv = np.argsort(shuffle)
    lay2 = lay.with_cols(inv[cols], n_cols)
    y2 = sell_spmv_plain(sv, lay2, torch.as_tensor(x[shuffle])).numpy()
    np.testing.assert_array_equal(y2, y)
