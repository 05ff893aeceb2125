"""The supernode route (arcanefem_tpu_torch/sparse/supernode.py and the
block-Jacobi smoother of solver/amg.py) against the JAX package on the CPU,
on a 9x8x7 box and on the sphere_cut h=14 system, both in supernode order.
The port's gathers run on their plain twins here; the kernels are held to
the twins in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.fem.bcs import dtype_safe_penalty
from arcanefem_tpu.fem.problem import FemProblem
from arcanefem_tpu.mesh.generate import box_tetra_mesh
from arcanefem_tpu.ops import elements
from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.solver.amg import with_supernode_smoother as jax_sn_smoother
from arcanefem_tpu.solver.iterative import pcg as jax_pcg
from arcanefem_tpu.sparse.bell import BellMatrix as JaxBell
from arcanefem_tpu.sparse.supernode import SupernodeSpmv as JaxSn
from arcanefem_tpu.sparse.supernode import supernode_order as jax_sn_order
from arcanefem_tpu.sparse.topology import build_topology
from arcanefem_tpu.utils.ordering import renumber_mesh
from arcanefem_tpu_torch.bench_unstructured import dirichlet_data, sphere_cut_system
from arcanefem_tpu_torch.solver.amg import amg_from_numpy, with_supernode_smoother
from arcanefem_tpu_torch.solver.iterative import pcg
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.supernode import (
    SupernodeMatrix,
    SupernodeSpmv,
    bsr8_spmv,
    bsr8_spmv_plain,
)

from test_torch_amg import _as_numpy


def _box(dims=(9, 8, 7)):
    """The JAX tests' supernode box (tests/test_supernode.py::_system) at
    9x8x7: (JAX BellMatrix, Dirichlet mask of the boundary nodes)."""
    mesh = box_tetra_mesh(*dims)
    t0 = build_topology(mesh.n_nodes, mesh.cells)
    mesh = renumber_mesh(mesh, jax_sn_order(t0, mesh.coords))
    A = FemProblem(mesh, ndof=1, dtype=np.float32).assemble_matrix(
        lambda ct, xyz: elements.stiffness(ct, xyz))
    faces = np.concatenate([c.ravel() for c in mesh.boundary_faces().values()])
    mask = np.zeros(mesh.n_nodes, bool)
    mask[np.unique(faces)] = True
    return A, mask


def _sphere():
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    vals = TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(mesh.coords.astype(np.float32)))
    A = JaxBell(values=jnp.asarray(np.asarray(vals).reshape(
        topo.n_nodes, topo.width, 1, 1)), topo=topo, block=1,
        cols=jnp.asarray(topo.ell_cols))
    return A, dirichlet_data(mesh, 1e30)[0]


SYSTEMS = {"box": _box, "sphere": _sphere}


def _penalised(A, mask, dtype):
    """A with its Dirichlet rows' diagonal set to the dtype-safe 1e30
    penalty, in ``dtype`` (the JAX block-smoother test's system)."""
    pen = dtype_safe_penalty(1e30, dtype)
    vals = np.asarray(A.flat_values()).reshape(-1).astype(dtype)
    d = A.topo.diag_slot
    vals[d[mask]] = pen
    return A.with_values(jnp.asarray(vals)), np.where(mask, 0.0, 1.0)


def _port_bell(A, dtype) -> BellMatrix:
    t = A.topo
    return BellMatrix.from_numpy(
        np.asarray(A.values).reshape(t.n_nodes, t.width), t.ell_cols,
        t.diag_slot, device="cpu", dtype=dtype)


def _from_jax(sn, dtype) -> SupernodeSpmv:
    return SupernodeSpmv.from_numpy(np.asarray(sn.blocks), sn._bcol, sn._bptr,
                                    sn._brow, sn.n, device="cpu", dtype=dtype)


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def system(request):
    A, mask = SYSTEMS[request.param]()
    return A, mask, JaxSn.build(A)


def test_build_matches_jax(system):
    """The port's host build == the JAX build, bit for bit (f32 values)."""
    A, _, sn = system
    got = SupernodeSpmv.build(_port_bell(A, torch.float32), A.topo)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(sn.blocks))
    for k in ("bcol", "bptr", "brow"):
        np.testing.assert_array_equal(getattr(got, k), getattr(sn, f"_{k}"))
    n_pad = got.n_sup * 8 - got.n
    assert got.blocks.shape[0] == len(sn._bcol) and 0 <= n_pad < 8


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 5e-5)])
def test_spmv_matches_jax(system, dtype, rtol):
    """One operator fed to both packages: the port's SpMV == JAX emulate()
    (rtol) and == A.spmv (an f32 product: 1e-6 in f64), relative to each
    row's sum |a x| (f32: the JAX test's 5e-5); the port's own f64 build ==
    its f64 BellMatrix SpMV to 1e-12."""
    A, _, sn = system
    x = np.random.RandomState(0).rand(sn.n)
    xt = torch.as_tensor(x, dtype=dtype)
    got = _from_jax(sn, dtype)(xt).double().numpy()
    assert got.shape == (sn.n,)
    absval = np.abs(np.asarray(A.values, np.float64).reshape(sn.n, -1))
    row_scale = (absval * x[A.topo.ell_cols]).sum(1)
    for want, tol in ((sn.emulate(x), rtol),
                      (np.asarray(A.spmv(jnp.asarray(x)), np.float64), max(rtol, 1e-6))):
        assert (np.abs(got - want) <= tol * row_scale).all()
    A64 = _port_bell(A.with_values(jnp.asarray(
        np.asarray(A.flat_values(), np.float64))), torch.float64)
    own = SupernodeSpmv.build(A64, A.topo)
    y = own(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, A64.spmv(torch.as_tensor(x)).numpy(),
                               rtol=1e-12, atol=1e-12 * row_scale.max())


def test_as_bf16_close(system):
    """bf16 blocks: within the JAX test's 2e-2 of the f32 operator."""
    _, _, sn = system
    x = np.random.RandomState(3).rand(sn.n).astype(np.float32)
    port = _from_jax(sn, torch.float32)
    lo = port.as_bf16()
    assert lo.blocks.dtype == torch.bfloat16 and lo.cols is port.cols
    ref = sn.emulate(x)
    got = lo(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    assert np.abs(np.asarray(lo.blocks.float()) - np.asarray(sn.as_bf16().blocks,
                                                             np.float32)).max() == 0


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def smoothed(request):
    """The JAX block-smoother test's set-up, f64 with penalty rows: A, rhs,
    the JAX hierarchy M and M with the block smoother, and the JAX sn."""
    A, mask = SYSTEMS[request.param]()
    A, rhs = _penalised(A, mask, np.float64)
    sn = JaxSn.build(A)
    M = build_amg(A, use_pallas=False)
    return A, rhs, sn, M, jax_sn_smoother(M, A, sn)


def test_supernode_smoother_matches_jax(smoothed):
    """l0_binv, rhos[0] and omegas[0] == the JAX function's to 1e-12."""
    A, _, sn, M, Mb = smoothed
    port = with_supernode_smoother(amg_from_numpy(_as_numpy(M), "cpu", torch.float64),
                                   _port_bell(A, torch.float64),
                                   _from_jax(sn, torch.float64))
    want = np.asarray(Mb.l0_binv)
    assert port.l0_binv.dtype == torch.float64
    np.testing.assert_allclose(port.l0_binv.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(port.rhos, Mb.rhos, rtol=1e-12)
    np.testing.assert_allclose(port.omegas, Mb.omegas, rtol=1e-12)
    # the padded slots of the last supernode carry identity
    n_pad = sn.n_sup * 8 - sn.n
    if n_pad:
        last = port.l0_binv[-1].numpy()
        np.testing.assert_array_equal(last[8 - n_pad:, 8 - n_pad:], np.eye(n_pad))


def test_block_smoothed_pcg_matches_jax(smoothed):
    """PCG with the block-smoothed hierarchy carried from JAX: the same
    iterations (±1) and solution (atol 2e-7) as the JAX pcg, in f64, and
    no more iterations than the pointwise smoother (tests/test_supernode.py)."""
    A, rhs, sn, M, Mb = smoothed
    b = jnp.asarray(rhs)
    x0 = jnp.zeros_like(b)
    xj, kj, _ = jax_pcg(A, b, Mb, x0, 1e-10, 0.0, 3000)
    _, k0, _ = jax_pcg(A, b, M, x0, 1e-10, 0.0, 3000)
    P = amg_from_numpy(_as_numpy(Mb), "cpu", torch.float64)
    assert P.l0_binv is not None
    At = _port_bell(A, torch.float64)
    x, k, rel = pcg(At, torch.as_tensor(rhs), P, torch.zeros(len(rhs), dtype=torch.float64),
                    1e-10, 0.0, 3000)
    assert abs(k - int(kj)) <= 1, (k, int(kj))
    assert rel <= 1e-10 and int(kj) <= int(k0)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=2e-7)
    # and with the port's own supernode operator in the cycle and in CG
    snp = SupernodeSpmv.build(At, A.topo)
    Ps = P.replace(mats=(SupernodeMatrix(snp, At.diagonal()),) + P.mats[1:])
    xs, ks, _ = pcg(SupernodeMatrix(snp, At.diagonal()), torch.as_tensor(rhs), Ps,
                    torch.zeros(len(rhs), dtype=torch.float64), 1e-10, 0.0, 3000)
    assert abs(ks - int(kj)) <= 1
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), atol=2e-7)


def test_route_raises_instead_of_falling_back(monkeypatch):
    """A failed supernode self-check raises (bench.py falls back to the
    window SpMV); so do options that do not go together."""
    import arcanefem_tpu_torch.bench_unstructured as bu

    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    kw = dict(device="cpu", dtype=torch.float64, penalty=1e30)
    res = bu.solve_sphere_cut(mesh, topo, spmv="supernode", **kw)
    assert res["spmv_path"] == "SupernodeMatrix" and res["sn_check"] <= 1e-12
    monkeypatch.setattr(bu, "operator_self_check", lambda op, A: 1.0)
    with pytest.raises(RuntimeError, match="self-check"):
        bu.solve_sphere_cut(mesh, topo, spmv="supernode", system=res["system"], **kw)
    with pytest.raises(ValueError):
        bu.solve_sphere_cut(mesh, topo, sn_bf16=True, system=res["system"], **kw)
    with pytest.raises(ValueError):
        bu.solve_sphere_cut(mesh, topo, spmv="bsr", system=res["system"], **kw)
    with pytest.raises(ValueError):  # a system of another dtype
        bu.solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float32,
                            penalty=1e12, system=res["system"])


def test_bench_flags_map_to_route_options(monkeypatch):
    """bench_unstructured's flags reach solve_sphere_cut's options under
    bench.py's knob names; without a card the bench raises."""
    import arcanefem_tpu_torch.bench_unstructured as bu

    seen = {}

    def fake(h, refine, **options):
        seen.update(options, h=h, refine=refine)
        return {}

    monkeypatch.setattr(bu, "bench_unstructured", fake)
    bu.main(["--h", "5", "--refine", "2", "--spmv", "supernode", "--sn-block",
             "--sn-bf16", "--vcycle-bf16", "--asm-coords", "batched",
             "--asm-compact", "--band-pre", "--order", "rcm",
             "--smoother", "jacobi", "--cheb-deg", "2,4", "--cycle", "W"])
    assert seen == dict(h=5.0, refine=2, spmv="supernode", sn_block=True,
                        sn_bf16=True, vcycle_bf16=True, asm_coords="batched",
                        asm_compact=True, band_pre=True, order="rcm",
                        smoother="jacobi", cheb_deg=(2, 4), cycle="W")
    seen.clear()
    bu.main(["--spmv", "diag"])
    assert seen["spmv"] == "diag" and seen["order"] == "sn"
    assert not seen["band_pre"] and not seen["asm_compact"]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bu.bench_unstructured(14.0, 0, spmv="supernode", sn_block=True)


@pytest.mark.parametrize("dims", [(9, 8, 7), (9, 8, 6)])
def test_bsr8_plain_matches_jax(dims):
    """The kernel's plain twin ``bsr8_spmv_plain`` (and the CPU wrapper
    ``bsr8_spmv``) on the JAX build's blocks of the supernode box (720
    nodes, and 630: n not a multiple of 8) == the JAX ``emulate()``,
    relative to each row's sum |a·x|, with f64 blocks to 1e-12 and f32
    blocks to 1e-6 (one f32 rounding of y), and == ``A.spmv`` to 1e-6 (the
    JAX BELL product runs in f32 there); the port's bf16 blocks (the
    JAX ``as_bf16()`` blocks) == ``as_bf16().emulate`` of x rounded to bf16,
    as the JAX einsum rounds it, to 1e-6, and within the bf16 test's 2e-2
    of the f32 operator."""
    A, _ = _box(dims)
    sn = JaxSn.build(A)
    n = sn.n
    assert (n % 8 == 0) == (dims == (9, 8, 7))
    x = np.random.RandomState(5).rand(n).astype(np.float32).astype(np.float64)
    absval = np.abs(np.asarray(A.values, np.float64).reshape(n, -1))
    row_scale = (absval * x[A.topo.ell_cols]).sum(1)
    bcol = torch.as_tensor(sn._bcol.astype(np.int32))
    bptr = torch.as_tensor(sn._bptr.astype(np.int32))
    want = {"emulate": sn.emulate(x),
            "A.spmv": np.asarray(A.spmv(jnp.asarray(x)), np.float64)}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        blocks = torch.tensor(np.asarray(sn.blocks), dtype=dtype)
        xt = torch.as_tensor(x).to(dtype)
        got = bsr8_spmv_plain(blocks, bcol, bptr, xt)
        assert got.dtype == dtype and got.shape == (n,)
        assert torch.equal(bsr8_spmv(blocks, bcol, bptr, xt), got)
        for name, w in want.items():
            tol = rtol if name == "emulate" else max(rtol, 1e-6)
            err = np.abs(got.double().numpy() - w)
            assert (err <= tol * row_scale).all(), (dtype, name, err.max())
    lo = sn.as_bf16()
    xr = np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16), np.float64)
    got = bsr8_spmv_plain(_from_jax(sn, torch.float32).as_bf16().blocks, bcol, bptr,
                          torch.as_tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float32
    xp = np.zeros(sn.n_sup * 8)
    xp[:n] = np.abs(xr)
    bscale = (np.abs(np.asarray(lo.blocks, np.float64))
              * xp.reshape(-1, 8)[sn._bcol][:, None, :]).sum(2)
    rs = np.zeros((sn.n_sup, 8))
    np.add.at(rs, sn._brow, bscale)
    err = np.abs(got.double().numpy() - lo.emulate(xr))
    assert (err <= 1e-6 * rs.reshape(-1)[:n]).all()
    ref = want["emulate"]
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 2e-2


def test_bsr8_spmv_checks_operands():
    """The wrapper raises on operands the kernel does not take; the
    operator checks its plan once and a call checks x."""
    blocks = torch.zeros((3, 8, 8))
    bcol = torch.tensor([0, 1, 1], dtype=torch.int32)
    bptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    x = torch.zeros(12)
    assert bsr8_spmv(blocks, bcol, bptr, x).shape == (12,)
    with pytest.raises(TypeError):  # int64 indices
        bsr8_spmv(blocks, bcol.long(), bptr, x)
    with pytest.raises(TypeError):  # f64 x with f32 blocks
        bsr8_spmv(blocks, bcol, bptr, x.double())
    with pytest.raises(TypeError):  # bf16 blocks take f32 x only
        bsr8_spmv(blocks.bfloat16(), bcol, bptr, x.double())
    with pytest.raises(ValueError):  # x too short for 2 supernodes
        bsr8_spmv(blocks, bcol, bptr, torch.zeros(8))
    with pytest.raises(ValueError):  # x too long
        bsr8_spmv(blocks, bcol, bptr, torch.zeros(17))
    with pytest.raises(ValueError):  # 4x4 blocks
        bsr8_spmv(torch.zeros((3, 4, 4)), bcol, bptr, x)
    with pytest.raises(ValueError):  # no kernel off CPU and CUDA
        bsr8_spmv(blocks.to("meta"), bcol.to("meta"), bptr.to("meta"), x.to("meta"))
    sn = SupernodeSpmv(12, blocks, np.array([0, 1, 1]), np.array([0, 2, 3]),
                       np.array([0, 0, 1]))
    assert sn.cols.dtype == sn.ptr.dtype == torch.int32
    with pytest.raises(ValueError):
        sn(torch.zeros(13))
    with pytest.raises(ValueError):  # a block column past the last supernode
        SupernodeSpmv(12, blocks, np.array([0, 1, 2]), np.array([0, 2, 3]),
                      np.array([0, 0, 1]))
