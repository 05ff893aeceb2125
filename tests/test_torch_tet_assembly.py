"""The sphere's tetrahedron assembly (arcanefem_tpu_torch/ops/lane_assembly.py,
sparse/slot_reduce.py) on the CPU: the slot-sorted contributor lists
against a numpy build, the reduction twin against a float64 sum in the
same order, the element table against a numpy float64 element matrix,
the assembled values against the JAX package's segment-sum, and every
assembly route against the others.  The CUDA kernels are held to these
twins in tests/test_torch_kernels.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.sparse.pallas_assembly import Q2P16 as JAX_Q2P16
from arcanefem_tpu.sparse.pallas_assembly import TRI10 as JAX_TRI10
from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
from arcanefem_tpu_torch.ops import lane_assembly as la
from arcanefem_tpu_torch.ops.lane_assembly import (
    Q2P16,
    TRI10,
    TetraAssembler,
    tet_corners_plain,
    tet_element,
    tet_element_gathered,
    tet_element_plain,
)
from arcanefem_tpu_torch.sparse import slot_reduce as sr
from arcanefem_tpu_torch.sparse.slot_reduce import (
    group_by_slot,
    slot_reduce,
    slot_reduce_plain,
)

ROUTES = {
    "split": {},
    "batched": dict(coords_batched=True),
    "compact": dict(coords_compact=True),
    "compact batched banded": dict(coords_compact=True, coords_batched=True,
                                   band_pre=True),
}


@pytest.fixture(scope="module", params=[14.0, 8.0])
def sphere(request):
    """The sphere_cut mesh at h (refine 0), its topology and split
    assembler, and float32 coordinates."""
    mesh, topo = sphere_cut_system(request.param, 0, cache=False)
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device="cpu")
    return mesh, topo, asm, torch.as_tensor(mesh.coords.astype(np.float32))


def _numpy_lists(topo, layout):
    """(ptr, ids) by numpy: a stable argsort of the cell-major SELL slot
    map, entry (c, q) packed as c*10 + Q2P16[q]."""
    sm = layout.ell_to_sell[np.asarray(topo.slot_maps["tetra4"], np.int64).reshape(-1)]
    order = np.argsort(sm, kind="stable")
    ids = (order // 16) * 10 + Q2P16[order % 16]
    ptr = np.zeros(layout.n_slots + 1, np.int64)
    np.cumsum(np.bincount(sm, minlength=layout.n_slots), out=ptr[1:])
    return sm, ptr, ids


def test_packing_matches_jax():
    """TRI10 and Q2P16 are the JAX window reducer's packing."""
    assert TRI10 == JAX_TRI10
    np.testing.assert_array_equal(Q2P16, JAX_Q2P16)


def test_contributor_lists_match_numpy(sphere):
    """ptr and ids equal the numpy build exactly: int32, each slot's
    contributors in ascending (cell, q) order, 16 per cell in all, none on
    a slot the layout drops or pads, at least one on every real slot."""
    mesh, topo, asm, _ = sphere
    nc = mesh.cells["tetra4"].shape[0]
    sm, ptr, ids = _numpy_lists(topo, asm.layout)
    assert asm.ptr.dtype == asm.ids.dtype == torch.int32
    np.testing.assert_array_equal(asm.ptr.numpy(), ptr)
    np.testing.assert_array_equal(asm.ids.numpy(), ids)
    assert int(asm.ptr[-1]) == 16 * nc == asm.ids.numel()
    count = np.diff(ptr)
    assert not count[~asm.layout.real].any() and (count[asm.layout.real] > 0).all()
    # within a slot: cells ascending, and the ordered pair q ascending
    # inside a cell; every contributor's slot is the slot it is listed on
    order = np.argsort(sm, kind="stable")
    key = np.repeat(np.arange(asm.layout.n_slots), count)
    np.testing.assert_array_equal(sm[order], key)
    same = key[1:] == key[:-1]
    assert (order[1:][same] > order[:-1][same]).all()


def test_reduction_twin_equals_ordered_f64_sum(sphere):
    """The twin == a float64 sum of each slot's contributors in stored
    order, rounded once, bit for bit (float32 and float64 tables)."""
    _, _, asm, _ = sphere
    ptr, ids = asm.ptr.numpy(), asm.ids.numpy()
    rng = np.random.RandomState(0)
    for dt in (np.float32, np.float64):
        table = (rng.rand(int(ids.max()) + 1) - 0.5).astype(dt)
        want = np.empty(len(ptr) - 1, dt)
        for s in range(len(ptr) - 1):
            acc = 0.0  # a Python float: IEEE float64, added in order
            for k in range(ptr[s], ptr[s + 1]):
                acc += float(table[ids[k]])
            want[s] = acc
        got = slot_reduce(asm.ptr, asm.ids, torch.as_tensor(table)).numpy()
        assert got.dtype == dt
        np.testing.assert_array_equal(got, want)


def test_element_table_matches_numpy_f64(sphere):
    """The (nc, 10) table == V G Gᵀ of each cell in float64 numpy (G the
    barycentric gradients) to 1e-5 of the cell's max |ke|, in TRI10 order;
    both input modes give the same table."""
    mesh, _, asm, coords = sphere
    conn = mesh.cells["tetra4"]
    p = mesh.coords.astype(np.float32).astype(np.float64)[conn]  # (nc, 4, 3)
    J = p[:, 1:] - p[:, :1]  # rows p_i - p_0
    grads = np.linalg.inv(J).transpose(0, 2, 1)  # (nc, 3, 3) gradients of l1..l3
    G = np.concatenate([-grads.sum(axis=1, keepdims=True), grads], axis=1)
    V = np.abs(np.linalg.det(J)) / 6.0
    full = V[:, None, None] * G @ G.transpose(0, 2, 1)
    want = np.stack([full[:, i, j] for i in range(4) for j in range(i, 4)], axis=1)
    got = tet_element(coords, asm.corner_cols)
    assert got.shape == (conn.shape[0], 10) and got.dtype == torch.float32
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale).all()
    corners = tet_corners_plain(coords, asm.corner_cols)
    assert torch.equal(tet_element_gathered(corners), got)
    assert torch.equal(tet_element_gathered(list(corners)), got)


def test_assembly_matches_jax_segsum(sphere):
    """The assembled SELL values == the JAX TetraLaneAssembler segment-sum
    to 1e-5·max|vals| (both float32, summed in different orders); every
    slot off the topology's real ones stays exactly 0."""
    mesh, topo, asm, coords = sphere
    want = np.asarray(TetraLaneAssembler(topo, mesh.cells["tetra4"], reduce="segsum")(
        jnp.asarray(coords.numpy())))
    got = asm(coords)
    assert got.dtype == torch.float32 and got.shape == (asm.layout.n_slots,)
    assert not got[torch.as_tensor(~asm.layout.real)].any()  # SELL padding
    ell = asm.layout.to_ell(got).numpy()
    assert np.abs(ell - want).max() <= 1e-5 * np.abs(want).max()
    assert not ell[~topo.ell_valid].any()


def test_routes_bit_equal(sphere):
    """All four assembly routes, and two calls of each, give the same
    values bit for bit; none launches a kernel on the CPU."""
    mesh, topo, asm, coords = sphere
    la.reset_launch_counts()
    sr.reset_launch_counts()
    ref = asm(coords)
    for name, kw in ROUTES.items():
        other = TetraAssembler(topo, mesh.cells["tetra4"], device="cpu",
                               layout=asm.layout, **kw)
        assert torch.equal(other(coords), ref), name
        assert torch.equal(other(coords.double()), ref), name
    assert la.launch_counts() == {"tet_element": 0, "tet_assemble": 0}
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 0}


MESHES = [(14.0, 0), (8.0, 0), (14.0, 1)]
CAPS = [la.PATCH_BYTES, 20_000]  # shared memory per patch: the default, and small


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"h{m[0]:g}r{m[1]}")
def patched(request):
    """A sphere_cut mesh, its CPU assembler (window lists), float32
    coordinates and its patch lists at each of CAPS."""
    mesh, topo = sphere_cut_system(*request.param, cache=False)
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device="cpu")
    patches = {cap: la.TetPatches.build(topo, mesh.cells["tetra4"], asm.layout, "cpu",
                                        max_bytes=cap) for cap in CAPS}
    return mesh, topo, asm, torch.as_tensor(mesh.coords.astype(np.float32)), patches


@pytest.mark.parametrize("cap", CAPS)
def test_patch_lists_match_numpy(patched, cap):
    """Each patch (a run of whole slices) holds the cells with a corner on
    one of its rows, ascending and complete, as positions among its nodes,
    the distinct corners of those cells ascending (padded to 4 with node
    0); it grows while its cells and buffer (its nodes counted at the
    build's share) stay within the caps and its local indices within 16
    bits, and its real buffer stays within the cap; its part of the blob
    takes its slots longest list first, ties by slot, with their list
    pointers, and each slot lists the window lists' (cell, TRI10 column)
    pairs in their order, as local ids: a brute-force numpy build."""
    mesh, topo, asm, _, patches = patched
    P, lay, conn = patches[cap], asm.layout, mesh.cells["tetra4"]
    slice_ptr = lay.slice_ptr.numpy()
    cell0, slot0, blob0, node0 = P.meta.numpy()
    bounds = np.searchsorted(slice_ptr, slot0)
    assert (slice_ptr[bounds] == slot0).all() and bounds[0] == 0
    assert bounds[-1] == lay.n_slices and (np.diff(bounds) > 0).all()
    pos = np.empty(lay.n_rows, np.int64)
    pos[np.arange(lay.n_rows) if lay.perm is None else lay.perm.numpy()] = np.arange(lay.n_rows)
    node_slice = pos // 32
    _, ptr, ids = _numpy_lists(topo, lay)
    assert P.lconn.dtype == P.blob.dtype == torch.int16 and P.nodes.dtype == torch.int32
    lconn = P.lconn.numpy().astype(np.int64) & 0xFFFF
    nodes = P.nodes.numpy()
    assert (np.diff(blob0) % 8 == 0).all() and (np.diff(node0) % 4 == 0).all()
    blob = P.blob.numpy().astype(np.int64) & 0xFFFF
    np.testing.assert_array_equal(P.corners().numpy(),
                                  nodes[np.repeat(node0[:-1], np.diff(cell0))[:, None] + lconn])

    def size(b0, b1):  # (cells, nodes, slots, contributors) of the slices [b0, b1)
        touch = conn[((node_slice[conn] >= b0) & (node_slice[conn] < b1)).any(1)]
        return (len(touch), len(np.unique(touch)), slice_ptr[b1] - slice_ptr[b0],
                ptr[slice_ptr[b1]] - ptr[slice_ptr[b0]])

    cap_cells, cap_buf = la._caps(cap)

    def grows(z):  # within the caps as the growth counts
        c, _, s, k = z
        return (c <= cap_cells and la._fits_u16(c, s, k)
                and la._buffer_bytes(c, int(np.ceil(P.share * c)), s, k) <= cap_buf)

    most = [0, 0]
    for p in range(P.n_patches):
        b0, b1 = bounds[p], bounds[p + 1]
        want = np.flatnonzero(((node_slice[conn] >= b0) & (node_slice[conn] < b1)).any(1))
        vs = np.unique(conn[want])
        pad = -len(vs) % 4
        np.testing.assert_array_equal(nodes[node0[p]:node0[p + 1]],
                                      np.concatenate([vs, np.zeros(pad, np.int32)]))
        np.testing.assert_array_equal(vs[lconn[cell0[p]:cell0[p + 1]]], conn[want])
        z = size(b0, b1)
        assert la._fits_u16(z[0], *z[2:])
        assert b1 - b0 == 1 or (grows(z) and la._buffer_bytes(*z) <= cap_buf)
        most = [max(most[0], z[0]), max(most[1], la._buffer_bytes(*z))]
        if p + 1 < P.n_patches:  # the next slice would have broken a limit
            assert not grows(size(b0, b1 + 1))
        count = np.diff(ptr[slot0[p]:slot0[p + 1] + 1])
        S, L = len(count), count.sum()
        taken = np.argsort(-count, kind="stable")
        n = count[taken]
        seg = blob[blob0[p]:blob0[p + 1]]
        assert len(seg) == (2 * S + 1 + L + 7) // 8 * 8 and not seg[2 * S + 1 + L:].any()
        np.testing.assert_array_equal(seg[:S + 1], np.concatenate([[0], np.cumsum(n)]))
        np.testing.assert_array_equal(seg[S + 1:2 * S + 1], taken)
        k = np.repeat(ptr[slot0[p] + taken] - np.concatenate([[0], np.cumsum(n)[:-1]]), n) \
            + np.arange(L)
        local = np.searchsorted(want, ids[k] // 10)
        assert (want[local] == ids[k] // 10).all()
        np.testing.assert_array_equal(seg[2 * S + 1:2 * S + 1 + L], local * 10 + ids[k] % 10)
    assert [P.max_cells, P.buf_bytes] == most
    assert P.n_computed == cell0[-1] == len(lconn)
    assert P.smem_bytes == la._align(40 * most[0]) + 2 * most[1]
    if cap == la.PATCH_BYTES:
        assert P.smem_bytes <= cap


@pytest.mark.parametrize("cap", CAPS)
def test_patch_sums_equal_the_window_route(patched, cap):
    """Each slot's local contributors summed in list order over the
    patches' tables (tet_assemble's plain twin, the CPU wrapper) equal
    slot_reduce_plain over tet_element_plain on the window lists, bit for
    bit, on float32 and float64 coordinates; the CPU launches nothing."""
    _, _, asm, coords, patches = patched
    want = slot_reduce_plain(asm.ptr, asm.ids, tet_element_plain(
        tet_corners_plain(coords, asm.corner_cols)).view(-1))
    la.reset_launch_counts()
    for c in (coords, coords.double()):
        got = la.tet_assemble(patches[cap], c)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(la.tet_assemble_plain(patches[cap], coords), want)
    assert la.launch_counts() == {"tet_element": 0, "tet_assemble": 0}


def test_patch_build_grows_again_past_the_node_share(patched, monkeypatch):
    """Counted at too small a share of nodes per cell, the patches pass
    the buffer's cap: the build grows them again at the share it saw, so
    each patch of more than one slice fits, and the sums stay the window
    route's."""
    mesh, topo, asm, coords, _ = patched
    monkeypatch.setattr(la, "_NODE_SHARE", 0.05)
    P = la.TetPatches.build(topo, mesh.cells["tetra4"], asm.layout, "cpu")
    cell0, slot0, _, node0 = P.meta
    cap_buf = la._caps(la.PATCH_BYTES)[1]
    assert P.share > 0.25 and P.smem_bytes <= la.PATCH_BYTES
    slices = torch.searchsorted(asm.layout.slice_ptr, slot0).diff()
    lists = asm.ptr.long()[slot0].diff()
    buffers = la._buffer_bytes(cell0.diff(), node0.diff(), slot0.diff(), lists)
    assert bool(((buffers <= cap_buf) | (slices == 1)).all())
    want = slot_reduce_plain(asm.ptr, asm.ids, tet_element_plain(
        tet_corners_plain(coords, asm.corner_cols)).view(-1))
    assert torch.equal(la.tet_assemble(P, coords), want)


def test_patch_build_checks(sphere):
    """The wrapper refuses coordinates of another shape; a CPU assembler
    keeps the window lists and no patches."""
    mesh, topo, asm, coords = sphere
    P = la.TetPatches.build(topo, mesh.cells["tetra4"], asm.layout, "cpu")
    with pytest.raises(ValueError, match="coords"):
        la.tet_assemble(P, coords[:-1])
    assert asm.patches is None and asm.ptr.numel() == asm.layout.n_slots + 1


@pytest.mark.parametrize("per_cell", [None, [2, 0, 1]])
def test_group_by_slot_small(per_cell):
    """A hand-checked case: entries grouped by slot in entry order, an
    empty slot, an optional per-cell packing."""
    slots = torch.tensor([3, 0, 3, 1, 0, 3], dtype=torch.int32)
    pc = None if per_cell is None else torch.tensor(per_cell)
    ptr, ids = group_by_slot(slots, 5, per_cell=pc)
    assert ptr.tolist() == [0, 2, 3, 3, 6, 6]
    want = [1, 4, 3, 0, 2, 5]
    if per_cell is not None:  # entry e -> (e // 3) * 3 + per_cell[e % 3]
        want = [(e // 3) * 3 + per_cell[e % 3] for e in want]
    assert ids.tolist() == want
    table = torch.arange(1.0, 7.0)
    out = slot_reduce(ptr, ids, table)
    assert out.tolist() == [float(table[want[0]] + table[want[1]]), float(table[want[2]]),
                            0.0, float(table[want[3]] + table[want[4]] + table[want[5]]), 0.0]


def test_wrappers_check_operands():
    slots = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):  # a slot outside the layout
        group_by_slot(slots, 1)
    with pytest.raises(ValueError):
        group_by_slot(torch.tensor([-1, 0]), 2)
    ptr, ids = group_by_slot(slots, 2)
    with pytest.raises(TypeError):
        slot_reduce(ptr.long(), ids, torch.zeros(2))
    with pytest.raises(TypeError):
        slot_reduce(ptr, ids, torch.zeros(2, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        slot_reduce(ptr, ids, torch.zeros(2, 1))
    with pytest.raises(ValueError):
        slot_reduce(ptr.to("meta"), ids.to("meta"), torch.zeros(2).to("meta"))
    cols = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tet_element(torch.zeros(4, 3, dtype=torch.float64), cols)
    with pytest.raises(ValueError):
        tet_element(torch.zeros(4, 2), cols)
    with pytest.raises(ValueError):
        tet_element(torch.zeros(4, 3), cols[:6])
    with pytest.raises(ValueError):
        tet_element_gathered(torch.zeros(2, 8))
    with pytest.raises(ValueError):
        tet_element_gathered(torch.zeros(3, 8).to("meta"))
    assert tet_element_plain(torch.zeros(3, 0)).shape == (0, 10)
