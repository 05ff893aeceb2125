"""Block BELL (b = 2, 3) and the block FEM methods against the JAX package
on the CPU in float64.

The port stores a block matrix as its scalar expansion (dof = node·b +
comp, ``sparse/bell.py::block_layout``) and sums it with
``block_slot_reduce``; JAX holds (N, W, b, b) blocks summed by
``segment_sum``.  Held here: ``spmv``, ``diagonal``, ``diag_blocks`` and
``todense`` of the assembled elasticity, divdiv/epseps/mass and mixed
bilaplacian operators to 1e-13; the block ``slot_reduce`` twin against
``index_add_`` and bit for bit against the former formulation through a
slot map (``dst``, rebuilt here from ``expanded_slot`` and
``ell_to_sell``) on default, σ = 1 and small-σ layouts and the mixed
passmo mesh (and the kernel bit for bit on the card, a case that skips
without one); the CSR/ELL order the block reduction relies on; the block ``FemProblem`` methods (body force, traction, face
matrices, vector Dirichlet) and the finalized system of every Dirichlet
method; block-Jacobi; and the dense solve."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box
from arcanefem_tpu.mesh.generate import rect_tria_mesh as jax_rect
from arcanefem_tpu.models import bilaplacian as jax_bilap
from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.solver.iterative import make_precond as jax_make_precond
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.models import bilaplacian
from arcanefem_tpu_torch.ops import elements as el
from arcanefem_tpu_torch.solver.iterative import make_precond
from arcanefem_tpu_torch.sparse import slot_reduce as sr
from arcanefem_tpu_torch.sparse import topology as port_topology
from arcanefem_tpu_torch.sparse.bell import (
    BlockAssembly,
    assemble_bell,
    block_layout,
    expanded_slot,
)
from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh
from test_torch_kernels import _sigma_layout

TOL = 1e-13
METHODS = ("Penalty", "WeakPenalty", "RowElimination", "RowColumnElimination")


def _pair(b):
    if b == 2:
        return rect_tria_mesh(14, 9, lx=2.0, ly=1.0), jax_rect(14, 9, lx=2.0, ly=1.0)
    return box_tetra_mesh(5, 4, 4), jax_box(5, 4, 4)


def _ops(b):
    """(name, port element fn, JAX element fn) of the block operators."""
    lam, mu2 = 1.7, 2.3
    cases = [("divdiv", el.divdiv, jel.divdiv), ("epseps", el.epseps, jel.epseps),
             ("mass", lambda ct, x: el.mass_blocks(ct, x, b),
              lambda ct, x: jel.mass_blocks(ct, x, b))]
    if b == 2:
        cases += [("elasticity", lambda ct, x: el.elasticity_tria3(x, lam, mu2),
                   lambda ct, x: jel.elasticity_tria3(x, lam, mu2)),
                  ("bilaplacian", bilaplacian.element_blocks, jax_bilap.element_blocks)]
    else:
        cases += [("elasticity", lambda ct, x: el.elasticity_tetra4(x, lam, mu2),
                   lambda ct, x: jel.elasticity_tetra4(x, lam, mu2))]
    return cases


@pytest.fixture(scope="module", params=[2, 3], ids=["b2", "b3"])
def problems(request):
    b = request.param
    mesh, jmesh = _pair(b)
    return b, FemProblem(mesh, ndof=b, device="cpu"), JaxProblem(jmesh, ndof=b)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


def test_block_layout_stores_every_entry_of_real_blocks(problems):
    """Rows n·b + a, slots w·b + c of every real node slot, zeros
    included; the diagonal slots point at (n·b + a, n·b + a)."""
    b, prob, _ = problems
    topo, lay = prob.topo, prob.layout
    assert (lay.n_rows, lay.width) == (topo.n_nodes * b, topo.width * b)
    assert lay.nnz == topo.nnz * b * b
    rows = torch.as_tensor(lay.slot_rows("cpu")).long()
    d = prob.block_assembly.diag_slot.long()
    assert torch.equal(rows[d], torch.arange(prob.n_dofs))
    assert torch.equal(lay.cols.long()[d], torch.arange(prob.n_dofs))
    blk = prob.block_assembly.dblock_slot.long()
    assert blk.shape == (topo.n_nodes, b, b)
    n = torch.arange(topo.n_nodes)[:, None, None]
    a, c = torch.arange(b)[None, :, None], torch.arange(b)[None, None, :]
    assert torch.equal(rows[blk], (n * b + a).expand_as(blk))
    assert torch.equal(lay.cols.long()[blk], (n * b + c).expand_as(blk))
    with pytest.raises(ValueError):
        block_layout(topo, 1, "cpu")


@pytest.mark.parametrize("op", range(5))
def test_block_bell_matches_jax(problems, op):
    """spmv, diagonal, diag_blocks and todense of each assembled block
    operator, to 1e-13 of the largest magnitude."""
    b, prob, jprob = problems
    ops = _ops(b)
    if op >= len(ops):
        op = 0  # b = 3 has four operators
    name, fn, jfn = ops[op]
    A = prob.assemble_matrix(fn)
    JA = jprob.assemble_matrix(jfn)
    assert A.block == JA.block == b and A.n_dofs == JA.n_dofs and A.n_nodes == JA.n_nodes
    x = np.random.RandomState(op).rand(A.n_dofs) - 0.5
    _close(A.spmv(torch.as_tensor(x)), JA.spmv(jnp.asarray(x)))
    _close(A.diagonal(), JA.diagonal())
    _close(A.diag_blocks(), JA.diag_blocks())
    _close(A.todense(), JA.todense())
    # the explicit zeros of the real blocks stay stored (bilaplacian's
    # (u1, u1) block is all zero)
    assert A.layout.nnz == prob.topo.nnz * b * b


def _dst(topo, layout, b):
    """The former slot map: the expanded SELL slot of entry (a, c) of each
    node slot, (nnz·b²,) int64."""
    W = topo.width
    node, w = np.divmod(np.asarray(topo.csr_to_ell, np.int64), W)
    a = np.arange(b, dtype=np.int64)[None, :, None]
    c = np.arange(b, dtype=np.int64)[None, None, :]
    flat = expanded_slot(node[:, None, None], w[:, None, None], a, c, b=b, width=W)
    return torch.as_tensor(layout.ell_to_sell[flat.reshape(-1)])


def _former_twin(asm, topo, layout, table, b):
    """block_slot_reduce as it was formulated through the slot map: the
    same float64 sums in list order, scattered through ``_dst`` into a
    zeroed output."""
    bb = b * b
    p = asm.ptr.long()
    start, count = p[:-1], p[1:] - p[:-1]
    rows = table.view(-1, bb)
    acc = torch.zeros((count.numel(), bb), dtype=torch.float64)
    for k in range(int(count.max())):
        live = count > k
        g = rows[asm.ids[torch.where(live, start + k, 0)].long()].double()
        acc += torch.where(live[:, None], g, 0.0)
    out = torch.zeros(layout.n_slots, dtype=table.dtype)
    out[_dst(topo, layout, b)] = acc.view(-1).to(table.dtype)
    return out


def _block_mesh(name):
    """(mesh, b) of the block reduction's layout cases."""
    if name == "rect":
        return rect_tria_mesh(9, 7), 2
    if name == "box":
        return box_tetra_mesh(4, 3, 3), 3
    return mixed_box_mesh(), 3  # hexa8, pyramid5, penta6, tetra4


def _table(n, b, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(n * b * b, generator=gen, dtype=torch.float64) - 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [2, 3])
def test_block_slot_reduce_twin_matches_index_add(dtype, b):
    """block_slot_reduce (its plain twin on the CPU) equals one
    index_add_ of every contributor's b² entries into its node slot,
    scattered through the former slot map; the expanded padding slots
    stay 0; operands it does not take are refused."""
    mesh = rect_tria_mesh(9, 7) if b == 2 else box_tetra_mesh(4, 3, 3)
    prob = FemProblem(mesh, ndof=b, device="cpu", dtype=dtype)
    asm = prob.block_assembly
    E = int(asm.ids.numel())
    table = _table(E, b, dtype, b)
    sr.reset_launch_counts()
    out = asm.reduce(table)
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 0}
    counts = (asm.ptr[1:] - asm.ptr[:-1]).long()
    node_slot = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    ref = torch.zeros((counts.numel(), b * b), dtype=torch.float64).index_add_(
        0, node_slot, table.view(-1, b * b)[asm.ids.long()].double())
    want = torch.zeros(prob.layout.n_slots, dtype=torch.float64)
    want[_dst(prob.topo, prob.layout, b)] = ref.view(-1)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    _close(out.double(), want, tol)
    assert out.dtype == dtype and out.shape == (prob.layout.n_slots,)
    assert not out[torch.as_tensor(~prob.layout.real)].any()
    assert torch.equal(out, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table, asm.row_ptr,
                                                       asm.layout, b))
    with pytest.raises(ValueError):
        sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr, asm.layout, 4)
    with pytest.raises(ValueError):
        sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr[:-1], asm.layout, b)
    with pytest.raises(TypeError):
        sr.block_slot_reduce(asm.ptr, asm.ids.long(), table, asm.row_ptr, asm.layout, b)
    with pytest.raises(TypeError):
        sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr.long(), asm.layout, b)


@pytest.mark.parametrize("sigma", [None, 1, 7], ids=["default", "sigma1", "sigma7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh_name", ["rect", "box", "mixed"])
def test_block_slot_reduce_twin_equals_former_formulation(mesh_name, dtype, sigma):
    """The twin, which places the sums by slice arithmetic, equals the
    former slot-map formulation bit for bit: on the problem's layout
    (σ = 1024), on σ = 1 (no permutation) and on σ = 7, where node rows
    straddle σ windows and (b = 3) slices; on the mixed passmo mesh a
    node slot's list crosses several buckets' entries."""
    mesh, b = _block_mesh(mesh_name)
    prob = FemProblem(mesh, ndof=b, device="cpu", dtype=dtype)
    asm = prob.block_assembly
    lay = asm.layout if sigma is None else _sigma_layout(prob.topo, b, "cpu", sigma)
    assert lay.sigma == (1024 if sigma is None else sigma)
    if sigma is not None:  # the helper builds block_layout's layout at its own σ
        same = _sigma_layout(prob.topo, b, "cpu", None)
        assert torch.equal(same.slice_ptr, asm.layout.slice_ptr)
        assert torch.equal(same.cols, asm.layout.cols)
    assert (lay.perm is None) == (lay.sigma == 1)
    table = _table(asm.ids.numel(), b, dtype, 5)
    got = sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.row_ptr, lay, b)
    assert torch.equal(got, _former_twin(asm, prob.topo, lay, table, b))
    if sigma is not None:
        # where each node's b rows sit: two σ windows, and (b = 3) two slices
        pos = np.empty(lay.n_rows, np.int64)
        pos[np.arange(lay.n_rows) if lay.perm is None else lay.perm.numpy()] = \
            np.arange(lay.n_rows)
        rows = pos.reshape(-1, b)
        if sigma > 1:
            assert ((rows // sigma).min(1) != (rows // sigma).max(1)).any()
        if b == 3:
            assert ((rows // 32).min(1) != (rows // 32).max(1)).any()


def test_block_slot_reduce_places_in_steps(monkeypatch):
    """The twin places the sums a step of slices at a time; steps of
    about one slice give the same output as one step."""
    mesh, b = _block_mesh("box")
    prob = FemProblem(mesh, ndof=b, device="cpu")
    asm = prob.block_assembly
    table = _table(asm.ids.numel(), b, torch.float64, 6)
    one = asm.reduce(table)
    monkeypatch.setattr(sr, "_PLACE_CHUNK", 40)
    assert asm.layout.n_slots > 4 * 40
    assert torch.equal(asm.reduce(table), one)


def test_block_slot_reduce_empty_lists():
    """Lists built over one bucket of the mixed mesh leave node slots of
    the topology without contributors: their entries sum to exactly 0,
    as in the former formulation."""
    mesh, b = _block_mesh("mixed")
    prob = FemProblem(mesh, ndof=b, device="cpu")
    asm = BlockAssembly(prob.topo, ["hexa8"], b, "cpu")
    assert bool(((asm.ptr[1:] - asm.ptr[:-1]) == 0).any())
    table = _table(asm.ids.numel(), b, torch.float64, 7)
    assert torch.equal(asm.reduce(table), _former_twin(asm, prob.topo, asm.layout, table, b))


def test_block_slot_reduce_wide_star():
    """A node of 83 node slots (an 80-tet star around it): the twin equals
    the former formulation; the card's kernel writes such a slice in
    chunks (tests/test_torch_kernels.py)."""
    m = 80
    ring = 1 + np.arange(m)
    nxt = 1 + (np.arange(m) + 1) % m
    conn = np.concatenate([np.stack([np.zeros(m, int), ring, nxt, np.full(m, m + 1)], 1),
                           np.stack([np.zeros(m, int), nxt, ring, np.full(m, m + 2)], 1)])
    topo = port_topology.build_topology(m + 3, {"tetra4": conn.astype(np.int32)})
    asm = BlockAssembly(topo, ["tetra4"], 3, "cpu")
    assert int(asm.layout.slice_width.max()) // 3 == m + 3
    table = _table(asm.ids.numel(), 3, torch.float64, 8)
    assert torch.equal(asm.reduce(table), _former_twin(asm, topo, asm.layout, table, 3))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mesh_name", ["rect", "box", "mixed"])
def test_csr_entries_lead_their_ell_rows(mesh_name, use_native):
    """Both topology builders put node n's CSR entries row_ptr[n] + w at
    its ELL slots n·W + w, the real slots first: the order the block
    reduction's slice arithmetic relies on."""
    mesh, _ = _block_mesh(mesh_name)
    topo = port_topology.build_topology(mesh.n_nodes, mesh.cells, use_native=use_native)
    if use_native:
        from arcanefem_tpu_torch.utils import native
        assert native.library() is not None
    rp = np.asarray(topo.row_ptr, np.int64)
    node = np.repeat(np.arange(topo.n_nodes), np.diff(rp))
    w = np.arange(topo.nnz) - rp[node]
    np.testing.assert_array_equal(topo.csr_to_ell, node * topo.width + w)
    valid = np.arange(topo.width)[None, :] < np.diff(rp)[:, None]
    np.testing.assert_array_equal(topo.ell_valid, valid)


def test_block_assembly_refuses_another_order():
    """A topology whose CSR entries do not lead their ELL rows in order is
    refused: the block reduction would place its sums wrongly."""
    mesh, b = _block_mesh("rect")
    topo = port_topology.build_topology(mesh.n_nodes, mesh.cells)
    rp = np.asarray(topo.row_ptr, np.int64)
    c2e = topo.csr_to_ell.copy()
    c2e[rp[0]:rp[1]] = c2e[rp[0]:rp[1]][::-1]
    topo.csr_to_ell = c2e
    with pytest.raises(ValueError, match="leading ELL slots"):
        BlockAssembly(topo, list(mesh.cells), b, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_slot_reduce_on_cuda(dtype):
    """On the card: the kernel equals its twin bit for bit, once and
    again, with one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    cuda = torch.device("cuda")
    prob = FemProblem(box_tetra_mesh(6, 5, 5), ndof=3, device=cuda, dtype=dtype)
    asm = prob.block_assembly
    table = _table(asm.ids.numel(), 3, dtype, 3).to(cuda)
    sr.reset_launch_counts()
    y, y2 = asm.reduce(table), asm.reduce(table)
    torch.cuda.synchronize()
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 2}
    assert torch.equal(y, y2)
    assert torch.equal(y, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table, asm.row_ptr,
                                                     asm.layout, 3))


def test_assemble_bell_builds_its_own_layout(problems):
    """assemble_bell(block=b) without a BlockAssembly builds one, and gives
    the problem's values; lists built for other buckets or another block
    size are refused."""
    b, prob, _ = problems
    fn = _ops(b)[0][1]
    mats = {ct: fn(ct, prob.cell_xyz(ct)) for ct in prob.mesh.cells}
    A = assemble_bell(prob.topo, mats, device="cpu", block=b)
    assert torch.equal(A.values, prob.assemble_matrix(fn).values)
    assert torch.equal(A.dblock_slot, prob.block_assembly.dblock_slot)
    asm = BlockAssembly(prob.topo, list(mats), b, "cpu")
    for name in ("ptr", "ids", "row_ptr"):
        assert torch.equal(getattr(asm, name), getattr(prob.block_assembly, name)), name
    assert asm.row_ptr.dtype == torch.int32
    with pytest.raises(ValueError):
        assemble_bell(prob.topo, {"other": mats[next(iter(mats))]}, device="cpu",
                      block=b, block_asm=asm)


def _rhs_pair(b, prob, jprob):
    """The same body force and traction through both packages."""
    f = (None, -1.0) if b == 2 else (0.3, None, -1.0)
    t = (0.5, None) if b == 2 else (0.5, None, 0.25)
    face = "right" if b == 2 else "xmax"
    rhs = prob.vector_source_rhs(torch.zeros(prob.n_dofs, dtype=torch.float64), f)
    rhs = prob.traction_rhs(rhs, face, t)
    jrhs = jprob.vector_source_rhs(jnp.zeros(jprob.n_dofs), f)
    jrhs = jprob.traction_rhs(jrhs, face, t)
    return rhs, jrhs


def test_block_rhs_and_face_matrix_match_jax(problems):
    """vector_source_rhs, traction_rhs and add_face_matrix (scalar blocks
    at a component, and full b×b blocks) against JAX."""
    b, prob, jprob = problems
    rhs, jrhs = _rhs_pair(b, prob, jprob)
    _close(rhs, jrhs)
    fn, jfn = _ops(b)[1][1:]
    A, JA = prob.assemble_matrix(fn), jprob.assemble_matrix(jfn)
    face = "left" if b == 2 else "xmin"
    ftype = next(iter(prob.mesh.face_groups[face]))

    def scalar(ft, xyz):
        return torch.ones((xyz.shape[0], xyz.shape[1], xyz.shape[1]), dtype=xyz.dtype) * 0.7

    def jscalar(ft, xyz):
        return jnp.ones((xyz.shape[0], xyz.shape[1], xyz.shape[1])) * 0.7

    def full(ft, xyz):  # distinct entries, scaled by each face's first x
        n = xyz.shape[1]
        g = torch.arange(n * n * b * b, dtype=xyz.dtype).reshape(1, n, n, b, b)
        return g * (1.0 + xyz[:, 0, 0])[:, None, None, None, None]

    def jfull(ft, xyz):
        n = xyz.shape[1]
        g = jnp.arange(n * n * b * b, dtype=xyz.dtype).reshape(1, n, n, b, b)
        return g * (1.0 + xyz[:, 0, 0])[:, None, None, None, None]

    assert ftype in ("line2", "tria3")
    B = prob.add_face_matrix(A, face, scalar, comp=b - 1)
    JB = jprob.add_face_matrix(JA, face, jscalar, comp=b - 1)
    _close(B.todense(), JB.todense())
    C = prob.add_face_matrix(A, face, full)
    JC = jprob.add_face_matrix(JA, face, jfull)
    _close(C.todense(), JC.todense())


@pytest.mark.parametrize("methods", [(m,) for m in METHODS] + [METHODS], ids=[
    *METHODS, "all"])
def test_block_apply_bcs_matches_jax(problems, methods):
    """apply_dirichlet_vector with each method (some components NULL), and
    all four on different groups, then the finalized (A, b) and the
    initial guess: equal to JAX's to 1e-13; block-Jacobi applies equal."""
    b, prob, jprob = problems
    fn, jfn = _ops(b)[3][1:]
    A, JA = prob.assemble_matrix(fn), jprob.assemble_matrix(jfn)
    rhs, jrhs = _rhs_pair(b, prob, jprob)
    groups = (("left", "right", "top", "bottom") if b == 2
              else ("xmin", "xmax", "ymax", "zmin"))
    s, js = prob.new_system(A), jprob.new_system(JA)
    s.rhs, js.rhs = rhs, jrhs
    for k, m in enumerate(methods):
        vals = (0.01 * (k + 1), None, -0.02)[:b] if k % 2 else (0.0,) * b
        if b == 2 and k % 2:
            vals = (None, 0.01 * (k + 1))
        nodes = prob.mesh.group_nodes(groups[k])
        prob.apply_dirichlet_vector(s, nodes, vals, m, 1e12)
        jprob.apply_dirichlet_vector(js, jprob.mesh.group_nodes(groups[k]), vals, m, 1e12)
    Af, bf = s.finalized()
    JAf, jbf = js.finalized()
    _close(Af.todense(), JAf.todense())
    _close(bf, jbf)
    _close(s.initial_guess(), js.initial_guess())
    _close(Af.diag_blocks(), JAf.diag_blocks())
    r = np.random.RandomState(1).rand(Af.n_dofs) - 0.5
    M, JM = make_precond(Af, "block-jacobi"), jax_make_precond(JAf, "block-jacobi")
    assert M.inv_diag.shape == (Af.n_nodes, b, b)
    _close(M.apply(torch.as_tensor(r)), JM.apply(jnp.asarray(r)), 1e-12)


def test_block_dense_solve_matches_jax(problems):
    """The dense back end on the finalized elasticity system."""
    from arcanefem_tpu.solver.linear_system import SolverOptions as JaxOptions
    from arcanefem_tpu_torch.solver.linear_system import SolverOptions

    b, prob, jprob = problems
    fn, jfn = _ops(b)[3][1:]
    s, js = prob.new_system(prob.assemble_matrix(fn)), jprob.new_system(jprob.assemble_matrix(jfn))
    s.rhs, js.rhs = _rhs_pair(b, prob, jprob)
    face = "left" if b == 2 else "xmin"
    prob.apply_dirichlet_vector(s, prob.mesh.group_nodes(face), (0.0,) * b, "Penalty")
    jprob.apply_dirichlet_vector(js, jprob.mesh.group_nodes(face), (0.0,) * b, "Penalty")
    s.options, js.options = SolverOptions(method="dense"), JaxOptions(method="dense")
    x, info = s.solve()
    jx, _ = js.solve()
    _close(x, jx, 1e-10)
    assert info["iterations"] == 1
    u = prob.node_values(x)
    assert u.shape == (prob.mesh.n_nodes, b)
