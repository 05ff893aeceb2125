"""Block BELL (b = 2, 3) and the block FEM methods against the JAX package
on the CPU in float64.

The port stores a block matrix as its scalar expansion (dof = node·b +
comp, ``sparse/bell.py::block_layout``) and sums it with
``block_slot_reduce``; JAX holds (N, W, b, b) blocks summed by
``segment_sum``.  Held here: ``spmv``, ``diagonal``, ``diag_blocks`` and
``todense`` of the assembled elasticity, divdiv/epseps/mass and mixed
bilaplacian operators to 1e-13; the block ``slot_reduce`` twin against
``index_add_`` (and bit for bit on the card, a case that skips without
one); the block ``FemProblem`` methods (body force, traction, face
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
from arcanefem_tpu_torch.sparse.bell import BlockAssembly, assemble_bell, block_layout

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [2, 3])
def test_block_slot_reduce_twin_matches_index_add(dtype, b):
    """block_slot_reduce (its plain twin on the CPU) equals one
    index_add_ of every contributor's b² entries into its node slot,
    scattered through dst; the expanded padding slots stay 0."""
    mesh = rect_tria_mesh(9, 7) if b == 2 else box_tetra_mesh(4, 3, 3)
    prob = FemProblem(mesh, ndof=b, device="cpu", dtype=dtype)
    asm = prob.block_assembly
    gen = torch.Generator().manual_seed(b)
    E = int(asm.ids.numel())
    table = (torch.rand(E * b * b, generator=gen, dtype=torch.float64) - 0.5).to(dtype)
    sr.reset_launch_counts()
    out = asm.reduce(table)
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 0}
    counts = (asm.ptr[1:] - asm.ptr[:-1]).long()
    node_slot = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    ref = torch.zeros((counts.numel(), b * b), dtype=torch.float64).index_add_(
        0, node_slot, table.view(-1, b * b)[asm.ids.long()].double())
    want = torch.zeros(prob.layout.n_slots, dtype=torch.float64)
    want[asm.dst.long()] = ref.view(-1)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    _close(out.double(), want, tol)
    assert out.dtype == dtype
    assert not out[torch.as_tensor(~prob.layout.real)].any()
    assert torch.equal(out, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table, asm.dst,
                                                       asm.n_out, b))
    with pytest.raises(ValueError):
        sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.dst, asm.n_out, 4)
    with pytest.raises(ValueError):
        sr.block_slot_reduce(asm.ptr, asm.ids, table, asm.dst[:-1], asm.n_out, b)
    with pytest.raises(TypeError):
        sr.block_slot_reduce(asm.ptr, asm.ids.long(), table, asm.dst, asm.n_out, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_slot_reduce_on_cuda(dtype):
    """On the card: the kernel equals its twin bit for bit, once and
    again, with one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    cuda = torch.device("cuda")
    prob = FemProblem(box_tetra_mesh(6, 5, 5), ndof=3, device=cuda, dtype=dtype)
    asm = prob.block_assembly
    gen = torch.Generator().manual_seed(3)
    table = (torch.rand(asm.ids.numel() * 9, generator=gen, dtype=torch.float64)
             - 0.5).to(dtype).to(cuda)
    sr.reset_launch_counts()
    y, y2 = asm.reduce(table), asm.reduce(table)
    torch.cuda.synchronize()
    assert sr.launch_counts() == {"slot_reduce": 0, "block_slot_reduce": 2}
    assert torch.equal(y, y2)
    assert torch.equal(y, sr.block_slot_reduce_plain(asm.ptr, asm.ids, table, asm.dst,
                                                     asm.n_out, 3))


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
    assert torch.equal(asm.dst, prob.block_assembly.dst)
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
