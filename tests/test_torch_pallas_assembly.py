"""The gather assemblies (arcanefem_tpu_torch/sparse/pallas_assembly.py) and
TetraAssembler's ``reduce`` orders against the JAX package's
``assemble_bell``, on the CPU in float64 (PallasAssembler) and on the
float32 element table (ReorderedAssembler, TetraAssembler): each is the
same slot_reduce over its own order of each slot's contributors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcanefem_tpu.ops import elements as jax_elements
from arcanefem_tpu.sparse.bell import assemble_bell as jax_assemble_bell
from arcanefem_tpu.sparse.topology import build_topology as jax_build_topology
from arcanefem_tpu_torch.mesh.core import read_msh
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.ops import elements
from arcanefem_tpu_torch.ops.lane_assembly import REDUCES, TetraAssembler, tet_element
from arcanefem_tpu_torch.sparse import slot_reduce as sr
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.pallas_assembly import (
    PallasAssembler,
    ReorderedAssembler,
)
from arcanefem_tpu_torch.sparse.topology import build_topology
from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh, write_msh


def _jax_values(mesh, topo, dtype=np.float64):
    """JAX ``assemble_bell`` of the mesh's stiffness, as (N, W)."""
    jtopo = jax_build_topology(mesh.n_nodes, mesh.cells)
    coords = jnp.asarray(mesh.coords.astype(dtype))
    mats = {ct: jax_elements.stiffness(ct, coords[jnp.asarray(c)])
            for ct, c in mesh.cells.items()}
    return np.asarray(jax_assemble_bell(jtopo, mats, block=1, dtype=dtype).values
                      ).reshape(topo.n_nodes, topo.width)


def _mats(mesh, dtype=torch.float64):
    coords = torch.as_tensor(mesh.coords).to(dtype)
    return {ct: elements.stiffness(ct, coords[torch.as_tensor(c).long()])
            for ct, c in mesh.cells.items()}


@pytest.mark.parametrize("which", ["rect", "box", "mixed"])
def test_pallas_assembler_matches_jax(which, tmp_path):
    if which == "mixed":
        write_msh(str(tmp_path / "m.msh"), mixed_box_mesh(2, 2))
        mesh = read_msh(str(tmp_path / "m.msh"))
    else:
        mesh = rect_tria_mesh(9, 7) if which == "rect" else box_tetra_mesh(5, 4, 3)
    topo = build_topology(mesh.n_nodes, mesh.cells)
    pa = PallasAssembler(topo, device="cpu")
    assert pa.available
    sr.reset_launch_counts()
    vals = pa(_mats(mesh))
    A = BellMatrix(vals, pa.layout)
    want = _jax_values(mesh, topo)
    assert np.abs(A.ell_values().numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_reordered_and_reduce_orders_match_jax():
    """ReorderedAssembler and the three TetraAssembler reduce orders sum
    the same float32 table: within one float32 rounding of each other per
    slot, and of JAX's assemble_bell (float64 on the same coordinates) at
    float32's precision; each reduce is one slot_reduce over its lists."""
    mesh = box_tetra_mesh(6, 5, 4)
    jit = np.random.RandomState(0).rand(*mesh.coords.shape) * 0.04
    mesh.coords = mesh.coords + jit
    topo = build_topology(mesh.n_nodes, mesh.cells)
    coords = torch.as_tensor(mesh.coords).float()
    asms = {r: TetraAssembler(topo, mesh.cells["tetra4"], device="cpu", reduce=r)
            for r in REDUCES}
    ra = ReorderedAssembler(topo, mesh.cells["tetra4"], device="cpu",
                            layout=asms["window"].layout)
    assert ra.available
    ke10 = tet_element(coords, asms["window"].corner_cols)
    got = {r: a(coords) for r, a in asms.items()}
    got["reordered"] = ra(ke10)
    assert torch.equal(got["reordered"], got["reorder"])
    ref = got["window"]
    ulp = torch.finfo(torch.float32).eps * ref.abs()
    for r, v in got.items():
        assert v.dtype == torch.float32
        assert bool(((v - ref).abs() <= ulp).all()), r
    for r in REDUCES:  # the same contributors, in another order
        a, w = asms[r], asms["window"]
        assert torch.equal(a.ptr, w.ptr)
        for s in range(0, w.ptr.numel() - 1, 97):
            lo, hi = int(w.ptr[s]), int(w.ptr[s + 1])
            assert sorted(a.ids[lo:hi].tolist()) == sorted(w.ids[lo:hi].tolist())
    want = _jax_values(mesh, topo)
    ev = BellMatrix(ref, asms["window"].layout).ell_values().double().numpy()
    assert np.abs(ev - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="reduce"):
        TetraAssembler(topo, mesh.cells["tetra4"], device="cpu", reduce="atomic")
    with pytest.raises(ValueError, match="ke10"):
        ra(ke10.T)


def test_bench_asm_reduce_gives_the_window_iterations():
    """AFEM_UNSTR_ASM=segsum and =reorder reach the port bench's route
    options and solve the h=14 sphere in the window route's iterations,
    to the same x (the same operator: each slot's float64 sum of the same
    float32 entries)."""
    from arcanefem_tpu_torch import bench
    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system

    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    kw = dict(device="cpu", dtype=torch.float32, penalty=1e12)
    ref = solve_sphere_cut(mesh, topo, **kw)
    for order in ("segsum", "reorder"):
        opts = bench.primary_args({"AFEM_UNSTR_ASM": order})[3]
        res = solve_sphere_cut(mesh, topo, asm_reduce=opts["asm_reduce"], **kw)
        assert res["iterations"] == ref["iterations"]
        assert torch.equal(res["x"], ref["x"])
