"""P1 tetra assembly (arcanefem_tpu_torch/ops/lane_assembly.py and
sparse/bell.py::assemble_bell) against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
from arcanefem_tpu.sparse.bell import assemble_bell as jax_assemble_bell
from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
from arcanefem_tpu_torch.sparse.bell import assemble_bell


@pytest.mark.parametrize("h", [14.0, 8.0])
def test_tetra_assembly_matches_jax_segsum(h):
    """Both in f32; the scatter order differs, so the bound is
    1e-5·max|vals| on the largest difference."""
    mesh, topo = sphere_cut_system(h, 0, cache=False)
    conn = mesh.cells["tetra4"]
    coords = mesh.coords.astype(np.float32)
    want = np.asarray(TetraLaneAssembler(topo, conn, reduce="segsum")(
        jnp.asarray(coords)))
    asm = TetraAssembler(topo, conn, device="cpu")
    got = asm(torch.as_tensor(coords))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == (asm.layout.n_slots,)  # straight into SELL storage
    got = asm.layout.to_ell(got).numpy()
    assert got.shape == want.shape == (topo.n_nodes, topo.width)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # padding slots stay exactly zero
    assert not got[~topo.ell_valid].any()


def test_assemble_bell_matches_jax():
    """index_add_ over the slot maps == the JAX segment-sum, in f64."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    nc = mesh.cells["tetra4"].shape[0]
    ke = np.random.RandomState(0).rand(nc, 4, 4)
    want = np.asarray(jax_assemble_bell(
        topo, {"tetra4": jnp.asarray(ke)}, block=1).values).reshape(
            topo.n_nodes, topo.width)
    A = assemble_bell(topo, {"tetra4": torch.as_tensor(ke)}, device="cpu")
    np.testing.assert_allclose(A.ell_values().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(A.layout.ell_cols, topo.ell_cols)


@pytest.mark.parametrize("h", [14.0, 8.0])
def test_batched_coords_equal_split(h):
    """coords_batched (one K3a gather over the (N, 3) coordinates, read in
    place) == the split form (three K2 gathers), bit for bit: the same
    corners and the same assembled values."""
    mesh, topo = sphere_cut_system(h, 0, cache=False)
    conn = mesh.cells["tetra4"]
    coords = torch.as_tensor(mesh.coords)
    split = TetraAssembler(topo, conn, device="cpu")
    batched = TetraAssembler(topo, conn, device="cpu", coords_batched=True)
    gs, gb = split.gather_corners(coords), batched.gather_corners(coords)
    assert gb.shape == (3, 4 * conn.shape[0]) and gb.is_contiguous()
    for k in range(3):
        assert torch.equal(gs[k], gb[k])
        assert torch.equal(gb[k].reshape(4, -1).T,
                           coords[torch.as_tensor(conn), k].float())
    assert torch.equal(split(coords), batched(coords))
