"""The port's partition (arcanefem_tpu_torch/parallel/partition.py) and
slab plans against the JAX package's, with exact equality: the RCB part
ids and every stacked shard array of ``build_sharded`` on tetra boxes and
tria rects at P = 1, 2, 3, 4 and 8, and ``plan_slabs``/``plan_mg_slabs``
with their coordinate and mask slabs on a structured box.  Every later
comparison of the sharded paths relies on these being equal bit for bit."""

import numpy as np
import pytest

from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box, rect_tria_mesh as jax_rect
from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.parallel import partition as jpart
from arcanefem_tpu.parallel import structured_mg as jmg
from arcanefem_tpu.parallel import structured_sharded as jslab
from arcanefem_tpu.parallel.block_sharded import stacked_dof_mask as jax_dof_mask
from arcanefem_tpu.parallel.sharded import stacked_node_mask as jax_node_mask
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.mesh.structured import StructuredBox
from arcanefem_tpu_torch.parallel import partition, structured_mg, structured_sharded
from arcanefem_tpu_torch.parallel.block_sharded import stacked_dof_mask
from arcanefem_tpu_torch.parallel.sharded import stacked_node_mask

MESHES = {
    "box": (lambda: box_tetra_mesh(6, 5, 4), lambda: jax_box(6, 5, 4)),
    "box_lx": (lambda: box_tetra_mesh(7, 3, 4, 2.0, 1.0, 0.5),
               lambda: jax_box(7, 3, 4, 2.0, 1.0, 0.5)),
    "rect": (lambda: rect_tria_mesh(12, 9), lambda: jax_rect(12, 9)),
}
PARTS = (1, 2, 3, 4, 8)
SCALARS = ("n_parts", "n_nodes", "ndof", "width", "n_own_max", "h_max", "s_max")
ARRAYS = ("part", "n_own", "owned_global", "ell_cols", "diag_slot", "row_valid",
          "send_idx", "halo_src")
BUCKETS = ("cells_xyz", "slot_map", "rhs_map", "cell_offsets")


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_partition_nodes_rcb_matches_jax(name, P):
    mesh, jmesh = (f() for f in MESHES[name])
    np.testing.assert_array_equal(mesh.coords, jmesh.coords)
    _equal(partition.partition_nodes_rcb(mesh.coords, P),
           jpart.partition_nodes_rcb(jmesh.coords, P), "part")


def test_partition_nodes_rcb_matches_jax_on_random_points():
    coords = np.random.RandomState(0).rand(1000, 3)
    for P in PARTS + (5, 7):
        _equal(partition.partition_nodes_rcb(coords, P),
               jpart.partition_nodes_rcb(coords, P), f"part P={P}")


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_sharded_matches_jax(name, P):
    mesh, jmesh = (f() for f in MESHES[name])
    sp, jsp = partition.build_sharded(mesh, P), jpart.build_sharded(jmesh, P)
    for k in SCALARS:
        assert getattr(sp, k) == getattr(jsp, k), k
    for k in ARRAYS:
        _equal(getattr(sp, k), getattr(jsp, k), k)
    for k in BUCKETS:
        got, want = getattr(sp, k), getattr(jsp, k)
        assert list(got) == list(want), k
        for bucket in want:
            _equal(got[bucket], want[bucket], f"{k}[{bucket}]")
    x = np.random.RandomState(P).rand(P, sp.n_own_max)
    _equal(sp.scatter_global(x), jsp.scatter_global(x), "scatter_global")


@pytest.mark.parametrize("P", (2, 3))
def test_stacked_masks_match_jax(P):
    mesh, jmesh = box_tetra_mesh(6, 5, 4), jax_box(6, 5, 4)
    sp, jsp = partition.build_sharded(mesh, P), jpart.build_sharded(jmesh, P)
    nodes = np.concatenate([mesh.group_nodes("xmin"), mesh.group_nodes("ymax")])
    vals = np.arange(len(nodes), dtype=np.float64)
    for got, want in zip(stacked_node_mask(sp, nodes, vals),
                         jax_node_mask(jsp, nodes, vals)):
        _equal(got, want, "stacked_node_mask")
    sets = [(mesh.group_nodes("xmin"), c, 0.5 * c) for c in range(3)]
    for got, want in zip(stacked_dof_mask(sp, 3, sets), jax_dof_mask(jsp, 3, sets)):
        _equal(got, want, "stacked_dof_mask")


@pytest.mark.parametrize("n_dev", (1, 2, 4))
def test_slab_plans_match_jax(n_dev):
    """plan_slabs and plan_mg_slabs on a 16·n_dev x 8 x 12 box (and 224
    along x, the bench box's divisor rule), with the coordinate and mask
    slabs they cut."""
    dims = (16 * n_dev, 8, 12)
    box, jbox = StructuredBox(*dims), JaxBox(*dims)
    plan, jplan = (structured_sharded.plan_slabs(box, n_dev),
                   jslab.plan_slabs(jbox, n_dev))
    assert (plan.n_dev, plan.px, plan.own_planes, plan.plane) == \
        (jplan.n_dev, jplan.px, jplan.own_planes, jplan.plane)
    c3d = box.grid_coords(np.float64, jitter=0.1)
    np.testing.assert_array_equal(c3d, jbox.grid_coords(np.float64, jitter=0.1))
    _equal(structured_sharded.slab_coords(plan, c3d), jslab.slab_coords(jplan, c3d),
           "slab_coords")
    mask = box.boundary_mask(("xmin", "xmax"))
    vals = np.arange(box.n_nodes, dtype=np.float64)
    for got, want in zip(structured_sharded.slab_mask_values(plan, mask, vals),
                         jslab.slab_mask_values(jplan, mask, vals)):
        _equal(got, want, "slab_mask_values")
    xs = np.random.RandomState(1).rand(n_dev, plan.own_planes * plan.plane)
    _equal(structured_sharded.gather_global(plan, xs), jslab.gather_global(jplan, xs),
           "gather_global")
    mg, jmg_plan = structured_mg.plan_mg_slabs(box, n_dev), jmg.plan_mg_slabs(jbox, n_dev)
    assert len(mg.levels) == len(jmg_plan.levels) >= 2
    for lv, jlv in zip(mg.levels, jmg_plan.levels):
        assert (lv.box.nx, lv.box.ny, lv.box.nz, lv.px) == \
            (jlv.box.nx, jlv.box.ny, jlv.box.nz, jlv.px)
    for got, want in zip(structured_mg.mg_slab_coords(mg, c3d),
                         jmg.mg_slab_coords(jmg_plan, c3d)):
        _equal(got, want, "mg_slab_coords")
    for got, want in zip(structured_mg.mg_slab_masks(mg), jmg.mg_slab_masks(jmg_plan)):
        _equal(got, want, "mg_slab_masks")
    big = StructuredBox(224, 4, 4)
    assert [lv.px for lv in structured_mg.plan_mg_slabs(big, n_dev).levels] == \
        [lv.px for lv in jmg.plan_mg_slabs(JaxBox(224, 4, 4), n_dev).levels]


def test_plan_slabs_refuses_uneven_slabs():
    for plan in (structured_sharded.plan_slabs, jslab.plan_slabs):
        with pytest.raises(ValueError):
            plan(StructuredBox(10, 4, 4) if plan is structured_sharded.plan_slabs
                 else JaxBox(10, 4, 4), 4)
