"""ops/quadrature.py, ops/elements.py::stiffness_iso and
mesh/generate.py::quadratize against the JAX package on the CPU: the
rules and shape tables bit for bit for every cell type and ``ninteg``
1-4; ``iso_geometry`` (closed-form det and inverse here, ``jnp.linalg``
there) and ``stiffness_iso`` to 1e-13 of each output's largest magnitude
in float64 on seeded, perturbed cells of every type; ``quadratize``
exactly, face groups included, on tria3, quad4, tetra4 and hexa8 meshes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.mesh.core import Mesh as JaxMesh
from arcanefem_tpu.mesh.generate import quadratize as jax_quadratize
from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.ops import quadrature as jq
from arcanefem_tpu_torch.mesh.core import Mesh
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, quadratize, rect_tria_mesh
from arcanefem_tpu_torch.ops import elements as el
from arcanefem_tpu_torch.ops import quadrature as q
from arcanefem_tpu_torch.tools.write_msh import rect_quad_mesh

RTOL = 1e-13
CELLS = sorted(q.REF_DIM)
VOLUME_CELLS = [c for c in CELLS if not c.startswith("line")]


def test_ref_dim_equal():
    assert q.REF_DIM == jq.REF_DIM


@pytest.mark.parametrize("ninteg", [1, 2, 3, 4])
@pytest.mark.parametrize("cell", CELLS)
def test_rule_and_shape_tables_bit_equal(cell, ninteg):
    for got, want in zip((*q.rule(cell, ninteg), *q.shape_tables(cell, ninteg)),
                         (*jq.rule(cell, ninteg), *jq.shape_tables(cell, ninteg))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _ref_nodes(cell: str) -> np.ndarray:
    """The reference element's nodes in gmsh order, (npc, 3)."""
    quad = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)
    hexa = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], float)
    tri = np.array([[0, 0], [1, 0], [0, 1]], float)
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)

    def mids(corners, edges):
        return np.concatenate([corners, [(corners[a] + corners[b]) / 2 for a, b in edges]])

    table = {
        "line2": np.array([[-1.0], [1.0]]),
        "line3": np.array([[-1.0], [1.0], [0.0]]),
        "tria3": tri, "tria6": mids(tri, [(0, 1), (1, 2), (2, 0)]),
        "quad4": quad, "quad8": mids(quad, [(0, 1), (1, 2), (2, 3), (3, 0)]),
        "tetra4": tet,
        "tetra10": mids(tet, [(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)]),
        "hexa8": hexa,
        "hexa20": mids(hexa, [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
                              (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]),
        "penta6": np.concatenate([np.c_[tri, -np.ones(3)], np.c_[tri, np.ones(3)]]),
        "pyramid5": np.concatenate([np.c_[quad, np.zeros(4)], [[0.0, 0.0, 1.0]]]),
    }
    ref = table[cell]
    return np.concatenate([ref, np.zeros((len(ref), 3 - ref.shape[1]))], axis=1)


def _cells(cell: str, n: int = 24, seed: int = 0) -> np.ndarray:
    """n seeded cells: the reference element through a random affine map
    (determinant > 0, only the element's own dimensions) plus a node
    jitter of 3% of its size, shifted."""
    rng = np.random.RandomState(seed + CELLS.index(cell))
    dim = q.REF_DIM[cell]
    ref = _ref_nodes(cell)
    out = np.zeros((n, len(ref), 3))
    for k in range(n):
        M = np.eye(3)
        M[:dim, :dim] = np.eye(dim) * rng.uniform(0.5, 2.0) + 0.2 * rng.uniform(-1, 1, (dim, dim))
        x = ref @ M.T
        x[:, :dim] += 0.03 * rng.uniform(-1, 1, (len(ref), dim)) + rng.uniform(-3, 3, dim)
        out[k] = x
    return out


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("ninteg", [2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_iso_geometry_matches_jax(cell, ninteg):
    xyz = _cells(cell)
    dim = q.REF_DIM[cell]
    N, grads, wdet = q.iso_geometry(cell, torch.as_tensor(xyz), dim, ninteg)
    jN, jgrads, jwdet = jq.iso_geometry(cell, jnp.asarray(xyz), dim, ninteg)
    np.testing.assert_array_equal(N, jN)
    _close(grads, jgrads)
    _close(wdet, jwdet)


@pytest.mark.parametrize("cell", VOLUME_CELLS)
def test_stiffness_iso_matches_jax(cell):
    """stiffness_iso and the stiffness dispatcher (which sends tria3,
    quad4 and tetra4 to their closed forms, as JAX does)."""
    xyz = _cells(cell, seed=7)
    _close(el.stiffness_iso(cell, torch.as_tensor(xyz)), jel.stiffness_iso(cell, jnp.asarray(xyz)))
    _close(el.stiffness(cell, torch.as_tensor(xyz)), jel.stiffness(cell, jnp.asarray(xyz)))


def _hexa_box(nx, ny, nz) -> Mesh:
    """A structured hexa8 box with quad4 face groups xmin and zmax, and a
    node group."""
    coords = np.stack(np.meshgrid(np.arange(nx + 1.0), np.arange(ny + 1.0) * 0.5,
                                  np.arange(nz + 1.0) * 0.7, indexing="ij"), -1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny),
                                               np.arange(nz), indexing="ij"))
    hexa = np.stack([nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K), nid(I, J + 1, K),
                     nid(I, J, K + 1), nid(I + 1, J, K + 1), nid(I + 1, J + 1, K + 1),
                     nid(I, J + 1, K + 1)], 1).astype(np.int32)
    J2, K2 = (a.ravel() for a in np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij"))
    xmin = np.stack([nid(0, J2, K2), nid(0, J2 + 1, K2), nid(0, J2 + 1, K2 + 1),
                     nid(0, J2, K2 + 1)], 1).astype(np.int32)
    I3, J3 = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij"))
    zmax = np.stack([nid(I3, J3, nz), nid(I3 + 1, J3, nz), nid(I3 + 1, J3 + 1, nz),
                     nid(I3, J3 + 1, nz)], 1).astype(np.int32)
    return Mesh(coords=coords, node_uids=np.arange(1, len(coords) + 1, dtype=np.int64),
                cells={"hexa8": hexa}, dim=3,
                face_groups={"xmin": {"quad4": xmin}, "zmax": {"quad4": zmax}},
                node_groups={"corner": np.array([0, 5], np.int32)})


QUAD_MESHES = {
    "tria3": lambda: rect_tria_mesh(7, 5, lx=1.3),
    "quad4": lambda: rect_quad_mesh(6, 4, regions=True),
    "tetra4": lambda: box_tetra_mesh(3, 2, 4),
    "hexa8": lambda: _hexa_box(3, 2, 2),
}


@pytest.mark.parametrize("kind", sorted(QUAD_MESHES))
def test_quadratize_equal(kind):
    mesh = QUAD_MESHES[kind]()
    jmesh = JaxMesh(coords=mesh.coords, node_uids=mesh.node_uids, cells=mesh.cells,
                    dim=mesh.dim, face_groups=mesh.face_groups,
                    node_groups=mesh.node_groups, cell_groups=mesh.cell_groups)
    got, want = quadratize(mesh), jax_quadratize(jmesh)
    assert isinstance(got, Mesh) and got.dim == want.dim
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.node_uids, want.node_uids)
    assert got.node_uids.dtype == want.node_uids.dtype
    for name in ("cells", "face_groups", "cell_groups", "node_groups"):
        g, w = getattr(got, name), getattr(want, name)
        assert sorted(g) == sorted(w), name
        for k in w:
            if isinstance(w[k], dict):
                assert sorted(g[k]) == sorted(w[k])
                for t in w[k]:
                    assert g[k][t].dtype == w[k][t].dtype
                    np.testing.assert_array_equal(g[k][t], w[k][t])
            else:
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="no quadratic counterpart"):
        quadratize(got)
