"""ops/geometry.py and ops/elements.py against the JAX package's, in
float64 on random tria3, quad4 and tetra4 cells (and line2/tria3 boundary
faces), to 1e-13 of each output's largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.ops import elements as jel
from arcanefem_tpu.ops import geometry as jgeo
from arcanefem_tpu_torch.ops import elements as el
from arcanefem_tpu_torch.ops import geometry as geo

RTOL = 1e-13
NPC = {"line2": 2, "tria3": 3, "quad4": 4, "tetra4": 4}


def _cells(kind: str, n: int = 64, seed: int = 0) -> np.ndarray:
    """Random cells: planar (z=0) for tria3 and quad4 (quads convex, from
    a jittered square), 3D for tetra4, line2 and the tria3 faces."""
    rng = np.random.RandomState(seed)
    if kind == "quad4":
        sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
        xy = sq[None] * rng.uniform(0.5, 2.0, (n, 1, 2)) + rng.uniform(-0.15, 0.15, (n, 4, 2))
        xy += rng.uniform(-5, 5, (n, 1, 2))
        return np.concatenate([xy, np.zeros((n, 4, 1))], axis=2)
    xyz = rng.uniform(-2, 2, (n, NPC[kind.split("_")[0]], 3))
    if kind == "tria3":
        xyz[..., 2] = 0.0
    return xyz


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _both(fn_port, fn_jax, xyz, *args):
    return fn_port(torch.as_tensor(xyz), *args), fn_jax(jnp.asarray(xyz), *args)


GEOMETRY = [
    ("tria3_area", "tria3"), ("tria3_area", "tria3_faces"),
    ("tria3_area2_signed", "tria3"), ("tetra4_volume6_signed", "tetra4"),
    ("tetra4_volume", "tetra4"), ("tria3_gradients", "tria3"),
    ("quad4_area2_signed", "quad4"), ("quad4_area", "quad4"),
    ("quad4_gradients", "quad4"), ("tetra4_gradients", "tetra4"),
    ("edge2_length", "line2"), ("edge2_normal", "line2"),
    ("tria3_normal", "tria3_faces"), ("barycenter", "tetra4"),
    ("barycenter", "quad4"),
]


@pytest.mark.parametrize("fn,kind", GEOMETRY)
def test_geometry_matches_jax(fn, kind):
    got, want = _both(getattr(geo, fn), getattr(jgeo, fn), _cells(kind))
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


ELEMENTS = [
    ("stiffness_tria3", "tria3"), ("stiffness_tetra4", "tetra4"),
    ("stiffness_quad4", "quad4"), ("mass_tria3", "tria3"),
    ("mass_tetra4", "tetra4"), ("edge2_mass", "line2"),
]


@pytest.mark.parametrize("fn,kind", ELEMENTS)
def test_element_matrices_match_jax(fn, kind):
    _close(*_both(getattr(el, fn), getattr(jel, fn), _cells(kind)))


@pytest.mark.parametrize("kind", ["tria3", "quad4", "tetra4"])
@pytest.mark.parametrize("fn", ["stiffness", "measure", "gradients", "mass",
                                "divdiv", "epseps"])
def test_dispatchers_match_jax(fn, kind):
    xyz = _cells(kind, seed=1)
    if fn == "mass" and kind == "quad4":
        with pytest.raises(ValueError):
            el.mass(kind, torch.as_tensor(xyz))
        return
    got, want = _both(lambda x: getattr(el, fn)(kind, x),
                      lambda x: getattr(jel, fn)(kind, x), xyz)
    for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
        _close(g, w)


@pytest.mark.parametrize("kind,ndof", [("tria3", 2), ("tetra4", 3)])
def test_block_elements_match_jax(kind, ndof):
    xyz = _cells(kind, seed=2)
    lam, mu2 = 1.7, 0.9
    fn = {"tria3": "elasticity_tria3", "tetra4": "elasticity_tetra4"}[kind]
    _close(*_both(getattr(el, fn), getattr(jel, fn), xyz, lam, mu2))
    _close(*_both(lambda x: el.mass_blocks(kind, x, ndof),
                  lambda x: jel.mass_blocks(kind, x, ndof), xyz))


def test_stiffness_iso_and_unknown_types_raise():
    """Every zoo type but the lines (and the three closed forms above) now
    goes through stiffness_iso, equal to JAX's to 1e-13 on an affine image
    of its reference cell (perturbed cells and every rule:
    test_torch_quadrature.py); a line or an unknown type still raises."""
    from arcanefem_tpu.ops.quadrature import REF_DIM
    from test_torch_quadrature import _ref_nodes

    rng = np.random.RandomState(3)
    for ctype in sorted(t for t in REF_DIM if not t.startswith("line")):
        if ctype in ("tria3", "tetra4", "quad4"):
            continue
        M = np.eye(3) + 0.1 * rng.uniform(-1, 1, (3, 3))
        if REF_DIM[ctype] == 2:
            M[2], M[:, 2] = 0.0, 0.0
        xyz = np.stack([_ref_nodes(ctype) @ M.T + k for k in range(2)])
        _close(el.stiffness(ctype, torch.as_tensor(xyz)), jel.stiffness(ctype, jnp.asarray(xyz)))
    xyz = torch.zeros((2, 10, 3), dtype=torch.float64)
    for ctype in ("line2", "line3", "prism9"):
        with pytest.raises(ValueError):
            el.stiffness(ctype, xyz)
