"""Gauss quadrature and isoparametric shape functions for the element zoo.

The counterpart of ``arcanefem_tpu/ops/quadrature.py`` (the reference's
FemShapeMethods, FemGaussQuadrature and GaussQuadrature.h tables,
femutils/ArcaneFemFunctions.h:1252-2878, femutils/GaussQuadrature.h).
The rules and shape tables (``REF_DIM`` through ``_shape_at``) are numpy
host constants per cell type, copied from the JAX module; the CPU tests
hold them bit-equal to the originals.  :func:`iso_geometry` is the only
per-cell work: the Jacobians, their determinants and inverses at every
Gauss point, batched over a bucket in plain torch on the cells' device.

Reference elements use gmsh node orderings.  The zoo: line2/3, tria3/6,
quad4/8, tetra4/10, hexa8/20, penta6 and pyramid5, with rules of 1-4
points per axis (``ninteg``).  The pyramid uses the rational basis on the
square-base pyramid (base (±1,±1,0), apex (0,0,1)) with a conical-product
rule: Gauss-Legendre² in the collapsed coordinates × Gauss-Jacobi(2,0)
along the axis.

The elasticity blocks of the JAX module, :func:`stiffness_blocks_iso`
and :func:`mass_blocks_iso` (passmo's general-element operators), are the
same Gauss-point contractions, plain torch ``einsum`` as the JAX module's
``jnp.einsum``; ``ops/gauss_state.py`` runs them on stored Gauss data,
in chunks of cells.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_G1 = 1.0 / np.sqrt(3.0)  # 2-pt Gauss-Legendre node

REF_DIM = {
    "line2": 1, "line3": 1,
    "tria3": 2, "tria6": 2, "quad4": 2, "quad8": 2,
    "tetra4": 3, "tetra10": 3, "hexa8": 3, "hexa20": 3,
    "penta6": 3, "pyramid5": 3,
}

# gmsh corner signs for tensor-product elements
_QUAD_SIGNS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
_HEX_SIGNS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64
)

# (pyramid axis rules are generated by _gauss_jacobi20_01; the 2-point
# nodes/weights quoted in the module docstring are its ninteg=2 output)


def _bary_perm_pts(*groups):
    """Simplex rule from (value-pattern, weight) groups.

    Each group is (bary_pattern, w): all distinct permutations of the
    barycentric multiset become points; (x, y[, z]) = pattern[1:].
    Returns (pts, wts) with w repeated per permutation.
    """
    from itertools import permutations

    pts, wts = [], []
    for pattern, w in groups:
        seen = set()
        for perm in permutations(pattern):
            if perm in seen:
                continue
            seen.add(perm)
            pts.append(perm[1:])
            wts.append(w)
    return np.array(pts, np.float64), np.array(wts, np.float64)


def _tri_rule(n: int):
    """Triangle rules, degree ≥ n (GaussQuadrature.h:141-186 role)."""
    if n == 1:
        return np.array([[1 / 3, 1 / 3]]), np.array([0.5])
    if n == 2:
        # 3-point edge-midpoint rule, degree 2 (GaussQuadrature.h order 2)
        return np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]]), np.full(3, 1 / 6)
    if n == 3:
        # 4-point degree-3 rule (centroid + 3), negative centroid weight
        return _bary_perm_pts(
            ((1 / 3, 1 / 3, 1 / 3), -27 / 96),
            ((0.6, 0.2, 0.2), 25 / 96),
        )
    if n == 4:
        # Dunavant degree-4 6-point rule (weights × area 1/2)
        return _bary_perm_pts(
            ((0.108103018168070, 0.445948490915965, 0.445948490915965),
             0.223381589678011 / 2),
            ((0.816847572980459, 0.091576213509771, 0.091576213509771),
             0.109951743655322 / 2),
        )
    raise NotImplementedError(f"no triangle rule for ninteg={n}")


def _tet_rule(n: int):
    """Tetrahedron rules, orders 1-4 (GaussQuadrature.h:191-243 role)."""
    if n == 1:
        return np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6])
    if n == 2:
        a, b = 0.5854101966249685, 0.1381966011250105
        pts = np.array([[a, b, b], [b, a, b], [b, b, a], [b, b, b]])
        return pts, np.full(4, 1 / 24)
    if n == 3:
        # 5-point degree-3 rule, negative centroid weight
        return _bary_perm_pts(
            ((0.25, 0.25, 0.25, 0.25), -2 / 15),
            ((0.5, 1 / 6, 1 / 6, 1 / 6), 3 / 40),
        )
    if n == 4:
        # 15-point degree-5 rule (Stroud T3:5-1 / Keast), weights × vol 1/6
        s15 = np.sqrt(15.0)
        a2 = (7 + s15) / 34
        a3 = (7 - s15) / 34
        a4 = (10 - 2 * s15) / 40
        return _bary_perm_pts(
            ((0.25, 0.25, 0.25, 0.25), 8 / 405),
            ((1 - 3 * a2, a2, a2, a2), (2665 - 14 * s15) / 226800),
            ((1 - 3 * a3, a3, a3, a3), (2665 + 14 * s15) / 226800),
            ((0.5 - a4, 0.5 - a4, a4, a4), 5 / 567),
        )
    raise NotImplementedError(f"no tetrahedron rule for ninteg={n}")


def _gauss_jacobi20_01(n: int):
    """n-point Gauss-Jacobi(2,0) rule on [0,1]: ∫₀¹ (1−t)² f(t) dt."""
    import scipy.special

    x, w = scipy.special.roots_jacobi(n, 2, 0)
    return (x + 1.0) / 2.0, w / 8.0


@lru_cache(maxsize=None)
def rule(cell_type: str, ninteg: int = 2):
    """(points (ng, rdim), weights (ng,)) numpy constants.

    ninteg ∈ {1,2,3,4} mirrors the reference's gauss-nint option (default 2,
    modules/passmo/Elastodynamic.axl:448; tables GaussQuadrature.h:44-316).
    Tensor-product cells use ninteg-point Gauss-Legendre per axis; simplices
    use compact rules of matching degree; penta = triangle × line and
    pyramid = Gauss-Legendre² × Gauss-Jacobi(2,0) conical products.
    """
    if not 1 <= ninteg <= 4:
        raise NotImplementedError(
            f"ninteg={ninteg} not supported (rules wired for 1-4)"
        )
    gx, gw = np.polynomial.legendre.leggauss(ninteg)
    if cell_type in ("line2", "line3"):
        return gx[:, None], gw
    if cell_type in ("tria3", "tria6"):
        return _tri_rule(ninteg)
    if cell_type in ("quad4", "quad8"):
        pts = np.array([[x, y] for x in gx for y in gx])
        wts = np.array([wx * wy for wx in gw for wy in gw])
        return pts, wts
    if cell_type in ("tetra4", "tetra10"):
        return _tet_rule(ninteg)
    if cell_type in ("hexa8", "hexa20"):
        pts = np.array([[x, y, z] for x in gx for y in gx for z in gx])
        wts = np.array([wx * wy * wz for wx in gw for wy in gw for wz in gw])
        return pts, wts
    if cell_type == "penta6":
        tri, tw = _tri_rule(ninteg)
        pts, wts = [], []
        for zi, zw in zip(gx, gw):
            for (x, y), w in zip(tri, tw):
                pts.append([x, y, zi])
                wts.append(w * zw)
        return np.array(pts), np.array(wts)
    if cell_type == "pyramid5":
        jx, jw = _gauss_jacobi20_01(ninteg)
        pts, wts = [], []
        for zi, zw in zip(jx, jw):
            s = 1.0 - zi
            for u, wu in zip(gx, gw):
                for v, wv in zip(gx, gw):
                    pts.append([u * s, v * s, zi])
                    wts.append(zw * wu * wv)
        return np.array(pts), np.array(wts)
    raise NotImplementedError(f"no quadrature rule for '{cell_type}'")


@lru_cache(maxsize=None)
def shape_tables(cell_type: str, ninteg: int = 2):
    """(N (ng, npc), dN (ng, npc, rdim)) numpy constants at the rule points."""
    pts, _ = rule(cell_type, ninteg)
    return _shape_at(cell_type, pts)


def _shape_at(cell_type: str, pts: np.ndarray):
    ng = pts.shape[0]
    if cell_type == "line2":
        x = pts[:, 0]
        N = np.stack([(1 - x) / 2, (1 + x) / 2], axis=1)
        dN = np.tile(np.array([[-0.5], [0.5]])[None], (ng, 1, 1))
        return N, dN
    if cell_type == "line3":
        # gmsh node order: end(ξ=-1), end(ξ=+1), mid(ξ=0)
        x = pts[:, 0]
        N = np.stack([x * (x - 1) / 2, x * (x + 1) / 2, 1 - x * x], axis=1)
        dN = np.stack([x - 0.5, x + 0.5, -2 * x], axis=1)[:, :, None]
        return N, dN
    if cell_type == "tria3":
        x, y = pts[:, 0], pts[:, 1]
        N = np.stack([1 - x - y, x, y], axis=1)
        dN = np.tile(
            np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])[None], (ng, 1, 1)
        )
        return N, dN
    if cell_type == "quad4":
        x, y = pts[:, 0], pts[:, 1]
        sx, sy = _QUAD_SIGNS[:, 0], _QUAD_SIGNS[:, 1]
        N = 0.25 * (1 + x[:, None] * sx) * (1 + y[:, None] * sy)
        dN = np.stack(
            [0.25 * sx * (1 + y[:, None] * sy), 0.25 * sy * (1 + x[:, None] * sx)],
            axis=2,
        )
        return N, dN
    if cell_type == "tetra4":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        N = np.stack([1 - x - y - z, x, y, z], axis=1)
        d = np.array(
            [[-1, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64
        )
        return N, np.tile(d[None], (ng, 1, 1))
    if cell_type == "hexa8":
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        sx, sy, sz = _HEX_SIGNS[:, 0], _HEX_SIGNS[:, 1], _HEX_SIGNS[:, 2]
        fx = 1 + x[:, None] * sx
        fy = 1 + y[:, None] * sy
        fz = 1 + z[:, None] * sz
        N = 0.125 * fx * fy * fz
        dN = np.stack(
            [0.125 * sx * fy * fz, 0.125 * sy * fx * fz, 0.125 * sz * fx * fy],
            axis=2,
        )
        return N, dN
    if cell_type == "penta6":
        # gmsh wedge: triangle (x,y) × line z ∈ [−1,1]; nodes 0-2 at z=−1
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        t = np.stack([1 - x - y, x, y], axis=1)  # (ng, 3)
        dt = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        lo, hi = (1 - z) / 2, (1 + z) / 2
        N = np.concatenate([t * lo[:, None], t * hi[:, None]], axis=1)
        dN = np.zeros((ng, 6, 3))
        for k in range(3):
            dN[:, k, :2] = dt[k] * lo[:, None]
            dN[:, 3 + k, :2] = dt[k] * hi[:, None]
            dN[:, k, 2] = -0.5 * t[:, k]
            dN[:, 3 + k, 2] = 0.5 * t[:, k]
        return N, dN
    if cell_type == "pyramid5":
        # rational basis on base (±1,±1,0), apex (0,0,1):
        # N_i = (t1+sx·x)(t1+sy·y)/(4 t1), t1 = 1−z; N_4 = z
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        t1 = 1.0 - z
        sx, sy = _QUAD_SIGNS[:, 0], _QUAD_SIGNS[:, 1]
        fx = t1[:, None] + x[:, None] * sx
        fy = t1[:, None] + y[:, None] * sy
        N = np.concatenate(
            [fx * fy / (4 * t1[:, None]), z[:, None]], axis=1
        )
        dN = np.zeros((ng, 5, 3))
        dN[:, :4, 0] = sx * fy / (4 * t1[:, None])
        dN[:, :4, 1] = sy * fx / (4 * t1[:, None])
        dN[:, :4, 2] = (
            fx * fy / (4 * t1[:, None] ** 2) - (fx + fy) / (4 * t1[:, None])
        )
        dN[:, 4, 2] = 1.0
        return N, dN
    if cell_type == "tria6":
        # gmsh: corners 0-2, midsides 3=(0,1), 4=(1,2), 5=(2,0)
        x, y = pts[:, 0], pts[:, 1]
        L = np.stack([1 - x - y, x, y], axis=1)
        dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        edges = [(0, 1), (1, 2), (2, 0)]
        N = np.concatenate(
            [L * (2 * L - 1)]
            + [4 * (L[:, a] * L[:, b])[:, None] for a, b in edges], axis=1
        )
        dN = np.zeros((ng, 6, 2))
        for i in range(3):
            dN[:, i] = (4 * L[:, i, None] - 1) * dL[i]
        for k, (a, b) in enumerate(edges):
            dN[:, 3 + k] = 4 * (L[:, a, None] * dL[b] + L[:, b, None] * dL[a])
        return N, dN
    if cell_type == "tetra10":
        # gmsh: corners 0-3, edges 4=(0,1) 5=(1,2) 6=(0,2) 7=(0,3) 8=(2,3) 9=(1,3)
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        L = np.stack([1 - x - y - z, x, y, z], axis=1)
        dL = np.array(
            [[-1, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64
        )
        edges = [(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)]
        N = np.concatenate(
            [L * (2 * L - 1)]
            + [4 * (L[:, a] * L[:, b])[:, None] for a, b in edges], axis=1
        )
        dN = np.zeros((ng, 10, 3))
        for i in range(4):
            dN[:, i] = (4 * L[:, i, None] - 1) * dL[i]
        for k, (a, b) in enumerate(edges):
            dN[:, 4 + k] = 4 * (L[:, a, None] * dL[b] + L[:, b, None] * dL[a])
        return N, dN
    if cell_type == "quad8":
        # serendipity; gmsh midsides 4=(0,1) 5=(1,2) 6=(2,3) 7=(3,0)
        x, y = pts[:, 0], pts[:, 1]
        sx, sy = _QUAD_SIGNS[:, 0], _QUAD_SIGNS[:, 1]
        N = np.zeros((ng, 8))
        dN = np.zeros((ng, 8, 2))
        fx = 1 + x[:, None] * sx
        fy = 1 + y[:, None] * sy
        N[:, :4] = 0.25 * fx * fy * (x[:, None] * sx + y[:, None] * sy - 1)
        dN[:, :4, 0] = 0.25 * sx * fy * (2 * x[:, None] * sx + y[:, None] * sy)
        dN[:, :4, 1] = 0.25 * sy * fx * (x[:, None] * sx + 2 * y[:, None] * sy)
        mids = [(0.0, -1.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0)]
        for k, (mx, my) in enumerate(mids):
            i = 4 + k
            if mx == 0.0:
                N[:, i] = 0.5 * (1 - x * x) * (1 + y * my)
                dN[:, i, 0] = -x * (1 + y * my)
                dN[:, i, 1] = 0.5 * (1 - x * x) * my
            else:
                N[:, i] = 0.5 * (1 + x * mx) * (1 - y * y)
                dN[:, i, 0] = 0.5 * mx * (1 - y * y)
                dN[:, i, 1] = -y * (1 + x * mx)
        return N, dN
    if cell_type == "hexa20":
        # serendipity; gmsh edge order (0,1)(0,3)(0,4)(1,2)(1,5)(2,3)
        # (2,6)(3,7)(4,5)(4,7)(5,6)(6,7)
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        sx, sy, sz = _HEX_SIGNS[:, 0], _HEX_SIGNS[:, 1], _HEX_SIGNS[:, 2]
        N = np.zeros((ng, 20))
        dN = np.zeros((ng, 20, 3))
        fx = 1 + x[:, None] * sx
        fy = 1 + y[:, None] * sy
        fz = 1 + z[:, None] * sz
        s = x[:, None] * sx + y[:, None] * sy + z[:, None] * sz
        N[:, :8] = 0.125 * fx * fy * fz * (s - 2)
        dN[:, :8, 0] = 0.125 * sx * fy * fz * (s - 2 + fx)
        dN[:, :8, 1] = 0.125 * sy * fx * fz * (s - 2 + fy)
        dN[:, :8, 2] = 0.125 * sz * fx * fy * (s - 2 + fz)
        hex_edges = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
                     (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
        for k, (a, b) in enumerate(hex_edges):
            m = 0.5 * (_HEX_SIGNS[a] + _HEX_SIGNS[b])  # midside coordinate
            comps = np.array([x, y, z])  # (3, ng)
            zero_ax = int(np.where(m == 0)[0][0])
            u = comps[zero_ax]
            quad = 1 - u * u
            lin = np.ones(ng)
            for ax in range(3):
                if ax != zero_ax:
                    lin = lin * (1 + comps[ax] * m[ax])
            i = 8 + k
            N[:, i] = 0.25 * quad * lin
            for ax in range(3):
                if ax == zero_ax:
                    dN[:, i, ax] = 0.25 * (-2 * u) * lin
                else:
                    other = [a2 for a2 in range(3) if a2 not in (zero_ax, ax)][0]
                    dN[:, i, ax] = (
                        0.25 * quad * m[ax] * (1 + comps[other] * m[other])
                    )
        return N, dN
    raise NotImplementedError(f"no shape functions for '{cell_type}'")


def _det_inv(J: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """det and inverse of a batch (..., d, d), d in 1-3, in closed form
    (cofactors over the determinant): elementwise torch, where the JAX
    module calls ``jnp.linalg.det``/``inv``; the CPU tests hold the two to
    round-off."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        return det, (1.0 / det)[..., None, None]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2)
        return det, inv / det[..., None, None]
    if d != 3:
        raise ValueError(f"no closed-form inverse for {d}x{d}")
    j = [[J[..., r, s] for s in range(3)] for r in range(3)]
    # cofactor C[r][s] of entry (r, s); inv = C^T / det
    C = [[j[(r + 1) % 3][(s + 1) % 3] * j[(r + 2) % 3][(s + 2) % 3]
          - j[(r + 1) % 3][(s + 2) % 3] * j[(r + 2) % 3][(s + 1) % 3]
          for s in range(3)] for r in range(3)]
    det = j[0][0] * C[0][0] + j[0][1] * C[0][1] + j[0][2] * C[0][2]
    inv = torch.stack([torch.stack([C[s][r] for s in range(3)], -1)
                       for r in range(3)], -2)
    return det, inv / det[..., None, None]


def iso_geometry(cell_type: str, xyz: torch.Tensor, dim: int, ninteg: int = 2):
    """Batched isoparametric geometry at every Gauss point.

    xyz: (nc, npc, 3) vertex coordinates; uses the first ``dim``
    components.  Returns (N (ng, npc) numpy constant, grads (ng, nc, npc,
    dim), wdet (ng, nc)) with wdet = w_g · |det J|, in xyz's dtype and on
    its device.
    """
    N, dN = shape_tables(cell_type, ninteg)
    _, w = rule(cell_type, ninteg)
    X = xyz[..., :dim]  # (nc, npc, dim)
    dNj = torch.as_tensor(dN, dtype=xyz.dtype, device=xyz.device)
    # J[g,c,r,d] = Σ_n dN[g,n,r] X[c,n,d]
    J = torch.einsum("gnr,cnd->gcrd", dNj, X)
    detJ, invJ = _det_inv(J)
    # chain rule: dN_x[d] = Σ_r (J⁻¹)[d,r] dN_ξ[r]
    grads = torch.einsum("gcdr,gnr->gcnd", invJ, dNj)
    wdet = detJ.abs() * torch.as_tensor(w, dtype=xyz.dtype, device=xyz.device)[:, None]
    return N, grads, wdet


def _per_cell(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or a (nc,)/(1, nc) per-cell value as a tensor that
    broadcasts against (ng, nc) Gauss weights ``like``."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def elastic_blocks(grads: torch.Tensor, wdet: torch.Tensor, lam, mu) -> torch.Tensor:
    """Σ_g w·detJ·(λ divdiv + 2μ ε:ε) -> (nc, npc, npc, d, d) from the
    Gauss gradients (ng, nc, npc, d) and weights (ng, nc); ``lam``/``mu``
    scalars or per-cell (broadcasting against (ng, nc))."""
    lamc = _per_cell(lam, wdet) * wdet  # (g, c)
    muc = _per_cell(mu, wdet) * wdet
    t_div = torch.einsum("gc,gcia,gcjb->cijab", lamc, grads, grads)
    t_eps1 = torch.einsum("gc,gcib,gcja->cijab", muc, grads, grads)
    dot = torch.einsum("gc,gcik,gcjk->gcij", muc, grads, grads)
    eye = torch.eye(grads.shape[-1], dtype=grads.dtype, device=grads.device)
    t_eps2 = torch.einsum("gcij,ab->cijab", dot, eye)
    return t_div + t_eps1 + t_eps2


def mass_blocks_from(N, wdet: torch.Tensor, rho, dim: int) -> torch.Tensor:
    """Σ_g w·detJ·ρ·N_i N_j · I_d -> (nc, npc, npc, d, d) from the shape
    values N (ng, npc) and the Gauss weights (ng, nc)."""
    Nj = torch.as_tensor(N, dtype=wdet.dtype, device=wdet.device)
    rhoc = _per_cell(rho, wdet) * wdet
    m = torch.einsum("gc,gi,gj->cij", rhoc, Nj, Nj)
    eye = torch.eye(dim, dtype=wdet.dtype, device=wdet.device)
    return m[:, :, :, None, None] * eye[None, None, None]


def stiffness_blocks_iso(cell_type: str, xyz: torch.Tensor, lam, mu, dim: int,
                         ninteg: int = 2) -> torch.Tensor:
    """Elasticity blocks Σ_g w·detJ·(λ divdiv + 2μ ε:ε) -> (nc,npc,npc,d,d).

    lam/mu: scalars or (nc,) per-cell values (passmo's per-cell material
    variables, modules/passmo ElastodynamicModule.cc m_lambda/m_mu)."""
    _, grads, wdet = iso_geometry(cell_type, xyz, dim, ninteg)
    return elastic_blocks(grads, wdet, lam, mu)


def mass_blocks_iso(cell_type: str, xyz: torch.Tensor, rho, dim: int,
                    ninteg: int = 2) -> torch.Tensor:
    """Consistent mass blocks Σ_g w·detJ·ρ·N_i N_j · I_d."""
    N, _, wdet = iso_geometry(cell_type, xyz, dim, ninteg)
    return mass_blocks_from(N, wdet, rho, dim)
