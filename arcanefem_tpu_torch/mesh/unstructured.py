"""Unstructured tetrahedral mesh generation + uniform refinement (host).

The port's copy of ``arcanefem_tpu/mesh/unstructured.py``; the CPU tests
hold it to the original with exact equality.

The reference's north-star 3D benchmark mesh is ``sphere_cut``: a radius-100
sphere with the (+,+,+) octant box removed, meshed with tetrahedra and
scaled to ~10M DoF (reference meshes/med/sphere_cut.py — a Salome/Gmsh
recipe; groups "Cut" = the three flat cut faces, "sphere" = the spherical
surface).  Neither Salome nor Gmsh is available here, so we rebuild the
same geometry with a filtered Delaunay triangulation:

* quasi-uniform interior points (jittered grid) restricted to the domain,
* explicit boundary points on the sphere surface, the three cut planes,
  and the sharp feature curves (arcs + axes) so the boundary is crisp,
* scipy Delaunay, then drop tetrahedra whose centroid is outside.

``refine_tetra`` performs uniform 1->8 tetra subdivision (new node per
unique edge, the standard red refinement) so a moderate Delaunay mesh can
be scaled to benchmark size — the same scaling role as the reference's
mesh-size parameter sweep (modules/testlab/benchmarking/run-benchmark.sh).

The result is a genuinely unstructured mesh: irregular connectivity,
variable node degree, no exploitable stencil structure.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh

RADIUS = 100.0


def _inside(p: np.ndarray, margin: float) -> np.ndarray:
    """Mask of points at least `margin` inside the sphere-minus-octant
    domain: away from the sphere AND away from (or inside) the removed
    octant — min(p) > -margin means within `margin` of a cut face (or in
    the octant), so those points are dropped and the structured cut-face
    points own the boundary."""
    r = np.linalg.norm(p, axis=1)
    in_sphere = r < RADIUS - margin
    near_or_in_octant = np.min(p, axis=1) > -margin
    return in_sphere & ~near_or_in_octant


def _fibonacci_sphere(n: int, rng) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    p = np.stack(
        [
            np.sin(phi) * np.cos(theta),
            np.sin(phi) * np.sin(theta),
            np.cos(phi),
        ],
        axis=1,
    )
    return RADIUS * p


def _disk_points(h: float, rng) -> np.ndarray:
    """Jittered-grid points on the QUARTER disk {u≥0, v≥0, r<R} — the
    flat cut face of ball-minus-(+,+,+)-octant on each coordinate plane
    (on x=0 the face is {y≥0, z≥0}: points with min(y,z)<0 there are
    INTERIOR, not boundary) — plus its feature curves: the quarter arc
    and the two axis edges shared between adjacent cut faces."""
    n = int(RADIUS / h)
    u = np.linspace(0.0, RADIUS, n + 1)
    U, V = np.meshgrid(u, u, indexing="ij")
    pts = np.stack([U.ravel(), V.ravel()], axis=1)
    pts += rng.uniform(-0.3 * h, 0.3 * h, pts.shape)
    r = np.linalg.norm(pts, axis=1)
    keep = (
        (r < RADIUS - 0.6 * h)
        & (pts[:, 0] > 0.6 * h)
        & (pts[:, 1] > 0.6 * h)
    )
    interior = pts[keep]
    # quarter circle arc (the curved edge of the cut face)
    na = int(0.5 * np.pi * RADIUS / h)
    ang = np.linspace(0.0, 0.5 * np.pi, na + 1)
    arc = RADIUS * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    # the two straight feature edges (positive u and v axes; the origin
    # and arc endpoints dedup with their twins from the other planes)
    ne = int(RADIUS / h)
    t = np.linspace(0.0, RADIUS - h, ne)
    eu = np.stack([t, np.zeros_like(t)], axis=1)
    ev = np.stack([np.zeros_like(t), t], axis=1)
    return np.concatenate([interior, arc, eu, ev])


def sphere_cut_points(h: float, seed: int = 0) -> np.ndarray:
    """Quasi-uniform point cloud for the sphere_cut domain, spacing ~h."""
    rng = np.random.default_rng(seed)

    # interior: jittered BCC lattice.  A jittered CUBIC grid Delaunay is
    # sliver-prone (cubic lattices are degenerately co-spherical; the
    # jitter resolves ties into near-flat tets — measured q1% 0.026 on the
    # refined 300k mesh, driving AMG-PCG to 71 iterations).  The BCC
    # lattice's Delaunay is the high-quality disphenoid mesh; 10% jitter
    # keeps the connectivity genuinely irregular.  With the quarter-disk
    # cut faces (v3 geometry): q1% 0.021 at h5r1 and 19 (jacobi) / 14
    # (chebyshev) AMG-PCG iterations to 1e-8 — the earlier jagged cut
    # boundary alone cost 2x the iterations.  Cell size a = 2^(1/3)·h
    # matches the cubic-grid density.
    a = 2.0 ** (1.0 / 3.0) * h
    n = int(2 * RADIUS / a)
    u = np.linspace(-RADIUS, RADIUS, n + 1)
    X, Y, Z = np.meshgrid(u, u, u, indexing="ij")
    g1 = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    pts = np.concatenate([g1, g1 + 0.5 * a])
    pts += rng.uniform(-0.10 * a, 0.10 * a, pts.shape)
    interior = pts[_inside(pts, 0.6 * h)]

    # sphere surface (minus the cut octant)
    n_surf = int(4 * np.pi * RADIUS**2 / (0.8 * h) ** 2)
    sp = _fibonacci_sphere(n_surf, rng)
    sp = sp[~(np.min(sp, axis=1) > 0.5 * h)]

    # three cut planes: x=0, y=0, z=0 (3/4 disks, shared feature curves
    # deduplicated later through rounding)
    d = _disk_points(h, rng)
    zeros = np.zeros((len(d), 1))
    cuts = np.concatenate(
        [
            np.concatenate([zeros, d], axis=1),  # x = 0
            np.concatenate([d[:, :1], zeros, d[:, 1:]], axis=1),  # y = 0
            np.concatenate([d, zeros], axis=1),  # z = 0
        ]
    )

    all_pts = np.concatenate([interior, sp, cuts])
    # dedup near-coincident points (feature curves shared by planes)
    key = np.round(all_pts / (0.4 * h)).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return all_pts[np.sort(idx)]


def delaunay_mesh(points: np.ndarray, classify_boundary: bool = True) -> Mesh:
    """Delaunay-tetrahedralize a sphere_cut point cloud and trim to the
    domain; boundary faces classified into the reference's "Cut" /
    "sphere" groups by centroid position."""
    from scipy.spatial import Delaunay

    tri = Delaunay(points)
    tets = tri.simplices.astype(np.int32)
    cent = points[tets].mean(axis=1)
    r = np.linalg.norm(cent, axis=1)
    keep = (r < RADIUS) & ~(np.min(cent, axis=1) > 0.0)
    # drop near-degenerate slivers (flat Delaunay artifacts on surfaces)
    p = points[tets]
    v = p[:, 1:] - p[:, :1]
    vol6 = np.einsum(
        "ij,ij->i", np.cross(v[:, 0], v[:, 1]), v[:, 2]
    )
    edge = np.linalg.norm(p[:, 1] - p[:, 0], axis=1)
    keep &= np.abs(vol6) > 1e-4 * edge**3
    tets = tets[keep]
    # orient positively
    flip = vol6[keep] < 0
    tets[flip, 0], tets[flip, 1] = tets[flip, 1], tets[flip, 0].copy()

    # compact node numbering to referenced nodes only
    used = np.unique(tets)
    remap = np.full(len(points), -1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    mesh = Mesh(
        coords=points[used],
        node_uids=np.arange(1, len(used) + 1, dtype=np.int64),
        cells={"tetra4": remap[tets]},
        dim=3,
    )
    if classify_boundary:
        _classify_sphere_cut_boundary(mesh)
    return mesh


def _classify_sphere_cut_boundary(mesh: Mesh) -> None:
    """Split exterior faces into "Cut" (the three flat faces) and "sphere"
    groups — the same names the reference recipe assigns."""
    faces = mesh.boundary_faces().get("tria3", np.zeros((0, 3), np.int32))
    if not len(faces):
        return
    cent = mesh.coords[faces].mean(axis=1)
    r = np.linalg.norm(cent, axis=1)
    near_plane = np.min(np.abs(cent), axis=1)
    is_cut = near_plane < (RADIUS - r)  # closer to a cut plane than to the sphere
    mesh.face_groups["Cut"] = {"tria3": faces[is_cut]}
    mesh.face_groups["sphere"] = {"tria3": faces[~is_cut]}


def sphere_cut_tetra_mesh(h: float, seed: int = 0) -> Mesh:
    """The full recipe: points -> Delaunay -> trimmed, grouped Mesh."""
    return delaunay_mesh(sphere_cut_points(h, seed))


# --- uniform red refinement ------------------------------------------------

# child tets of the 1->8 split in terms of (corner 0..3, edge 0..5) local
# ids; edges in the gmsh tetra order used by generate._Q_EDGES:
#   e0=(0,1) e1=(1,2) e2=(0,2) e3=(0,3) e4=(2,3) e5=(1,3)
_TET_EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)]
# corners 0..3 -> local ids 0..3, edge k -> local id 4+k
_TET_CORNER_CHILDREN = [
    (0, 4, 6, 7),  # corner 0
    (4, 1, 5, 9),  # corner 1
    (6, 5, 2, 8),  # corner 2
    (7, 9, 8, 3),  # corner 3
]
# interior octahedron (vertices a..f = midpoints 4..9; opposite pairs are
# the diagonals (4,8), (5,7), (6,9)): split into 4 tets around ONE
# diagonal.  The diagonal is chosen per tet as the SHORTEST (standard
# quality-preserving red refinement — a fixed diagonal squares the worst
# aspect ratio under repeated refinement).
_TET_OCTA_CHILDREN = {
    0: [(4, 5, 6, 8), (4, 6, 7, 8), (4, 7, 9, 8), (4, 9, 5, 8)],  # diag 4-8
    1: [(5, 4, 6, 7), (5, 6, 8, 7), (5, 8, 9, 7), (5, 9, 4, 7)],  # diag 5-7
    2: [(6, 4, 5, 9), (6, 5, 8, 9), (6, 8, 7, 9), (6, 7, 4, 9)],  # diag 6-9
}
_TRI_EDGES = [(0, 1), (1, 2), (2, 0)]
_TRI_CHILDREN = [(0, 3, 5), (3, 1, 4), (5, 4, 2), (3, 4, 5)]


def refine_tetra(mesh: Mesh) -> Mesh:
    """Uniform red refinement: every tetra4 -> 8 children, every boundary
    tria3 face -> 4; one new node per unique edge (midpoint).

    The refinement scaling role of the reference benchmark's mesh-size
    parameter; connectivity stays fully unstructured.
    """
    conn = mesh.cells["tetra4"].astype(np.int64)

    pairs = np.asarray(_TET_EDGES)
    edges = np.sort(conn[:, pairs].reshape(-1, 2), axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid = (mesh.n_nodes + np.arange(len(uniq))).astype(np.int64)
    coords = np.concatenate(
        [mesh.coords, 0.5 * (mesh.coords[uniq[:, 0]] + mesh.coords[uniq[:, 1]])]
    )

    loc = np.concatenate(
        [conn, mid[inv].reshape(len(conn), 6)], axis=1
    )  # (nc, 10): corners + edge midpoints
    corner_children = np.concatenate(
        [loc[:, list(ch)] for ch in _TET_CORNER_CHILDREN], axis=0
    )
    # per-tet shortest octahedron diagonal
    mc = coords[loc[:, 4:]]  # (nc, 6, 3) midpoint coords
    dlen = np.stack(
        [
            np.linalg.norm(mc[:, 0] - mc[:, 4], axis=1),  # 4-8
            np.linalg.norm(mc[:, 1] - mc[:, 3], axis=1),  # 5-7
            np.linalg.norm(mc[:, 2] - mc[:, 5], axis=1),  # 6-9
        ],
        axis=1,
    )
    case = np.argmin(dlen, axis=1)
    octa_children = np.empty((len(conn), 4, 4), np.int64)
    for c, tpl in _TET_OCTA_CHILDREN.items():
        m = case == c
        octa_children[m] = loc[m][:, np.asarray(tpl)]
    children = np.concatenate(
        [corner_children, octa_children.transpose(1, 0, 2).reshape(-1, 4)],
        axis=0,
    ).astype(np.int32)
    # orient positively (octa templates are orientation-agnostic)
    pc = coords[children]
    vv = pc[:, 1:] - pc[:, :1]
    neg = np.einsum("ij,ij->i", np.cross(vv[:, 0], vv[:, 1]), vv[:, 2]) < 0
    children[neg, 0], children[neg, 1] = (
        children[neg, 1], children[neg, 0].copy()
    )

    # refine boundary face groups: midpoints already exist (face edges are
    # tet edges); locate them through the same unique-edge table
    new_fg: dict[str, dict[str, np.ndarray]] = {}
    if mesh.face_groups:
        # uniq is lexicographically sorted by (a, b); build the packed key
        packed = uniq[:, 0] * (2**32) + uniq[:, 1]
        assert np.all(np.diff(packed) > 0)
        for g, types in mesh.face_groups.items():
            fconn = types.get("tria3")
            if fconn is None or not len(fconn):
                continue
            f = fconn.astype(np.int64)
            fe = np.sort(f[:, np.asarray(_TRI_EDGES)].reshape(-1, 2), axis=1)
            fk = fe[:, 0] * (2**32) + fe[:, 1]
            pos = np.searchsorted(packed, fk)
            valid = (pos < len(packed))
            pos = np.clip(pos, 0, len(packed) - 1)
            valid &= packed[pos] == fk
            fmid = np.where(valid, mid[pos], -1).reshape(len(f), 3)
            ok = np.all(fmid >= 0, axis=1)
            floc = np.concatenate([f[ok], fmid[ok]], axis=1)
            fchildren = np.concatenate(
                [floc[:, list(ch)] for ch in _TRI_CHILDREN], axis=0
            ).astype(np.int32)
            new_fg[g] = {"tria3": fchildren}

    uid0 = int(mesh.node_uids.max()) + 1
    return Mesh(
        coords=coords,
        node_uids=np.concatenate(
            [mesh.node_uids,
             np.arange(uid0, uid0 + len(uniq), dtype=np.int64)]
        ),
        cells={"tetra4": children},
        dim=3,
        face_groups=new_fg,
        node_groups=dict(mesh.node_groups),
    )
