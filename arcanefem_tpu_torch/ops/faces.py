"""Boundary-face operations: Gauss geometry on embedded faces, outward
local frames, and boundary-cell lookup.

The counterpart of ``arcanefem_tpu/ops/faces.py``, the face-side helpers
of passmo's paraxial and traction terms:

* surface Gauss integration of face shape functions, the role of
  ``cell_fem.getGaussData(face, ...)`` + ``_computeJacobian`` on faces
  (modules/passmo/ElastodynamicModule.cc:2157-2170, 1347-1384: for a face
  the "jacobian" is the surface measure scale at the Gauss point), in
  plain torch on the coordinates' device;
* the per-face local referential (e1, e2, e3) with outward normal, the
  role of ``ArcaneFemFunctions::MeshOperation::dirVectors``
  (femutils/ArcaneFemFunctions.h:382-430), the orientation recovered
  from the adjacent cell's centroid;
* the face -> adjacent cell map, the role of ``face.boundaryCell()``
  (inner-material paraxial defaults, ElastodynamicModule.cc:838-843).

The adjacency is host numpy, once per face group: where the JAX module
fills a Python dict over every cell facet, here one sort of the packed
facet keys (``fem/problem.py::row_ids``) finds, for each face, the last
facet with its nodes in the dict's loop order (cell bucket, local face,
cell), the cell the dict keeps; O(facets) work, seconds on a sphere of
11M tetrahedra.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quadrature as Q


def face_gauss(face_type: str, xyz: torch.Tensor, ninteg: int = 2):
    """Batched surface-Gauss data for faces embedded in ambient space.

    xyz: (nf, nfn, 3).  Returns (N (ng, nfn) numpy constant, wdet (ng,
    nf)) with wdet = w_g · sqrt(det(J Jᵀ)), the length (edge) or area
    (face) jacobian at each Gauss point, valid for curved quadratic faces.
    """
    N, dN = Q.shape_tables(face_type, ninteg)
    _, w = Q.rule(face_type, ninteg)
    dNj = torch.as_tensor(dN, dtype=xyz.dtype, device=xyz.device)
    J = torch.einsum("gnr,cnd->gcrd", dNj, xyz)  # (ng, nf, rdim, 3)
    G = torch.einsum("gcrd,gcsd->gcrs", J, J)  # Gram (ng, nf, rdim, rdim)
    det, _ = Q._det_inv(G)
    wdet = torch.sqrt(det) * torch.as_tensor(w, dtype=xyz.dtype, device=xyz.device)[:, None]
    return N, wdet


def face_mass(face_type: str, xyz: torch.Tensor, ninteg: int = 2) -> torch.Tensor:
    """Consistent face mass matrix ∫_Γ φi φj dΓ -> (nf, nfn, nfn)."""
    N, wdet = face_gauss(face_type, xyz, ninteg)
    Nj = torch.as_tensor(N, dtype=xyz.dtype, device=xyz.device)
    return torch.einsum("gc,gi,gj->cij", wdet, Nj, Nj)


def face_load(face_type: str, xyz: torch.Tensor, ninteg: int = 2) -> torch.Tensor:
    """Consistent nodal load weights ∫_Γ φi dΓ -> (nf, nfn) (the reference
    lumps tractions equally per node, ElastodynamicModule.cc:2317-2334;
    this is the consistent Gauss version, as in JAX)."""
    N, wdet = face_gauss(face_type, xyz, ninteg)
    Nj = torch.as_tensor(N, dtype=xyz.dtype, device=xyz.device)
    return torch.einsum("gc,gi->ci", wdet, Nj)


def _adjacency_table(mesh, nfn: int):
    """(names, keys, bucket, row): every nfn-node cell facet in the JAX
    dict's loop order (cell bucket, local face, cell), its sorted nodes
    ``keys`` (n, nfn), its bucket's index in ``names`` and its cell row."""
    from ..mesh.core import _FACES_OF

    names = list(mesh.cells)
    keys, bucket, row = [], [], []
    for b, (ctype, cells) in enumerate(mesh.cells.items()):
        for loc in _FACES_OF.get(ctype, []):
            if len(loc) != nfn:
                continue
            keys.append(np.sort(cells[:, loc], axis=1))
            bucket.append(np.full(len(cells), b, np.int64))
            row.append(np.arange(len(cells), dtype=np.int64))
    if not keys:
        z = np.zeros(0, np.int64)
        return names, np.zeros((0, nfn), np.int64), z, z
    return names, np.concatenate(keys), np.concatenate(bucket), np.concatenate(row)


def boundary_cell_arrays(mesh, conn: np.ndarray):
    """(names, bucket (nf,), row (nf,)): the cell of each face of ``conn``
    as the index of its bucket in ``names`` and its row there, the last
    facet with the face's nodes in the loop order of the JAX dict (for a
    boundary face, its one cell); bucket -1 where no volume cell of the
    mesh has the face."""
    from ..fem.problem import row_ids

    nf = len(conn)
    names, keys, bucket, row = _adjacency_table(mesh, conn.shape[1])
    out_b = np.full(nf, -1, np.int64)
    out_r = np.full(nf, -1, np.int64)
    nk = len(keys)
    if not nk or not nf:
        return names, out_b, out_r
    inv = row_ids(np.concatenate([keys[::-1], np.sort(conn, axis=1)]))
    # the first occurrence in reversed order is the last in the loop's order
    uid, first = np.unique(inv[:nk], return_index=True)
    owner = np.full(int(inv.max()) + 1, -1, np.int64)
    owner[uid] = nk - 1 - first
    own = owner[inv[nk:]]
    found = own >= 0
    out_b[found] = bucket[own[found]]
    out_r[found] = row[own[found]]
    return names, out_b, out_r


def boundary_cells(mesh, conn: np.ndarray):
    """Per-face adjacent cell as (cell_type, row), face.boundaryCell(); a
    list of length nf, None where no volume cell of the mesh contains the
    face (e.g. standalone surface meshes)."""
    names, b, r = boundary_cell_arrays(mesh, conn)
    return [None if bb < 0 else (names[bb], int(rr)) for bb, rr in zip(b.tolist(), r.tolist())]


_CORNERS = {"line2": 2, "line3": 2, "tria3": 3, "tria6": 3,
            "quad4": 4, "quad8": 4}


def face_frames(mesh, face_type: str, conn: np.ndarray, adj=None):
    """Constant per-face local frame (e1, e2, e3), each (nf, 3) host numpy.

    Mirrors dirVectors (ArcaneFemFunctions.h:382-430): e1 = first edge
    direction; 2D -> e2 = outward normal, e3 = 0; 3D -> e3 = outward
    normal, e2 = e3×e1.  "Outward" is resolved from the adjacent cell's
    centroid (a face without one keeps the normal as constructed).
    Quadratic faces use their corner nodes.  ``adj``: the faces'
    :func:`boundary_cell_arrays`, if the caller has them.
    """
    xyz = mesh.coords[conn]  # (nf, nfn, 3)
    names, bucket, row = adj if adj is not None else boundary_cell_arrays(mesh, conn)
    fc = xyz[:, : _CORNERS[face_type]].mean(axis=1)  # corner centroid
    cell_cent = fc.copy()  # no adjacent cell: the sign test is a no-op
    for b, ctype in enumerate(names):
        sel = bucket == b
        if sel.any():
            cell_cent[sel] = mesh.coords[mesh.cells[ctype][row[sel]]].mean(axis=1)
    e1 = xyz[:, 1] - xyz[:, 0]
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    if face_type in ("line2", "line3"):
        n = np.stack([e1[:, 1], -e1[:, 0], np.zeros(len(e1))], axis=1)
        flip = np.einsum("fd,fd->f", n, fc - cell_cent) < 0
        n[flip] *= -1.0
        return e1, n, np.zeros_like(n)
    n = np.cross(xyz[:, 1] - xyz[:, 0], xyz[:, 2] - xyz[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flip = np.einsum("fd,fd->f", n, fc - cell_cent) < 0
    n[flip] *= -1.0
    e2 = np.cross(n, e1)
    return e1, e2, n


def outward_normals(mesh, face_type: str, conn: np.ndarray, adj=None) -> np.ndarray:
    """(nf, 3) outward unit normals (e2 in 2D, e3 in 3D)."""
    e1, e2, e3 = face_frames(mesh, face_type, conn, adj)
    return e2 if face_type in ("line2", "line3") else e3


def paraxial_direction_matrix(normals: np.ndarray, rho, cs, cp, ndof: int) -> np.ndarray:
    """P(n) = ρ·(cs·(I − n⊗n) + cp·n⊗n) restricted to ndof components,
    host numpy: the directional impedance matrix of the 0th-order paraxial
    condition (modules/passmo/ElastodynamicModule.cc:1662-1694, aij =
    ρcs·δ + ρ(cp−cs)·n_l n_ll; quadratic in n, so face orientation does
    not matter).  rho/cs/cp: scalars or (nf,) arrays."""
    nf = normals.shape[0]
    rho = np.broadcast_to(np.asarray(rho, np.float64), (nf,))
    cs = np.broadcast_to(np.asarray(cs, np.float64), (nf,))
    cp = np.broadcast_to(np.asarray(cp, np.float64), (nf,))
    n = normals[:, :ndof]
    eye = np.eye(ndof)
    nxn = np.einsum("fa,fb->fab", n, n)
    return (rho * cs)[:, None, None] * (eye[None] - nxn) + (rho * cp)[:, None, None] * nxn
