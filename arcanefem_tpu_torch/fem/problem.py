"""FemProblem — the per-module FEM infrastructure, in torch on one device.

The counterpart of ``arcanefem_tpu/fem/problem.py``: what every reference
module repeats (FemDoFsOnNodes numbering, femutils/FemDoFsOnNodes.cc:71-128;
the sparsity set-up; right-hand sides and boundary conditions,
femutils/ArcaneFemFunctions.h:824-1222).

Host numpy work happens once per problem: the topology, the SELL layout of
the assembled operator (``sparse/bell.py::fine_layout``, or for ``ndof`` b
> 1 the scalar expansion of the b×b blocks with its node-level
contributor lists, ``BlockAssembly``), boundary-face
orientation and group index arrays.  Per solve, on ``device``: the element
matrices (``ops/elements.py``, plain torch), their sum into the BELL matrix
(``assemble_bell``: one ``slot_reduce`` or ``block_slot_reduce`` launch on
the card), the RHS and the boundary-face matrices, and the Dirichlet
conditions, deferred to ``solver/linear_system.py``.  Every sum of
contributions that meet in one dof or one matrix slot runs in a fixed
order: the RHS sums (``constant_source_rhs``, ``vector_source_rhs``,
``traction_rhs``, ``neumann_rhs``, and the models' per-step sums through
:meth:`FemProblem.dof_sum` / :meth:`FemProblem.node_sum`) and the face
matrices (``add_face_matrix``, ``add_face_blocks``) go through a
``SlotSum`` whose contributor lists are built once per (cell buckets or
face group, component) and cached on the problem, then one ``slot_reduce``
per call, so a run gives the same bits every time, on the card as on the
CPU (an ``index_add`` on the card sums through atomics, in an order that
changes from run to run).  Every matrix of a problem shares its one
layout, so ``with_values`` combines them (elastodynamics' c0·M + c1·D +
c2·E).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..mesh.core import _FACES_OF, Mesh
from ..ops import elements, geometry
from ..solver.linear_system import LinearSystem, SolverOptions
from ..sparse.bell import (
    BellMatrix,
    BlockAssembly,
    assemble_bell,
    expanded_slot,
    fine_layout,
)
from ..sparse.sell import SellLayout
from ..sparse.slot_reduce import SlotSum
from ..sparse.topology import Topology, build_topology, face_dof_slots

_FACE_MEASURE = {
    "line2": geometry.edge2_length,
    "tria3": geometry.tria3_area,
}
_FACE_NORMAL = {
    "line2": geometry.edge2_normal,
    "tria3": geometry.tria3_normal,
}

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """float32 or float64 as a torch dtype, from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the FEM path runs float32 or float64, not {dtype}")
        return dtype
    try:
        return _TORCH_DTYPE[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"the FEM path runs float32 or float64, not {dtype}") from None


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a float32 or float64 torch or numpy dtype."""
    return np.dtype(str(torch_dtype(dtype)).removeprefix("torch."))


def row_ids(rows: np.ndarray) -> np.ndarray:
    """int64 ids of the (m, k) non-negative integer ``rows``: equal rows get
    equal ids, in the rows' lexicographic order (the inverse of
    ``np.unique(rows, axis=0)``, which takes ~90 s on the 43.9M cell faces
    of the 1.9M sphere).  One sort of packed int64 keys where the rows fit
    in 63 bits, a lexsort otherwise."""
    m, k = rows.shape
    if not m:
        return np.zeros(0, np.int64)
    r = rows.astype(np.int64)
    bits = max(int(r.max()).bit_length(), 1)
    if k * bits <= 63:
        key = np.zeros(m, np.int64)
        for c in range(k):
            key = (key << bits) | r[:, c]
        return np.unique(key, return_inverse=True)[1].reshape(-1)
    order = np.lexsort(r.T[::-1])
    srt = r[order]
    new = np.ones(m, bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    ids = np.empty(m, np.int64)
    ids[order] = np.cumsum(new) - 1
    return ids


def orient_faces_outward(mesh: Mesh, conn: np.ndarray) -> np.ndarray:
    """Flip boundary faces so their normal points out of the domain.

    The reference gets this from Arcane's face orientation
    (`isSubDomainBoundaryOutside`, ArcaneFemFunctions.h:271-284); as in the
    JAX package, it is recovered from face-cell adjacency: the outward
    normal points away from the centroid of the cell that has the face.
    Vectorised: every cell face of the face's node count, in the JAX
    loop's order (cell bucket, local face, cell), and for each face of
    ``conn`` the last of them with the same nodes (the cell the JAX dict
    keeps); faces no cell has are left as they are.
    """
    nfn = conn.shape[1]
    keys, cents = [], []
    for ctype, cells in mesh.cells.items():
        cent = mesh.coords[cells].mean(axis=1)
        for loc in _FACES_OF.get(ctype, []):
            if len(loc) != nfn:
                continue
            keys.append(np.sort(cells[:, loc], axis=1))
            cents.append(cent)
    out = conn.copy()
    if not keys or not len(conn):
        return out
    keys = np.concatenate(keys)
    cents = np.concatenate(cents)
    nk = len(keys)
    inv = row_ids(np.concatenate([keys[::-1], np.sort(conn, axis=1)]))
    # the first occurrence in reversed order is the last in the loop's order
    uid, first = np.unique(inv[:nk], return_index=True)
    owner = np.full(int(inv.max()) + 1, -1, np.int64)
    owner[uid] = nk - 1 - first
    own = owner[inv[nk:]]
    found = own >= 0
    fc = mesh.coords[conn[found]]  # (nf, nfn, 3)
    centroid = fc.mean(axis=1)
    if nfn == 2:
        d = fc[:, 1] - fc[:, 0]
        n = np.stack([d[:, 1], -d[:, 0], np.zeros(len(d))], axis=1)
    else:
        n = np.cross(fc[:, 1] - fc[:, 0], fc[:, 2] - fc[:, 0])
    flip = np.zeros(len(conn), bool)
    flip[found] = np.einsum("ij,ij->i", n, centroid - cents[own[found]]) < 0
    out[flip, 0], out[flip, 1] = conn[flip, 1], conn[flip, 0]
    return out


@dataclass
class FemProblem:
    mesh: Mesh
    ndof: int = 1
    dtype: torch.dtype = torch.float64
    pad_width_to: int = 1
    device: torch.device | str = "cuda"

    topo: Topology = field(init=False)
    coords: torch.Tensor = field(init=False)

    def __post_init__(self):
        if self.ndof not in (1, 2, 3):
            raise ValueError(f"ndof={self.ndof}: block BELL takes 1, 2 or 3 dofs "
                             "per node")
        self.dtype = torch_dtype(self.dtype)
        self.device = torch.device(self.device)
        self.topo = build_topology(
            self.mesh.n_nodes, self.mesh.cells, pad_width_to=self.pad_width_to
        )
        self.coords = torch.as_tensor(self.mesh.coords, device=self.device).to(self.dtype)
        self._oriented_faces: dict[str, dict[str, np.ndarray]] = {}
        self._sums: dict = {}  # key -> SlotSum, built once

    @functools.cached_property
    def layout(self) -> SellLayout:
        """The SELL layout of the assembled operator, built once."""
        if self.ndof > 1:
            return self.block_assembly.layout
        return fine_layout(self.topo, self.device)

    @functools.cached_property
    def block_assembly(self) -> BlockAssembly:
        """The block operator's layout and node-level contributor lists,
        built once, over the mesh's cell buckets."""
        return BlockAssembly(self.topo, list(self.mesh.cells), self.ndof, self.device)

    # -- dof helpers --------------------------------------------------------
    @property
    def n_dofs(self) -> int:
        return self.mesh.n_nodes * self.ndof

    def dof_ids(self, nodes: np.ndarray, comp: int = 0) -> np.ndarray:
        """dof uid = node*ndof + comp (FemDoFsOnNodes.cc:86)."""
        return nodes.astype(np.int64) * self.ndof + comp

    def _index(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def cell_xyz(self, cell_type: str) -> torch.Tensor:
        return self.coords[self._index(self.mesh.cells[cell_type])]

    def face_xyz(self, conn: np.ndarray) -> torch.Tensor:
        return self.coords[self._index(conn)]

    # -- matrix assembly ------------------------------------------------------
    def assemble_matrix(
        self,
        element_fn: Callable[[str, torch.Tensor], torch.Tensor],
    ) -> BellMatrix:
        """element_fn(cell_type, xyz) -> (nc, npc, npc) element matrices
        (ndof 1) or (nc, npc, npc, b, b) blocks, summed by ``assemble_bell``
        (``slot_reduce`` or ``block_slot_reduce``)."""
        mats = {
            ctype: element_fn(ctype, self.cell_xyz(ctype))
            for ctype in self.mesh.cells
        }
        if self.ndof > 1:
            return assemble_bell(self.topo, mats, device=self.device, dtype=self.dtype,
                                 block=self.ndof, block_asm=self.block_assembly)
        return assemble_bell(self.topo, mats, device=self.device,
                             dtype=self.dtype, layout=self.layout)

    def stiffness_matrix(self, coef=1.0) -> BellMatrix:
        return self.assemble_matrix(
            lambda ct, xyz: coef * elements.stiffness(ct, xyz)
        )

    def add_face_matrix(
        self,
        A: BellMatrix,
        group: str,
        face_fn: Callable[[str, torch.Tensor], torch.Tensor],
        comp: int = 0,
    ) -> BellMatrix:
        """Add boundary-element matrices (e.g. convection h·∫uv on EDGE2,
        reference modules/heat/FemModule.cc:225-227; paraxial terms in
        soildynamics) into the assembled matrix ``A`` (on this problem's
        layout): face_fn(ftype, xyz) -> (nf, nfn, nfn) scalar blocks added
        at component ``comp``, or (nf, nfn, nfn, b, b) full blocks, summed
        into the SELL slots in a fixed order (:meth:`add_face_blocks`)."""
        for ftype, conn in self.mesh.face_groups[group].items():
            A = self.add_face_blocks(A, conn, face_fn(ftype, self.face_xyz(conn)),
                                     key=(group, ftype), comp=comp)
        return A

    def add_face_blocks(self, A: BellMatrix, conn: np.ndarray, ke: torch.Tensor,
                        key, comp: int = 0) -> BellMatrix:
        """``A`` plus the (nf, nfn, nfn) face matrices ``ke`` at component
        ``comp``, or the (nf, nfn, nfn, b, b) full blocks, of the faces
        ``conn``: the SELL slot of each entry (``face_dof_slots``, then
        ``expanded_slot`` and ``ell_to_sell``) is the slot of a
        ``SlotSum`` cached under ``key``, one ``slot_reduce`` over the
        layout's slots added to ``A.values``.  The JAX ``.at[].add`` sums
        the same entries."""
        full = ke.dim() == 5
        b = self.ndof

        def slots():
            W = self.topo.width
            nfn = conn.shape[1]
            rows = np.repeat(conn, nfn, axis=1).reshape(-1)
            cols = np.tile(conn, (1, nfn)).reshape(-1)
            node, w = np.divmod(face_dof_slots(self.topo, rows, cols).astype(np.int64), W)
            if full:
                a, c = np.divmod(np.arange(b * b), b)
            else:
                a = c = np.array([comp])
            flat = expanded_slot(node[:, None], w[:, None], a[None], c[None], b=b, width=W)
            return self.layout.ell_to_sell[flat.reshape(-1)]

        s = self._sum(("face-matrix", key, "full" if full else comp),
                      self.layout.n_slots, slots)
        vals = A.values
        return A.with_values(vals + s(ke.reshape(-1).to(vals.dtype)))

    def _sum(self, key, n: int, slots: Callable[[], np.ndarray]) -> SlotSum:
        """The ``SlotSum`` of ``key``, built from ``slots()`` the first time."""
        s = self._sums.get(key)
        if s is None:
            s = self._sums[key] = SlotSum(slots(), n, self.device)
        return s

    def dof_sum(self, key, dofs: Callable[[], np.ndarray]) -> SlotSum:
        """A fixed-order scatter-add into the (n_dofs,) vector: the entries'
        dofs ``dofs()``, grouped once and cached under ``key``."""
        return self._sum(("dofs", key), self.n_dofs, dofs)

    def cell_sum(self, comp: int = 0) -> SlotSum:
        """The ``SlotSum`` of per-(cell, node) entries over every cell bucket
        in the mesh's order, into the dofs of component ``comp``."""
        return self.dof_sum(("cells", comp), lambda: np.concatenate(
            [self.dof_ids(c.reshape(-1), comp) for c in self.mesh.cells.values()]))

    def face_sum(self, key, conn: np.ndarray, comp: int = 0) -> SlotSum:
        """The ``SlotSum`` of per-(face, node) entries of the faces
        ``conn`` into the dofs of component ``comp``."""
        return self.dof_sum(("faces", key, comp),
                            lambda: self.dof_ids(conn.reshape(-1), comp))

    def node_sum(self, key, conn: np.ndarray) -> SlotSum:
        """The ``SlotSum`` of (…, b) per-node vectors at the nodes ``conn``
        (any shape), entry (…, a) into dof node·b + a: the JAX
        ``rhs.reshape(-1, b).at[conn].add(contrib)``."""
        b = self.ndof
        return self.dof_sum(("nodes", key), lambda: (
            np.asarray(conn, np.int64).reshape(-1, 1) * b + np.arange(b)).reshape(-1))

    def new_system(self, matrix: BellMatrix,
                   options: SolverOptions | None = None) -> LinearSystem:
        rhs = torch.zeros(self.n_dofs, dtype=matrix.values.dtype, device=self.device)
        return LinearSystem(
            matrix=matrix, rhs=rhs, options=options or SolverOptions()
        )

    # -- right-hand sides -------------------------------------------------------
    def constant_source_rhs(self, qdot, comp: int = 0) -> torch.Tensor:
        """rhs[node] += qdot * measure / npc over all cells
        (applyConstantSourceToRhs, ArcaneFemFunctions.h:845-855/1010-1021)."""
        return self.cell_sum(comp)(torch.cat([
            torch.repeat_interleave(qdot * meas / npc, npc)
            for meas, npc in self._cell_measures()]))

    def _cell_measures(self) -> list[tuple[torch.Tensor, int]]:
        """(measure (nc,), npc) of each cell bucket, in the mesh's order."""
        return [(elements.measure(ctype, self.cell_xyz(ctype)), conn.shape[1])
                for ctype, conn in self.mesh.cells.items()]

    def vector_source_rhs(self, rhs: torch.Tensor, f: tuple) -> torch.Tensor:
        """Body-force rhs[node*b+c] += f_c * measure / npc per cell
        (reference modules/elasticity/FemModule.cc:230-241); None = skip."""
        measures = self._cell_measures()
        for c, fc in enumerate(f):
            if fc is None or c >= self.ndof:
                continue
            rhs = rhs + self.cell_sum(c)(torch.cat(
                [torch.repeat_interleave(fc * meas / npc, npc) for meas, npc in measures]))
        return rhs

    def traction_rhs(self, rhs: torch.Tensor, group: str, t: tuple) -> torch.Tensor:
        """Traction rhs[node*b+c] += t_c * measure / n_face_nodes per face
        (reference modules/elasticity/FemModule.cc:246-272)."""
        for ftype, conn in self.mesh.face_groups[group].items():
            meas = _FACE_MEASURE[ftype](self.face_xyz(conn))
            nfn = conn.shape[1]
            for c, tc in enumerate(t):
                if tc is None or c >= self.ndof:
                    continue
                contrib = torch.repeat_interleave(tc * meas / nfn, nfn)
                rhs = rhs + self.face_sum((group, ftype), conn, c)(contrib)
        return rhs

    def apply_dirichlet_vector(
        self,
        system: LinearSystem,
        nodes: np.ndarray,
        values: tuple,
        method: str = "Penalty",
        penalty: float = 1.0e30,
    ) -> None:
        """Per-component vector Dirichlet: component c is constrained only
        when values[c] is not None (the reference's NULL components,
        modules/elasticity/FemModule.cc:299-400)."""
        for c, v in enumerate(values):
            if v is None or c >= self.ndof:
                continue
            self.apply_dirichlet(system, self.dof_ids(nodes, c), v, method, penalty)

    def oriented_group(self, name: str) -> dict[str, np.ndarray]:
        """Outward-oriented face connectivity for a boundary group."""
        if name not in self._oriented_faces:
            self._oriented_faces[name] = {
                ftype: orient_faces_outward(self.mesh, conn)
                for ftype, conn in self.mesh.face_groups[name].items()
            }
        return self._oriented_faces[name]

    def neumann_rhs(
        self,
        rhs: torch.Tensor,
        group: str,
        value: float | None = None,
        vector: tuple | None = None,
        comp: int = 0,
    ) -> torch.Tensor:
        """applyNeumannToRhs (ArcaneFemFunctions.h:934-988 / 1062-1116):
        per boundary face, each node gets value*measure/n_face_nodes; for
        vector loads the value is n·v."""
        for ftype, conn in self.oriented_group(group).items():
            xyz = self.face_xyz(conn)
            meas = _FACE_MEASURE[ftype](xyz)
            if value is not None:
                per_face = value * meas
            else:
                normal = _FACE_NORMAL[ftype](xyz)  # (nf, dim)
                v = torch.as_tensor(vector[: normal.shape[1]], dtype=self.dtype,
                                    device=self.device)
                per_face = (normal @ v) * meas
            nfn = conn.shape[1]
            contrib = torch.repeat_interleave(per_face / nfn, nfn)
            rhs = rhs + self.face_sum((group, ftype, "outward"), conn, comp)(contrib)
        return rhs

    # -- Dirichlet methods ------------------------------------------------------
    def group_dofs(self, group: str, comp: int = 0) -> np.ndarray:
        return self.dof_ids(self.mesh.group_nodes(group), comp)

    def apply_dirichlet(
        self,
        system: LinearSystem,
        dofs: np.ndarray,
        value,
        method: str = "Penalty",
        penalty: float = 1.0e30,
    ) -> None:
        """The four enforcement methods of the reference
        (modules/elasticity/FemModule.cc:285-400, FemBoundaryConditions.axl
        enforce-Dirichlet-method): Penalty, WeakPenalty, RowElimination,
        RowColumnElimination.
        """
        dofs = np.asarray(dofs)
        # straight to the problem's dtype: a Python float through float32
        # (torch's default) would lose its low bits
        vals = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        vals = torch.broadcast_to(vals, dofs.shape)
        system.add_guess(dofs, vals)
        if method == "Penalty":
            system.set_forced_diag(
                dofs, torch.full(dofs.shape, penalty, dtype=self.dtype,
                                 device=self.device))
            system.set_rhs(dofs, penalty * vals)
        elif method == "WeakPenalty":
            # matrixAddValue(diag, P) instead of set; the dofs are
            # distinct, so each slot takes one addend and the index_add
            # is the same in any order
            A = system.matrix
            slots = A.diag_slot[self._index(dofs)]
            add = torch.full(slots.shape, penalty, dtype=A.values.dtype,
                             device=self.device)
            system.matrix = A.with_values(A.values.index_add(0, slots, add))
            system.set_rhs(dofs, penalty * vals)
        elif method == "RowElimination":
            system.eliminate_row(dofs, vals)
        elif method == "RowColumnElimination":
            system.eliminate_row_col(dofs, vals)
        else:
            raise ValueError(f"unknown Dirichlet method '{method}'")

    # -- solution handling -----------------------------------------------------
    def node_values(self, x: torch.Tensor) -> np.ndarray:
        """Solution as an (n_nodes, ndof) host array in the problem's dtype
        (the _updateVariables copy)."""
        return x.to(self.dtype).cpu().numpy().reshape(self.mesh.n_nodes, self.ndof)
