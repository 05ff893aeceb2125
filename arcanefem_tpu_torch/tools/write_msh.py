"""Test tooling: write a Mesh as a Gmsh 4.1 ASCII file, and a case file.

    write_msh(path, mesh)
    write_arc(path, mesh_file, codename="Laplace", dirichlet=[("left", 1.0)])
    rect_quad_mesh(nx, ny, regions=True)

The repository holds no ``.msh`` or ``.arc`` file, so the tests and
``chip_smoke.py`` write their own from generated meshes (``mesh/generate.py``)
and read them back through ``mesh/core.py::read_msh`` and
``fem/arc.py::load_case``.  This is not a feature of the port: the
reference meshes come from Gmsh.

:func:`write_msh` writes the nodes (tags ``mesh.node_uids``, coordinates
to 17 significant digits, so they read back bit for bit) in one block, the
cells in one entity of the mesh's dimension, each face group as one entity
of dimension ``dim - 1`` per face type and each node group as one entity
of dimension 0 (``point1`` elements), every group under its own physical
name.  Cell groups must be disjoint sets of the mesh's cells: each is
one entity of the mesh's dimension under its name, and the cells of no
group one more entity without a name.  ``read_msh`` gives back the same
coordinates, tags and groups, and the same cells, grouped by entity.

:func:`rect_quad_mesh` is the quad4 rectangle of the tests and chip_smoke
(the package's ``mesh/generate.py`` has triangles and tetrahedra only).
"""

from __future__ import annotations

import numpy as np

from ..fem.problem import row_ids
from ..mesh.gmsh import ELEMENT_TYPES

_TYPE_ID = {name: tid for tid, (name, _nn, _dim) in ELEMENT_TYPES.items()}


def _lines(rows) -> str:
    return "".join(" ".join(map(str, r)) + "\n" for r in rows)


def _cell_blocks(mesh) -> list:
    """(dim, group name or None, type, connectivity) of the mesh's cells:
    each cell group's rows of each type, then the rows of no group."""
    blocks = []
    for t, cells in mesh.cells.items():
        owner = np.full(len(cells), -1, np.int64)
        names = [g for g, by_type in mesh.cell_groups.items() if t in by_type]
        for k, g in enumerate(names):
            sel = np.asarray(mesh.cell_groups[g][t]).reshape(-1, cells.shape[1])
            inv = row_ids(np.concatenate([cells, sel]))
            rows = np.flatnonzero(np.isin(inv[: len(cells)], inv[len(cells):]))
            if len(rows) != len(sel) or (owner[rows] >= 0).any():
                raise ValueError(f"write_msh: cell group '{g}' is not a disjoint "
                                 f"set of the {t} cells")
            owner[rows] = k
        for k, g in enumerate(names):
            blocks.append((mesh.dim, g, t, cells[owner == k]))
        if (owner < 0).any():
            blocks.append((mesh.dim, None, t, cells[owner < 0]))
    return blocks


def write_msh(path: str, mesh) -> None:
    """``mesh`` (a ``mesh.core.Mesh``) as a Gmsh 4.1 ASCII file."""
    uids = np.asarray(mesh.node_uids, np.int64)
    dim = mesh.dim
    # (entity dim, physical name, element type, connectivity)
    blocks = _cell_blocks(mesh)
    for name, by_type in mesh.face_groups.items():
        blocks += [(dim - 1, name, t, c) for t, c in by_type.items()]
    for name, nodes in mesh.node_groups.items():
        blocks.append((0, name, "point1", np.asarray(nodes).reshape(-1, 1)))
    phys = {}  # name -> (dim, tag)
    for bdim, name, _t, _c in blocks:
        if name is not None and name not in phys:
            phys[name] = (bdim, len(phys) + 1)

    lo, hi = mesh.coords.min(axis=0), mesh.coords.max(axis=0)
    box = " ".join(repr(float(v)) for v in (*lo, *hi))
    entities: list[list[str]] = [[], [], [], []]
    for tag, (bdim, name, _t, _c) in enumerate(blocks, start=1):
        ptags = [] if name is None else [phys[name][1]]
        head = f"{tag} " + (" ".join(repr(float(v)) for v in lo) if bdim == 0 else box)
        tail = f" {len(ptags)}" + "".join(f" {p}" for p in ptags)
        entities[bdim].append(head + tail + ("" if bdim == 0 else " 0"))

    n_elem = sum(len(c) for _d, _n, _t, c in blocks)
    out = ["$MeshFormat\n4.1 0 8\n$EndMeshFormat\n"]
    if phys:
        out.append(f"$PhysicalNames\n{len(phys)}\n")
        out += [f'{d} {t} "{name}"\n' for name, (d, t) in phys.items()]
        out.append("$EndPhysicalNames\n")
    out.append("$Entities\n" + " ".join(str(len(e)) for e in entities) + "\n")
    out += [ln + "\n" for e in entities for ln in e]
    out.append("$EndEntities\n")
    n = len(uids)
    out.append(f"$Nodes\n1 {n} {uids.min(initial=0)} {uids.max(initial=0)}\n"
               f"{dim} 1 0 {n}\n")
    out.append(_lines(uids[:, None]))
    out.append("".join(f"{x!r} {y!r} {z!r}\n" for x, y, z in mesh.coords.tolist()))
    out.append("$EndNodes\n")
    out.append(f"$Elements\n{len(blocks)} {n_elem} 1 {n_elem}\n")
    etag = 1
    for tag, (bdim, _name, t, c) in enumerate(blocks, start=1):
        c = np.asarray(c)
        out.append(f"{bdim} {tag} {_TYPE_ID[t]} {len(c)}\n")
        ids = np.arange(etag, etag + len(c), dtype=np.int64)[:, None]
        out.append(_lines(np.concatenate([ids, uids[c]], axis=1)))
        etag += len(c)
    out.append("$EndElements\n")
    with open(path, "w") as f:
        f.write("".join(out))


def write_arc(path: str, mesh_file: str, *, codename: str = "Laplace",
              f: float | None = None, dirichlet=(), neumann=(),
              linear_system: dict | None = None,
              result_file: str | None = None, values: dict | None = None,
              materials=(), manufactured: dict | None = None, farfield=(),
              dirichlet_bc=(), post_processing=(), dirichlet_vector=(),
              dirichlet_point=(), traction=(), component_tags: bool = False,
              blocks=(), mesh_init=()) -> None:
    """A reference case file: the scalar modules (Poisson, Laplace,
    Fourier, Electrostatics, Acoustics, Aerodynamics) and the vector ones
    (Bilaplacian, Elasticity, Elastodynamics).

    ``dirichlet``: (surface, value[, method]) tuples; ``neumann``: (surface,
    value) tuples, both in ``<boundary-conditions>``; ``linear_system``:
    None (the Aleph default, no <linear-system>) or {"name": service, tag:
    text, ...} (e.g. {"name": "HypreLinearSystem", "rtol": "1e-10"});
    ``mesh_file`` and ``result_file`` as ``load_case`` resolves them
    (absolute paths work).  The other modules' fields: ``values``, scalar
    ``<fem>`` fields by tag (``lambda``, ``qdot``, ``rho``, ``epsilon``,
    ``kc2``, ``penalty``); ``materials``, (volume, lambda) pairs as
    ``<material-property>``; ``manufactured``, {"dirichlet": function name,
    "source": function name[, "method": ..., "penalty": ...]} as the
    ``<manufactured-solution>`` of ``<boundary-conditions>``; ``farfield``,
    (surface, angle) pairs as ``<farfield-boundary-condition>``;
    ``dirichlet_bc``, (surface, value) pairs as aerodynamics'
    ``<dirichlet-boundary-condition>``; ``post_processing``, the variable
    names of an ``<arcane-post-processing>`` block.

    The vector modules' fields: ``f`` as a tuple (elasticity's body force,
    None written as NULL); ``values`` also takes text (``E``, ``nu``,
    ``rho``, ``tmax``, ``dt``, ``etam``, ``etak``, ``alpm``, ``alpf``,
    ``time-discretization``, ``enforce-Dirichlet-method``, ...);
    ``dirichlet_vector``, (surface, components) pairs as
    ``<dirichlet-boundary-condition>``; ``dirichlet_point``, (node group,
    components) pairs as ``<dirichlet-point-condition>``; ``traction``,
    (surface, components) or (surface, None, input file) as
    ``<traction-boundary-condition>``, the file as
    ``<traction-input-file>``.  Components are written as elasticity reads
    them (``<u>0.0 NULL</u>``, ``<t>..</t>``), or with ``component_tags``
    as elastodynamics reads them (``<u1>0.0</u1>``, a None left out).

    The transient modules' blocks: ``blocks``, (tag, {child tag: text})
    pairs written as ``<tag><child>text</child>...</tag>`` inside
    ``<fem>`` (heat's ``convection-boundary-condition``, soildynamics'
    ``paraxial-boundary-condition`` and ``double-couple``, passmo's
    ``dirichlet-surface-condition``, ``init-elast-properties``, ...);
    ``mesh_init``, (variable, cell group, value) triples as the mesh's
    ``<initialization>`` (passmo's Rho, Lambda, Mu)."""
    bcs = []
    for d in dirichlet:
        surface, value = d[0], d[1]
        method = (f"<enforce-Dirichlet-method>{d[2]}</enforce-Dirichlet-method>"
                  if len(d) > 2 else "")
        bcs.append(f"      <dirichlet><surface>{surface}</surface>"
                   f"<value>{value!r}</value>{method}</dirichlet>\n")
    bcs += [f"      <neumann><surface>{s}</surface><value>{v!r}</value></neumann>\n"
            for s, v in neumann]
    if manufactured is not None:
        ms = dict(manufactured)
        inner = "".join(f'<manufactured-{k} function="{ms.pop(k)}"/>'
                        for k in ("dirichlet", "source") if k in ms)
        if "method" in ms:
            inner += (f"<enforce-Dirichlet-method>{ms.pop('method')}"
                      "</enforce-Dirichlet-method>")
        inner += "".join(f"<{k}>{v!r}</{k}>" for k, v in ms.items())
        bcs.append(f"      <manufactured-solution>{inner}</manufactured-solution>\n")
    def comps(tag, vals):
        if component_tags:
            return "".join(f"<{tag}{i}>{v!r}</{tag}{i}>" for i, v in enumerate(vals, 1)
                           if v is not None)
        return f"<{tag}>" + " ".join("NULL" if v is None else repr(v) for v in vals) + f"</{tag}>"

    fem = []
    if isinstance(f, tuple):
        fem.append("    <f>" + " ".join("NULL" if v is None else repr(v) for v in f)
                   + "</f>\n")
    elif f is not None:
        fem.append(f"    <f>{f!r}</f>\n")
    fem += [f"    <{k}>{v if isinstance(v, str) else repr(v)}</{k}>\n"
            for k, v in (values or {}).items()]
    fem += [f"    <dirichlet-boundary-condition><surface>{s}</surface>{comps('u', v)}"
            "</dirichlet-boundary-condition>\n" for s, v in dirichlet_vector]
    fem += [f"    <dirichlet-point-condition><node>{s}</node>{comps('u', v)}"
            "</dirichlet-point-condition>\n" for s, v in dirichlet_point]
    for tr in traction:
        s, v = tr[0], tr[1]
        inner = (f"<traction-input-file>{tr[2]}</traction-input-file>" if len(tr) > 2
                 else comps("t", v))
        fem.append(f"    <traction-boundary-condition><surface>{s}</surface>{inner}"
                   "</traction-boundary-condition>\n")
    fem += [f"    <material-property><volume>{vol}</volume><lambda>{lam!r}</lambda>"
            "</material-property>\n" for vol, lam in materials]
    fem += [f"    <farfield-boundary-condition><surface>{s}</surface><angle>{a!r}"
            "</angle></farfield-boundary-condition>\n" for s, a in farfield]
    fem += [f"    <dirichlet-boundary-condition><surface>{s}</surface><value>{v!r}"
            "</value></dirichlet-boundary-condition>\n" for s, v in dirichlet_bc]
    fem += [f"    <{tag}>" + "".join(f"<{k}>{v if isinstance(v, str) else repr(v)}</{k}>"
                               for k, v in kids.items()) + f"</{tag}>\n"
            for tag, kids in blocks]
    fem.append("    <boundary-conditions>\n" + "".join(bcs)
               + "    </boundary-conditions>\n")
    if linear_system is not None:
        ls = dict(linear_system)
        name = ls.pop("name")
        fem.append(f'    <linear-system name="{name}">'
                   + "".join(f"<{k}>{v}</{k}>" for k, v in ls.items())
                   + "</linear-system>\n")
    if result_file is not None:
        fem.append(f"    <result-file>{result_file}</result-file>\n")
    post = ""
    if post_processing:
        post = ("  <arcane-post-processing><output-period>1</output-period>"
                '<format name="VtkHdfV2PostProcessor"/><output>'
                + "".join(f"<variable>{v}</variable>" for v in post_processing)
                + "</output></arcane-post-processing>\n")
    init = ""
    if mesh_init:
        init = ("<initialization>" + "".join(
            f"<variable><name>{n}</name><value>{v!r}</value><group>{g}</group></variable>"
            for n, g, v in mesh_init) + "</initialization>")
    text = (f'<?xml version="1.0"?>\n<case codename="{codename}" xml:lang="en" '
            'codeversion="1.0">\n'
            f"  <arcane><title>{codename}</title></arcane>\n"
            f"  <meshes><mesh><filename>{mesh_file}</filename>{init}</mesh></meshes>\n"
            + post + "  <fem>\n" + "".join(fem) + "  </fem>\n</case>\n")
    with open(path, "w") as fh:
        fh.write(text)


def rect_quad_mesh(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
                   regions: bool = False):
    """Structured quad4 mesh of an (lx × ly) rectangle, the node numbering
    of ``mesh/generate.py::rect_tria_mesh`` (node (i, j) is i·(ny+1) + j),
    each cell (i, j), (i+1, j), (i+1, j+1), (i, j+1) counter-clockwise;
    face groups left/right/bottom/top (line2).  ``regions``: cell groups
    "west" (the cells left of x = lx/2) and "east" (the others)."""
    from ..mesh.core import Mesh

    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.zeros(((nx + 1) * (ny + 1), 3), np.float64)
    coords[:, 0] = X.ravel()
    coords[:, 1] = Y.ravel()

    def nid(i, j):
        return i * (ny + 1) + j

    I, J = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij"))
    quads = np.stack([nid(I, J), nid(I + 1, J), nid(I + 1, J + 1), nid(I, J + 1)],
                     axis=1).astype(np.int32)
    i, j = np.arange(nx), np.arange(ny)

    def edges(a, b):
        return {"line2": np.stack([a, b], axis=1).astype(np.int32)}

    fg = {"left": edges(nid(0, j), nid(0, j + 1)),
          "right": edges(nid(nx, j), nid(nx, j + 1)),
          "bottom": edges(nid(i, 0), nid(i + 1, 0)),
          "top": edges(nid(i, ny), nid(i + 1, ny))}
    cg = {}
    if regions:
        west = I < (nx + 1) // 2
        cg = {"west": {"quad4": quads[west]}, "east": {"quad4": quads[~west]}}
    return Mesh(coords=coords, node_uids=np.arange(1, len(coords) + 1, dtype=np.int64),
                cells={"quad4": quads}, dim=2, face_groups=fg, cell_groups=cg)


# local faces of the cells mixed_box_mesh makes, as (node indices) in
# cyclic order (gmsh orderings: pyramid5 base 0-3 then apex 4; penta6
# triangles 0-2 and 3-5)
_MIXED_FACES = {
    "hexa8": [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
              (3, 0, 4, 7)],
    "pyramid5": [(0, 1, 2, 3), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
    "penta6": [(0, 1, 2), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)],
    "tetra4": [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)],
}


def mixed_box_mesh(nx: int = 3, ny: int = 2, lx: float = 1.5, ly: float = 1.0,
                   lz: float = 1.5):
    """A conforming (lx × ly × lz) box of three layers of nx × ny cubes with
    every 3D cell type of passmo's P1 zoo: layer 0 hexa8, its first cube
    split into 6 pyramid5 around a centre node; layer 1 penta6, each cube
    cut into two prisms along a yz diagonal (quad faces below and above);
    layer 2 one pyramid5 on each cube's bottom quad and tetra4 on its top
    and sides (each quad cut along the diagonal through its lowest node id,
    so neighbours agree) around a centre node.  Face groups xmin, xmax,
    ymin, ymax, zmin, zmax (quad4 and tria3 faces); cell groups "lower"
    (layers 0 and 1) and "upper" (layer 2); node groups "all" and
    "top_corner" (the node at (lx, ly, lz))."""
    from ..mesh.core import Mesh

    nz = 3
    xs, ys, zs = (np.linspace(0.0, n_l, n + 1) for n, n_l in ((nx, lx), (ny, ly), (nz, lz)))
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = [np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)]
    n_grid = len(coords[0])

    def v(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    cells = {"hexa8": [], "pyramid5": [], "penta6": [], "tetra4": []}
    layer = {t: [] for t in cells}

    def centre(corners):
        coords.append(coords[0][corners].mean(axis=0)[None])
        return n_grid + len(coords) - 2

    def add(t, nodes, lay):
        cells[t].append(nodes)
        layer[t].append(lay)

    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = [v(i, j, k), v(i + 1, j, k), v(i + 1, j + 1, k), v(i, j + 1, k),
                     v(i, j, k + 1), v(i + 1, j, k + 1), v(i + 1, j + 1, k + 1),
                     v(i, j + 1, k + 1)]
                if k == 0 and (i, j) != (0, 0):
                    add("hexa8", c, 0)
                elif k == 0:
                    m = centre(c)
                    for f in _MIXED_FACES["hexa8"]:
                        add("pyramid5", [c[q] for q in f] + [m], 0)
                elif k == 1:
                    # triangles in the yz plane extruded along x
                    add("penta6", [c[0], c[3], c[7], c[1], c[2], c[6]], 1)
                    add("penta6", [c[0], c[7], c[4], c[1], c[6], c[5]], 1)
                else:
                    m = centre(c)
                    add("pyramid5", [c[0], c[1], c[2], c[3], m], 2)
                    for f in _MIXED_FACES["hexa8"][1:]:
                        q = [c[p] for p in f]
                        s = int(np.argmin(q))
                        q = q[s:] + q[:s]
                        add("tetra4", [q[0], q[1], q[2], m], 2)
                        add("tetra4", [q[0], q[2], q[3], m], 2)
    coords = np.concatenate(coords)
    conn = {t: np.asarray(c, np.int32) for t, c in cells.items()}
    # boundary faces: the faces of one cell only
    faces = [conn[t][:, list(f)] for t in conn for f in _MIXED_FACES[t]]
    by_len = {}
    for f in faces:
        by_len.setdefault(f.shape[1], []).append(f)
    face_groups: dict = {}
    for n, parts in by_len.items():
        allf = np.concatenate(parts)
        inv = row_ids(np.sort(allf, axis=1))
        once = np.bincount(inv)[inv] == 1
        bnd = allf[once]
        fx = coords[bnd]
        for name, axis, val in (("xmin", 0, 0.0), ("xmax", 0, lx), ("ymin", 1, 0.0),
                                ("ymax", 1, ly), ("zmin", 2, 0.0), ("zmax", 2, lz)):
            sel = np.all(np.isclose(fx[:, :, axis], val), axis=1)
            if sel.any():
                face_groups.setdefault(name, {})["tria3" if n == 3 else "quad4"] = (
                    bnd[sel].astype(np.int32))
    lay = {t: np.asarray(layer[t]) for t in conn}
    cell_groups = {
        "lower": {t: conn[t][lay[t] < 2] for t in conn if (lay[t] < 2).any()},
        "upper": {t: conn[t][lay[t] == 2] for t in conn if (lay[t] == 2).any()}}
    node_groups = {"all": np.arange(len(coords)),
                   "top_corner": np.array([v(nx, ny, nz)])}
    return Mesh(coords=coords, node_uids=np.arange(1, len(coords) + 1, dtype=np.int64),
                cells=conn, dim=3, face_groups=face_groups, cell_groups=cell_groups,
                node_groups=node_groups)
