"""Test tooling: write a Mesh as a Gmsh 4.1 ASCII file, and a case file.

    write_msh(path, mesh)
    write_arc(path, mesh_file, codename="Laplace", dirichlet=[("left", 1.0)])

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
name.  ``read_msh`` gives back the same coordinates, tags, cells and
groups.  Cell groups are not written (their cells would be read as a
second copy of the mesh's cells).
"""

from __future__ import annotations

import numpy as np

from ..mesh.gmsh import ELEMENT_TYPES

_TYPE_ID = {name: tid for tid, (name, _nn, _dim) in ELEMENT_TYPES.items()}


def _lines(rows) -> str:
    return "".join(" ".join(map(str, r)) + "\n" for r in rows)


def write_msh(path: str, mesh) -> None:
    """``mesh`` (a ``mesh.core.Mesh``) as a Gmsh 4.1 ASCII file."""
    if mesh.cell_groups:
        raise ValueError("write_msh: cell groups are not written")
    uids = np.asarray(mesh.node_uids, np.int64)
    dim = mesh.dim
    # (entity dim, physical name, element type, connectivity)
    blocks = [(dim, None, t, c) for t, c in mesh.cells.items()]
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
              result_file: str | None = None) -> None:
    """A reference case file for the Poisson/Laplace module.

    ``dirichlet``: (surface, value[, method]) tuples; ``neumann``: (surface,
    value) tuples; ``linear_system``: None (the Aleph default, no
    <linear-system>) or {"name": service, tag: text, ...} (e.g.
    {"name": "HypreLinearSystem", "rtol": "1e-10"}); ``mesh_file`` and
    ``result_file`` as ``load_case`` resolves them (absolute paths work)."""
    bcs = []
    for d in dirichlet:
        surface, value = d[0], d[1]
        method = (f"<enforce-Dirichlet-method>{d[2]}</enforce-Dirichlet-method>"
                  if len(d) > 2 else "")
        bcs.append(f"      <dirichlet><surface>{surface}</surface>"
                   f"<value>{value!r}</value>{method}</dirichlet>\n")
    bcs += [f"      <neumann><surface>{s}</surface><value>{v!r}</value></neumann>\n"
            for s, v in neumann]
    fem = []
    if f is not None:
        fem.append(f"    <f>{f!r}</f>\n")
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
    text = (f'<?xml version="1.0"?>\n<case codename="{codename}" xml:lang="en" '
            'codeversion="1.0">\n'
            f"  <arcane><title>{codename}</title></arcane>\n"
            f"  <meshes><mesh><filename>{mesh_file}</filename></mesh></meshes>\n"
            "  <fem>\n" + "".join(fem) + "  </fem>\n</case>\n")
    with open(path, "w") as fh:
        fh.write(text)
