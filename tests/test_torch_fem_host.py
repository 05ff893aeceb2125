"""The port's host copies of the FEM core equal the JAX package's: the
Gmsh reader on files the tests write (4.1 ASCII through
``tools/write_msh.py``, 4.1 binary and 2.2 ASCII written here), the
Mesh helpers and exterior faces of every cell type, ``face_dof_slots``,
the ``.arc`` reader and every solver mapping of ``parse_solver``, the
golden-file check, the penalty clamp and the outward face orientation
(vectorised in the port, a loop in JAX)."""

import dataclasses
import struct
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from arcanefem_tpu.fem import arc as jarc
from arcanefem_tpu.fem.bcs import dtype_safe_penalty as jax_penalty
from arcanefem_tpu.fem.problem import orient_faces_outward as jax_orient
from arcanefem_tpu.fem.validation import check_node_results as jax_check
from arcanefem_tpu.mesh import core as jcore
from arcanefem_tpu.mesh.gmsh import parse_msh as jax_parse_msh
from arcanefem_tpu.solver import linear_system as jls
from arcanefem_tpu.sparse.topology import build_topology as jax_build_topology
from arcanefem_tpu.sparse.topology import face_dof_slots as jax_face_dof_slots
from arcanefem_tpu_torch.fem import arc
from arcanefem_tpu_torch.fem.bcs import dtype_safe_penalty
from arcanefem_tpu_torch.fem.problem import orient_faces_outward
from arcanefem_tpu_torch.fem.validation import check_node_results
from arcanefem_tpu_torch.mesh import core
from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu_torch.mesh.gmsh import ELEMENT_TYPES, parse_msh
from arcanefem_tpu_torch.mesh.unstructured import sphere_cut_tetra_mesh
from arcanefem_tpu_torch.sparse.topology import build_topology, face_dof_slots
from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

_TYPE_ID = {name: tid for tid, (name, _n, _d) in ELEMENT_TYPES.items()}


def _assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.node_uids, b.node_uids)
    assert a.dim == b.dim
    for name in ("cells", "face_groups", "cell_groups"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert sorted(ga) == sorted(gb), name
        for k in ga:
            if isinstance(ga[k], dict):
                assert sorted(ga[k]) == sorted(gb[k])
                for t in ga[k]:
                    assert ga[k][t].dtype == gb[k][t].dtype
                    np.testing.assert_array_equal(ga[k][t], gb[k][t])
            else:
                assert ga[k].dtype == gb[k].dtype
                np.testing.assert_array_equal(ga[k], gb[k])
    assert sorted(a.node_groups) == sorted(b.node_groups)
    for k in a.node_groups:
        np.testing.assert_array_equal(a.node_groups[k], b.node_groups[k])


def _meshes():
    rect = rect_tria_mesh(9, 7, lx=2.0, ly=0.5)
    rect.node_groups["corner"] = np.array([0, 5, 17], np.int32)
    box = box_tetra_mesh(3, 4, 2)
    box.node_groups["pin"] = np.array([3], np.int32)
    return {"rect": rect, "box": box}


@pytest.mark.parametrize("name", ["rect", "box"])
def test_write_msh_reads_back_exactly(tmp_path, name):
    """tools/write_msh.py: the JAX read_msh (and the port's copy) give back
    exactly the written mesh; the two parsers agree field for field."""
    mesh = _meshes()[name]
    path = str(tmp_path / f"{name}.msh")
    write_msh(path, mesh)
    _assert_mesh_equal(jcore.read_msh(path), mesh)
    _assert_mesh_equal(core.read_msh(path), mesh)
    a, b = parse_msh(path), jax_parse_msh(path)
    assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
    np.testing.assert_array_equal(a.node_tags, b.node_tags)
    assert a.physical_names == b.physical_names
    assert a.entity_physicals == b.entity_physicals
    assert len(a.blocks) == len(b.blocks)
    for x, y in zip(a.blocks, b.blocks):
        assert x[:3] == y[:3]
        np.testing.assert_array_equal(x[3], y[3])
        np.testing.assert_array_equal(x[4], y[4])


def _write_msh22(path, mesh):
    """Legacy 2.2 ASCII: one element list, the physical tag first."""
    uids = mesh.node_uids
    rows = [(t, 0, c) for t, c in mesh.cells.items()]
    names = []
    for name, by_type in mesh.face_groups.items():
        names.append(name)
        rows += [(t, len(names), c) for t, c in by_type.items()]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
             str(len(names))]
    lines += [f'{mesh.dim - 1} {i + 1} "{n}"' for i, n in enumerate(names)]
    lines += ["$EndPhysicalNames", "$Nodes", str(len(uids))]
    lines += [f"{u} {x!r} {y!r} {z!r}" for u, (x, y, z) in
              zip(uids.tolist(), mesh.coords.tolist())]
    lines += ["$EndNodes", "$Elements", str(sum(len(c) for _, _, c in rows))]
    e = 1
    for t, ptag, c in rows:
        for nodes in uids[c].tolist():
            lines.append(f"{e} {_TYPE_ID[t]} 2 {ptag} {ptag} " + " ".join(map(str, nodes)))
            e += 1
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _write_msh41_binary(path, mesh):
    """4.1 binary, little-endian: one entity per cell bucket and group."""
    uids = np.asarray(mesh.node_uids, np.int64)
    blocks = [(mesh.dim, None, t, c) for t, c in mesh.cells.items()]
    for name, by_type in mesh.face_groups.items():
        blocks += [(mesh.dim - 1, name, t, c) for t, c in by_type.items()]
    names = sorted({b[1] for b in blocks if b[1] is not None})
    out = [b"$MeshFormat\n4.1 1 8\n", struct.pack("<i", 1), b"\n$EndMeshFormat\n",
           b"$PhysicalNames\n%d\n" % len(names)]
    out += [b'%d %d "%s"\n' % (mesh.dim - 1, i + 1, n.encode()) for i, n in enumerate(names)]
    out.append(b"$EndPhysicalNames\n$Entities\n")
    counts = [0, 0, 0, 0]
    for b in blocks:
        counts[b[0]] += 1
    out.append(struct.pack("<4q", *counts))
    for tag, (d, name, _t, _c) in sorted(enumerate(blocks, 1), key=lambda b: b[1][0]):
        ptags = [] if name is None else [names.index(name) + 1]
        out.append(struct.pack("<i6dq", tag, *([0.0] * 6), len(ptags)))
        out.append(struct.pack(f"<{len(ptags)}iq", *ptags, 0))
    out.append(b"\n$EndEntities\n$Nodes\n")
    out.append(struct.pack("<4q", 1, len(uids), uids.min(), uids.max()))
    out.append(struct.pack("<3iq", mesh.dim, 1, 0, len(uids)))
    out.append(uids.astype("<i8").tobytes() + mesh.coords.astype("<f8").tobytes())
    out.append(b"\n$EndNodes\n$Elements\n")
    n = sum(len(c) for *_, c in blocks)
    out.append(struct.pack("<4q", len(blocks), n, 1, n))
    e = 1
    for tag, (d, _name, t, c) in enumerate(blocks, 1):
        out.append(struct.pack("<3iq", d, tag, _TYPE_ID[t], len(c)))
        ids = np.arange(e, e + len(c), dtype=np.int64)[:, None]
        out.append(np.concatenate([ids, uids[c]], axis=1).astype("<i8").tobytes())
        e += len(c)
    out.append(b"\n$EndElements\n")
    with open(path, "wb") as f:
        f.write(b"".join(out))


@pytest.mark.parametrize("fmt", ["msh22", "msh41_binary"])
@pytest.mark.parametrize("name", ["rect", "box"])
def test_read_msh_other_formats_equal(tmp_path, fmt, name):
    mesh = _meshes()[name]
    mesh.node_groups.clear()
    path = str(tmp_path / f"{name}_{fmt}.msh")
    {"msh22": _write_msh22, "msh41_binary": _write_msh41_binary}[fmt](path, mesh)
    got, want = core.read_msh(path), jcore.read_msh(path)
    _assert_mesh_equal(got, want)
    _assert_mesh_equal(got, mesh)


def _mixed_mesh():
    """Buckets of every cell type _FACES_OF knows, on random connectivity
    (faces shared between cells and buckets)."""
    rng = np.random.RandomState(3)
    cells = {t: rng.randint(0, 40, (12, n)).astype(np.int32)
             for t, n in (("tetra4", 4), ("tetra10", 10), ("hexa8", 8),
                          ("hexa20", 20))}
    surf = {t: rng.randint(0, 40, (15, n)).astype(np.int32)
            for t, n in (("tria3", 3), ("quad4", 4), ("tria6", 6), ("quad8", 8))}
    coords = rng.rand(40, 3)
    return (core.Mesh(coords=coords, node_uids=np.arange(1, 41), cells=cells, dim=3),
            core.Mesh(coords=coords, node_uids=np.arange(1, 41), cells=surf, dim=2))


@pytest.mark.parametrize("which", ["rect", "box", "volume_zoo", "surface_zoo"])
def test_boundary_faces_and_helpers_equal(which):
    mesh = (_meshes()[which] if which in ("rect", "box")
            else _mixed_mesh()[which == "surface_zoo"])
    jmesh = jcore.Mesh(**{f.name: getattr(mesh, f.name)
                          for f in dataclasses.fields(mesh)})
    got, want = mesh.boundary_faces(), jmesh.boundary_faces()
    assert sorted(got) == sorted(want)
    for t in got:
        assert got[t].dtype == want[t].dtype
        np.testing.assert_array_equal(got[t], want[t])
    assert core._FACES_OF == jcore._FACES_OF and core.CELL_NNODES == jcore.CELL_NNODES
    for g in list(mesh.face_groups) + list(mesh.node_groups):
        np.testing.assert_array_equal(mesh.group_nodes(g), jmesh.group_nodes(g))
    if len(mesh.cells) == 1:
        assert mesh.cell_type() == jmesh.cell_type()
        np.testing.assert_array_equal(mesh.connectivity(), jmesh.connectivity())
    else:
        with pytest.raises(ValueError):
            mesh.cell_type()
    with pytest.raises(KeyError):
        mesh.group_nodes("no such group")


@pytest.mark.parametrize("name", ["rect", "box"])
def test_face_dof_slots_equal(name):
    mesh = _meshes()[name]
    topo = build_topology(mesh.n_nodes, mesh.cells)
    jtopo = jax_build_topology(mesh.n_nodes, mesh.cells)
    for by_type in mesh.face_groups.values():
        for conn in by_type.values():
            nfn = conn.shape[1]
            rows = np.repeat(conn, nfn, axis=1).reshape(-1)
            cols = np.tile(conn, (1, nfn)).reshape(-1)
            np.testing.assert_array_equal(face_dof_slots(topo, rows, cols),
                                          jax_face_dof_slots(jtopo, rows, cols))
    far = np.array([0]), np.array([mesh.n_nodes - 1])
    with pytest.raises(ValueError):
        face_dof_slots(topo, *far)


def _random_flips(conn, seed):
    out = conn.copy()
    flip = np.random.RandomState(seed).rand(len(conn)) < 0.5
    out[flip, 0], out[flip, 1] = conn[flip, 1], conn[flip, 0]
    return out


@pytest.mark.parametrize("name", ["rect", "box", "sphere"])
def test_orient_faces_outward_equals_jax(name):
    """The port's vectorised orientation flips exactly the faces the JAX
    loop flips, on every face group with half of its faces reversed, on
    the boundary faces and on interior faces (the last cell in the JAX
    loop's order decides)."""
    if name == "sphere":
        mesh = sphere_cut_tetra_mesh(h=16.0)
    else:
        mesh = _meshes()[name]
    groups = [c for by_type in mesh.face_groups.values() for c in by_type.values()]
    groups += list(mesh.boundary_faces().values())
    for ctype, cells in mesh.cells.items():
        loc = core._FACES_OF[ctype][1]
        groups.append(cells[:40, loc])  # interior and boundary faces
    groups.append(np.array([[0, 1, 2][:groups[0].shape[1]]], np.int32))  # no cell's
    for i, conn in enumerate(groups):
        conn = _random_flips(conn, i)
        got, want = orient_faces_outward(mesh, conn), jax_orient(mesh, conn)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _fem(children: str) -> ET.Element:
    return ET.fromstring(f"<fem>{children}</fem>")


SOLVER_XML = [
    "",
    '<linear-system name="SequentialBasicLinearSystem"/>',
    '<linear-system name="HypreLinearSystem"/>',
    '<linear-system name="HypreLinearSystem"><rtol>1e-9</rtol><atol>1e-12</atol>'
    '<max-iter>77</max-iter></linear-system>',
    '<linear-system name="AlephLinearSystem"/>',
    '<linear-system name="AlephLinearSystem"><epsilon>1e-15</epsilon></linear-system>',
    '<linear-system name="AlephLinearSystem"><epsilon>1e-6</epsilon></linear-system>',
    '<linear-system><solver-method>gmres</solver-method></linear-system>',
    '<linear-system name="AlephLinearSystem"><solver-method>bicgstab</solver-method>'
    '</linear-system>',
    '<linear-system name="AlephLinearSystem"><solver-method>bicgstab2</solver-method>'
    '</linear-system>',
    '<linear-system name="AlephLinearSystem"><solver-method>cg</solver-method>'
    '</linear-system>',
] + [f'<linear-system name="{n}"><preconditioner>{p}</preconditioner></linear-system>'
     for n in ("AlephLinearSystem", "HypreLinearSystem")
     for p in ("diagonal", "amg", "none", "poly", "ainv", "ic", "ilu", "ilup", "other")]


def _solver_fields(opts) -> dict:
    """The options' fields, field for field, without JAX's ``gmres_restart``
    (the port has no gmres yet), which holds its default: no .arc setting
    moves it."""
    d = dataclasses.asdict(opts)
    default = jls.SolverOptions.gmres_restart
    assert d.pop("gmres_restart", default) == default
    return d


@pytest.mark.parametrize("xml", SOLVER_XML)
def test_parse_solver_equal(xml):
    got, want = arc.parse_solver(_fem(xml)), jarc.parse_solver(_fem(xml))
    assert _solver_fields(got) == _solver_fields(want)


BCS_XML = """<boundary-conditions>
  <dirichlet><surface>left</surface><value>0.5</value></dirichlet>
  <dirichlet><surface>right</surface><value>2</value>
    <enforce-Dirichlet-method>RowColumnElimination</enforce-Dirichlet-method>
    <penalty>1e20</penalty></dirichlet>
  <dirichlet><surface>top</surface><valueX>1</valueX><valueY/><Uz>3</Uz></dirichlet>
  <dirichlet-point><node>corner</node><value>4</value><Ux>1</Ux></dirichlet-point>
  <neumann><surface>bottom</surface><value>-1.5</value></neumann>
  <neumann><surface>top</surface><valueX>1</valueX><valueZ>2</valueZ></neumann>
</boundary-conditions>"""

VECTOR_XML = """<enforce-Dirichlet-method>WeakPenalty</enforce-Dirichlet-method>
<penalty>1e25</penalty>
<dirichlet-boundary-condition><surface>left</surface><u>0.0 NULL</u></dirichlet-boundary-condition>
<dirichlet-boundary-condition><surface>right</surface><u>1 2 3</u>
  <enforce-Dirichlet-method>Penalty</enforce-Dirichlet-method></dirichlet-boundary-condition>
<dirichlet-point-condition><node>corner</node><u>NULL 1</u></dirichlet-point-condition>
<traction-boundary-condition><surface>top</surface><t>NULL -1</t></traction-boundary-condition>"""


def test_parse_bcs_equal():
    got = arc.parse_bcs(ET.fromstring(BCS_XML))
    assert dataclasses.asdict(got) == dataclasses.asdict(jarc.parse_bcs(ET.fromstring(BCS_XML)))
    assert dataclasses.asdict(arc.parse_bcs(None)) == dataclasses.asdict(jarc.parse_bcs(None))
    vec = _fem(VECTOR_XML)
    assert dataclasses.asdict(arc.parse_bcs_vector(vec)) == \
        dataclasses.asdict(jarc.parse_bcs_vector(vec))
    for f in ("1.5", "", None):
        xml = "" if f is None else f"<f>{f}</f>"
        assert arc.opt_float(_fem(xml), "f") == jarc.opt_float(_fem(xml), "f")
        assert arc.opt_text(_fem(xml), "f", "d") == jarc.opt_text(_fem(xml), "f", "d")
    for b in ("true", "False", None):
        xml = "" if b is None else f"<b>{b}</b>"
        assert arc.opt_bool(_fem(xml), "b") == jarc.opt_bool(_fem(xml), "b")


def _case_fields(case):
    d = {k: v for k, v in vars(case).items() if k != "fem"}
    d["bcs"] = dataclasses.asdict(case.bcs)
    d["solver"] = _solver_fields(case.solver)
    d["post_processing"] = (None if case.post_processing is None
                            else dataclasses.asdict(case.post_processing))
    return d


def test_load_case_equal(tmp_path):
    """Cases the tests write: mesh beside the case, under mesh_root, the
    result file in the module root's check/ directory, and the
    post-processing block."""
    mesh = _meshes()["rect"]
    (tmp_path / "inputs").mkdir()
    (tmp_path / "check").mkdir()
    (tmp_path / "meshes").mkdir()
    write_msh(str(tmp_path / "inputs" / "rect.msh"), mesh)
    write_msh(str(tmp_path / "meshes" / "other.msh"), mesh)
    (tmp_path / "check" / "gold.txt").write_text("1 0.0\n")
    p1 = str(tmp_path / "inputs" / "a.arc")
    write_arc(p1, "rect.msh", codename="Poisson", f=1.0,
              dirichlet=[("left", 1.0, "RowElimination"), ("right", 2.0)],
              neumann=[("top", 0.25)],
              linear_system={"name": "HypreLinearSystem", "rtol": "1e-9"},
              result_file="gold.txt")
    text = open(p1).read().replace(
        "<fem>", "<arcane-post-processing><output-period>3</output-period><output>"
        "<variable>U</variable><variable>Flux</variable></output>"
        '<format name="VtkHdfV2PostProcessor"/></arcane-post-processing>\n  <fem>')
    with open(p1, "w") as f:
        f.write(text)
    p2 = str(tmp_path / "inputs" / "b.arc")
    write_arc(p2, "sub/other.msh", dirichlet=[("left", 0.0)])
    for path, root in ((p1, None), (p2, str(tmp_path / "meshes"))):
        got = arc.load_case(path, mesh_root=root)
        want = jarc.load_case(path, mesh_root=root)
        assert _case_fields(got) == _case_fields(want)
        assert ET.tostring(got.fem) == ET.tostring(want.fem)
    assert arc.load_case(p1).result_file == str(tmp_path / "check" / "gold.txt")
    with pytest.raises(FileNotFoundError):
        arc.load_case(p2)


def test_penalty_clamp_and_golden_check_equal(tmp_path):
    for p in (1e30, 1e10, 1e12):
        for dt in (np.float32, np.float64):
            assert dtype_safe_penalty(p, dt) == jax_penalty(p, dt)
    rng = np.random.RandomState(0)
    uids = np.arange(1, 51)
    ref = rng.rand(50, 2) + 0.5
    path = tmp_path / "gold.txt"
    np.savetxt(path, np.column_stack([uids[::-1], ref[::-1]]), fmt="%.17g")
    vals = ref * (1 + 5e-5)
    assert check_node_results(uids, vals, str(path), 1e-4) == \
        jax_check(uids, vals, str(path), 1e-4) == 0
    bad = vals.copy()
    bad[[3, 7], 1] *= 1.01
    for fn in (check_node_results, jax_check):
        with pytest.raises(AssertionError, match="2 nodes differ"):
            fn(uids, bad, str(path), 1e-4)
        assert fn(uids, bad, str(path), 1e-4, min_value_rel=2.0) == 0


@pytest.mark.parametrize("k,hi", [(2, 7), (3, 100), (3, 2 ** 22), (6, 50000)],
                         ids=["pairs", "packed", "lexsort-wide-ids", "lexsort-six"])
def test_row_ids_is_unique_inverse(k, hi):
    """fem/problem.py::row_ids (packed int64 keys where the rows fit in 63
    bits, a lexsort otherwise) equals np.unique(rows, axis=0)'s inverse."""
    from arcanefem_tpu_torch.fem.problem import row_ids

    rng = np.random.default_rng(k + hi)
    rows = rng.integers(0, hi, (5000, k))
    rows = np.concatenate([rows, rows[::7]])
    _, inv = np.unique(rows, axis=0, return_inverse=True)
    np.testing.assert_array_equal(row_ids(rows), inv.reshape(-1))
    assert row_ids(rows[:0]).shape == (0,)
