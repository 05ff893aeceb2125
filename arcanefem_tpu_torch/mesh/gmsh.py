"""Gmsh ``.msh`` reader (MSH 4.1 binary/ASCII and legacy 2.2 ASCII).

The port's copy of ``arcanefem_tpu/mesh/gmsh.py`` (numpy and struct only);
the CPU tests hold it to the original with exact equality.  Parsing
produces flat int64/float64 arrays and the physical-group tables that
``mesh/core.py::read_msh`` resolves into a Mesh.  Node unique-ids are the
1-based Gmsh node tags, which golden files key their results by.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# Gmsh element type id -> (name, nodes per element, topological dim)
ELEMENT_TYPES: dict[int, tuple[str, int, int]] = {
    1: ("line2", 2, 1),
    2: ("tria3", 3, 2),
    3: ("quad4", 4, 2),
    4: ("tetra4", 4, 3),
    5: ("hexa8", 8, 3),
    6: ("penta6", 6, 3),
    7: ("pyramid5", 5, 3),
    8: ("line3", 3, 1),
    9: ("tria6", 6, 2),
    10: ("quad9", 9, 2),
    11: ("tetra10", 10, 3),
    12: ("hexa27", 27, 3),
    13: ("penta18", 18, 3),
    14: ("pyramid14", 14, 3),
    15: ("point1", 1, 0),
    16: ("quad8", 8, 2),
    17: ("hexa20", 20, 3),
    18: ("penta15", 15, 3),
    19: ("pyramid13", 13, 3),
    26: ("line4", 4, 1),
}

NAME_TO_DIM = {name: dim for _, (name, _nn, dim) in ELEMENT_TYPES.items()}
NAME_TO_NNODES = {name: nn for _, (name, nn, _dim) in ELEMENT_TYPES.items()}


@dataclass
class RawGmsh:
    """Parsed .msh content before group resolution."""

    node_tags: np.ndarray  # (n,) int64 gmsh tags (1-based, possibly sparse)
    coords: np.ndarray  # (n, 3) float64
    # blocks: list of (entity_dim, entity_tag, type_name, elem_tags, conn)
    # conn uses *gmsh node tags* (not yet remapped).
    blocks: list[tuple[int, int, str, np.ndarray, np.ndarray]] = field(
        default_factory=list
    )
    # physical names: (dim, physical_tag) -> name
    physical_names: dict[tuple[int, int], str] = field(default_factory=dict)
    # entity -> physical tags: (dim, entity_tag) -> [ptag, ...]
    entity_physicals: dict[tuple[int, int], list[int]] = field(default_factory=dict)


class _BinReader:
    def __init__(self, data: bytes, pos: int, swap: bool):
        self.data = data
        self.pos = pos
        self.swap = swap

    def read(self, fmt: str):
        if self.swap:
            fmt = ">" + fmt
        else:
            fmt = "<" + fmt
        size = struct.calcsize(fmt)
        out = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return out

    def read_array(self, dtype: np.dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype)
        if self.swap:
            dt = dt.newbyteorder(">")
        arr = np.frombuffer(self.data, dtype=dt, count=count, offset=self.pos)
        self.pos += dt.itemsize * count
        return arr.astype(dtype, copy=False)


def _find_section(data: bytes, name: bytes, start: int = 0) -> tuple[int, int]:
    """Return (start_of_payload, start_of_end_marker) byte offsets."""
    key = b"$" + name
    i = data.find(key, start)
    if i < 0:
        return -1, -1
    # payload starts after the newline following the section tag
    j = data.find(b"\n", i)
    end = data.find(b"$End" + name, j)
    return j + 1, end


def parse_msh(path: str) -> RawGmsh:
    with open(path, "rb") as f:
        data = f.read()

    hdr_start, _ = _find_section(data, b"MeshFormat")
    if hdr_start < 0:
        raise ValueError(f"{path}: not a Gmsh .msh file (no $MeshFormat)")
    hdr_line = data[hdr_start : data.find(b"\n", hdr_start)].split()
    version = float(hdr_line[0])
    is_binary = int(hdr_line[1]) == 1
    swap = False
    if is_binary:
        # endianness probe: the int right after the header line must read 1
        probe_pos = data.find(b"\n", hdr_start) + 1
        (one,) = struct.unpack_from("<i", data, probe_pos)
        swap = one != 1

    raw = RawGmsh(
        node_tags=np.zeros(0, np.int64), coords=np.zeros((0, 3), np.float64)
    )
    _parse_physical_names(data, raw)

    if version >= 4.0:
        _parse_entities_v4(data, raw, is_binary, swap)
        _parse_nodes_v4(data, raw, is_binary, swap)
        _parse_elements_v4(data, raw, is_binary, swap)
    elif version >= 2.0:
        if is_binary:
            raise NotImplementedError("binary MSH 2.x not supported")
        _parse_nodes_v2(data, raw)
        _parse_elements_v2(data, raw)
    else:
        raise ValueError(f"unsupported msh version {version}")
    return raw


def _parse_physical_names(data: bytes, raw: RawGmsh) -> None:
    start, end = _find_section(data, b"PhysicalNames")
    if start < 0:
        return
    text = data[start:end].decode("utf-8", errors="replace")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    n = int(lines[0])
    for ln in lines[1 : 1 + n]:
        parts = ln.split(None, 2)
        dim, tag = int(parts[0]), int(parts[1])
        name = parts[2].strip().strip('"')
        raw.physical_names[(dim, tag)] = name


def _parse_entities_v4(data: bytes, raw: RawGmsh, binary: bool, swap: bool) -> None:
    start, end = _find_section(data, b"Entities")
    if start < 0:
        return
    if binary:
        r = _BinReader(data, start, swap)
        np_, nc, ns, nv = r.read("4q")
        counts = (np_, nc, ns, nv)
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                (tag,) = r.read("i")
                r.read("3d" if dim == 0 else "6d")  # coords or bbox
                (nphys,) = r.read("q")
                ptags = list(r.read(f"{nphys}i")) if nphys else []
                if dim > 0:
                    (nb,) = r.read("q")
                    if nb:
                        r.read(f"{nb}i")
                if ptags:
                    raw.entity_physicals[(dim, tag)] = ptags
    else:
        toks = data[start:end].split()
        it = iter(toks)

        def ni() -> int:
            return int(next(it))

        def nf() -> float:
            return float(next(it))

        counts = (ni(), ni(), ni(), ni())
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                tag = ni()
                for _ in range(3 if dim == 0 else 6):
                    nf()
                nphys = ni()
                ptags = [ni() for _ in range(nphys)]
                if dim > 0:
                    nb = ni()
                    for _ in range(nb):
                        ni()
                if ptags:
                    raw.entity_physicals[(dim, tag)] = ptags


def _parse_nodes_v4(data: bytes, raw: RawGmsh, binary: bool, swap: bool) -> None:
    start, end = _find_section(data, b"Nodes")
    if start < 0:
        raise ValueError("no $Nodes section")
    tags_list: list[np.ndarray] = []
    coords_list: list[np.ndarray] = []
    if binary:
        r = _BinReader(data, start, swap)
        nblocks, nnodes, _mn, _mx = r.read("4q")
        for _ in range(nblocks):
            _dim, _etag, parametric, nb = r.read("3iq")
            tags = r.read_array(np.int64, nb)
            ncoord = 3 + (_dim if parametric else 0)
            xyz = r.read_array(np.float64, nb * ncoord).reshape(nb, ncoord)[:, :3]
            tags_list.append(tags)
            coords_list.append(xyz)
    else:
        toks = data[start:end].split()
        it = iter(toks)

        def ni() -> int:
            return int(next(it))

        nblocks, nnodes = ni(), ni()
        ni(), ni()  # min/max tag
        for _ in range(nblocks):
            _dim, _etag, parametric, nb = ni(), ni(), ni(), ni()
            tags = np.array([ni() for _ in range(nb)], np.int64)
            ncoord = 3 + (_dim if parametric else 0)
            xyz = np.array(
                [[float(next(it)) for _ in range(ncoord)] for _ in range(nb)],
                np.float64,
            ).reshape(nb, ncoord)[:, :3]
            tags_list.append(tags)
            coords_list.append(xyz)
    raw.node_tags = (
        np.concatenate(tags_list) if tags_list else np.zeros(0, np.int64)
    )
    raw.coords = (
        np.concatenate(coords_list) if coords_list else np.zeros((0, 3), np.float64)
    )


def _parse_elements_v4(data: bytes, raw: RawGmsh, binary: bool, swap: bool) -> None:
    start, end = _find_section(data, b"Elements")
    if start < 0:
        raise ValueError("no $Elements section")
    if binary:
        r = _BinReader(data, start, swap)
        nblocks, _ne, _mn, _mx = r.read("4q")
        for _ in range(nblocks):
            dim, etag, etype, nb = r.read("3iq")
            if etype not in ELEMENT_TYPES:
                raise ValueError(f"unknown gmsh element type {etype}")
            name, nn, _tdim = ELEMENT_TYPES[etype]
            flat = r.read_array(np.int64, nb * (1 + nn)).reshape(nb, 1 + nn)
            raw.blocks.append((dim, etag, name, flat[:, 0].copy(), flat[:, 1:].copy()))
    else:
        toks = data[start:end].split()
        it = iter(toks)

        def ni() -> int:
            return int(next(it))

        nblocks = ni()
        ni(), ni(), ni()
        for _ in range(nblocks):
            dim, etag, etype, nb = ni(), ni(), ni(), ni()
            name, nn, _tdim = ELEMENT_TYPES[etype]
            flat = np.array(
                [[ni() for _ in range(1 + nn)] for _ in range(nb)], np.int64
            ).reshape(nb, 1 + nn)
            raw.blocks.append((dim, etag, name, flat[:, 0].copy(), flat[:, 1:].copy()))


def _parse_nodes_v2(data: bytes, raw: RawGmsh) -> None:
    start, end = _find_section(data, b"Nodes")
    toks = data[start:end].split()
    n = int(toks[0])
    arr = np.array(toks[1 : 1 + 4 * n], dtype=np.float64).reshape(n, 4)
    raw.node_tags = arr[:, 0].astype(np.int64)
    raw.coords = arr[:, 1:4].copy()


def _parse_elements_v2(data: bytes, raw: RawGmsh) -> None:
    start, end = _find_section(data, b"Elements")
    toks = data[start:end].split()
    it = iter(toks)

    def ni() -> int:
        return int(next(it))

    n = ni()
    # group elements into pseudo-blocks keyed by (ptag, type)
    buckets: dict[tuple[int, str], list[list[int]]] = {}
    for _ in range(n):
        tag = ni()
        etype = ni()
        ntags = ni()
        tags = [ni() for _ in range(ntags)]
        ptag = tags[0] if tags else 0
        name, nn, dim = ELEMENT_TYPES[etype]
        nodes = [ni() for _ in range(nn)]
        buckets.setdefault((ptag, name), []).append([tag] + nodes)
    eid = 0
    for (ptag, name), rows in buckets.items():
        eid -= 1  # synthetic entity tags (negative to avoid collisions)
        dim = NAME_TO_DIM[name]
        arr = np.asarray(rows, np.int64)
        raw.blocks.append((dim, eid, name, arr[:, 0].copy(), arr[:, 1:].copy()))
        if ptag:
            raw.entity_physicals[(dim, eid)] = [ptag]
