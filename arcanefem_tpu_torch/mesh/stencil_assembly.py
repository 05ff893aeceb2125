"""Stencil assembly of the structured Kuhn box (K4 on the card).

The counterpart of ``arcanefem_tpu/mesh/pallas_stencil.py``:

* ``assemble_stiffness_kernel``: the P1 stiffness as a ``DiaMatrix``
  (``assemble_stiffness_pallas``);
* ``assemble_system``: the fused form (``assemble_system_pallas``): the
  stiffness straight into the padded plane layout of
  ``sparse/dia_stencil.py`` with the per-node Σvol/4 as a second output
  and, given the padded mask and penalty·g planes, penalty Dirichlet
  applied in the same pass (diag := penalty and rhs := f·free·Σvol/4 +
  penalty·g).

On a CUDA tensor each launches the kernel of ``csrc/stencil_assembly.cu``
or raises; on a CPU tensor it runs the plain version beside it
(``StructuredBox.assemble_stiffness`` and ``source_rhs``, then the BC in
the padded layout), which is also the kernel's test oracle.  Each launch
adds one to ``launch_counts()["stencil_assembly"]``.

The kernel computes each hex's 6 tets once into a table of ``HEX_SLOTS``
values (one per edge of ``HEX_EDGES`` and the 8 corners' sums of vol/4),
then sums each node's 14 off-diagonal bands from the tables of the <= 8
hexes it is a corner of, and its diagonal as minus their sum.  The
tables that say where each value goes (``TET_EDGE``, ``CORNER_SLOT``,
``CORNER_BAND``) are
defined here once; :func:`kernel_tables` renders them as the C++ the
kernel source holds (a test checks the two agree), and
:func:`assemble_by_hex_table` assembles through them on the CPU, in the
kernel's output layouts, so the indexing is tested without a card.
"""

from __future__ import annotations

import torch

from ..sparse.dia import DiaMatrix
from ..sparse.dia_stencil import (
    D0,
    KUHN_OFFS3,
    DiaPlaneMatrixP,
    _pads,
    offsets3d,
    pad_vec,
    to_plane_matrix,
    unpad_vec,
)
from ..utils import kernels, tracing
from .structured import _HEX_CORNERS, _TETS, StructuredBox

# -- the hex table: where each value of a hex's 6 tets goes ------------------

# every corner pair that shares a Kuhn tet: 12 cube edges, 6 face
# diagonals through corner 0 or 6, and the body diagonal 0-6
HEX_EDGES = tuple(sorted({(min(a, b), max(a, b)) for t in _TETS
                          for a in t for b in t if a != b}))
VOL_SLOT0 = len(HEX_EDGES)  # slots 0-18: edge values; 19-26: sum of vol/4 at corner c
HEX_SLOTS = VOL_SLOT0 + 8
TET_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))  # a tet's local edges


def _band(h: int, c: int) -> int:
    """Band of the entry (node at corner h, node at corner c)."""
    d = tuple(x - y for x, y in zip(_HEX_CORNERS[c], _HEX_CORNERS[h]))
    return KUHN_OFFS3.index(d)


# TET_EDGE[t][k]: edge slot of local edge TET_PAIRS[k] of tet t
TET_EDGE = tuple(tuple(HEX_EDGES.index(tuple(sorted((t[q], t[r])))) for q, r in TET_PAIRS)
                 for t in _TETS)
# the (slot, band) pairs of the off-diagonal entries a node at hex corner h
# sums, padded with (-1, -1) to 7 (corners 0 and 6 lie on 7 edges, the
# others on 4); its diagonal is minus their sum (a P1 row sums to zero)
_CORNER = tuple(tuple((e, _band(h, b if a == h else a))
                      for e, (a, b) in enumerate(HEX_EDGES) if h in (a, b))
                for h in range(8))
CORNER_SLOT = tuple(tuple(s for s, _ in c) + (-1,) * (7 - len(c)) for c in _CORNER)
CORNER_BAND = tuple(tuple(b for _, b in c) + (-1,) * (7 - len(c)) for c in _CORNER)


def _c_array(name: str, a) -> str:
    """``constexpr int name[d0][d1]... = {...};`` of nested sequences."""
    def lit(x):
        return "{" + ", ".join(map(lit, x)) + "}" if isinstance(x, (tuple, list)) else str(x)

    dims, x = "", a
    while isinstance(x, (tuple, list)):
        dims, x = dims + f"[{len(x)}]", x[0]
    return f"  constexpr int {name}{dims} = {lit(a)};"


def kernel_tables() -> str:
    """The tables as the C++ accessor functions of
    ``csrc/stencil_assembly.cu``, which holds this text verbatim."""
    out = [f"constexpr int kHexSlots = {HEX_SLOTS};",
           f"constexpr int kVolSlot0 = {VOL_SLOT0};"]
    for fn, name, arr, args in (
            ("tet_corner", "kTet", _TETS, ("t", "q")),
            ("tet_edge", "kEdge", TET_EDGE, ("t", "k")),
            ("corner_slot", "kSlot", CORNER_SLOT, ("h", "e")),
            ("corner_band", "kBand", CORNER_BAND, ("h", "e"))):
        params = ", ".join(f"int {p}" for p in args)
        out += [f"__host__ __device__ __forceinline__ constexpr int {fn}({params}) {{",
                _c_array(name, arr),
                f"  return {name}{''.join(f'[{p}]' for p in args)};", "}"]
    return "\n".join(out) + "\n"


_LAUNCHES = tracing.counters("stencil_assembly")
_ENTRY = {torch.float32: "afem_stencil_assembly_f32",
          torch.float64: "afem_stencil_assembly_f64"}


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def _check(box: StructuredBox, coords3d: torch.Tensor, planes=()) -> bool:
    """Raise on an operand the kernel does not take; True for CUDA
    coordinates.  One attribute read per test."""
    if coords3d.shape != box.shape + (3,):
        raise ValueError(f"coords3d {tuple(coords3d.shape)}, expected "
                         f"{box.shape + (3,)}")
    if coords3d.dtype not in _ENTRY:
        raise TypeError(f"coords3d must be float32 or float64, got {coords3d.dtype}")
    if offsets3d(box) != KUHN_OFFS3:
        raise ValueError("the box's stencil is not the 15-offset Kuhn stencil")
    want = (box.nx + 1,) + _pads(box)
    dev, cuda = coords3d.get_device(), coords3d.is_cuda
    for p in planes:
        if p.shape != want or p.dtype != coords3d.dtype:
            raise ValueError(f"a BC plane is {tuple(p.shape)} {p.dtype}, "
                             f"expected {want} {coords3d.dtype}")
        if p.get_device() != dev:
            raise ValueError("stencil assembly: operands lie on different devices")
        if cuda and not p.is_contiguous():
            raise ValueError("stencil assembly: the CUDA kernel takes contiguous operands")
    if cuda and not coords3d.is_contiguous():
        raise ValueError("stencil assembly: the CUDA kernel takes contiguous operands")
    if not cuda and coords3d.device.type != "cpu":
        raise ValueError(f"stencil assembly: no kernel for device {coords3d.device}")
    return cuda


def _launch(box, coords3d, bands, rhs, mask_p, pg_p, nyo, nzo, off,
            s_plane, s_band, penalty, f) -> None:
    kernels.launch(
        _ENTRY[coords3d.dtype], coords3d.device,
        coords3d.data_ptr(), None if mask_p is None else mask_p.data_ptr(),
        None if pg_p is None else pg_p.data_ptr(), bands.data_ptr(),
        None if rhs is None else rhs.data_ptr(), box.nx, box.ny, box.nz,
        nyo, nzo, off, s_plane, s_band, float(penalty), float(f))
    tracing.count("stencil_assembly")


def assemble_stiffness_plain(box: StructuredBox, coords3d: torch.Tensor) -> DiaMatrix:
    """Plain version of :func:`assemble_stiffness_kernel`."""
    return box.assemble_stiffness(coords3d)


def assemble_stiffness_kernel(box: StructuredBox, coords3d: torch.Tensor) -> DiaMatrix:
    """The stiffness as a (15, n_nodes) DiaMatrix; the kernel writes the
    bands in that layout directly."""
    if not _check(box, coords3d):
        return assemble_stiffness_plain(box, coords3d)
    nx1, ny1, nz1 = box.shape
    bands = coords3d.new_empty((len(KUHN_OFFS3), nx1, ny1, nz1))
    _launch(box, coords3d, bands, None, None, None, ny1, nz1, 0,
            ny1 * nz1, box.n_nodes, 0.0, 0.0)
    return DiaMatrix(bands.reshape(len(KUHN_OFFS3), -1), box.offsets)


def _cross(u, v):
    return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0])


def _dot(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def hex_tables(box: StructuredBox, coords3d: torch.Tensor) -> torch.Tensor:
    """(HEX_SLOTS, nx, ny, nz): every hex's table, its 6 tets computed
    once with the kernel's arithmetic.  Every tet is (0, a, b, 6): with
    e_c = P_c - P_0 and w_c = e_c x e_6 its cofactor vectors (|6V| times
    the gradients of its vertices) are g1 = w_b, g2 = -w_a, g3 = e_a x
    e_b and g0 = -(g1 + g2 + g3); |6V| = |e_a . w_b|.  Entry (q, r) is
    vol / |6V|^2 (g_q . g_r) = (g_q . g_r) / (6 |6V|), with 1/|6V| := 0
    where |6V| <= 1e-30 (pallas_stencil.py's guard); the entries with
    vertex 0 follow from the rows' zero sums, so 6 dot products give the
    tet's 6 edges."""
    nx, ny, nz = box.nx, box.ny, box.nz
    P = [coords3d[dx : dx + nx, dy : dy + ny, dz : dz + nz].unbind(-1)
         for dx, dy, dz in _HEX_CORNERS]
    e = [tuple(p - q for p, q in zip(P[c], P[0])) for c in range(8)]
    w = {c: _cross(e[c], e[6]) for c in (1, 2, 3, 4, 5, 7)}
    ww = {c: _dot(w[c], w[c]) for c in w}
    table = coords3d.new_zeros((HEX_SLOTS, nx, ny, nz))
    av6 = []
    for t, (_, a, b, _) in enumerate(_TETS):
        g3 = _cross(e[a], e[b])
        d12, d13, d23 = -_dot(w[b], w[a]), _dot(w[b], g3), -_dot(w[a], g3)
        d11, d22, d33 = ww[b], ww[a], _dot(g3, g3)
        k = (-(d11 + d12 + d13), -(d12 + d22 + d23), -(d13 + d23 + d33), d12, d13, d23)
        av6.append(_dot(e[a], w[b]).abs())
        ok = av6[t] > 1e-30
        scale = torch.where(ok, 1.0 / torch.where(ok, av6[t], 1.0), 0.0) * (1.0 / 6.0)
        for slot, kk in zip(TET_EDGE[t], k):
            table[slot] += scale * kk
    # corner sums of vol/4 = |6V|/24: all six tets at corners 0 and 6, tets
    # t - 1 and t at tet t's a (the tets' b is the next tet's a)
    table[VOL_SLOT0] = table[VOL_SLOT0 + 6] = (
        ((av6[0] + av6[1]) + (av6[2] + av6[3])) + (av6[4] + av6[5])) * (1.0 / 24.0)
    for t, (_, a, _, _) in enumerate(_TETS):
        table[VOL_SLOT0 + a] = (av6[t - 1] + av6[t]) * (1.0 / 24.0)
    return table


def assemble_by_hex_table(box: StructuredBox, coords3d: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          pg: torch.Tensor | None = None,
                          penalty: float = 0.0, f: float = 1.0,
                          layout: str = "plane"):
    """The kernel's two phases in plain PyTorch: :func:`hex_tables`, then
    each node sums the (slot, band) pairs of ``CORNER_SLOT``/``CORNER_BAND``
    over the hexes it is a corner of (hexes outside the box add 0), in
    corner order, and its diagonal is minus the sum of its other 14 bands
    in band order; then the BC epilogue and the output layout with zero
    pads.  ``layout`` "plane" gives bands (nx+1, 15, ny',
    nz') and rhs (nx+1, ny', nz') as :func:`assemble_system`; "dia" gives
    bands (15, nx+1, ny+1, nz+1) as :func:`assemble_stiffness_kernel` and rhs
    (nx+1, ny+1, nz+1).  ``mask`` and ``pg`` are planes of the rhs's shape.
    Returns (bands, rhs)."""
    nx, ny, nz = box.nx, box.ny, box.nz
    table = torch.nn.functional.pad(hex_tables(box, coords3d), (1, 1) * 3)
    acc = coords3d.new_zeros((len(KUHN_OFFS3),) + box.shape)
    vsum = coords3d.new_zeros(box.shape)
    for h, (dx, dy, dz) in enumerate(_HEX_CORNERS):
        def at(slot, dx=dx, dy=dy, dz=dz):
            return table[slot, 1 - dx : 2 - dx + nx, 1 - dy : 2 - dy + ny,
                         1 - dz : 2 - dz + nz]
        for s, band in zip(CORNER_SLOT[h], CORNER_BAND[h]):
            if s >= 0:
                acc[band] += at(s)
        vsum += at(VOL_SLOT0 + h)
    for d in range(len(KUHN_OFFS3)):
        if d != D0:
            acc[D0] -= acc[d]
    off = {"plane": 1, "dia": 0}[layout]
    nyo, nzo = _pads(box) if off else box.shape[1:]
    real = (slice(None), slice(off, off + ny + 1), slice(off, off + nz + 1))
    if mask is not None:
        m, g = mask[real], pg[real]
        free = 1.0 - m
        acc[D0] = acc[D0] * free + penalty * m
        vsum = vsum * (f * free) + g
    bands = coords3d.new_zeros((len(KUHN_OFFS3), nx + 1, nyo, nzo))
    bands[(slice(None),) + real] = acc
    rhs = coords3d.new_zeros((nx + 1, nyo, nzo))
    rhs[real] = vsum
    return (bands.movedim(0, 1).contiguous() if off else bands), rhs


def assemble_system_plain(box: StructuredBox, coords3d: torch.Tensor,
                          mask_p: torch.Tensor | None = None,
                          pg_p: torch.Tensor | None = None,
                          penalty: float = 0.0, f: float = 1.0):
    """Plain version of :func:`assemble_system`."""
    A = box.assemble_stiffness(coords3d)
    vs = box.source_rhs(coords3d, 1.0)
    if mask_p is not None:
        m = unpad_vec(mask_p, box.shape)
        free = 1.0 - m
        A.bands[D0] = A.bands[D0] * free + penalty * m
        vs = vs * (f * free) + unpad_vec(pg_p, box.shape)
    Ap = to_plane_matrix(A, box)
    return Ap, Ap.pad_vec(vs)


def assemble_system(box: StructuredBox, coords3d: torch.Tensor,
                    mask_p: torch.Tensor | None = None,
                    pg_p: torch.Tensor | None = None,
                    penalty: float = 0.0, f: float = 1.0):
    """Fused assembly + RHS + penalty Dirichlet into the padded plane layout.

    mask_p: padded (nx+1, ny', nz') plane, 1 on Dirichlet rows; pg_p: the
    padded penalty·g·mask plane.  Without them only the stiffness and the
    raw Σvol/4 per node are produced (no source factor, no BC).
    Returns (``DiaPlaneMatrixP``, padded rhs)."""
    if (mask_p is None) != (pg_p is None):
        raise ValueError("assemble_system takes both mask_p and pg_p, or neither")
    planes = () if mask_p is None else (mask_p, pg_p)
    if not _check(box, coords3d, planes):
        return assemble_system_plain(box, coords3d, mask_p, pg_p, penalty, f)
    nyp, nzp = _pads(box)
    plane = nyp * nzp
    bands = coords3d.new_empty((box.nx + 1, len(KUHN_OFFS3), nyp, nzp))
    rhs = coords3d.new_empty((box.nx + 1, nyp, nzp))
    _launch(box, coords3d, bands, rhs, mask_p, pg_p, nyp, nzp, 1,
            len(KUHN_OFFS3) * plane, plane, penalty, f)
    return DiaPlaneMatrixP(bands, box.nx, box.ny, box.nz), rhs
