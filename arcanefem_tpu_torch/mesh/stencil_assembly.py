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
from ..utils import kernels
from .structured import StructuredBox

_LAUNCHES = {"stencil_assembly": 0}
_ENTRY = {torch.float32: "afem_stencil_assembly_f32",
          torch.float64: "afem_stencil_assembly_f64"}


def reset_launch_counts() -> None:
    _LAUNCHES["stencil_assembly"] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


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
    _LAUNCHES["stencil_assembly"] += 1


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
