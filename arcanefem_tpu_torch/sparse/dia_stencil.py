"""The structured box's DIA operator on padded planes, and its stencil kernel.

The counterpart of ``arcanefem_tpu/sparse/dia_pallas.py``.

**Layout.**  A vector is an (nx+1, ny', nz') array of x-planes with the
real nodes at [:, 1:ny+2, 1:nz+2] and exact zeros elsewhere: one zero row
and column on each side of every plane, ny' = ny+3 rounded up to 8 and
nz' = nz+3 rounded up to 128 (``_pads``).  The rounding is the TPU's tile
rule, kept so that the JAX package's padded arrays carry over unchanged
(``DiaPlaneMatrixP.from_jax_numpy``, ``solver/multigrid.py::mg_from_numpy``);
nz' is a multiple of the CUDA kernels' 128-thread blocks too.  The pads
are what make the solver's dot products plain sums over whole arrays:
every kernel writes exact zeros there.  Bands are (nx+1, 15, ny', nz')
(x-major, ``DiaPlaneMatrixP``, the assembly kernel's output order) or
(15, nx+1, ny', nz') (band-major, ``DiaStencilMatrix``).

**Kernel.**  ``dia_stencil`` is the wrapper of the CUDA kernel
``csrc/dia_stencil.cu`` (K5-K8): for ``mode`` "spmv" y = A x, "jacobi"
y = x + omega * aux * (b - A x), "residual" y = (b - A x) * aux (aux
omitted: 1).  On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs ``dia_stencil_plain``, which is also the kernel's test
oracle.  Band products are summed in the vectors' type: bf16 bands are
promoted per band and summed in float32, as the Pallas kernels do, and
float32 bands with float64 vectors give the float64 residual b − A x that
the solver's residual replacement needs (``solver/iterative.py::pcg``).
Each launch adds one to the count of its TPU counterpart's name
(``launch_counts``), except the residual in float64 vectors: no Pallas
kernel computes it, and it counts as ``residual_replace_f64``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels, tracing
from .dia import DiaMatrix

SUBLANE, LANE = 8, 128  # the plane rounding (TPU tiles, CUDA blocks)
# (dx, dy, dz) of the 15 Kuhn stencil offsets, in StructuredBox.offsets
# order (lexical); csrc/ computes the same table from the band index
KUHN_OFFS3 = tuple((dx, dy, dz)
                   for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                   if min(dx, dy, dz) >= 0 or max(dx, dy, dz) <= 0)
N_BANDS = len(KUHN_OFFS3)
D0 = KUHN_OFFS3.index((0, 0, 0))  # the diagonal band
MODES = {"spmv": 0, "jacobi": 1, "residual": 2}

# kernel launches by the name of the Pallas function each one replaces;
# the solver's float64 residual replacement has a count of its own
_LAUNCHES = tracing.counters("dia_spmv_p", "dia_jacobi_p", "dia_residual_p",
                             "dia_spmv", "dia_sweep", "residual_replace_f64")
_PLANE_COUNT = {m: f"dia_{m}_p" for m in ("spmv", "jacobi", "residual")}
_ENTRY = {  # (bands, vectors) -> C entry point
    (torch.float32, torch.float32): "afem_dia_stencil_f32_f32",
    (torch.bfloat16, torch.float32): "afem_dia_stencil_bf16_f32",
    (torch.float32, torch.float64): "afem_dia_stencil_f32_f64",
    (torch.float64, torch.float64): "afem_dia_stencil_f64_f64",
}


def reset_launch_counts() -> None:
    tracing.reset_counts(_LAUNCHES)


def launch_counts() -> dict[str, int]:
    return tracing.counts(_LAUNCHES)


def offsets3d(box) -> tuple:
    """Linear offsets of ``box`` -> (dx, dy, dz) grid deltas."""
    return _offsets3d(box.offsets, box.sx, box.sy)


@functools.cache
def _offsets3d(offsets: tuple, sx: int, sy: int) -> tuple:
    out = []
    for off in offsets:
        found = None
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                dz = off - dx * sx - dy * sy
                if -1 <= dz <= 1:
                    found = (dx, dy, dz)
        if found is None:
            raise ValueError(f"offset {off} is not a unit stencil delta")
        out.append(found)
    return tuple(out)


def _pads(box) -> tuple[int, int]:
    nyp2 = -(-(box.ny + 3) // SUBLANE) * SUBLANE  # ny+1 real rows + a zero each side
    nzp = -(-(box.nz + 3) // LANE) * LANE  # nz+1 real + a zero each side
    return nyp2, nzp


def pad_host_vec(box, x_flat, dtype=np.float32) -> np.ndarray:
    """Host-side pad of a flat (n_nodes,) vector into the plane layout."""
    nyp2, nzp = _pads(box)
    x3 = np.asarray(x_flat, dtype).reshape(box.shape)
    return np.pad(x3, ((0, 0), (1, nyp2 - box.ny - 2), (1, nzp - box.nz - 2)))


def pad_vec(x: torch.Tensor, shape, nyp: int, nzp: int) -> torch.Tensor:
    """Flat (n_nodes,) -> (nx+1, nyp, nzp) plane layout with zero pads."""
    nx1, ny1, nz1 = shape
    xp = torch.zeros((nx1, nyp, nzp), dtype=x.dtype, device=x.device)
    xp[:, 1 : ny1 + 1, 1 : nz1 + 1] = x.reshape(nx1, ny1, nz1)
    return xp


def unpad_vec(xp: torch.Tensor, shape) -> torch.Tensor:
    _, ny1, nz1 = shape
    return xp[:, 1 : ny1 + 1, 1 : nz1 + 1].reshape(-1)


def _check(mode, bands, x, band_major, ny, nz, b, aux) -> bool:
    """Raise on an operand the kernel does not take; True for a CUDA x.
    One attribute read per test, to keep a call's host cost near a PyTorch
    op's."""
    if mode not in MODES:
        raise ValueError(f"dia_stencil: unknown mode {mode!r}")
    xs = x.shape
    if bands.dim() != 4 or len(xs) != 3:
        raise ValueError(f"dia_stencil: bands must be 4-D and x 3-D, got "
                         f"{tuple(bands.shape)} and {tuple(xs)}")
    nx1, nyp, nzp = xs
    want = (N_BANDS, nx1, nyp, nzp) if band_major else (nx1, N_BANDS, nyp, nzp)
    if bands.shape != want:
        raise ValueError(f"dia_stencil: bands {tuple(bands.shape)}, expected {want}")
    if nyp < ny + 3 or nzp < nz + 3:
        raise ValueError(f"dia_stencil: planes ({nyp}, {nzp}) hold no zero "
                         f"border around ({ny + 1}, {nz + 1}) nodes")
    if (mode == "jacobi" and (b is None or aux is None)) or (mode == "residual" and b is None):
        raise ValueError(f"dia_stencil: mode {mode!r} is missing b or aux")
    dev, cuda = x.get_device(), x.is_cuda
    for t in (b, aux):
        if t is not None and (t.shape != xs or t.dtype != x.dtype):
            raise ValueError("dia_stencil: b and aux must match x in shape and dtype")
        if t is not None and (t.get_device() != dev or cuda and not t.is_contiguous()):
            raise ValueError("dia_stencil: b and aux must be contiguous, on x's device")
    if bands.get_device() != dev:
        raise ValueError("dia_stencil: operands lie on different devices")
    if cuda and not (bands.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_stencil: the CUDA kernel takes contiguous operands")
    if not cuda and x.device.type != "cpu":
        raise ValueError(f"dia_stencil: no kernel for device {x.device}")
    return cuda


def dia_stencil_plain(mode: str, bands: torch.Tensor, x: torch.Tensor, *,
                      band_major: bool, ny: int, nz: int,
                      b: torch.Tensor | None = None,
                      aux: torch.Tensor | None = None,
                      omega: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`dia_stencil`: 15 shifted band·x products over
    the real region of the planes, an x-plane past either end skipped."""
    B = bands.transpose(0, 1) if band_major else bands  # (nx+1, 15, ny', nz')
    nx1 = x.shape[0]
    ys, zs = slice(1, ny + 2), slice(1, nz + 2)
    Ax = torch.zeros((nx1, ny + 1, nz + 1), dtype=x.dtype, device=x.device)
    for d, (dx, dy, dz) in enumerate(KUHN_OFFS3):
        i0, i1 = max(0, -dx), nx1 - max(0, dx)
        if i1 > i0:
            Ax[i0:i1] += (B[i0:i1, d, ys, zs].to(x.dtype)
                          * x[i0 + dx : i1 + dx, 1 + dy : ny + 2 + dy,
                              1 + dz : nz + 2 + dz])
    if mode == "spmv":
        out = Ax
    else:
        r = b[:, ys, zs] - Ax
        if mode == "jacobi":
            out = x[:, ys, zs] + omega * aux[:, ys, zs] * r
        else:
            out = r if aux is None else r * aux[:, ys, zs]
    y = torch.zeros_like(x)
    y[:, ys, zs] = out
    return y


def dia_stencil(mode: str, bands: torch.Tensor, x: torch.Tensor, *,
                band_major: bool, ny: int, nz: int,
                b: torch.Tensor | None = None, aux: torch.Tensor | None = None,
                omega: float = 0.0) -> torch.Tensor:
    """The stencil operator on padded planes (K5-K8 on the card); see the
    module docstring for the modes, layouts and types."""
    if not _check(mode, bands, x, band_major, ny, nz, b, aux):
        return dia_stencil_plain(mode, bands, x, band_major=band_major, ny=ny,
                                 nz=nz, b=b, aux=aux, omega=omega)
    entry = _ENTRY.get((bands.dtype, x.dtype))
    if entry is None:
        raise TypeError(f"dia_stencil: no kernel for (bands, vectors) types "
                        f"{(bands.dtype, x.dtype)}")
    nx1, nyp, nzp = x.shape
    plane = nyp * nzp
    s_plane, s_band = (plane, nx1 * plane) if band_major else (N_BANDS * plane, plane)
    y = x.new_empty((nx1, nyp, nzp))
    kernels.launch(entry, x.device, MODES[mode],
                   bands.data_ptr(), s_plane, s_band, x.data_ptr(),
                   None if b is None else b.data_ptr(),
                   None if aux is None else aux.data_ptr(), y.data_ptr(),
                   nx1, nyp, nzp, ny + 1, nz + 1, float(omega))
    if mode == "residual" and x.dtype == torch.float64:
        tracing.count("residual_replace_f64")
    elif band_major:
        tracing.count("dia_spmv" if mode == "spmv" else "dia_sweep")
    else:
        tracing.count(_PLANE_COUNT[mode])
    return y


def _inv_nonzero(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def _bands_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy (JAX) bands to a tensor (a copy); bfloat16 comes as its 16 raw
    bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.tensor(np.asarray(a), device=device)


class DiaPlaneMatrixP:
    """x-major padded bands (nx+1, 15, ny', nz') over padded vectors.

    The MG-PCG operator: ``spmv`` (K5), ``jacobi_sweep`` (K6) and
    ``residual`` (K7) take and return (nx+1, ny', nz') vectors; ``pad_vec``
    and ``unpad_vec`` convert at the entry and exit of a solve."""

    def __init__(self, bands_p: torch.Tensor, nx: int, ny: int, nz: int):
        self.bands_p = bands_p
        self.nx, self.ny, self.nz = nx, ny, nz

    @classmethod
    def from_jax_numpy(cls, bands_p: np.ndarray, box, device) -> "DiaPlaneMatrixP":
        """From the numpy copy of a JAX ``DiaPlaneMatrixP.bands_p`` (the
        same layout)."""
        if tuple(bands_p.shape) != (box.nx + 1, len(KUHN_OFFS3)) + _pads(box):
            raise ValueError(f"bands_p {bands_p.shape} is not box {box.shape}'s "
                             "padded plane layout")
        return cls(_bands_from_numpy(bands_p, device), box.nx, box.ny, box.nz)

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx + 1, self.ny + 1, self.nz + 1)

    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        return pad_vec(x, self.shape, *self.bands_p.shape[2:])

    def unpad_vec(self, xp: torch.Tensor) -> torch.Tensor:
        return unpad_vec(xp, self.shape)

    def diagonal_p(self) -> torch.Tensor:
        d = self.bands_p[:, D0]
        return d.float() if d.dtype == torch.bfloat16 else d

    def inv_diagonal_p(self) -> torch.Tensor:
        return _inv_nonzero(self.diagonal_p())

    def astype_bands(self, dtype) -> "DiaPlaneMatrixP":
        return DiaPlaneMatrixP(self.bands_p.to(dtype), self.nx, self.ny, self.nz)

    def _apply(self, mode, xp, **kw) -> torch.Tensor:
        return dia_stencil(mode, self.bands_p, xp, band_major=False,
                           ny=self.ny, nz=self.nz, **kw)

    def spmv(self, xp: torch.Tensor) -> torch.Tensor:
        return self._apply("spmv", xp)

    def jacobi_sweep(self, xp: torch.Tensor, bp: torch.Tensor,
                     invd_p: torch.Tensor, omega: float) -> torch.Tensor:
        return self._apply("jacobi", xp, b=bp, aux=invd_p, omega=omega)

    def residual(self, bp: torch.Tensor, xp: torch.Tensor,
                 maskmul_p: torch.Tensor | None = None) -> torch.Tensor:
        """(b − A x) ⊙ maskmul (unmasked without it)."""
        return self._apply("residual", xp, b=bp, aux=maskmul_p)


class DiaStencilMatrix:
    """Band-major padded bands (15, nx+1, ny', nz') behind the flat-vector
    interface of ``DiaMatrix``: each call pads its vectors, runs the
    stencil kernel (K8) and unpads the result."""

    def __init__(self, bands_p: torch.Tensor, nx: int, ny: int, nz: int):
        self.bands_p = bands_p
        self.nx, self.ny, self.nz = nx, ny, nz

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx + 1, self.ny + 1, self.nz + 1)

    def _run(self, mode, x, **kw) -> torch.Tensor:
        nyp, nzp = self.bands_p.shape[2:]
        pad = {k: pad_vec(v, self.shape, nyp, nzp) for k, v in kw.items()
               if isinstance(v, torch.Tensor)}
        kw.update(pad)
        y = dia_stencil(mode, self.bands_p, pad_vec(x, self.shape, nyp, nzp),
                        band_major=True, ny=self.ny, nz=self.nz, **kw)
        return unpad_vec(y, self.shape)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("spmv", x)

    def diagonal(self) -> torch.Tensor:
        return unpad_vec(self.bands_p[D0], self.shape)

    def jacobi_sweep(self, x: torch.Tensor, b: torch.Tensor, omega: float) -> torch.Tensor:
        """x + ω·D⁻¹·(b − A x) in one kernel pass."""
        return self._run("jacobi", x, b=b, aux=_inv_nonzero(self.diagonal()),
                         omega=omega)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b − A x in one kernel pass."""
        return self._run("residual", x, b=b)


def _padded_band_major(A: DiaMatrix, box) -> torch.Tensor:
    if offsets3d(box) != KUHN_OFFS3:
        raise ValueError("the box's stencil is not the 15-offset Kuhn stencil")
    nyp2, nzp = _pads(box)
    bp = torch.zeros((len(KUHN_OFFS3), box.nx + 1, nyp2, nzp),
                     dtype=A.bands.dtype, device=A.bands.device)
    bp[:, :, 1 : box.ny + 2, 1 : box.nz + 2] = A.bands.reshape((-1,) + box.shape)
    return bp


def to_plane_matrix(A: DiaMatrix, box) -> DiaPlaneMatrixP:
    """A DiaMatrix's bands in the x-major padded plane layout (one copy)."""
    bp = _padded_band_major(A, box).transpose(0, 1).contiguous()
    return DiaPlaneMatrixP(bp, box.nx, box.ny, box.nz)


def to_stencil_matrix(A: DiaMatrix, box) -> DiaStencilMatrix:
    """A DiaMatrix's bands in the band-major padded layout (one copy)."""
    return DiaStencilMatrix(_padded_band_major(A, box), box.nx, box.ny, box.nz)
