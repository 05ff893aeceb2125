"""DIA (diagonal/offset) sparse matrix of the structured box, plain PyTorch.

The counterpart of ``arcanefem_tpu/sparse/dia.py``: row r couples to
column r + offsets[d] with coefficient bands[d, r], and

    y = sum_d band_d * roll(x, -offset_d)

where a wrapped-around entry always meets a zero band (no cell couples
those nodes).  It holds the assembled operator for the tests, for the
float64 true-residual check of the structured bench and as the input of
``sparse/dia_stencil.py``'s padded layouts; the solver's kernels run on
those layouts.
"""

from __future__ import annotations

import numpy as np
import torch


class DiaMatrix:
    """bands: (D, N) coefficients; offsets: tuple of D int deltas."""

    def __init__(self, bands: torch.Tensor, offsets: tuple):
        self.bands = bands
        self.offsets = tuple(offsets)

    @property
    def n_dofs(self) -> int:
        return self.bands.shape[1]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        y = None
        for d, off in enumerate(self.offsets):
            t = self.bands[d] * (x if off == 0 else torch.roll(x, -off))
            y = t if y is None else y + t
        return y

    def diagonal(self) -> torch.Tensor:
        return self.bands[self.offsets.index(0)]

    def with_bands(self, bands: torch.Tensor) -> "DiaMatrix":
        return DiaMatrix(bands, self.offsets)

    def todense(self) -> np.ndarray:
        """Dense numpy copy, for tests and small systems."""
        n = self.n_dofs
        b = self.bands.detach().cpu().numpy()
        out = np.zeros((n, n), b.dtype)
        rows = np.arange(n)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            m = (cols >= 0) & (cols < n)
            out[rows[m], cols[m]] = b[d, m]
        return out
