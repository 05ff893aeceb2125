"""Time-series case tables with linear interpolation.

The port's copy of ``arcanefem_tpu/fem/casetable.py``, the counterpart of
the reference's ``readFileAsCaseTable`` + Arcane CaseTable
(femutils/FemUtils.cc:180-228): whitespace-separated floats, each row =
[time, v_1..v_ndim], linearly interpolated (CurveLinear) and clamped at
the ends.  Used for transient tractions (modules/elastodynamics/
FemModule.cc:305-320).

The interpolation runs on the host in float64 numpy, with ``jnp.interp``'s
formula ``fp[i-1] + q * df``, q = (t - xp[i-1]) / dx, and the multiply-add
rounded once (a fused multiply-add, exact through ``fractions``), as the
compiled JAX table computes it: the values then agree bit for bit.
``numpy.interp`` computes ``(df / dx) * (t - xp[i-1]) + fp[i-1]`` with two
roundings, which differs in the last bit at most times.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np


def _fma(a: float, b: float, c: float) -> float:
    """a·b + c rounded once (exact rationals, then one rounding)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


@dataclass
class CaseTable:
    times: np.ndarray  # (T,) ascending
    values: np.ndarray  # (T, ndim)

    def value(self, t) -> np.ndarray:
        """(ndim,) float64 linear interpolation at time t, clamped at the
        ends."""
        xp = np.asarray(self.times, np.float64)
        fp = np.asarray(self.values, np.float64)
        x = np.float64(t)
        i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
        df = fp[i] - fp[i - 1]
        dx = xp[i] - xp[i - 1]
        delta = x - xp[i - 1]
        if abs(dx) <= np.spacing(np.finfo(np.float64).eps):
            f = fp[i - 1].copy()
        else:
            q = float(delta / dx)
            f = np.array([_fma(q, float(d), float(v)) for d, v in zip(df, fp[i - 1])])
        if x < xp[0]:
            f = fp[0].copy()
        if x > xp[-1]:
            f = fp[-1].copy()
        return f


def read_case_table(path: str, ndim: int) -> CaseTable:
    with open(path) as fh:
        data = np.array(fh.read().split(), dtype=np.float64)
    if len(data) % (ndim + 1) != 0:
        raise ValueError(
            f"{path}: {len(data)} values is not a multiple of {ndim + 1}"
        )
    rows = data.reshape(-1, ndim + 1)
    return CaseTable(times=rows[:, 0], values=rows[:, 1:])
