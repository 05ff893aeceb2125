"""Typed boundary-condition configuration.

The port's copy of ``arcanefem_tpu/fem/bcs.py``.  Mirrors the option
surface of the reference's FemBoundaryConditions service
(femutils/FemBoundaryConditions.axl:7-131 and IArcaneFemBC.h:19-73):
repeated <dirichlet>, <dirichlet-point>, <neumann>, <manufactured-solution>
blocks with penalty (default 1e30) and enforce-Dirichlet-method (default
"Penalty").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class DirichletBC:
    surface: str
    value: float | None = None
    # vector modules (elasticity & co) give per-component values; None = free
    values: tuple[float | None, ...] | None = None
    method: str = "Penalty"
    penalty: float = 1.0e30


@dataclass
class DirichletPointBC:
    node_group: str
    value: float | None = None
    values: tuple[float | None, ...] | None = None
    method: str = "Penalty"
    penalty: float = 1.0e30


@dataclass
class TractionBC:
    """Vector surface load `<traction-boundary-condition><t>tx ty [tz]</t>`
    (reference modules/elasticity/FemModule.cc traction assembly: each face
    node gets t_c * measure / n_face_nodes per component; NULL = 0)."""

    surface: str
    t: tuple = (None, None, None)


@dataclass
class NeumannBC:
    surface: str
    value: float | None = None
    valueX: float | None = None
    valueY: float | None = None
    valueZ: float | None = None

    def vector(self) -> tuple[float, float, float]:
        return (self.valueX or 0.0, self.valueY or 0.0, self.valueZ or 0.0)


@dataclass
class ManufacturedSolution:
    """Manufactured Dirichlet/source given as Python callables of (x,y,z).

    The reference wires these through C# user functions + IStandardFunction
    (modules/fourier/ExternalFunctions.cs, FemModule.cc:35-55); here they are
    plain callables, called with torch tensors of the coordinates on the
    problem's device.
    """

    dirichlet: Callable | None = None
    source: Callable | None = None
    method: str = "Penalty"
    penalty: float = 1.0e30


@dataclass
class BoundaryConditions:
    dirichlet: list[DirichletBC] = field(default_factory=list)
    dirichlet_point: list[DirichletPointBC] = field(default_factory=list)
    neumann: list[NeumannBC] = field(default_factory=list)
    traction: list[TractionBC] = field(default_factory=list)
    manufactured: ManufacturedSolution | None = None


def dtype_safe_penalty(penalty: float, dtype) -> float:
    """Clamp the reference's 1e30 default to an f32-safe magnitude.

    With f32 arithmetic, r·r on penalty rows overflows past ~1e19; 1e12
    keeps the enforcement error (~1/P) far below golden-file tolerances.
    """
    import numpy as np

    if np.dtype(dtype) == np.float32:
        return min(penalty, 1.0e12)
    return penalty
