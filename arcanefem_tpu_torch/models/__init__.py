"""Physics models (the reference's modules/*).

Ported: ``poisson`` (the Poisson and Laplace codenames), ``fourier``,
``electrostatics``, ``acoustics``, ``aerodynamics``, ``bilaplacian``,
``elasticity`` and ``elastodynamics``.  The other codenames of
``arcanefem_tpu/models`` raise, naming their ROADMAP item
(:data:`NOT_PORTED`).
"""

from . import (  # noqa: F401
    acoustics,
    aerodynamics,
    bilaplacian,
    elasticity,
    elastodynamics,
    electrostatics,
    fourier,
    poisson,
)

_ALL = ["poisson", "fourier", "electrostatics", "acoustics", "aerodynamics",
        "bilaplacian", "elasticity", "elastodynamics"]

# codename (lower case) -> what it waits for, in ROADMAP.md Queue 1
NOT_PORTED = {
    "heat": "fem/checkpoint.py and the time-history output, ROADMAP Queue 1 items 5 and 9",
    "soildynamics": "its paraxial and double-couple terms, ROADMAP Queue 1 item 9",
    "passmo": "ops/faces.py, ops/gauss_state.py and the block quadrature integrals, "
              "ROADMAP Queue 1 item 9",
    "testlab": "the testlab entry point, ROADMAP Queue 1 item 10",
}
