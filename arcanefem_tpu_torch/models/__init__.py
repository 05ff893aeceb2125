"""Physics models (the reference's modules/*).

Ported: ``poisson`` (the Poisson and Laplace codenames), ``fourier``,
``electrostatics``, ``acoustics``, ``aerodynamics``, ``bilaplacian``,
``elasticity``, ``elastodynamics`` and the transient families ``heat``,
``soildynamics`` and ``passmo``.  The ``testlab`` codename raises, naming
its ROADMAP item (:data:`NOT_PORTED`).
"""

from . import (  # noqa: F401
    acoustics,
    aerodynamics,
    bilaplacian,
    elasticity,
    elastodynamics,
    electrostatics,
    fourier,
    heat,
    passmo,
    poisson,
    soildynamics,
)

_ALL = ["poisson", "fourier", "electrostatics", "acoustics", "aerodynamics",
        "bilaplacian", "elasticity", "elastodynamics", "heat", "soildynamics", "passmo"]

# codename (lower case) -> what it waits for, in ROADMAP.md Queue 1
NOT_PORTED = {
    "testlab": "the testlab entry point, ROADMAP Queue 1 item 10",
}
