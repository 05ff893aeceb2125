"""Physics models (the reference's modules/*).

Ported: ``poisson`` (the Poisson and Laplace codenames), ``fourier``,
``electrostatics``, ``acoustics``, ``aerodynamics``, ``bilaplacian``,
``elasticity``, ``elastodynamics``, the transient families ``heat``,
``soildynamics`` and ``passmo``, and ``testlab_model`` (the Testlab
codename).  :data:`NOT_PORTED` is empty: every codename runs.
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
    testlab_model,
)

_ALL = ["poisson", "fourier", "electrostatics", "acoustics", "aerodynamics",
        "bilaplacian", "elasticity", "elastodynamics", "heat", "soildynamics", "passmo",
        "testlab_model"]

# codename (lower case) -> what it waits for, in ROADMAP.md Queue 1
NOT_PORTED: dict[str, str] = {}
