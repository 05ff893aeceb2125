"""Physics models (the reference's modules/*).

Ported: ``poisson`` (the Poisson and Laplace codenames), ``fourier``,
``electrostatics``, ``acoustics`` and ``aerodynamics``.  The other
codenames of ``arcanefem_tpu/models`` raise, naming their ROADMAP item
(:data:`NOT_PORTED`).
"""

from . import acoustics, aerodynamics, electrostatics, fourier, poisson  # noqa: F401

_ALL = ["poisson", "fourier", "electrostatics", "acoustics", "aerodynamics"]

# codename (lower case) -> what it waits for, in ROADMAP.md Queue 1
NOT_PORTED = {
    "bilaplacian": "block BELL, ROADMAP Queue 1 item 9",
    "elasticity": "block BELL and the rigid-body-mode AMG, ROADMAP Queue 1 item 9",
    "heat": "transient support, ROADMAP Queue 1 items 8 and 9",
    "elastodynamics": "transient support and block BELL, ROADMAP Queue 1 items 8 and 9",
    "soildynamics": "transient support and block BELL, ROADMAP Queue 1 items 8 and 9",
    "passmo": "block BELL, ops/faces.py and ops/gauss_state.py, ROADMAP Queue 1 item 9",
    "testlab": "the testlab entry point, ROADMAP Queue 1 item 10",
}
