"""Physics models (the reference's modules/*).

Ported so far: ``poisson`` (the Poisson and Laplace codenames).  The other
twelve families of ``arcanefem_tpu/models`` follow (ROADMAP Queue 1).
"""

from . import poisson  # noqa: F401

_ALL = ["poisson"]
