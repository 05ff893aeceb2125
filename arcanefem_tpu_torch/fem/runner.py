"""Case runner: codename -> model dispatch.

The counterpart of ``arcanefem_tpu/fem/runner.py``: each model registers a
``run(case, mesh, dtype, device, ...)`` callable and :func:`run_case` plays
the role of the reference's ArcaneLauncher, on one device (the card by
default).  Post-processing output (``output_dir``, the VTKHDF writer of
``fem/vtkhdf.py``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..mesh.core import read_msh
from .arc import load_case

_REGISTRY: dict[str, Callable] = {}

# the ROADMAP entry of the features that raise until they are ported
OUTPUT_NOT_PORTED = ("--output-dir / output_dir (fem/vtk.py and fem/vtkhdf.py) "
                     "is not ported yet (ROADMAP Queue 1 item 5)")


def register(codename: str):
    def deco(fn):
        # case-insensitive: reference case files are inconsistent
        # (codename="aerodynamics" vs "Poisson")
        _REGISTRY[codename.lower()] = fn
        return fn

    return deco


def run_case(
    path: str,
    dtype=None,
    mesh_root: str | None = None,
    rcm: bool = False,
    verbose: bool = False,
    output_dir: str | None = None,
    device="cuda",
    **kw,
):
    """Load an .arc case, read its mesh, dispatch to the registered model
    on ``device``.

    dtype: float64 (default) or float32, numpy or torch.
    rcm: bandwidth-reducing node renumbering (utils/ordering.py); golden
    validation is uid-keyed, so results are invariant.
    verbose: print `[ArcaneFem-Timer]` phase lines (the reference's
    per-phase wall-clock instrumentation, modules/poisson/FemModule.cc:28-39).
    output_dir: not ported yet; raises NotImplementedError.
    """
    if output_dir:
        raise NotImplementedError(OUTPUT_NOT_PORTED)
    case = load_case(path, mesh_root=mesh_root)
    key = (case.codename or "").lower()
    if key not in _REGISTRY:
        # import model modules lazily so registration side-effects run
        from ..models import _ALL

        _ = _ALL
    if key not in _REGISTRY:
        raise KeyError(
            f"no model registered for codename '{case.codename}' "
            f"(have: {sorted(_REGISTRY)}; the others are not ported yet, "
            "ROADMAP Queue 1 item 9)"
        )
    mesh = read_msh(case.mesh_file)
    if rcm:
        from ..sparse.topology import build_topology
        from ..utils.ordering import rcm_order, renumber_mesh

        topo = build_topology(mesh.n_nodes, mesh.cells)
        mesh = renumber_mesh(
            mesh, rcm_order(mesh.n_nodes, topo.row_ptr, topo.csr_cols)
        )
    if verbose and "timer" not in kw:
        from .timer import PhaseTimer

        kw["timer"] = PhaseTimer(verbose=True)
    return _REGISTRY[key](case, mesh, dtype=dtype or np.float64, device=device, **kw)
