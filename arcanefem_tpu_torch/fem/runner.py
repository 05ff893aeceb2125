"""Case runner: codename -> model dispatch.

The counterpart of ``arcanefem_tpu/fem/runner.py``: each model registers a
``run(case, mesh, dtype, device, ...)`` callable and :func:`run_case` plays
the role of the reference's ArcaneLauncher, on one device (the card by
default).  ``output_dir`` writes the case's ``<arcane-post-processing>``
variables after the run: VTKHDF (``fem/vtkhdf.py``) where h5py can be
imported, legacy VTK (``fem/vtk.py``) where it cannot, as in the JAX
package.  A declared variable is looked up on the result under the
reference's names (``_VAR_ALIASES``: NodeTemperature is heat's ``T``,
Displ passmo's ``u``, StrainVol/StrainDev/StressVol/StressDev its
recovered cell fields).  A result with a non-empty ``history`` of (t,
field) snapshots (heat's ``keep_history``) becomes one temporal VTKHDF
file, one ``add_step`` per snapshot; without h5py the legacy VTK file
holds the final fields.
"""

from __future__ import annotations

import inspect
from typing import Callable

import numpy as np

from ..mesh.core import read_msh
from .arc import load_case

_REGISTRY: dict[str, Callable] = {}


def register(codename: str):
    def deco(fn):
        # case-insensitive: reference case files are inconsistent
        # (codename="aerodynamics" vs "Poisson")
        _REGISTRY[codename.lower()] = fn
        return fn

    return deco


# declared .arc output-variable name (lower case) -> result attributes to
# try, the JAX runner's table (U/V/A displacement-velocity-acceleration,
# NodeTemperature for heat, Displ for passmo, Phi/E electrostatics, psi
# aerodynamics, u1/u2 bilaplacian, passmo's recovered cell variables,
# Elastodynamic.axl:41-52)
_VAR_ALIASES = {
    "u": ("u",), "v": ("v",), "a": ("a",),
    "nodetemperature": ("T", "u"), "displ": ("u",),
    "phi": ("phi",), "e": ("E",), "psi": ("psi",), "flux": ("flux",),
    "u1": ("u1",), "u2": ("u2",),
    "strainvol": ("strain_vol",), "straindev": ("strain_dev",),
    "stressvol": ("stress_vol",), "stressdev": ("stress_dev",),
}


def _write_post_processing(case, mesh, res, output_dir: str) -> str:
    """Write the case's `<arcane-post-processing>` variables as a VTKHDF
    file (the reference's VtkHdfV2PostProcessor output), or as legacy
    ASCII VTK where h5py cannot be imported; returns the file's path."""
    import os

    point_data, cell_data = {}, {}
    for name in case.post_processing.variables:
        attrs = _VAR_ALIASES.get(name.lower(), (name, name.lower()))
        val = next(
            (getattr(res, a) for a in attrs if getattr(res, a, None)
             is not None),
            None,
        )
        if val is None:
            continue  # derived-only variables (e.g. UExact): no field held
        if isinstance(val, dict):
            cell_data[name] = val
        else:
            arr = np.asarray(val)
            (point_data if arr.shape[0] == mesh.n_nodes else cell_data)[
                name
            ] = arr
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(case.path))[0]
    from . import vtkhdf

    history = getattr(res, "history", None)
    if vtkhdf.HAVE_H5PY:
        out = os.path.join(output_dir, stem + ".hdf")
        if history:
            # transient snapshots [(t, field)] -> one temporal VTKHDF file,
            # the field under the first declared point variable's name
            name = next(iter(point_data), "U")
            with vtkhdf.VtkHdfWriter(out, mesh) as w:
                for t, snap in history:
                    w.add_step(float(t), point_data={name: snap})
        else:
            vtkhdf.write_vtkhdf(out, mesh, point_data=point_data, cell_data=cell_data)
    else:
        from .vtk import write_vtk

        out = os.path.join(output_dir, stem + ".vtk")
        write_vtk(out, mesh, point_data=point_data, cell_data=cell_data)
    return out


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
    output_dir: write the case's `<arcane-post-processing>` variables
    there after the run (VTKHDF with h5py, legacy VTK without); a model
    that takes ``keep_history`` (heat) then keeps its per-step snapshots
    for a temporal file unless ``keep_history`` is given.
    """
    case = load_case(path, mesh_root=mesh_root)
    key = (case.codename or "").lower()
    if key not in _REGISTRY:
        # import model modules lazily so registration side-effects run
        from ..models import NOT_PORTED

        if key in NOT_PORTED:
            raise KeyError(f"codename '{case.codename}' is not ported yet "
                           f"({NOT_PORTED[key]})")
    if key not in _REGISTRY:
        raise KeyError(
            f"no model registered for codename '{case.codename}' "
            f"(have: {sorted(_REGISTRY)})"
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
    fn = _REGISTRY[key]
    if output_dir and "keep_history" in inspect.signature(fn).parameters:
        # a transient model's snapshots become the temporal output file
        kw.setdefault("keep_history", True)
    res = fn(case, mesh, dtype=dtype or np.float64, device=device, **kw)
    if output_dir and case.post_processing is not None:
        out = _write_post_processing(case, mesh, res, output_dir)
        if verbose:
            print(f"[post-processing] wrote {out}")
    return res
