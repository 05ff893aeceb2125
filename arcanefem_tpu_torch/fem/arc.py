"""Reference ``.arc`` case-file reader.

The port's copy of ``arcanefem_tpu/fem/arc.py``, with one difference: a
mesh is looked for beside the case file, in the module root and under
``mesh_root``, and in no fixed directory of the reference checkout.

Runs the reference's XML case files directly (e.g.
modules/poisson/inputs/circle.2D.arc): mesh selection, <fem> options,
boundary conditions and linear-system choice are parsed into the typed
configs of this framework.

Solver-backend mapping:
  SequentialBasicLinearSystem -> dense direct (tiny systems)
  AlephLinearSystem (petsc/hypre/trilinos) -> cg (jacobi)
  HypreLinearSystem -> cg (amg), rtol from <rtol>
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from ..solver.linear_system import SolverOptions
from .bcs import (
    BoundaryConditions,
    DirichletBC,
    DirichletPointBC,
    NeumannBC,
)


@dataclass
class PostProcessing:
    """`<arcane-post-processing>` block (e.g. modules/poisson/inputs/
    circle.2D.arc:8-14): which node variables to dump, how often, and the
    format service name (the reference always uses VtkHdfV2PostProcessor)."""

    variables: list = field(default_factory=list)
    output_period: int = 1
    format: str = "VtkHdfV2PostProcessor"


@dataclass
class ArcCase:
    codename: str
    path: str
    mesh_file: str
    fem: ET.Element
    base_dir: str  # module root (for check/ result files)
    # mesh <initialization> variables: name -> [(cell group, value)]
    # (passmo's per-region Rho/Lambda/Mu, inputs/bar2d_tria.arc)
    mesh_init: dict = field(default_factory=dict)

    # parsed generic pieces
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    post_processing: PostProcessing | None = None


def _text(elem: ET.Element | None, default=None):
    if elem is None or elem.text is None:
        return default
    return elem.text.strip()


def _float(elem: ET.Element | None, default=None):
    t = _text(elem)
    return float(t) if t is not None else default


def opt_float(fem: ET.Element, name: str, default=None):
    return _float(fem.find(name), default)


def opt_text(fem: ET.Element, name: str, default=None):
    return _text(fem.find(name), default)


def opt_bool(fem: ET.Element, name: str, default=False):
    t = _text(fem.find(name))
    if t is None:
        return default
    return t.lower() == "true"


def parse_bcs(bc_elem: ET.Element | None) -> BoundaryConditions:
    bcs = BoundaryConditions()
    if bc_elem is None:
        return bcs
    for d in bc_elem.findall("dirichlet"):
        values = None
        comp = {}
        for ax, tag in enumerate(("valueX", "valueY", "valueZ")):
            v = opt_float(d, tag)
            if v is not None or d.find(tag) is not None:
                comp[ax] = v
        # Ux/Uy/Uz style used by elasticity-family modules
        for ax, tag in enumerate(("Ux", "Uy", "Uz")):
            v = opt_float(d, tag)
            if v is not None:
                comp[ax] = v
        if comp:
            values = tuple(comp.get(a) for a in range(3))
        bcs.dirichlet.append(
            DirichletBC(
                surface=_text(d.find("surface")),
                value=opt_float(d, "value"),
                values=values,
                method=opt_text(d, "enforce-Dirichlet-method", "Penalty"),
                penalty=opt_float(d, "penalty", 1.0e30),
            )
        )
    for d in bc_elem.findall("dirichlet-point"):
        comp = {}
        for ax, tag in enumerate(("Ux", "Uy", "Uz")):
            v = opt_float(d, tag)
            if v is not None:
                comp[ax] = v
        values = tuple(comp.get(a) for a in range(3)) if comp else None
        bcs.dirichlet_point.append(
            DirichletPointBC(
                node_group=_text(d.find("node")),
                value=opt_float(d, "value"),
                values=values,
                method=opt_text(d, "enforce-Dirichlet-method", "Penalty"),
                penalty=opt_float(d, "penalty", 1.0e30),
            )
        )
    for n in bc_elem.findall("neumann"):
        bcs.neumann.append(
            NeumannBC(
                surface=_text(n.find("surface")),
                value=opt_float(n, "value"),
                valueX=opt_float(n, "valueX"),
                valueY=opt_float(n, "valueY"),
                valueZ=opt_float(n, "valueZ"),
            )
        )
    return bcs


def parse_null_vector(text: str | None) -> tuple:
    """Space-separated component list with NULL = unset: '0.0 NULL' ->
    (0.0, None) (reference modules/elasticity/FemModule.cc:225-230)."""
    if text is None:
        return ()
    out = []
    for tok in text.split():
        out.append(None if tok.upper() == "NULL" else float(tok))
    return tuple(out)


def parse_bcs_vector(fem: ET.Element) -> BoundaryConditions:
    """BC surface of the vector-valued modules (elasticity family):
    <dirichlet-boundary-condition><surface>..<u>ux uy</u>,
    <dirichlet-point-condition><node>..<u>, <traction-boundary-condition>
    <surface>..<t>; fem-level <enforce-Dirichlet-method>/<penalty> defaults
    (reference modules/elasticity/Fem.axl)."""
    from .bcs import TractionBC

    bcs = BoundaryConditions()
    method = opt_text(fem, "enforce-Dirichlet-method", "Penalty")
    penalty = opt_float(fem, "penalty", 1.0e30)
    for d in fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=_text(d.find("surface")),
                values=parse_null_vector(_text(d.find("u"))),
                method=opt_text(d, "enforce-Dirichlet-method", method),
                penalty=opt_float(d, "penalty", penalty),
            )
        )
    for d in fem.findall("dirichlet-point-condition"):
        bcs.dirichlet_point.append(
            DirichletPointBC(
                node_group=_text(d.find("node")),
                values=parse_null_vector(_text(d.find("u"))),
                method=opt_text(d, "enforce-Dirichlet-method", method),
                penalty=opt_float(d, "penalty", penalty),
            )
        )
    for tr in fem.findall("traction-boundary-condition"):
        bcs.traction.append(
            TractionBC(
                surface=_text(tr.find("surface")),
                t=parse_null_vector(_text(tr.find("t"))),
            )
        )
    return bcs


def parse_solver(fem: ET.Element) -> SolverOptions:
    opts = SolverOptions()
    ls = fem.find("linear-system")
    if ls is None:
        # no <linear-system> means the Aleph default backend with
        # epsilon=1e-15 (AlephDoFLinearSystem.cc:346-378); run tight
        opts.rtol = 1.0e-12
        return opts
    name = ls.get("name", "")
    if name == "SequentialBasicLinearSystem":
        opts.method = "dense"
    elif name == "HypreLinearSystem":
        opts.method = "cg"
        # the Hypre backend always preconditions PCG with one BoomerAMG
        # V-cycle (HypreDoFLinearSystem.cc:686-742) — map it onto the
        # aggregation AMG (solver/amg.py; block systems use node-aggregation
        # AMG with block Frobenius strength inside build_amg)
        opts.preconditioner = "amg"
        rtol = opt_float(ls, "rtol")
        if rtol is not None:
            opts.rtol = rtol
        atol = opt_float(ls, "atol")
        if atol is not None:
            opts.atol = atol
        mi = opt_float(ls, "max-iter")
        if mi is not None:
            opts.max_iter = int(mi)
    else:  # AlephLinearSystem & default
        eps = opt_float(ls, "epsilon")
        if eps is not None:
            # Aleph epsilon 1e-15 is an absolute-ish tolerance; we keep a
            # tight relative tolerance for golden-file parity
            opts.rtol = max(eps, 1.0e-12)
    pc = opt_text(ls, "preconditioner")
    if pc is not None:
        # Aleph preconditioner enum (AlephDoFLinearSystemFactory.axl):
        # diagonal|amg|ainv|ic|poly|ilu|ilup|none — amg maps onto the
        # aggregation AMG; poly and the triangular-solve/approximate-
        # inverse kinds (ainv/ic/ilu/ilup) onto the Chebyshev polynomial
        # preconditioner (solver/poly.py), the standard accelerator
        # substitute since sequential triangular solves don't map to TPU
        opts.preconditioner = {
            "diagonal": "jacobi", "amg": "amg", "none": "none",
            "poly": "poly", "ainv": "poly", "ic": "poly",
            "ilu": "poly", "ilup": "poly",
        }.get(pc, "jacobi")
    method = opt_text(ls, "solver-method")
    if method == "gmres":
        # (AlephDoFLinearSystemFactory.axl solver-method) on-device GMRES(m)
        opts.method = "gmres"
    elif method == "bicgstab":
        opts.method = "bicgstab"
    elif method == "bicgstab2":
        # Sleijpen-Fokkema BiCGStab(2) (solver/iterative.py::bicgstab2)
        opts.method = "bicgstab2"
    return opts


def load_case(path: str, mesh_root: str | None = None) -> ArcCase:
    tree = ET.parse(path)
    root = tree.getroot()
    codename = root.get("codename")

    mesh_file = None
    meshes = root.find("meshes")
    if meshes is not None:
        m = meshes.find("mesh")
        if m is not None:
            mesh_file = _text(m.find("filename"))
    if mesh_file is None:
        m = root.find("mesh")
        if m is not None:  # legacy <mesh><meshes-file>
            mesh_file = _text(m.find("filename")) or _text(m.find("meshes-file"))
    if mesh_file is None:
        raise ValueError(f"{path}: no mesh filename found")

    base_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    candidates = [
        os.path.join(os.path.dirname(path), mesh_file),
        os.path.join(base_dir, mesh_file),
    ]
    if mesh_root:
        candidates.append(os.path.join(mesh_root, os.path.basename(mesh_file)))
    resolved = next((c for c in candidates if os.path.exists(c)), None)
    if resolved is None:
        raise FileNotFoundError(f"mesh '{mesh_file}' not found near {path}")

    fem = root.find("fem")
    if fem is None:
        fem = root.find("elastodynamic")  # passmo module root element
    if fem is None:
        raise ValueError(f"{path}: no <fem>/<elastodynamic> element")

    mesh_init: dict = {}
    if meshes is not None and meshes.find("mesh") is not None:
        init = meshes.find("mesh").find("initialization")
        if init is not None:
            for v in init.findall("variable"):
                mesh_init.setdefault(_text(v.find("name")), []).append(
                    (_text(v.find("group")), float(_text(v.find("value"))))
                )

    case = ArcCase(
        codename=codename,
        path=path,
        mesh_file=resolved,
        fem=fem,
        base_dir=base_dir,
        mesh_init=mesh_init,
    )
    pp = root.find("arcane-post-processing")
    if pp is not None:
        out = pp.find("output")
        fmt = pp.find("format")
        case.post_processing = PostProcessing(
            variables=[_text(v) for v in out.findall("variable")]
            if out is not None else [],
            output_period=int(_text(pp.find("output-period"), 1)),
            format=fmt.get("name") if fmt is not None
            else "VtkHdfV2PostProcessor",
        )

    case.bcs = parse_bcs(fem.find("boundary-conditions"))
    case.solver = parse_solver(fem)
    rf = opt_text(fem, "result-file")
    if rf:
        cands = [
            os.path.join(base_dir, rf),
            os.path.join(base_dir, "tests", rf),
            os.path.join(base_dir, "check", rf),
        ]
        case.result_file = next((c for c in cands if os.path.exists(c)), cands[0])
    return case
