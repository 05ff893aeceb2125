"""Passmo: general-element transient elastodynamics (the "full FEM" module).

The counterpart of ``arcanefem_tpu/models/passmo.py`` (reference
modules/passmo, ElastodynamicModule.cc and Elastodynamic.axl), at the JAX
module's option surface:

* every cell type of the zoo per mesh (tria3/6, quad4/8, tetra4/10,
  hexa8/20, penta6, pyramid5; mixed meshes bucket by type, one
  ``block_slot_reduce`` over all buckets per operator) with persistent
  per-Gauss-point state (``ops/gauss_state.py``, the GaussDoFsOnCells
  role, ElastodynamicModule.cc:188-253);
* Newmark-β / Generalized-α in displacement form
      (cm·M + (1−αf)·K + c1·Mparax)·d_{n+1} = M(cm·u_pred − αm·a_n) − αf·K·d_n
                                              + f_ext + f_parax
  (ElastodynamicModule.cc:1707-1793 LHS, 1798-2104 RHS, 554-591 update);
* per-region elastic properties from the mesh ``<initialization>``
  variables and ``<init-elast-properties>`` blocks (young/lame/veloc,
  ElastodynamicModule.cc:331-382);
* imposed displacement / velocity / acceleration / force on surfaces and
  node groups, constant or CaseTable curves with x/y/z-axis selectors,
  with the reference's Newmark overrides (:567-582) and its asymmetry:
  point conditions with imposed A/V also Dirichlet-constrain the
  displacement (:736-746), surface conditions do not (:655-657);
* Neumann tractions, constant or a curve, as consistent Gauss face loads;
* paraxial absorbing boundaries on the face zoo: LHS c1·∫φφ·P(n) and RHS
  ∫φφ·P(n)(c1·u_pred − c0·v_pred − αf·v_n) with P(n) = ρ(cs(I−n⊗n) +
  cp·n⊗n) (``ops/faces.py``), outer-domain properties or the inner
  boundary cell's, and (``paraxial_incident``, default on) the incident
  traction 2·P(n)·v_in of the analytic or type-6 input motions;
* initial node and cell conditions, double-couple sources on the xy, yz
  and xz planes, gravity;
* stress/strain recovery: the volume-weighted per-cell Voigt strain and
  linear-elastic stress with the initial cell tensors
  (StrainVol/StrainDev/StressVol/StressDev, Elastodynamic.axl:41-52).

As in JAX, the operator is frozen once and each step is RHS-only: one or
two ``sell_spmv``, the paraxial, incident-wave and timed-traction sums
through ``SlotSum``s whose lists are built once per face bucket (a fixed
order, the same bits in every run), the imposed values written through
the frozen masks.  The JAX package's jitted step functions are plain
tensor functions here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.casetable import CaseTable
from ..fem.problem import FemProblem, numpy_dtype
from ..fem.timer import PhaseTimer
from ..fem.transient import anchor_atol, free_residual
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import faces as F
from ..ops.gauss_state import GaussState
from ..solver.amg_setup import rigid_body_modes
from ..solver.iterative import make_precond
from ..solver.linear_system import SolverOptions, solve_finalized
from .fourier import _rows_in_bucket

_3NONE = (None, None, None)


# --------------------------------------------------------------------------
# analytic incident-motion functions (modules/passmo/analytic_func.cc)
# --------------------------------------------------------------------------


@dataclass
class AnalyticInput:
    """Parameters of the analytical input motions (Elastodynamic.axl:388-425)."""

    tp: float = 1.0
    ts: float = 1.0
    coef: float = 1.0
    amplit: float = 1.0
    phase: float = 0.0
    order: int = 2

    def ricker(self, t: float) -> float:
        x = math.pi * (t - self.ts) / self.tp
        x2 = x * x
        e = self.amplit * math.exp(-x2)
        if self.order == 0:
            return e
        if self.order == 1:
            return -math.sqrt(2.0) * math.exp(0.5) * e * x
        if self.order == 3:
            k = 1.5 - math.sqrt(1.5)
            return math.exp(k) * e * (1.5 - x2) * x / math.sqrt(1.5 * k)
        return 0.5 * math.exp(1.5) * e * (x2 - 0.5)  # default order 2

    def harmonic(self, t: float) -> float:
        return self.amplit * math.sin(2 * math.pi * t / self.tp + self.phase)

    def decay(self, t: float) -> float:
        return self.amplit * math.exp(max(-700.0, -self.coef * t))

    def tsang(self, t: float) -> float:
        return self.decay(t) * math.sin(2 * math.pi * t / self.tp + self.phase)

    def dirac(self, t: float, dt: float) -> float:
        return self.amplit if abs(t - self.tp) < 0.5 * dt else 0.0

    def value(self, typ: int, t: float, dt: float) -> float:
        return {1: self.harmonic, 2: self.ricker, 3: self.decay,
                4: self.tsang}.get(typ, lambda tt: self.dirac(tt, dt))(t)


# --------------------------------------------------------------------------
# condition dataclasses (the Elastodynamic.axl option surface)
# --------------------------------------------------------------------------


@dataclass
class ImposedCond:
    """dirichlet-surface-condition / dirichlet-point-condition
    (Elastodynamic.axl:202-330): constant U/V/A/F per component plus
    optional 3-column time-history curves gated by the x/y/z-axis flags."""

    group: str
    is_surface: bool = True
    U: tuple = _3NONE
    V: tuple = _3NONE
    A: tuple = _3NONE
    Fv: tuple = _3NONE
    u_curve: CaseTable | None = None
    v_curve: CaseTable | None = None
    a_curve: CaseTable | None = None
    f_curve: CaseTable | None = None
    axes: tuple = (False, False, False)

    def comps(self, kind: str, ndof: int) -> list[int]:
        const = {"u": self.U, "v": self.V, "a": self.A, "f": self.Fv}[kind]
        curve = getattr(self, f"{kind}_curve")
        return [
            c for c in range(ndof)
            if (const[c] is not None) or (curve is not None and self.axes[c])
        ]


@dataclass
class NeumannCond:
    surface: str
    t: tuple = _3NONE
    curve: CaseTable | None = None


@dataclass
class ParaxialCond:
    """paraxial-boundary-condition (Elastodynamic.axl:357-426)."""

    surface: str
    rho: float | None = None
    cs: float | None = None
    cp: float | None = None
    E: float | None = None
    nu: float | None = None
    lam: float | None = None
    mu: float | None = None
    input_type: int = 0
    analytic: AnalyticInput = field(default_factory=AnalyticInput)
    u_input: CaseTable | None = None
    v_input: CaseTable | None = None
    a_input: CaseTable | None = None
    normal_angle: float = 0.0
    in_plane_angle: float = 0.0


@dataclass
class ElastProps:
    """init-elast-properties block (Elastodynamic.axl:146-176)."""

    cell_group: str
    rho: float = 2500.0
    young: float = 0.0
    nu: float = 0.0
    lam: float = 0.0
    mu: float = 0.0
    vp: float = 0.0
    vs: float = 0.0


@dataclass
class InitCellCond:
    """init-cell-condition block: initial Voigt tensors per cell group
    (vol = xx yy zz, dev = xy yz xz; Elastodynamic.axl:178-199)."""

    cell_group: str
    vol_stress: tuple = (0.0, 0.0, 0.0)
    vol_strain: tuple = (0.0, 0.0, 0.0)
    dev_stress: tuple = (0.0, 0.0, 0.0)
    dev_strain: tuple = (0.0, 0.0, 0.0)


@dataclass
class InitNodeCond:
    """initial-node-condition block (Elastodynamic.axl:429-446)."""

    node_group: str
    U: tuple | None = None
    V: tuple | None = None
    A: tuple | None = None
    Fv: tuple | None = None


@dataclass
class PassmoDoubleCouple:
    """double-couple block (Elastodynamic.axl:490-523): Ft from a seismic
    moment M0(t)/distance or a direct loading history; source plane selects
    the force components (ElastodynamicModule.cc:1997-2006)."""

    north: str
    south: str
    east: str
    west: str
    source_plane: int = 0  # 0=xy, 1=yz, 2=xz
    moment_table: CaseTable | None = None
    loading_table: CaseTable | None = None
    dew: float = 1.0
    dns: float = 1.0


@dataclass
class PassmoConfig:
    analysis_type: str = "planestrain"
    start: float = 0.0
    tmax: float = 1.0
    dt: float = 0.1
    beta: float = 0.25
    gamma: float = 0.5
    # Generalized-alfa (Chung–Hulbert): the reference declares these options
    # (Elastodynamic.axl:476-483 alfam/alfaf/alfa_method) but fatals on use
    # ("Generalized-alfa will be done later", ElastodynamicModule.cc:1756);
    # implemented here: M a_{n+1-αm} + K d_{n+1-αf} = 0 in displacement form
    alfa_method: bool = False
    alfam: float = 0.0
    alfaf: float = 0.0
    ninteg: int = 2  # gauss-nint (Elastodynamic.axl:448)
    gravity: tuple = (0.0, 0.0, 0.0)  # gx/gy/gz options
    # material per cell group: name -> value (mesh <initialization>)
    rho: dict = field(default_factory=dict)
    lam: dict = field(default_factory=dict)
    mu: dict = field(default_factory=dict)
    elast_type: str = ""  # init-elast-type: young|lame|veloc
    init_props: list = field(default_factory=list)  # [ElastProps]
    init_cells: list = field(default_factory=list)  # [InitCellCond]
    init_nodes: list = field(default_factory=list)  # [InitNodeCond]
    conditions: list = field(default_factory=list)  # [ImposedCond]
    neumann: list = field(default_factory=list)  # [NeumannCond]
    paraxial: list = field(default_factory=list)  # [ParaxialCond]
    double_couple: list = field(default_factory=list)  # [PassmoDoubleCouple]
    paraxial_incident: bool = True  # add 2·P·v_in (reference stores only)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    penalty: float = 1.0e30
    method: str = "Penalty"
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4  # _checkResultFile epsilon
    result_min_value: float = 1.0e-10
    recover_fields: bool = True
    stress_file: str | None = None
    strain_file: str | None = None


@dataclass
class PassmoResult:
    u: np.ndarray
    v: np.ndarray
    a: np.ndarray
    steps: int
    problem: FemProblem
    # per-cell Voigt recovery: {cell_type: (nc, 3)} — the StrainVol/StrainDev/
    # StressVol/StressDev cell variables (Elastodynamic.axl:41-52)
    strain_vol: dict | None = None
    strain_dev: dict | None = None
    stress_vol: dict | None = None
    stress_dev: dict | None = None
    # Krylov iterations over every step's solve, and each step's
    iterations: int = 0
    step_iterations: list = field(default_factory=list)
    residual: float = 0.0  # the last step's monitored residual
    solve_s: float = 0.0  # the steps' solve seconds (the card synchronised)
    info: dict = field(default_factory=dict)  # the last step's solver info


# --------------------------------------------------------------------------
# material / group helpers
# --------------------------------------------------------------------------


def _per_cell(mesh: Mesh, group_values: dict, default: float = 0.0):
    """name->value group map to per-bucket (nc,) arrays (the reference's
    mesh-initialized cell variables m_rho/m_lambda/m_mu)."""
    out = {ct: np.full(c.shape[0], default) for ct, c in mesh.cells.items()}
    for group, value in group_values.items():
        for ct, sel in mesh.cell_groups.get(group, {}).items():
            out[ct][_rows_in_bucket(mesh.cells[ct], sel)] = value
    return out


def _group_rows(mesh: Mesh, group: str):
    """[(cell_type, row_indices)] for a named cell group."""
    out = []
    for ct, sel in mesh.cell_groups.get(group, {}).items():
        out.append((ct, _rows_in_bucket(mesh.cells[ct], sel)))
    return out


def _resolve_materials(mesh: Mesh, cfg: PassmoConfig):
    """Per-bucket (rho, lam, mu, vp, vs) cell arrays.

    Precedence: mesh `<initialization>` Rho/Lambda/Mu variables first, then
    `<init-elast-properties>` blocks with the init-elast-type conversion
    (_applyInitialCellConditions, ElastodynamicModule.cc:334-382)."""
    rho_c = _per_cell(mesh, cfg.rho)
    lam_c = _per_cell(mesh, cfg.lam)
    mu_c = _per_cell(mesh, cfg.mu)
    et = (cfg.elast_type or "").lower()
    for p in cfg.init_props:
        rho = p.rho
        if "young" in et or (not et and p.young):
            E, nu = p.young, p.nu
            lam = nu * E / (1 + nu) / (1 - 2 * nu)
            mu = E / 2.0 / (1 + nu)
        elif "lame" in et or (not et and (p.lam or p.mu)):
            lam, mu = p.lam, p.mu
        elif "veloc" in et or (not et and (p.vp or p.vs)):
            mu = rho * p.vs**2
            lam = rho * p.vp**2 - 2 * mu
        else:
            raise ValueError(
                "init-elast-properties needs init-elast-type young|lame|veloc"
            )
        for ct, rows in _group_rows(mesh, p.cell_group):
            rho_c[ct][rows] = rho
            lam_c[ct][rows] = lam
            mu_c[ct][rows] = mu
    vp_c, vs_c = {}, {}
    for ct in rho_c:
        with np.errstate(divide="ignore", invalid="ignore"):
            vs_c[ct] = np.where(
                rho_c[ct] > 0, np.sqrt(np.abs(mu_c[ct]) / rho_c[ct]), 0.0
            )
            vp_c[ct] = np.where(
                rho_c[ct] > 0,
                np.sqrt(np.abs(lam_c[ct] + 2 * mu_c[ct]) / rho_c[ct]),
                0.0,
            )
    return rho_c, lam_c, mu_c, vp_c, vs_c


# --------------------------------------------------------------------------
# imposed-condition machinery
# --------------------------------------------------------------------------


class _Channel:
    """One (condition, kind) write set: dofs + constant values or a curve.

    Per-step evaluation writes the (3,) value vector onto the dofs, the
    _applyDirichletBoundaryConditions value writes
    (ElastodynamicModule.cc:900-1190), order-preserving (later wins)."""

    def __init__(self, dofs_by_comp, const, curve, device):
        self.entries = [(torch.as_tensor(np.asarray(d, np.int64), device=device), c)
                        for c, d in dofs_by_comp]
        self.const = const
        self.curve = curve

    def write(self, vec: torch.Tensor, t: float) -> torch.Tensor:
        vals = (
            np.asarray(self.curve.value(t))
            if self.curve is not None
            else np.array([v if v is not None else 0.0 for v in self.const])
        )
        for dofs, c in self.entries:
            vec = vec.index_fill(0, dofs, float(vals[c]))
        return vec


def _build_channels(mesh: Mesh, prob: FemProblem, conds: list[ImposedCond]):
    """masks (imp_u explicit / dir / v / a / f) + per-kind channel lists."""
    n = prob.n_dofs
    ndof = prob.ndof
    masks = {k: np.zeros(n, bool) for k in ("u", "dir", "v", "a", "f")}
    channels = {k: [] for k in ("u", "v", "a", "f")}
    for cond in conds:
        nodes = mesh.group_nodes(cond.group)
        for kind in ("u", "v", "a", "f"):
            comps = cond.comps(kind, ndof)
            if not comps:
                continue
            dbc = [(c, prob.dof_ids(nodes, c)) for c in comps]
            for c, d in dbc:
                masks[kind][d] = True
            const = {"u": cond.U, "v": cond.V, "a": cond.A, "f": cond.Fv}[kind]
            channels[kind].append(
                _Channel(dbc, const, getattr(cond, f"{kind}_curve"), prob.device))
        # Dirichlet rows: explicit U always; point conditions also constrain
        # components with imposed A/V (ElastodynamicModule.cc:736-746;
        # surface conditions do NOT, :655-657)
        dir_comps = set(cond.comps("u", ndof))
        if not cond.is_surface:
            dir_comps |= set(cond.comps("a", ndof)) | set(cond.comps("v", ndof))
        for c in dir_comps:
            masks["dir"][prob.dof_ids(nodes, c)] = True
    return masks, channels


_METHODS = {"penalty": "Penalty", "weakpenalty": "WeakPenalty", "weak": "WeakPenalty",
            "rowelimination": "RowElimination", "rowelim": "RowElimination",
            "rowcolumnelimination": "RowColumnElimination",
            "rowcolumnelim": "RowColumnElimination"}


# --------------------------------------------------------------------------
# solve
# --------------------------------------------------------------------------


def solve(mesh: Mesh, cfg: PassmoConfig, dtype=torch.float64,
          timer: PhaseTimer | None = None,
          device: torch.device | str = "cuda") -> PassmoResult:
    timer = timer or PhaseTimer(verbose=False)
    np_dtype = numpy_dtype(dtype)
    ndof = 3 if (mesh.dim == 3 or cfg.analysis_type.lower() == "3d") else 2
    beta, gamma, dt = cfg.beta, cfg.gamma, cfg.dt
    am, af = (cfg.alfam, cfg.alfaf) if cfg.alfa_method else (0.0, 0.0)
    dt2 = dt * dt
    cab = 1.0 / (beta * dt2)  # Newmark acceleration recovery factor
    cm = (1.0 - am) * cab  # mass LHS factor ((1-αm)/(β·dt²))
    # paraxial Newmark factors (_getParaxialContribution,
    # ElastodynamicModule.cc:2113-2117)
    pc0 = 1.0 - af
    pc1 = pc0 * gamma / (beta * dt)

    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype, device=device)
        prob.block_assembly  # the layout and contributor lists, once

    rho_c, lam_c, mu_c, vp_c, vs_c = _resolve_materials(mesh, cfg)

    def cells(v, ct):  # a per-cell host array as a (1, nc) tensor
        return torch.as_tensor(v[ct], dtype=prob.dtype, device=prob.device)[None, :]

    with timer.phase("lhs-matrix-assembly"):
        # persistent per-Gauss-point state, built once and reused by both
        # matrices and the stress/strain recovery (the GaussDoFsOnCells
        # role, ElastodynamicModule.cc:188-253)
        gstate = GaussState.build(mesh, prob.coords, cfg.ninteg, ndof)
        Mm = prob.assemble_matrix(
            lambda ct, xyz: gstate.mass_blocks(ct, cells(rho_c, ct)))
        Km = prob.assemble_matrix(
            lambda ct, xyz: gstate.stiffness_blocks(ct, cells(lam_c, ct), cells(mu_c, ct)))
        A = Mm.with_values(cm * Mm.values + (1.0 - af) * Km.values)
        if not af:
            Km = None  # the RHS reads K only under Generalized-α

        # paraxial LHS: c1·∫φφ·P(n) face blocks
        # (_assembleLHSParaxialContribution, ElastodynamicModule.cc:2226-2304)
        parax = []  # (cond, faces, mass (nf,nfn,nfn), P (nf,b,b), load, node sum)
        for pc in cfg.paraxial:
            for ftype, conn in mesh.face_groups[pc.surface].items():
                adj = F.boundary_cell_arrays(mesh, conn)  # host, once per bucket
                normals = F.outward_normals(mesh, ftype, conn, adj)
                rho, cs, cp = _paraxial_props(pc, adj, rho_c, vs_c, vp_c)
                P = torch.as_tensor(F.paraxial_direction_matrix(normals, rho, cs, cp, ndof),
                                    dtype=prob.dtype, device=prob.device)
                xyz = prob.face_xyz(conn)
                mass = F.face_mass(ftype, xyz, cfg.ninteg)
                blocks = pc1 * torch.einsum("fij,fab->fijab", mass, P)
                A = prob.add_face_blocks(A, conn, blocks, key=("paraxial", pc.surface, ftype))
                load = F.face_load(ftype, xyz, cfg.ninteg)
                parax.append((pc, prob._index(conn), mass, P, load,
                              prob.node_sum(("paraxial", pc.surface, ftype), conn)))

    # ---- imposed-condition masks + channels -------------------------------
    conds = list(cfg.conditions)
    for bc in cfg.bcs.dirichlet:  # legacy surface-Dirichlet surface
        conds.append(
            ImposedCond(group=bc.surface, is_surface=True,
                        U=tuple(bc.values or _3NONE) + _3NONE[len(bc.values or ()):]))
    masks, channels = _build_channels(mesh, prob, conds)
    dir_mask = masks["dir"]

    def dev_mask(m):
        return torch.as_tensor(m, device=prob.device)

    impv, impa, impf, dirm = (dev_mask(masks[k]) for k in ("v", "a", "f", "dir"))

    # ---- frozen BC matrix ---------------------------------------------------
    pen = dtype_safe_penalty(cfg.penalty, np_dtype)
    system = prob.new_system(A, cfg.solver)
    dir_dofs = np.nonzero(dir_mask)[0]
    method = (cfg.method or "Penalty").lower()
    prob.apply_dirichlet(system, dir_dofs,
                         torch.zeros(len(dir_dofs), dtype=prob.dtype, device=prob.device),
                         _METHODS.get(method, "Penalty"), pen)
    is_pen = "penalty" in method or "weak" in method
    is_rowcol = "rowcolumn" in method
    A_pre = A if is_rowcol else None  # pre-BC operator (RowColumn per-step correction)
    A_bc, _rhs0 = system.finalized()
    del system, A, _rhs0
    ns = rigid_body_modes(mesh.coords, ndof) if cfg.solver.preconditioner == "amg" else None
    M_pre = make_precond(A_bc, cfg.solver.preconditioner, nullspace=ns)

    # ---- constant RHS pieces -----------------------------------------------
    zeros = torch.zeros(prob.n_dofs, dtype=prob.dtype, device=prob.device)
    g = np.asarray(cfg.gravity[:ndof], np.float64)
    body = zeros
    if np.any(g != 0):
        # ∫ ρ φ_i g_c per node (the body-force Gauss term,
        # ElastodynamicModule.cc:1893-1899)
        w = [torch.einsum("gc,gi->ci", cells(rho_c, ct) * st.wdet, st.N).reshape(-1)
             for ct, st in gstate.buckets.items()]  # (nc·npc,) per bucket
        for c in range(ndof):
            if g[c] != 0.0:
                body = body + prob.cell_sum(c)(torch.cat([g[c] * wb for wb in w]))

    # Neumann tractions: constant part now, curves per step (consistent
    # Gauss loads, ops/faces.face_load)
    tr_const = zeros
    tr_timed = []  # (surface entries, curve)
    for nc_ in cfg.neumann:
        entries = []
        for ftype, conn in mesh.face_groups[nc_.surface].items():
            load = F.face_load(ftype, prob.face_xyz(conn), cfg.ninteg).reshape(-1)
            entries.append((("neumann", nc_.surface, ftype), conn, load))
        if nc_.curve is not None:
            tr_timed.append((entries, nc_.curve))
        else:
            for key, conn, load in entries:
                for c, tc in enumerate(nc_.t[:ndof]):
                    if tc is None or tc == 0.0:
                        continue
                    tr_const = tr_const + prob.face_sum(key, conn, c)(tc * load)

    # double-couple dof sets (ElastodynamicModule.cc:1997-2099)
    dcs = []
    for dc in cfg.double_couple:
        i1, i2 = {0: (0, 1), 1: (1, 2), 2: (0, 2)}[dc.source_plane]
        dcs.append((dc, *(prob._index(prob.dof_ids(mesh.group_nodes(grp), comp))
                          for grp, comp in ((dc.west, i2), (dc.east, i2),
                                            (dc.north, i1), (dc.south, i1)))))

    # ---- step functions -----------------------------------------------------
    def predict(U, V, Acc):
        u_pred = U + dt * V + dt2 * (0.5 - beta) * Acc
        v_pred = V + dt * (1.0 - gamma) * Acc
        rhs = Mm.spmv(cm * u_pred - am * Acc) if am else Mm.spmv(cm * u_pred)
        if af:
            rhs = rhs - af * Km.spmv(U)
        rhs = rhs + body + tr_const
        # paraxial RHS: M_Γ ⊗ P · (c1·u_pred − c0·v_pred − αf·v_n)
        if parax:
            X = (pc1 * u_pred - pc0 * v_pred - af * V).reshape(-1, ndof)
            for _pc, connj, mass, P, _load, psum in parax:
                xf = X[connj]  # (nf, nfn, b)
                rhs = rhs + psum(torch.einsum("fij,fab,fjb->fia", mass, P, xf))
        return rhs, u_pred, v_pred

    def apply_bc_rhs(rhs, gdir, fvec):
        rhs = torch.where(impf, rhs + fvec, rhs)
        if is_pen:
            return torch.where(dirm, pen * gdir, rhs)
        # row elimination: rhs row = g; rowcol also corrects the other rows
        # by −A_pre·(g on constrained dofs) (AlephDoFLinearSystem.cc:540-565
        # semantics, per-step values)
        if is_rowcol:
            rhs = rhs - A_pre.spmv(torch.where(dirm, gdir, 0.0))
        return torch.where(dirm, gdir, rhs)

    def update(dU, u_pred, v_pred, a_imp_t, v_imp_t):
        # _updateNewmark with imposed-acceleration/velocity overrides
        # (ElastodynamicModule.cc:567-582)
        a_new = torch.where(impa, a_imp_t, (dU - u_pred) * cab)
        d_new = torch.where(impa, u_pred + (beta * dt2) * a_imp_t, dU)
        v_new = torch.where(impv, v_imp_t, v_pred + dt * gamma * a_new)
        return d_new, v_new, a_new

    # ---- initial state --------------------------------------------------------
    U, V, Acc, Fimp = (zeros.clone() for _ in range(4))
    for ic in cfg.init_nodes:  # _applyInitialNodeConditions (:302-327)
        nodes = mesh.group_nodes(ic.node_group)
        for vec_name, vals in (("U", ic.U), ("V", ic.V), ("A", ic.A), ("F", ic.Fv)):
            if vals is None:
                continue
            for c in range(ndof):
                dofs = prob._index(prob.dof_ids(nodes, c))
                val = float(vals[c])
                if vec_name == "U":
                    U = U.index_fill(0, dofs, val)
                elif vec_name == "V":
                    V = V.index_fill(0, dofs, val)
                elif vec_name == "A":
                    Acc = Acc.index_fill(0, dofs, val)
                else:
                    Fimp = Fimp.index_fill(0, dofs, val)

    def eval_channels(kind, vec, t):
        for ch in channels[kind]:
            vec = ch.write(vec, t)
        return vec

    def incident_rhs(rhs, t):
        """Incident-wave traction 2·P(n)·v_in on paraxial faces (an
        extension: the reference stores u/v/a_in but never forces with
        them, ElastodynamicModule.cc:2133-2141)."""
        for pc, _connj, _mass, P, load, psum in parax:
            if pc.input_type <= 0:
                continue
            vin = _incident_velocity(pc, t, dt, ndof)
            if vin is None:
                continue
            tvec = 2.0 * P @ torch.as_tensor(np.asarray(vin[:ndof], np.float64),
                                              dtype=P.dtype, device=P.device)  # (nf, b)
            rhs = rhs + psum(torch.einsum("fi,fa->fia", load, tvec))
        return rhs

    t = cfg.start + dt
    steps = 0
    step_iters = []
    solve_s = 0.0
    info = {}
    opts = cfg.solver
    with timer.phase("time-loop"):
        while t <= cfg.tmax + 1e-12 * dt:
            rhs, u_pred, v_pred = predict(U, V, Acc)
            # per-step imposed values at t_{n+1}
            v_imp_t = eval_channels("v", V, t)
            a_imp_t = eval_channels("a", Acc, t)
            Fimp = eval_channels("f", Fimp, t)
            # Dirichlet values: explicit U writes over the integrated state
            # (imposed-acc point rows keep their Newmark-integrated value)
            gdir = eval_channels("u", U, t)
            for entries, curve in tr_timed:
                tv = np.asarray(curve.value(t))
                for key, conn, load in entries:
                    for c in range(min(ndof, len(tv))):
                        if tv[c] == 0.0:
                            continue
                        rhs = rhs + prob.face_sum(key, conn, c)(float(tv[c]) * load)
            if cfg.paraxial_incident:
                rhs = incident_rhs(rhs, t)
            rhs = apply_bc_rhs(rhs, gdir, Fimp)
            for dc, dwest, deast, dnorth, dsouth in dcs:
                ft = _dc_force(dc, t)
                rhs = rhs.index_fill(0, dwest, ft[0]).index_fill(0, deast, -ft[0])
                rhs = rhs.index_fill(0, dnorth, ft[1]).index_fill(0, dsouth, -ft[1])
            x0 = torch.where(dirm, gdir, U)
            if steps == 0:
                # later steps' absolute tolerance anchored at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(cfg.solver, atol=max(
                    cfg.solver.atol, anchor_atol(A_bc, M_pre, rhs, x0, cfg.solver.rtol,
                                                 method=cfg.solver.method)))
            dU, info = solve_finalized(A_bc, rhs, opts, x0=x0, precond=M_pre)
            step_iters.append(int(info["iterations"]))
            solve_s += info.get("solve_s", 0.0)
            last = (rhs, dU)
            U, V, Acc = update(dU.to(prob.dtype), u_pred, v_pred, a_imp_t, v_imp_t)
            t += dt
            steps += 1
    if steps:
        info["free_residual"] = free_residual(A_bc, *last, dirm)
        del last

    u = prob.node_values(U)
    res = PassmoResult(u=u, v=prob.node_values(V), a=prob.node_values(Acc), steps=steps,
                       problem=prob, iterations=sum(step_iters), step_iterations=step_iters,
                       residual=float(info.get("residual", 0.0)), solve_s=solve_s, info=info)
    if cfg.recover_fields:
        with timer.phase("stress-strain-recovery"):
            _recover_fields(res, mesh, gstate, prob, U, lam_c, mu_c, cfg)
    if cfg.result_file:
        with timer.phase("result-validation"):
            check_node_results(mesh.node_uids, u, cfg.result_file, cfg.result_epsilon,
                               min_value=cfg.result_min_value)
    return res


def _paraxial_props(pc: ParaxialCond, adj, rho_c, vs_c, vp_c):
    """(rho, cs, cp) for a paraxial face bucket: the outer-domain options
    in the reference's precedence (E/ν, cp/cs, λ/μ; ElastodynamicModule.cc:
    789-822, with the cs=getCp() slip at :805 fixed), else per-face inner
    boundary-cell values (:838-843), from the faces' adjacent cells ``adj``
    (``ops/faces.py::boundary_cell_arrays``)."""
    if pc.E is not None and pc.nu is not None:
        rho = pc.rho if pc.rho is not None else 2500.0
        lam = pc.nu * pc.E / (1 + pc.nu) / (1 - 2 * pc.nu)
        mu = pc.E / 2.0 / (1 + pc.nu)
        return rho, math.sqrt(mu / rho), math.sqrt((lam + 2 * mu) / rho)
    if pc.cp is not None and pc.cs is not None:
        return (pc.rho if pc.rho is not None else 2500.0), pc.cs, pc.cp
    if pc.lam is not None and pc.mu is not None:
        rho = pc.rho if pc.rho is not None else 2500.0
        return rho, math.sqrt(pc.mu / rho), math.sqrt((pc.lam + 2 * pc.mu) / rho)
    # inner: per-face material from the adjacent boundary cell
    names, bucket, row = adj
    if (bucket < 0).any():
        k = int(np.flatnonzero(bucket < 0)[0])
        raise ValueError(
            f"paraxial face {k} of '{pc.surface}' has no adjacent cell "
            "and no outer-domain properties were given")
    rho, cs, cp = (np.empty(len(bucket)) for _ in range(3))
    for b, ct in enumerate(names):
        sel = bucket == b
        rho[sel], cs[sel], cp[sel] = (x[ct][row[sel]] for x in (rho_c, vs_c, vp_c))
    return rho, cs, cp


def _incident_velocity(pc: ParaxialCond, t: float, dt: float, ndof: int):
    """Incident particle velocity (3,) from type-6 curves or the analytic
    input motions (displacement histories differentiated centrally)."""
    if pc.input_type == 6:
        if pc.v_input is not None:
            return np.asarray(pc.v_input.value(t))[:3]
        if pc.u_input is not None:
            up = np.asarray(pc.u_input.value(t + 0.5 * dt))
            um = np.asarray(pc.u_input.value(t - 0.5 * dt))
            return (up - um) / dt
        return None

    # analytic u(t)·direction (ElastodynamicModule.cc:1288-1326)
    def uval(tt):
        return pc.analytic.value(pc.input_type, tt, dt)

    dudt = (uval(t + 0.5 * dt) - uval(t - 0.5 * dt)) / dt
    rad = math.pi / 180.0
    can, san = math.cos(pc.normal_angle * rad), math.sin(pc.normal_angle * rad)
    cat, sat = (math.cos(pc.in_plane_angle * rad),
                math.sin(pc.in_plane_angle * rad))
    if ndof == 3:
        direc = np.array([san * cat, san * sat, can])
    else:
        direc = np.array([san, can, 0.0])
    return dudt * direc


def _dc_force(dc: PassmoDoubleCouple, t: float):
    """(F_eastwest, F_northsouth) at time t (ElastodynamicModule.cc:
    1977-2099: moment → F = M0(t)/distance, loading → F directly)."""
    if dc.moment_table is not None:
        m0 = float(dc.moment_table.value(t)[0])
        few = m0 / dc.dew if dc.dew else m0
        fns = m0 / dc.dns if dc.dns else m0
        return few, fns
    if dc.loading_table is not None:
        ft = float(dc.loading_table.value(t)[0])
        return ft, ft
    return 0.0, 0.0


def _recover_fields(res: PassmoResult, mesh, gstate, prob, U,
                    lam_c, mu_c, cfg: PassmoConfig):
    """Volume-averaged per-cell Voigt strain/stress including the initial
    cell tensors (init-cell-condition): the StrainVol/StrainDev/StressVol/
    StressDev output variables (Elastodynamic.axl:41-52).  The Gauss
    contraction runs on U's device, the rest on the host."""
    ndof = prob.ndof
    sv, sd, tv, td = {}, {}, {}, {}
    # initial tensors per bucket
    eps0 = {ct: np.zeros((c.shape[0], 6)) for ct, c in mesh.cells.items()}
    sig0 = {ct: np.zeros((c.shape[0], 6)) for ct, c in mesh.cells.items()}
    for icc in cfg.init_cells:
        for ct, rows in _group_rows(mesh, icc.cell_group):
            eps0[ct][rows, :3] = icc.vol_strain
            eps0[ct][rows, 3:] = icc.dev_strain
            sig0[ct][rows, :3] = icc.vol_stress
            sig0[ct][rows, 3:] = icc.dev_stress
    for ct, conn in mesh.cells.items():
        st = gstate.buckets[ct]
        w = st.wdet / torch.sum(st.wdet, dim=0, keepdim=True)
        eps = torch.einsum("gc,gcab->cab", w, gstate.strain(ct, conn, U)).cpu().numpy()
        lam = lam_c[ct][:, None, None]
        mu = mu_c[ct][:, None, None]
        tr = np.trace(eps, axis1=1, axis2=2)[:, None, None]
        sig = lam * tr * np.eye(ndof) + 2 * mu * eps
        nc = eps.shape[0]

        def voigt(tmat, t0):
            out = np.zeros((nc, 6))
            for i in range(ndof):
                out[:, i] = tmat[:, i, i]
            out[:, 3] = tmat[:, 0, 1]
            if ndof == 3:
                out[:, 4] = tmat[:, 1, 2]
                out[:, 5] = tmat[:, 0, 2]
            return out + t0

        ev = voigt(eps, eps0[ct])
        sg = voigt(sig, sig0[ct])
        sv[ct], sd[ct] = ev[:, :3], ev[:, 3:]
        tv[ct], td[ct] = sg[:, :3], sg[:, 3:]
    res.strain_vol, res.strain_dev = sv, sd
    res.stress_vol, res.stress_dev = tv, td
    for path, vol, dev in ((cfg.strain_file, sv, sd),
                           (cfg.stress_file, tv, td)):
        if not path:
            continue
        with open(path, "w") as f:
            for ct in sorted(vol):
                for k in range(vol[ct].shape[0]):
                    f.write(
                        f"{ct} {k} "
                        + " ".join(f"{x:.9e}" for x in vol[ct][k])
                        + " " + " ".join(f"{x:.9e}" for x in dev[ct][k])
                        + "\n"
                    )


# --------------------------------------------------------------------------
# .arc case parsing (the Elastodynamic.axl surface)
# --------------------------------------------------------------------------


def _real3(elem, name, default=None):
    from ..fem.arc import opt_text

    txt = opt_text(elem, name)
    if txt is None:
        return default
    vals = [float(x) for x in txt.split()]
    while len(vals) < 3:
        vals.append(vals[-1] if len(vals) == 1 else 0.0)
    return tuple(vals[:3])


def _opt_tuple(elem, names):
    from ..fem.arc import opt_float

    return tuple(opt_float(elem, n) for n in names)


def _curve(case, elem, name, ndim=3):
    import os

    from ..fem.arc import opt_text
    from ..fem.casetable import read_case_table

    fn = opt_text(elem, name)
    if not fn:
        return None
    return read_case_table(os.path.join(case.base_dir, fn), ndim)


def _parse_imposed(case, elem, group_attr, is_surface) -> ImposedCond:
    from ..fem.arc import opt_bool, opt_text

    return ImposedCond(
        group=opt_text(elem, group_attr),
        is_surface=is_surface,
        U=_opt_tuple(elem, ("Ux", "Uy", "Uz")),
        V=_opt_tuple(elem, ("Vx", "Vy", "Vz")),
        A=_opt_tuple(elem, ("Ax", "Ay", "Az")),
        Fv=_opt_tuple(elem, ("Fx", "Fy", "Fz")),
        u_curve=_curve(case, elem, "U-curve"),
        v_curve=_curve(case, elem, "V-curve"),
        a_curve=_curve(case, elem, "A-curve"),
        f_curve=_curve(case, elem, "F-curve"),
        axes=(opt_bool(elem, "x-axis"), opt_bool(elem, "y-axis"),
              opt_bool(elem, "z-axis")),
    )


def config_from_case(case, check: bool = True) -> "PassmoConfig":
    """PassmoConfig from a parsed .arc case (Elastodynamic.axl surface)."""
    from ..fem.arc import opt_float, opt_text

    fem = case.fem
    method = opt_text(fem, "enforce-Dirichlet-method", "Penalty")
    conditions = [
        _parse_imposed(case, d, "surface", True)
        for d in fem.findall("dirichlet-surface-condition")
    ] + [
        _parse_imposed(case, d, "node", False)
        for d in fem.findall("dirichlet-point-condition")
    ]
    neumann = [
        NeumannCond(
            surface=opt_text(n, "surface"),
            t=_opt_tuple(n, ("X-val", "Y-val", "Z-val")),
            curve=_curve(case, n, "curve"),
        )
        for n in fem.findall("neumann-condition")
    ]
    paraxial = []
    for p in fem.findall("paraxial-boundary-condition"):
        paraxial.append(ParaxialCond(
            surface=opt_text(p, "surface"),
            rho=opt_float(p, "rhopar"),
            cs=opt_float(p, "cs"), cp=opt_float(p, "cp"),
            E=opt_float(p, "E-par"), nu=opt_float(p, "nu-par"),
            lam=opt_float(p, "lambda-par"), mu=opt_float(p, "mu-par"),
            input_type=int(opt_float(p, "input-motion-type", 0)),
            analytic=AnalyticInput(
                tp=opt_float(p, "tp", 1.0), ts=opt_float(p, "ts", 1.0),
                coef=opt_float(p, "coef", 1.0),
                amplit=opt_float(p, "amplit", 1.0),
                phase=opt_float(p, "phase", 0.0),
                order=int(opt_float(p, "order", 2)),
            ),
            u_input=_curve(case, p, "u-input"),
            v_input=_curve(case, p, "v-input"),
            a_input=_curve(case, p, "a-input"),
            normal_angle=opt_float(p, "normal-angle", 0.0),
            in_plane_angle=opt_float(p, "in-plane-angle", 0.0),
        ))
    init_props = [
        ElastProps(
            cell_group=opt_text(e, "cell-group"),
            rho=opt_float(e, "rho", 2500.0),
            young=opt_float(e, "young", 0.0), nu=opt_float(e, "nu", 0.0),
            lam=opt_float(e, "lambda", 0.0), mu=opt_float(e, "mu", 0.0),
            vp=opt_float(e, "vp", 0.0), vs=opt_float(e, "vs", 0.0),
        )
        for e in fem.findall("init-elast-properties")
    ]
    init_cells = [
        InitCellCond(
            cell_group=opt_text(e, "cell-group"),
            vol_stress=_real3(e, "vol-stress", (0.0,) * 3),
            vol_strain=_real3(e, "vol-strain", (0.0,) * 3),
            dev_stress=_real3(e, "dev-stress", (0.0,) * 3),
            dev_strain=_real3(e, "dev-strain", (0.0,) * 3),
        )
        for e in fem.findall("init-cell-condition")
    ]
    init_nodes = [
        InitNodeCond(
            node_group=opt_text(e, "node-group"),
            U=_real3(e, "U"), V=_real3(e, "V"), A=_real3(e, "A"),
            Fv=_real3(e, "F"),
        )
        for e in fem.findall("initial-node-condition")
    ]
    dcs = []
    for e in fem.findall("double-couple"):
        dcs.append(PassmoDoubleCouple(
            north=opt_text(e, "north-node"), south=opt_text(e, "south-node"),
            east=opt_text(e, "east-node"), west=opt_text(e, "west-node"),
            source_plane=int(opt_float(e, "source-plane", 0)),
            moment_table=_curve(case, e, "seismic-moment-file", 1),
            loading_table=_curve(case, e, "loading-file", 1),
            dew=opt_float(e, "dist-ew-seismic-moment", 1.0),
            dns=opt_float(e, "dist-ns-seismic-moment", 1.0),
        ))
    init = case.mesh_init
    cfg = PassmoConfig(
        analysis_type=opt_text(fem, "analysis-type", "planestrain"),
        start=opt_float(fem, "start", 0.0),
        tmax=opt_float(fem, "final-time", 1.0),
        dt=opt_float(fem, "deltat", 0.1),
        beta=opt_float(fem, "beta", 0.25),
        gamma=opt_float(fem, "gamma", 0.5),
        alfa_method=opt_text(fem, "alfa_method", "false").lower() == "true",
        alfam=opt_float(fem, "alfam", 0.0),
        alfaf=opt_float(fem, "alfaf", 0.0),
        ninteg=int(opt_float(fem, "gauss-nint", 2)),
        gravity=(opt_float(fem, "gx", 0.0), opt_float(fem, "gy", 0.0),
                 opt_float(fem, "gz", 0.0)),
        rho=dict(init.get("Rho", [])),
        lam=dict(init.get("Lambda", [])),
        mu=dict(init.get("Mu", [])),
        elast_type=opt_text(fem, "init-elast-type", ""),
        init_props=init_props,
        init_cells=init_cells,
        init_nodes=init_nodes,
        conditions=conditions,
        neumann=neumann,
        paraxial=paraxial,
        double_couple=dcs,
        penalty=opt_float(fem, "penalty", 1.0e30),
        method=method,
        solver=case.solver,
        result_file=case.result_file if check else None,
        stress_file=opt_text(fem, "stress-results"),
        strain_file=opt_text(fem, "strain-results"),
    )
    return cfg


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             device="cuda"):
    cfg = config_from_case(case, check=check)
    return solve(mesh, cfg, dtype=dtype, timer=timer, device=device)


def _register():
    from ..fem.runner import register

    register("Passmo")(_run_arc)


_register()
