"""chip_smoke.py's device-time reading, on the CPU: the kernels it looks
for in each CUDA source, and the rule that reads a kernel's events out of
a profiler trace (only the record's own kernels, the median, None where
too few or too many were traced)."""

import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "arcanefem_tpu_torch", "csrc")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("src", sorted(f for f in os.listdir(CSRC) if f.endswith(".cu")))
def test_kernel_names_cover_every_global(src):
    with open(os.path.join(CSRC, src)) as fh:
        text = fh.read()
    names = _smoke()._kernel_names(src)
    assert len(names) == text.count("__global__")
    assert len(set(names)) == len(names)
    for name in names:
        assert re.search(rf"\b{name}\s*\(", text), name


def test_global_names_match_nested_parentheses():
    """A __launch_bounds__ argument with parentheses of its own hides no
    kernel (a pattern that stops at the first ')' misses both here)."""
    smoke = _smoke()
    text = ("__global__ void __launch_bounds__(kThreads * (kRows + 1)) "
            "block_kernel(const float* x) {}\n"
            "template <typename V>\n__global__ void __launch_bounds__((kA), (kB))\n"
            "pair_kernel(V* y) {}\n__global__ void plain_kernel(int n) {}\n")
    assert smoke._global_names(text) == ("block_kernel", "pair_kernel", "plain_kernel")
    old = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text)
    assert "block_kernel" not in old and "pair_kernel" not in old


def test_record_kernel_fails_when_its_kernel_is_not_parsed():
    """A [kernel] record reads its own kernel's events; one whose kernel
    the parse does not find fails its check instead of reading None."""
    smoke = _smoke()
    assert smoke._record_kernel("block_slot_reduce (b=3)", "tet_assembly.cu") == \
        "block_slot_reduce_kernel"
    assert smoke._record_kernel("bsr8_spmv (a)", "bsr8_spmv.cu") == "bsr_spmv_kernel"
    assert smoke._record_kernel("ell_gather_sum", "ell_gather.cu",
                                "ell_gather_kernel") == "ell_gather_kernel"
    with pytest.raises(RuntimeError, match="not among"):
        smoke._record_kernel("ell_gather_sum", "ell_gather.cu")
    with pytest.raises(RuntimeError, match="not among"):
        smoke._record_kernel("sell_spmv (shard 0)", "sell_spmv.cu", "missing_kernel")


def test_shard_halo_nodes_follow_the_partition_maps():
    """[parallel] (b) fills shard 0's halo on the host through halo_src and
    the owners' send_idx: the same nodes, in the same order, as the halo
    build_sharded numbered."""
    import numpy as np

    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh
    from arcanefem_tpu_torch.parallel.partition import build_sharded

    mesh = box_tetra_mesh(6, 5, 4)
    sp = build_sharded(mesh, 4)
    for p in range(4):
        touched = np.unique(np.concatenate([
            mesh.cells[k][sp.cell_offsets[k][p][sp.cell_offsets[k][p] >= 0]].ravel()
            for k in mesh.cells]))
        halo = touched[sp.part[touched] != p]
        np.testing.assert_array_equal(_smoke()._shard_halo_nodes(sp, p)[:len(halo)], halo)


def _events(own_us, stray_us=()):
    """A trace as the profiler names kernels: demangled, with templates."""
    own = [("void (anonymous namespace)::stencil_assembly_kernel<float>(float const*, "
            "float const*, float const*, float*, float*, int, int, int, int, int, int, "
            "long, long, float, float)", us) for us in own_us]
    stray = [("void at::native::vectorized_elementwise_kernel<4, "
              "at::native::FillFunctor<float>>(int, ...)", us) for us in stray_us]
    return own + stray


def test_own_events_ms_reads_only_the_records_kernels():
    own = _smoke()._own_events_ms
    names = ("stencil_assembly_kernel",)
    ms, counts = own(_events([540.0] * 15 + [560.0] * 5, [9000.0] * 30), names, 20)
    assert ms == pytest.approx(0.54) and counts == [20, 20]
    # a name that only contains the kernel's name is another kernel
    ms, counts = own([("void (anonymous namespace)::sell_spmv_batched_kernel<float>()",
                       180.0)] * 20, ("sell_spmv_kernel",), 20)
    assert ms is None and counts == [0, 20]


def test_own_events_ms_is_none_when_the_trace_is_short_or_doubled():
    own = _smoke()._own_events_ms
    names = ("stencil_assembly_kernel",)
    assert own(_events([540.0] * 10), names, 20) == (0.54, [10, 20])
    assert own(_events([540.0] * 9), names, 20) == (None, [9, 20])
    assert own(_events([540.0] * 39), names, 20)[0] == pytest.approx(0.54)
    assert own(_events([540.0] * 40), names, 20) == (None, [40, 20])
    assert own([], names, 20) == (None, [0, 20])


def test_fem_cases_cover_every_method_and_route(tmp_path, monkeypatch):
    """[fem] F1's case files, written at a small size: every Dirichlet
    method on both meshes, and the Hypre (AMG), Aleph default (Jacobi),
    poly and dense routes, each loadable by the port's reader."""
    from arcanefem_tpu_torch.fem.arc import load_case

    smoke = _smoke()
    monkeypatch.setattr(smoke, "FEM_2D_N", 6)
    monkeypatch.setattr(smoke, "FEM_3D_N", 3)
    cases = smoke._fem_cases(str(tmp_path))
    assert len(cases) == 12 and len({c["name"] for c in cases}) == 12
    loaded = {c["name"]: load_case(c["path"]) for c in cases}
    methods = {(n.split("_")[0], bc.method) for n, case in loaded.items()
               for bc in case.bcs.dirichlet}
    assert {(m, meth) for m in ("rect", "box") for meth in smoke.FEM_METHODS} <= methods
    routes = {(c.solver.method, c.solver.preconditioner) for c in loaded.values()}
    assert routes == {("cg", "jacobi"), ("cg", "amg"), ("cg", "poly"), ("dense", "jacobi")}
    assert loaded["rect_neumann"].bcs.neumann and loaded["rect_neumann"].codename == "Poisson"
    assert all(c["exact"] == (c["name"] != "rect_neumann") for c in cases)


def test_model_cases_cover_every_codename_mesh_and_method(tmp_path, monkeypatch):
    """[models] M1's case files, written at a small size: the four
    codenames, the quad4, tria6 and tetra10 meshes, every solver method,
    one post-processing case; each runs on the CPU through run_case, and
    its post-processing file's Phi reads back through the legacy reader
    the card's machine (no h5py) uses."""
    from arcanefem_tpu_torch.fem import vtkhdf
    from arcanefem_tpu_torch.fem.arc import load_case
    from arcanefem_tpu_torch.fem.runner import run_case

    smoke = _smoke()
    for name, size in (("MODEL_2D_N", 6), ("MODEL_3D_N", 3), ("MODEL_P2_2D_N", 3),
                       ("MODEL_P2_3D_N", 2)):
        monkeypatch.setattr(smoke, name, size)
    cases = smoke._model_cases(str(tmp_path))
    assert len({c["name"] for c in cases}) == len(cases)
    assert {c["codename"] for c in cases} == {"Electrostatics", "Fourier", "Acoustics",
                                              "Aerodynamics"}
    loaded = {c["name"]: load_case(c["path"]) for c in cases}
    assert {case.solver.method for case in loaded.values()} == {
        "cg", "dense", "gmres", "bicgstab", "bicgstab2"}
    assert {case.solver.preconditioner for case in loaded.values()} >= {"amg", "jacobi"}
    kinds = set()
    monkeypatch.setattr(vtkhdf, "HAVE_H5PY", False)
    for c in cases:
        res = run_case(c["path"], device="cpu", output_dir=str(tmp_path / "out"))
        kinds |= set(res.problem.mesh.cells)
        for f in c["fields"]:
            assert getattr(res, f) is not None
        if c["name"] == smoke.MODEL_OUTPUT_CASE:
            back = smoke._read_vtk_point_data(str(tmp_path / "out" / f"{c['name']}.vtk"),
                                              "Phi")
            assert abs(back - res.phi).max() <= 1e-9 * abs(res.phi).max()
    assert kinds == {"tria3", "quad4", "tetra4", "tria6", "tetra10"}
    assert [p.name for p in (tmp_path / "out").iterdir()] == [f"{smoke.MODEL_OUTPUT_CASE}.vtk"]


def test_block_cases_cover_every_codename_method_and_route(tmp_path, monkeypatch):
    """[blocks] B1's case files, written at a small size: the three
    codenames; every Dirichlet method, point Dirichlet, body force and
    traction; the Aleph default (Jacobi-CG, bicgstab under
    RowElimination), gmres with AMG, Hypre (AMG with the rigid body
    modes), dense, and the in-process block-Jacobi and consistent-start
    routes; Newmark-β and Generalized-α, Rayleigh damping and a CaseTable
    traction.  Each runs on the CPU (u, u1/u2 or u/v/a finite)."""
    import numpy as np

    from arcanefem_tpu_torch.fem.arc import load_case
    from arcanefem_tpu_torch.fem.runner import run_case

    smoke = _smoke()
    monkeypatch.setattr(smoke, "BLOCK_RECT", (8, 4))
    monkeypatch.setattr(smoke, "BLOCK_BOX", (4, 2, 2))
    cases = smoke._block_cases(str(tmp_path))
    assert 12 <= len(cases) <= 16 and len({c["name"] for c in cases}) == len(cases)
    assert {c["codename"] for c in cases} == {"Bilaplacian", "Elasticity", "Elastodynamics"}
    loaded = {c["name"]: load_case(c["path"]) for c in cases if c["path"]}
    fem = {n: case.fem for n, case in loaded.items()}
    methods = {v.findtext("enforce-Dirichlet-method") for v in fem.values()}
    assert {"WeakPenalty", "RowElimination", "RowColumnElimination"} <= methods
    assert {(case.solver.method, case.solver.preconditioner) for case in loaded.values()} == {
        ("dense", "jacobi"), ("cg", "jacobi"), ("cg", "amg"), ("gmres", "amg")}
    assert any(f.find("dirichlet-point-condition") is not None for f in fem.values())
    assert any(f.findtext("traction-boundary-condition/traction-input-file")
               for f in fem.values())
    assert {f.findtext("time-discretization") for f in fem.values()} >= {
        "Newmark-beta", "Generalized-alpha"}
    assert any(f.findtext("etak") for f in fem.values())
    assert sum(c["path"] is None for c in cases) == 2
    for c in cases:
        res = c["solve"]("cpu") if c["path"] is None else run_case(c["path"], device="cpu")
        for f in c["fields"]:
            assert np.isfinite(getattr(res, f)).all(), (c["name"], f)


def test_transient_cases_cover_every_codename_method_and_route(tmp_path, monkeypatch):
    """[transient] T1's case files, written at a small size: heat with
    Penalty and RowElimination, convection, a constant qdot and the output
    case (NodeTemperature, a temporal file); the in-process resume through
    a checkpoint (equal to the continuous run); soildynamics with paraxial
    on three sides, a CaseTable traction and the double couple at four
    node groups; passmo on a tetra4 box (inner-cell paraxial, gravity, a
    traction curve) and on the mixed hexa8/pyramid5/penta6/tetra4 box
    (imposed U/V/A curves, a Ricker incident wave, Generalized-α, initial
    node conditions, the recovered fields in the output).  Each runs on
    the CPU with finite fields."""
    import numpy as np

    from arcanefem_tpu_torch.fem.arc import load_case
    from arcanefem_tpu_torch.fem.runner import run_case

    smoke = _smoke()
    monkeypatch.setattr(smoke, "TRANS_RECT", (8, 4))
    monkeypatch.setattr(smoke, "TRANS_BOX", (3, 2, 2))
    cases = smoke._transient_cases(str(tmp_path))
    assert {c["codename"] for c in cases} == {"Heat", "Soildynamics", "Passmo"}
    assert len({c["name"] for c in cases}) == len(cases) == 8
    fem = {c["name"]: load_case(c["path"]).fem for c in cases if c["path"]}
    heat = [f for n, f in fem.items() if n.startswith("heat")]
    assert {f.findtext("enforce-Dirichlet-method") for f in heat} == {None, "RowElimination"}
    assert any(f.find("convection-boundary-condition") is not None for f in heat)
    assert any(f.findtext("qdot") for f in heat)
    soil = [f for n, f in fem.items() if n.startswith("soil")]
    assert all(len(f.findall("paraxial-boundary-condition")) == 3 for f in soil)
    assert any(f.find("double-couple") is not None for f in soil)
    assert any(f.findtext("traction-boundary-condition/traction-input-file") for f in soil)
    mixed = fem["passmo_mixed_output"]
    assert mixed.findtext("alfa_method") == "true"
    assert {e.findtext(k) for e in mixed.findall("dirichlet-surface-condition")
            + mixed.findall("dirichlet-point-condition")
            for k in ("U-curve", "V-curve", "A-curve")} >= {"curve.txt"}
    assert mixed.find("paraxial-boundary-condition").findtext("input-motion-type") == "2"
    assert mixed.find("initial-node-condition") is not None
    assert [c["name"] for c in cases if c["output"]] == ["heat_convection_output",
                                                         "passmo_mixed_output"]
    for c in cases:
        if c["path"] is None:
            res = c["solve"]("cpu")
            assert np.abs(res.T - res.continuous.T).max() <= 1e-9 * np.abs(res.T).max()
        else:
            res = run_case(c["path"], device="cpu", output_dir=str(tmp_path / "out"))
        for f in c["fields"]:
            assert np.isfinite(getattr(res, f)).all() and np.abs(getattr(res, f)).max() > 0, (
                c["name"], f)
        if c["name"] == "passmo_mixed_output":
            assert set(res.problem.mesh.cells) == {"hexa8", "pyramid5", "penta6", "tetra4"}
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "heat_convection_output.hdf", "passmo_mixed_output.hdf"]


def test_cli_cases_cover_every_codename_and_route(tmp_path, monkeypatch):
    """The written cases that also run through the CLI (F1, M1, B1, T1;
    the others run on the CPU and the card only), as ``_cli_cases`` picks
    them: written .arc cases that cover every codename, every solver route
    of their phase, and the output cases; every other case chosen brings a
    codename or a route that no earlier case brought."""
    from arcanefem_tpu_torch.fem.arc import load_case

    smoke = _smoke()
    for name, size in (("FEM_2D_N", 6), ("FEM_3D_N", 3), ("MODEL_2D_N", 6),
                       ("MODEL_3D_N", 3), ("MODEL_P2_2D_N", 3), ("MODEL_P2_3D_N", 2),
                       ("BLOCK_RECT", (8, 4)), ("BLOCK_BOX", (4, 2, 2)),
                       ("TRANS_RECT", (8, 4)), ("TRANS_BOX", (3, 2, 2))):
        monkeypatch.setattr(smoke, name, size)
    phases = ((smoke._fem_cases, (), "fem"),
              (smoke._model_cases, (smoke.MODEL_OUTPUT_CASE,), "models"),
              (smoke._block_cases, (), "blocks"), (smoke._transient_cases, (), "transient"))
    for write, also, root in phases:
        cases = write(str(tmp_path / root))
        names = smoke._cli_cases(cases, also)
        arcs = {c["name"]: load_case(c["path"]) for c in cases if c.get("path")}
        outputs = {c["name"] for c in cases if c.get("output")} | set(also)
        assert outputs <= names <= set(arcs), root
        assert {arcs[n].codename for n in names} == {a.codename for a in arcs.values()}, root
        route = {n: (a.solver.method, a.solver.preconditioner) for n, a in arcs.items()}
        assert {route[n] for n in names} == set(route.values()), root
        seen = set()
        for n in arcs:
            keys = {arcs[n].codename, route[n]}
            assert (n in names) == (n in outputs or not keys <= seen), (root, n)
            seen |= keys
        assert len(names) < len(arcs), root


def test_lab_cli_cases_take_one_flag_per_format(tmp_path, monkeypatch):
    """L3's CLI runs: one flag of each format, the rect and the box in
    turn, among the written cases."""
    from arcanefem_tpu_torch.models.testlab_model import _FLAG_TO_FORMAT

    smoke = _smoke()
    monkeypatch.setattr(smoke, "LAB_2D_N", 4)
    monkeypatch.setattr(smoke, "LAB_3D_N", 3)
    cases = smoke._lab_cases(str(tmp_path))
    cli = smoke._lab_cli_cases(cases)
    formats = [_FLAG_TO_FORMAT[c["flag"]] for c in cli]
    assert sorted(formats) == sorted(set(_FLAG_TO_FORMAT.values()))
    assert {c["name"].split("_")[0] for c in cli} == {"rect", "box"}
    assert all(c in cases for c in cli)


def _sweep_rows():
    """A sweep's rows as [sweep] expects them: six formats at two sizes,
    the P = 1 devices row and both headline rows."""
    from arcanefem_tpu_torch.testlab import FORMATS

    rows = [{"axis": "assembly", "size": f"box{n}", "nodes": (n + 1) ** 3,
             "elements": 6 * n ** 3, "format": f, "devices": 1,
             "lhs_matrix_assembly_s": 0.00125, "mdof_per_s": 28.7}
            for n in (4, 6) for f in FORMATS]
    rows.append({"axis": "devices", "size": "box10", "nodes": 1331,
                 "format": "sharded-rcb-pcg", "devices": 1, "solve_s": 0.02,
                 "iterations": 54, "invariant": True})
    rows.append({"axis": "headline", "metric": "poisson3d_sphere_cut_0.0MDoF_"
                 "assembly+amgpcg_to_1e-08_s", "value": 0.0581})
    rows.append({"axis": "headline", "metric": "poisson3d_box_0.275MDoF_"
                 "assembly+cg_to_1e-08_s", "value": 0.0712})
    return rows


def _sweep_check(smoke, rows, launches=None, tsv=None):
    from arcanefem_tpu_torch.bench_sweep import tsv_text

    smoke._check_sweep(rows, tsv_text(rows) if tsv is None else tsv,
                       {"slot_reduce": 36} if launches is None else launches,
                       sizes=(4, 6))


@pytest.mark.parametrize("fault", [
    "none", "missing format row", "non-finite time", "non-invariant devices row",
    "devices error row", "missing headline value", "missing headline row",
    "no slot_reduce", "short tsv"])
def test_sweep_check(fault):
    """[sweep]'s checks pass on a whole sweep and fail on each fault."""
    smoke = _smoke()
    rows = _sweep_rows()
    launches, tsv = None, None
    if fault == "missing format row":
        rows = [r for r in rows if not (r.get("size") == "box6" and r.get("format") == "coo")]
    elif fault == "non-finite time":
        rows[3]["lhs_matrix_assembly_s"] = float("nan")
    elif fault == "non-invariant devices row":
        rows[-3]["invariant"] = False
    elif fault == "devices error row":
        rows[-3] = {"axis": "devices", "devices": 1, "error": True}
    elif fault == "missing headline value":
        del rows[-1]["value"]
    elif fault == "missing headline row":
        rows = rows[:-2] + rows[-1:]
    elif fault == "no slot_reduce":
        launches = {"slot_reduce": 0, "sell_spmv": 4}
    elif fault == "short tsv":
        from arcanefem_tpu_torch.bench_sweep import tsv_text

        tsv = tsv_text(rows[:-1])
    if fault == "none":
        _sweep_check(smoke, rows, launches, tsv)
    else:
        with pytest.raises(RuntimeError, match=r"\[sweep\]"):
            _sweep_check(smoke, rows, launches, tsv)


def _profile_unstr_ms():
    return {"fine_spmv": 0.31, "spmv_l1": 0.05, "spmv_l2": 0.01, "transfer_pair_l0": 0.12,
            "cheb_smooth_l0": 0.35, "vcycle": 1.6, "precise_dot": 0.02}


@pytest.mark.parametrize("fault", ["none", "missing level", "negative", "zero vcycle",
                                   "no measured time"])
def test_profile_unstr_check(fault):
    smoke = _smoke()
    ms, measured = _profile_unstr_ms(), 1.9
    if fault == "missing level":
        del ms["spmv_l2"]
    elif fault == "negative":
        ms["precise_dot"] = -0.01
    elif fault == "zero vcycle":
        ms["vcycle"] = 0.0
    elif fault == "no measured time":
        measured = float("nan")
    model = 5 * ms["fine_spmv"] + ms["transfer_pair_l0"] + 0.06
    if fault == "none":
        smoke._check_profile_unstr(ms, model, measured, 3)
    else:
        with pytest.raises(RuntimeError, match=r"\[profile\]"):
            smoke._check_profile_unstr(ms, model, measured, 3)


@pytest.mark.parametrize("fault", ["none", "missing list", "missing op", "nan op",
                                   "no measured time"])
def test_profile_iter_check(fault):
    from arcanefem_tpu_torch.tools.profile_iter import padded_ops, plain_ops

    smoke = _smoke()
    out = {which: {"ms": {name: 0.5 for name, _ in ops}, "measured_ms_per_iter": 3.2,
                   "iterations": 13}
           for which, ops in (("plain", plain_ops()), ("padded", padded_ops()))}
    if fault == "missing list":
        del out["padded"]
    elif fault == "missing op":
        del out["plain"]["ms"]["jacobi sweep"]
    elif fault == "nan op":
        out["padded"]["ms"]["coarse chain (l>=1)"] = float("nan")
    elif fault == "no measured time":
        del out["padded"]["measured_ms_per_iter"]
    if fault == "none":
        smoke._check_profile_iter(out)
    else:
        with pytest.raises(RuntimeError, match=r"\[profile\]"):
            smoke._check_profile_iter(out)


def _ilu_rows():
    """[ilu]'s rows as the JAX tool prints them at its sizes."""
    return [
        {"system": "poisson2d_8k", "n": 8281, "nnz": 57241, "jacobi": 171, "cheb3": 58,
         "ic0_iters": 71, "ic0_depth": 181, "ilut_iters": 2000, "ilut_depth": 836},
        {"system": "poisson3d_11k", "n": 12167, "nnz": 170083, "jacobi": 56, "cheb3": 19,
         "ic0_iters": 25, "ic0_depth": 67, "ilut_iters": 2000, "ilut_depth": 1377},
        {"system": "elasticity2d_5k", "n": 5202, "nnz": 71204, "jacobi": 592, "cheb3": 210,
         "ic0_iters": 138, "ic0_depth": 202, "ilut_iters": 10, "ilut_depth": 1306}]


@pytest.mark.parametrize("fault", [
    "none", "one iteration off", "two iterations off", "depth off", "nnz off",
    "ilut 15% off", "ilut off the cap", "ic0 breakdown", "csr differs",
    "csr pattern differs", "missing system", "no block_slot_reduce"])
def test_ilu_check(fault):
    """[ilu]'s checks pass on equal rows (and counts within 1) and fail on
    each fault."""
    import math

    smoke = _smoke()
    card, cpu = _ilu_rows(), _ilu_rows()
    diffs, launches = [0.0, 3e-16, 1e-13], {"slot_reduce": 2, "block_slot_reduce": 1}
    if fault == "one iteration off":
        card[0]["cheb3"] += 1
        card[2]["ic0_iters"] -= 1
    elif fault == "two iterations off":
        card[1]["jacobi"] += 2
    elif fault == "depth off":
        card[2]["ilut_depth"] += 1
    elif fault == "nnz off":
        cpu[0]["nnz"] -= 1
    elif fault == "ilut 15% off":
        card[2]["ilut_iters"] = 12
    elif fault == "ilut off the cap":
        card[0]["ilut_iters"] = 1500
    elif fault == "ic0 breakdown":
        card[1].update(ic0_iters=None, ic0_error="breakdown (non-positive pivot)")
        del card[1]["ic0_depth"]
    elif fault == "csr differs":
        diffs[1] = 2e-12
    elif fault == "csr pattern differs":
        diffs[2] = math.inf
    elif fault == "missing system":
        card, cpu = card[:2], cpu[:2]
    elif fault == "no block_slot_reduce":
        launches["block_slot_reduce"] = 0
    if fault in ("none", "one iteration off"):
        smoke._check_ilu(card, cpu, diffs, launches)
    else:
        with pytest.raises(RuntimeError, match=r"\[ilu\]"):
            smoke._check_ilu(card, cpu, diffs, launches)


def test_csr_diff():
    import numpy as np
    import scipy.sparse as sp

    smoke = _smoke()
    A = sp.random(30, 30, density=0.2, format="csr", random_state=0) + sp.identity(30)
    B = A.copy()
    B.data[3] *= 1 + 1e-13
    assert smoke._csr_diff(A, A) == 0.0
    assert 0 < smoke._csr_diff(B, A) <= 1e-13
    C = A.tolil()
    C[0, 29] = 1.0
    assert smoke._csr_diff(C.tocsr(), A) == np.inf


def test_ilu_experiment_on_the_cpu(monkeypatch):
    """ilu_experiment's control flow at a small size, both builds on the CPU
    and the rows in spawned processes: the rows of the two builds are equal
    and pass [ilu]'s row checks; no kernel launched on the CPU."""
    from arcanefem_tpu_torch.tools import ilu_decision

    smoke = _smoke()
    monkeypatch.setattr(ilu_decision, "SIZES", {
        "poisson2d_8k": (12, 12), "poisson3d_11k": (4, 4, 4), "elasticity2d_5k": (8, 8)})
    card, card_rows, cpu_rows, diffs, launches = smoke.ilu_experiment("cpu")
    assert [s.name for s in card] == list(ilu_decision.SIZES)
    assert card_rows == cpu_rows and diffs == [0.0, 0.0, 0.0]
    assert launches == {"slot_reduce": 0, "block_slot_reduce": 0}
    smoke._check_ilu(card_rows, cpu_rows, diffs, {"slot_reduce": 2, "block_slot_reduce": 1})


def test_add_ilu_launches():
    smoke = _smoke()
    records = [{"name": "sell_spmv"}, {"name": "slot_reduce"},
               {"name": "block_slot_reduce (soildynamics b=2)"}]
    smoke._add_ilu_launches(records, {"slot_reduce": 2, "block_slot_reduce": 1})
    assert [r.get("ilu_launches") for r in records] == [None, 2, 1]
    with pytest.raises(RuntimeError, match=r"\[ilu\]"):
        smoke._add_ilu_launches(records[:2], {"slot_reduce": 2, "block_slot_reduce": 1})


def _amg_runs():
    run = {"amg_setup_s": 3.1, "levels": [244183, 23056, 1361, 59], "iterations": 15,
           "rel": 3.3e-9, "true_residual": 1.9e-7, "launches": {"sell_spmv": 300}}
    return {"native": dict(run), "scipy": dict(run, iterations=16)}


@pytest.mark.parametrize("fault", ["none", "two iterations apart", "not converged",
                                   "true residual", "no K1", "missing branch"])
def test_amg_check(fault):
    smoke = _smoke()
    runs = _amg_runs()
    if fault == "two iterations apart":
        runs["scipy"]["iterations"] = 17
    elif fault == "not converged":
        runs["native"]["rel"] = 2e-8
    elif fault == "true residual":
        runs["scipy"]["true_residual"] = 2e-4
    elif fault == "no K1":
        runs["scipy"]["launches"] = {}
    elif fault == "missing branch":
        del runs["scipy"]
    if fault == "none":
        smoke._check_amg(runs)
    else:
        with pytest.raises(RuntimeError, match=r"\[amg\]"):
            smoke._check_amg(runs)


@pytest.fixture(scope="module")
def gate_dir(tmp_path_factory):
    """The four files a CPU run of the h=14 bench system (RCM order) writes,
    and the gate's environment for them."""
    import torch

    from arcanefem_tpu_torch import bench_unstructured as bu

    d = tmp_path_factory.mktemp("gate")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bu, "CACHE_DIR", str(d))
        mesh, topo = bu.sphere_cut_system(14.0, 0, order="rcm")
        bu.solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float32, penalty=1e12,
                            order="rcm", cache=str(d / bu.mesh_key(14.0, 0, "rcm")))
    return d, {"AFEM_CACHE_DIR": str(d), "BENCH_UNSTR_H": "14", "BENCH_UNSTR_REFINE": "0",
               "BENCH_UNSTR_ORDER": "rcm"}


@pytest.mark.parametrize("fault", ["none", "full exits 1", "a missing file", "empty exits 0",
                                   "empty lists three"])
def test_caches_check(gate_dir, tmp_path, capsys, fault):
    """[caches]' checks on the gate's own output: a directory of the four
    files a CPU run of the h=14 bench system writes (exit 0) and an empty
    one (exit 1); each fault fails."""
    import shutil

    from arcanefem_tpu_torch.tools import verify_caches

    smoke = _smoke()
    src, env = gate_dir

    def gate(e):
        code = verify_caches.main(e, "cpu")
        return code, capsys.readouterr().out

    full = gate(env)
    empty = gate({**env, "AFEM_CACHE_DIR": str(tmp_path / "empty")})
    if fault == "full exits 1":
        full = (1, full[1])
    elif fault == "a missing file":
        d = tmp_path / "c"
        shutil.copytree(src, d)
        os.remove(d / "sell_sphere_cut_v3_h14_r0_v1.npz")
        full = gate({**env, "AFEM_CACHE_DIR": str(d)})
    elif fault == "empty exits 0":
        empty = (0, empty[1])
    elif fault == "empty lists three":
        empty = (1, "\n".join(empty[1].splitlines()[1:]))
    if fault == "none":
        smoke._check_caches(full, empty)
    else:
        with pytest.raises(RuntimeError, match=r"\[caches\]"):
            smoke._check_caches(full, empty)
