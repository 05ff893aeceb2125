"""The port's spans and counters (``utils/tracing.py``): nothing recorded
without a profiler, the span structure of AMG-PCG on the h = 14 sphere and
MG-PCG on a 16³ box under one, and the modules' launch counters as views
of the one registry."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from arcanefem_tpu_torch import bench_structured
from arcanefem_tpu_torch.mesh import stencil_assembly
from arcanefem_tpu_torch.ops import lane_assembly
from arcanefem_tpu_torch.parallel import comm
from arcanefem_tpu_torch.solver.iterative import pcg, pcg_chunked
from arcanefem_tpu_torch.sparse import (
    band_gather,
    blocked,
    dia_stencil,
    diag_spmv,
    ell_gather,
    sell,
    slot_reduce,
    supernode,
)
from arcanefem_tpu_torch.tools import probe_gather
from arcanefem_tpu_torch.utils import tracing

# each module's launch counters, with the keys they have always had
LAUNCH_KEYS = {
    sell: ("sell_spmv", "sell_spmv_bf16", "sell_spmv_batched"),
    slot_reduce: ("slot_reduce", "block_slot_reduce"),
    ell_gather: ("ell_gather_sum", "ell_gather_sum_batched"),
    band_gather: ("band_gather", "band_gather_batched"),
    diag_spmv: ("diag_spmv",),
    blocked: ("bsr_spmv", "bsr_spmv_bf16"),
    supernode: ("bsr8_spmv", "bsr8_spmv_bf16"),
    dia_stencil: ("dia_spmv_p", "dia_jacobi_p", "dia_residual_p", "dia_spmv",
                  "dia_sweep", "residual_replace_f64"),
    stencil_assembly: ("stencil_assembly",),
    lane_assembly: ("tet_element", "tet_assemble"),
    probe_gather: ("window_take",),
}
PROBE = tracing.counters("test_torch_tracing.spmv")
SUBSPANS = (tracing.VCYCLE_SWEEP, tracing.RESTRICT_AXIS, tracing.PROLONG_AXIS)


class Diag:
    """A diagonal operator whose products count ``PROBE``."""

    def __init__(self, d):
        self.d = d

    def spmv(self, x):
        tracing.count(PROBE[0])
        return self.d * x

    def residual(self, b, x):
        return b - self.d * x


class Jacobi:
    def __init__(self, d):
        self.inv = 1.0 / d

    def apply(self, r):
        return self.inv * r


def _diag_system(n=64):
    d = torch.linspace(1.0, 50.0, n, dtype=torch.float64)
    return Diag(d), torch.ones(n, dtype=torch.float64), Jacobi(d + 0.5)


def _profiled(fn):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.report(), prof


@pytest.fixture(scope="module")
def sphere():
    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system

    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    res = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float32, penalty=1e12,
                           plain=True)
    return res["system"], res["M"]


def test_no_profiler_no_spans_and_counters_still_count():
    A, b, M = _diag_system()
    tracing.reset()
    tracing.reset_counts(PROBE)
    assert not tracing.active()
    _, k, rel = pcg(A, b, M, torch.zeros_like(b), 1e-10, 0.0, 200)
    assert tracing.report() == {}
    assert tracing.counts(PROBE) == {PROBE[0]: k + 1} and rel <= 1e-10
    with tracing.span("outside"):
        pass
    assert tracing.report() == {}


def test_counts_go_to_the_innermost_span_and_self_excludes_children():
    A, b, M = _diag_system()
    tracing.reset_counts(PROBE)
    (_, k, _), rep, _ = _profiled(lambda: pcg(A, b, M, torch.zeros_like(b), 1e-10, 0.0, 200))
    assert rep["cg.spmv"]["counts"] == {PROBE[0]: k + 1}
    assert rep["cg"]["counts"] == {} and tracing.counts(PROBE)[PROBE[0]] == k + 1
    assert rep["cg.dot"]["calls"] == 2 * k + 1 and rep["cg.test"]["calls"] == k + 1
    assert rep["cg.update"]["calls"] == 2 * k and rep["vcycle"]["calls"] == k + 1
    children = sum(r["incl_s"] for r in rep.values() if r["parent"] == "cg")
    assert rep["cg"]["self_s"] == pytest.approx(rep["cg"]["incl_s"] - children, abs=1e-9)
    assert {r["parent"] for n, r in rep.items() if n != "cg"} == {"cg"}


def test_chunked_cg_reads_the_test_once_per_chunk():
    A, b, M = _diag_system()
    (_, k, _), rep, _ = _profiled(
        lambda: pcg_chunked(A, b, M, torch.zeros_like(b), 1e-10, 0.0, 200, chunk=4,
                            replace_every=3))
    assert k % 4 == 0
    assert rep["cg.test"]["calls"] == k // 4 + 1
    assert rep["cg.replace"]["calls"] == k // 3


def _check_vcycle_structure(rep, applies, levels):
    assert rep["vcycle"]["calls"] == applies and rep["vcycle"]["parent"] == "cg"
    assert rep["vcycle.coarse"]["calls"] == applies
    for l in range(levels):
        names = tracing.level(l)
        assert rep[names.smooth]["calls"] == 2 * applies
        for n in (names.residual, names.restrict, names.prolong):
            assert rep[n]["calls"] == applies
    for name, r in rep.items():
        assert 0.0 <= r["self_s"] <= r["incl_s"]
        if name.startswith("vcycle.") and name not in SUBSPANS:
            assert r["parent"] == "vcycle", name


def _port_spans_are_host_events(rep, prof):
    cpu = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    other = {e.name for e in prof.events() if e.device_type != torch.autograd.DeviceType.CPU}
    assert set(rep) <= cpu
    assert not set(rep) & other


def test_amg_pcg_on_the_sphere_records_its_structure(sphere):
    system, M = sphere
    A, b, x0 = system["A"], system["b"], system["x0"]
    (_, k, rel), rep, prof = _profiled(lambda: pcg(A, b, M, x0, 1e-8, 0.0, 500,
                                                   use_precise_dot=True))
    assert rel <= 1e-8 and k > 0
    assert rep["cg"]["calls"] == 1 and rep["cg.spmv"]["calls"] == k + 1
    assert rep["cg.dot"]["calls"] == 2 * k + 1 and rep["cg.test"]["calls"] == k + 1
    _check_vcycle_structure(rep, k + 1, len(M.mats))
    _port_spans_are_host_events(rep, prof)


def test_mg_pcg_on_the_box_records_its_structure():
    s = bench_structured.box_system(16, "cpu")
    res, rep, _ = _profiled(lambda: bench_structured.solve_mg(s, replace_every=0))
    k, M = res["iterations"], res["M"]
    assert res["rel"] <= 1e-8 and k > 0
    assert rep["mg.assemble"]["calls"] == rep["mg.build"]["calls"] == 1
    assert rep["mg.assemble"]["parent"] is None and rep["cg"]["parent"] is None
    assert rep["cg.dot"]["calls"] == 2 * k + 1 and rep["cg.test"]["calls"] == k + 1
    levels = len(M.mats) - 1
    _check_vcycle_structure(rep, k + 1, levels)
    # the coarse solve's sweeps after the first, and each transfer axis by axis
    assert rep["vcycle.sweep"]["calls"] == (k + 1) * (M.coarse_iters - 1)
    assert rep["vcycle.sweep"]["parent"] == "vcycle.coarse"
    for name, transfer in ((tracing.RESTRICT_AXIS, "restrict"), (tracing.PROLONG_AXIS, "prolong")):
        assert rep[name]["calls"] == 3 * levels * (k + 1)
        assert rep[name]["parent"] == f"vcycle.l0.{transfer}"


def test_lhs_assembly_is_a_span(sphere):
    from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system

    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    asm = lane_assembly.TetraAssembler(topo, mesh.cells["tetra4"], device="cpu", plain=True)
    coords = torch.as_tensor(mesh.coords, dtype=torch.float32)
    _, rep, _ = _profiled(lambda: asm(coords))
    assert rep["asm"]["calls"] == 1 and rep["asm"]["parent"] is None


@pytest.mark.parametrize("module", list(LAUNCH_KEYS), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launch_counts_are_views_of_the_registry(module):
    keys = LAUNCH_KEYS[module]
    module.reset_launch_counts()
    assert module.launch_counts() == dict.fromkeys(keys, 0)
    for i, key in enumerate(keys):
        tracing.count(key, i + 1)
    assert module.launch_counts() == tracing.counts(keys) == {
        key: i + 1 for i, key in enumerate(keys)}
    module.reset_launch_counts()
    assert module.launch_counts() == dict.fromkeys(keys, 0)


def test_counter_names_are_disjoint_and_the_other_views_hold():
    names = [k for keys in LAUNCH_KEYS.values() for k in keys]
    names += ["slot_sum", "all_gather", "all_reduce", "p2p"]
    assert len(names) == len(set(names))
    tracing.count("slot_sum", 3)
    assert slot_reduce.sum_launch_counts() == {"slot_sum": 3}
    slot_reduce.reset_launch_counts()
    assert slot_reduce.sum_launch_counts() == {"slot_sum": 0}
    comm.reset_counts()
    saved = comm.counts()
    tracing.count("p2p", 2)
    assert comm.counts() == {"all_gather": 0, "all_reduce": 0, "p2p": 2}
    tracing.restore_counts(saved)
    assert comm.counts() == dict.fromkeys(("all_gather", "all_reduce", "p2p"), 0)


def test_level_names_are_made_once():
    assert tracing.level(3) is tracing.level(3)
    assert tracing.level(2).restrict == "vcycle.l2.restrict"
    assert all(n.startswith("vcycle.l0.") for n in tracing.level(0))
