"""Slice 4 end to end on the CPU in f64: the compact route (compact CG
operator and V-cycle, banded pre-gathers, compact batched coordinate
gather) and the RCM-ordered diag route, each against the port's ELL route
on the same system and against the JAX CPU solve.

Off the TPU the JAX package runs the plain BellMatrix whatever AFEM_SPMV,
AFEM_BAND_PRE and AFEM_ASM_COMPACT say, so its CPU solve is the ELL
solve; what the knobs change is held through the JAX planners and their
emulation in test_torch_band_compact.py and test_torch_diag.py.  The
compact, band and diag routes compute the same linear map as the ELL
route, so they must take the same iterations; the compact route even sums
the same products in the same order.
"""

import numpy as np
import pytest
import torch

from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.solver.iterative import pcg as jax_pcg
from arcanefem_tpu_torch.bench_unstructured import (
    _check_options,
    solve_sphere_cut,
    sphere_cut_system,
)
from arcanefem_tpu_torch.solver.amg import BF16_MIN_ROWS, with_bf16_vcycle
from arcanefem_tpu_torch.sparse.compact import CompactMatrix
from arcanefem_tpu_torch.sparse.diag_spmv import DiagEllMatrix

from test_torch_slice import PENALTY, _jax_system

KW = dict(device="cpu", dtype=torch.float64, penalty=PENALTY)
COMPACT = dict(spmv="compact", band_pre=True, asm_compact=True,
               asm_coords="batched")


def _jax_solve(mesh, topo):
    A, flat, mask, b, x0 = _jax_system(mesh, topo)
    M = build_amg(A, smoother="chebyshev", cheb_deg=2, theta=0.03,
                  values_np=flat)
    xj, kj, _ = jax_pcg(A, b, M, x0, 1e-8, 0.0, 1000, use_precise_dot=True)
    return np.asarray(xj), int(kj)


def _hold(res, ell, jax_x, jax_k):
    x, xe = res["x"].numpy(), ell["x"].numpy()
    assert res["iterations"] == ell["iterations"], (res["iterations"], ell["iterations"])
    assert np.abs(x - xe).max() <= 1e-10 * np.abs(xe).max()
    assert abs(res["iterations"] - jax_k) <= 1, (res["iterations"], jax_k)
    assert np.abs(x - jax_x).max() <= 1e-6 * np.abs(jax_x).max()
    assert res["rel"] <= 1e-8 and res["true_residual"] <= 1e-6


@pytest.mark.parametrize("h", [14.0, 8.0])
def test_compact_band_route_matches_ell_and_jax(h):
    mesh, topo = sphere_cut_system(h, 0, cache=False)
    ell = solve_sphere_cut(mesh, topo, **KW)
    res = solve_sphere_cut(mesh, topo, system=ell["system"], **COMPACT, **KW)
    assert res["spmv_path"] == "CompactMatrix" and res["compact_check"] <= 1e-12
    assert res["vcycle_compact"] >= 2
    _hold(res, ell, *_jax_solve(mesh, topo))
    # the non-band compact route on the same system
    plain = solve_sphere_cut(mesh, topo, system=ell["system"], spmv="compact", **KW)
    assert plain["vcycle_band"] == 0
    assert np.array_equal(plain["x"].numpy(), res["x"].numpy())


@pytest.mark.parametrize("h", [14.0, 8.0])
def test_diag_route_rcm_matches_ell_and_jax(h):
    mesh, topo = sphere_cut_system(h, 0, cache=False, order="rcm")
    ell = solve_sphere_cut(mesh, topo, order="rcm", **KW)
    res = solve_sphere_cut(mesh, topo, order="rcm", spmv="diag",
                           system=ell["system"], **KW)
    assert res["spmv_path"] == "DiagEllMatrix" and res["diag_check"] <= 1e-12
    _hold(res, ell, *_jax_solve(mesh, topo))


def test_compact_vcycle_equals_ell_cycle():
    """with_compact_vcycle: the levels and transfers of >= 1500 rows are
    compact, level 0 is the CG operator's CompactMatrix, and one cycle
    equals the ELL cycle bit for bit (the same products, the same order)."""
    mesh, topo = sphere_cut_system(8.0, 0, cache=False)
    ell = solve_sphere_cut(mesh, topo, **KW)
    res = solve_sphere_cut(mesh, topo, system=ell["system"], spmv="compact",
                           band_pre=True, **KW)
    system = res["system"]
    cg, Mc = system[("compact", True)]
    M = system["M"]
    assert Mc.vmats[0] is cg
    big = [m.n_nodes >= BF16_MIN_ROWS for m in M.mats]
    assert [v is not None for v in Mc.vmats] == big
    assert [p is not None for p in Mc.p_apply] == [
        p.n_nodes >= BF16_MIN_ROWS for p in M.P]
    assert all(isinstance(v, CompactMatrix) for v in Mc.vmats if v is not None)
    r = torch.as_tensor(np.random.RandomState(0).rand(topo.n_nodes))
    assert torch.equal(Mc.apply(r), M.apply(r))
    with pytest.raises(ValueError):
        with_bf16_vcycle(Mc)


def test_route_options_raise():
    """Combinations the JAX bench never runs, and unknown values, raise."""
    base = dict(spmv="ell", sn_block=False, sn_bf16=False, vcycle_bf16=False,
                asm_coords="split", asm_compact=False, band_pre=False,
                order="sn", smoother="chebyshev", cycle="V")
    _check_options(**base)
    for bad in (dict(band_pre=True), dict(spmv="diag", sn_block=True),
                dict(spmv="compact", sn_block=True),
                dict(order="rcm", spmv="supernode"), dict(order="rcm", sn_block=True),
                dict(spmv="compact", vcycle_bf16=True), dict(order="nd"),
                dict(spmv="window")):
        with pytest.raises(ValueError):
            _check_options(**{**base, **bad})
    _check_options(**{**base, "band_pre": True, "asm_compact": True})
    _check_options(**{**base, "spmv": "diag", "order": "rcm", "vcycle_bf16": True})
    with pytest.raises(ValueError):
        sphere_cut_system(14.0, 0, cache=False, order="nd")
    # no fallback: a column structure the diagonal plan declines raises
    n = 8192
    cols = np.random.RandomState(0).randint(0, n, (n, 64)).astype(np.int32)
    with pytest.raises(ValueError):
        DiagEllMatrix(torch.ones((n, 64), dtype=torch.float64), cols)
