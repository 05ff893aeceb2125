"""The structured Kuhn-box Poisson path, end to end, on one CUDA card.

    python -m arcanefem_tpu_torch.bench_structured [--n 224] [--precond mg|mg_flat|jacobi]

The counterpart of ``bench.py::bench_structured`` with its defaults:
−Δu = 1 on the unit cube split into n³ hexes of 6 Kuhn tetrahedra
((n+1)³ = 11,390,625 DoF at n = 224), node coordinates jittered by 0.1 of
the spacing, penalty Dirichlet (1e12) with u = 0 on x = 0 and u = 1 on
x = 1, in float32.  One pass is the fused assembly with RHS and BC (K4),
the geometric multigrid hierarchy (build_mg_padded: nu = 1, damped Jacobi
ω = 0.8, 40 coarse sweeps, bf16 bands, the levels re-assembled by K4) and
CG with compensated dots preconditioned by one V-cycle (K5 SpMV, K6
smoother, K7 residual) to rtol 1e-8.  ``--precond jacobi`` runs
Jacobi-preconditioned CG on the band-major stencil operator (K8a) instead,
and ``--precond mg_flat`` CG with the flat-vector V-cycle on that operator
(build_mg with stencil levels: K8a SpMV, K8b smoother and residual), as
the JAX package's tools/profile_iter.py runs it.  ``--nu``, ``--smoother
cheb``, ``--no-mg-bf16``, ``--unfused``, ``--chunk`` and ``--rtol`` are
``bench.py``'s BENCH_NU, BENCH_SMOOTHER, BENCH_MG_BF16=0, BENCH_FUSED=0,
BENCH_CHUNK and BENCH_RTOL (:class:`Options`).

It prints one JSON line with ``bench.py``'s field names; ``value`` is the
time of one full pass on CUDA events, ``solve_s`` that of its CG alone,
bracketed by events inside the same pass, and ``ms_per_iter`` =
solve_s / iterations.  The padded mask, penalty·g and
warm-start planes of every level are constants of the JAX trace; here
they are built once before the timed pass (``bc_planes_timed: false``).
Unlike the JAX bench it also checks the true residual
‖(b − A x)_free‖ / ‖b_free‖ in float64.
"""

from __future__ import annotations

import argparse
import functools
import json
from dataclasses import dataclass

import numpy as np
import torch

from .bench_unstructured import gpu_name_and_power
from .mesh.stencil_assembly import assemble_stiffness_kernel, assemble_system
from .mesh.structured import StructuredBox, apply_penalty_dirichlet
from .solver.iterative import Precond, pcg_chunked
from .solver.multigrid import build_mg, build_mg_padded, level_masks_p
from .sparse.dia import DiaMatrix
from .sparse.dia_stencil import (
    DiaPlaneMatrixP,
    pad_host_vec,
    to_plane_matrix,
    to_stencil_matrix,
)
from .utils.timing import time_op

RTOL = 1e-8
PENALTY = 1e12  # float32-safe, as the JAX bench
OMEGA, COARSE_ITERS, MIN_SIZE = 0.8, 40, 8  # the JAX bench's MG constants
# CG's float32 residual is recomputed as b − A x in float64 every 4
# iterations (solver/iterative.py::pcg): without it the float32 rounding of
# the O(h) initial residual next to the x = 1 plane stays in the answer,
# and the true residual grows ~4x per doubling of n (7.1e-4 at n = 64 on
# the CPU's plain path; 2.6e-6 with it)
REPLACE_EVERY = 4


@dataclass(frozen=True)
class Options:
    """The SECONDARY's knobs in ``bench.py``: ``nu`` (BENCH_NU),
    ``smoother`` "jacobi" or "cheb" (BENCH_SMOOTHER: fixed-ω Jacobi or the
    degree-nu Chebyshev weights), ``mg_bf16`` bf16 hierarchy bands
    (BENCH_MG_BF16), ``fused`` the fused assembly with RHS and BC and the
    fused MG build (BENCH_FUSED; False assembles the stiffness, penalises
    it and moves it to the plane layout, on every level), ``chunk`` CG
    steps between two reads of the stopping test (BENCH_CHUNK,
    ``pcg_chunked``) and ``rtol`` (BENCH_RTOL).  ``smoother``,
    ``mg_bf16`` and ``fused`` shape the padded MG path only."""

    nu: int = 1
    smoother: str = "jacobi"
    mg_bf16: bool = True
    fused: bool = True
    chunk: int = 1
    rtol: float = RTOL

    def __post_init__(self):
        if self.smoother not in ("jacobi", "cheb"):
            raise ValueError(f"smoother must be 'jacobi' or 'cheb', got {self.smoother!r}")
        if self.nu < 1 or self.chunk < 1:
            raise ValueError(f"nu and chunk must be >= 1, got {self.nu}, {self.chunk}")


DEFAULT = Options()


@dataclass
class BoxSystem:
    """The bench's box, coordinates and Dirichlet data on one device.

    mask/g: host numpy (Dirichlet rows, values); mask_p, pg_p, x0_p: their
    padded planes (mask, penalty·g·mask, g·mask); masks_p: the padded mask
    plane of every multigrid level."""

    box: StructuredBox
    coords3d: torch.Tensor
    mask: np.ndarray
    g: np.ndarray
    mask_p: torch.Tensor
    pg_p: torch.Tensor
    x0_p: torch.Tensor
    masks_p: list


def box_system(n: int, device, dtype=torch.float32) -> BoxSystem:
    """The bench system at box size n (float32 coordinates, as the JAX
    bench makes them, cast to ``dtype``)."""
    box = StructuredBox(n, n, n)
    c3 = torch.as_tensor(box.grid_coords(np.float32, jitter=0.1),
                         device=device).to(dtype)
    mask = box.boundary_mask(("xmin", "xmax"))
    g = np.zeros(box.n_nodes)
    g[box.boundary_mask(("xmax",))] = 1.0

    def plane(v):
        return torch.as_tensor(pad_host_vec(box, v, np.float64), device=device).to(dtype)

    return BoxSystem(box, c3, mask, g, plane(mask), plane(PENALTY * g * mask),
                     plane(g * mask),
                     level_masks_p(box, mask, min_size=MIN_SIZE,
                                   device=device, dtype=dtype))


def _pcg(A, b, M, x0, events, replace_every: int, opts: Options):
    """The bench's CG; ``events``, a pair of CUDA events, bracket it."""
    if events:
        events[0].record()
    out = pcg_chunked(A, b, M, x0, opts.rtol, 0.0, 5000, use_precise_dot=True,
                      chunk=opts.chunk, replace_every=replace_every)
    if events:
        events[1].record()
    return out


def _penalised_system(s: BoxSystem):
    """(stiffness DiaMatrix with the Dirichlet penalty, rhs, x0), flat."""
    dev = s.coords3d.device
    A = assemble_stiffness_kernel(s.box, s.coords3d)
    rhs = s.box.source_rhs(s.coords3d, 1.0)
    mask = torch.as_tensor(s.mask, device=dev)
    g = torch.as_tensor(s.g, device=dev).to(rhs.dtype)
    A, rhs = apply_penalty_dirichlet(A, rhs, mask, g, PENALTY)
    return A, rhs, torch.where(mask, g, 0.0)


def solve_mg(s: BoxSystem, replace_every: int = REPLACE_EVERY, events=None,
             opts: Options = DEFAULT) -> dict:
    """One full pass of the MG path: assembly with RHS and BC (fused, or
    with ``opts.fused`` False the stiffness penalised and moved to the
    plane layout), hierarchy, MG-PCG, unpad."""
    if opts.fused:
        Ap, rhs_p = assemble_system(s.box, s.coords3d, s.mask_p, s.pg_p, PENALTY, f=1.0)
    else:
        A, rhs, _ = _penalised_system(s)
        Ap = to_plane_matrix(A, s.box)
        rhs_p = Ap.pad_vec(rhs)
    M = build_mg_padded(s.box, s.coords3d, s.mask, PENALTY, fine=Ap,
                        masks_p=s.masks_p, min_size=MIN_SIZE, nu=opts.nu,
                        omega=OMEGA, coarse_iters=COARSE_ITERS, fused=opts.fused,
                        cheb=opts.smoother == "cheb",
                        band_dtype=torch.bfloat16 if opts.mg_bf16 else None)
    xp, k, rel = _pcg(Ap, rhs_p, M, s.x0_p, events, replace_every, opts)
    return {"x": Ap.unpad_vec(xp), "iterations": k, "rel": rel, "A": Ap,
            "b": rhs_p, "x0": s.x0_p, "M": M}


def _flat_system(s: BoxSystem):
    """(band-major stencil operator, rhs, x0) of the box, flat vectors."""
    A, rhs, x0 = _penalised_system(s)
    return to_stencil_matrix(A, s.box), rhs, x0


def _flat_pcg(S, rhs, M, x0, events, opts: Options) -> dict:
    x, k, rel = _pcg(S, rhs, M, x0, events, REPLACE_EVERY, opts)
    return {"x": x, "iterations": k, "rel": rel, "A": S, "b": rhs, "x0": x0, "M": M}


def solve_jacobi(s: BoxSystem, events=None, opts: Options = DEFAULT) -> dict:
    """Jacobi-preconditioned CG on the band-major stencil operator (K8a)."""
    S, rhs, x0 = _flat_system(s)
    return _flat_pcg(S, rhs, Precond.jacobi(S), x0, events, opts)


def solve_mg_flat(s: BoxSystem, events=None, opts: Options = DEFAULT) -> dict:
    """CG preconditioned by the flat-vector V-cycle on band-major stencil
    levels (K8a SpMV, K8b smoother and V-cycle residual)."""
    S, rhs, x0 = _flat_system(s)
    M = build_mg(s.box, s.coords3d, s.mask, PENALTY, min_size=MIN_SIZE,
                 nu=opts.nu, omega=OMEGA, use_stencil_spmv=True)
    return _flat_pcg(S, rhs, M, x0, events, opts)


def true_residual(s: BoxSystem, res: dict) -> float:
    """‖(b − A x)_free‖ / ‖b_free‖ in float64 with the plain DiaMatrix
    of the assembled (penalised) operator."""
    A, b = res["A"], res["b"]
    bands = A.bands_p
    if isinstance(A, DiaPlaneMatrixP):  # x-major planes, padded vectors
        bands, b = bands.movedim(1, 0), A.unpad_vec(b)
    bands = bands[:, :, 1 : s.box.ny + 2, 1 : s.box.nz + 2].reshape(15, -1).double()
    b = b.double()
    r = b - DiaMatrix(bands, s.box.offsets).spmv(res["x"].double())
    free = torch.as_tensor(~s.mask, device=r.device)
    return float(torch.linalg.vector_norm(r[free]) / torch.linalg.vector_norm(b[free]))


SOLVERS = {"mg": solve_mg, "mg_flat": solve_mg_flat, "jacobi": solve_jacobi}


def time_pass(solve, s: BoxSystem, passes: int = 5) -> tuple[float, float]:
    """(pass_s, solve_s) of the fastest of ``passes`` full passes after a
    warm one: CUDA events around the pass and, inside it, around its CG."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_pass measures on a CUDA device; none is available")
    solve(s)
    best = (float("inf"), float("inf"))
    for _ in range(passes):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        solve(s, events=ev[1:3])
        ev[3].record()
        ev[3].synchronize()
        t = (ev[0].elapsed_time(ev[3]) / 1e3, ev[1].elapsed_time(ev[2]) / 1e3)
        best = min(best, t)
    return best


def bench_line(s: BoxSystem, res: dict, precond: str,
               opts: Options = DEFAULT) -> dict:
    """Check ``res`` (a solve of ``s`` on the card), time the stiffness
    assembly and full passes of the ``precond`` path with their CG, and
    return the bench JSON."""
    asm_s = time_op(assemble_stiffness_kernel, s.box, s.coords3d, reps=5, outer=2)
    total, solve_s = time_pass(functools.partial(SOLVERS[precond], opts=opts), s)
    tr = true_residual(s, res)
    if not res["rel"] <= opts.rtol:
        raise RuntimeError(f"PCG did not converge: rel {res['rel']:.3e}")
    if not tr <= 1e-4:
        raise RuntimeError(f"true residual {tr:.3e} > 1e-4")
    if not bool(torch.isfinite(res["x"]).all()):
        raise RuntimeError("non-finite solution")
    iters, nn = res["iterations"], s.box.n_nodes
    name, power = (v.strip() for v in gpu_name_and_power().split(",", 1))
    return {
        "metric": f"poisson3d_box_{nn / 1e6:.3g}MDoF_assembly+cg_to_{opts.rtol:g}_s",
        "value": round(total, 4),
        "assembly_mdofs": round(nn / asm_s / 1e6, 1),
        "iterations": iters,
        "n_dofs": nn,
        "nnz_stored": 15 * nn,
        "solve_s": round(solve_s, 4),
        "ms_per_iter": round(solve_s / max(iters, 1) * 1e3, 3),
        "rel": res["rel"],
        "true_residual": tr,
        "precond": precond,
        "mg_levels": None if precond == "jacobi" else [list(v) for v in res["M"].shapes],
        **{k: getattr(opts, k) for k in ("nu", "smoother", "mg_bf16", "fused", "chunk")},
        "bc_planes_timed": False,
        "platform": "cuda",
        "backend": "torch",
        "gpu": name,
        "power_limit": power,
    }


def bench_structured(n: int = 224, precond: str = "mg",
                     opts: Options = DEFAULT) -> dict:
    """The structured path at box size n on one CUDA card, in float32."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_structured measures a CUDA card; none is available")
    if precond not in SOLVERS:
        raise ValueError(f"precond must be one of {tuple(SOLVERS)}, got {precond!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    s = box_system(n, "cuda")
    return bench_line(s, SOLVERS[precond](s, opts=opts), precond, opts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=224,
                    help="hexes per axis (224: 11.4M DoF)")
    ap.add_argument("--precond", choices=tuple(SOLVERS), default="mg")
    ap.add_argument("--nu", type=int, default=1, help="smoothing sweeps (BENCH_NU)")
    ap.add_argument("--smoother", choices=("jacobi", "cheb"), default="jacobi",
                    help="MG smoother weights (BENCH_SMOOTHER)")
    ap.add_argument("--no-mg-bf16", action="store_true",
                    help="f32 hierarchy bands (BENCH_MG_BF16=0)")
    ap.add_argument("--unfused", action="store_true",
                    help="unfused assembly and MG build (BENCH_FUSED=0)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="CG steps per stopping test (BENCH_CHUNK)")
    ap.add_argument("--rtol", type=float, default=RTOL, help="BENCH_RTOL")
    args = ap.parse_args(argv)
    opts = Options(nu=args.nu, smoother=args.smoother, mg_bf16=not args.no_mg_bf16,
                   fused=not args.unfused, chunk=args.chunk, rtol=args.rtol)
    print(json.dumps(bench_structured(args.n, args.precond, opts)), flush=True)


if __name__ == "__main__":
    main()
