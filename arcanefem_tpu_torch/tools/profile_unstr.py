"""Per-component timing of the unstructured AMG-PCG iteration.

    python -m arcanefem_tpu_torch.tools.profile_unstr [--device cuda|cpu]

The counterpart of ``tools/profile_unstr.py``: it splits one iteration of
the bench's unstructured PRIMARY (sphere_cut; ``BENCH_UNSTR_H`` and
``BENCH_UNSTR_REFINE``, 5 and 2 by default: the 1.9M-DoF sphere) into
its parts, each timed alone (:func:`components`): the fine SpMV (the CG
operator), each coarser level's SpMV, the level-0 transfer pair
(restriction then prolongation), the level-0 Chebyshev smoother from x = 0,
one whole V-cycle and the compensated dot.  A PCG iteration with a
degree-d Chebyshev V(1,1) cycle runs 2d + 1 fine SpMVs (one Krylov A·p,
d - 1 in the pre-smoother, the level residual, d in the post-smoother),
so the model (2d + 1)·fine + transfers + coarse levels, which leaves out
the dots and vector updates, is printed beside the measured ms per
iteration of one ``pcg_chunked`` solve of the same system.

Each probe applies its component k times in a row, renormalising the
vector after every step (y / (‖y‖ + 1e-30)) as JAX's probes do, and its
time is the slope (t(k2) − t(k1)) / (k2 − k1) of CUDA events around the
k runs (``utils/timing.py::slope_ms``; k pairs (2, 8), (1, 4) for the
V-cycle and (4, 16) for the dot, best of 3 at each k).  The level probes
run the cycle's own level operators (``AMGPrecond._mat``: the bf16 copies
with ``BENCH_UNSTR_BF16=1``).

The system is the bench's: ``bench_unstructured.sphere_cut_system`` from
the npz caches (prime an 8.9M one first with ``python -m
arcanefem_tpu_torch.bench_unstructured --h 6 --refine 3 --prime``), the
fine SELL layout and AMG hierarchy through the bench's cache
(``amg_cached``), and the PRIMARY's route and AMG knobs (``BENCH_UNSTR_SPMV``,
``BENCH_AMG_SMOOTHER``, ``BENCH_AMG_CHEB_DEG``, ``BENCH_AMG_THETA``, ...,
``bench.primary_args``).  It prints one ``[prof]`` line per component and
one JSON line.  It runs on the card; ``--device cpu`` (float64) is for
small systems.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..solver.iterative import pcg_chunked, precise_dot
from ..utils.timing import elapsed_s, slope_ms

K_PAIRS = {"vcycle": (1, 4), "precise_dot": (4, 16)}  # else (2, 8)


def renormalised(fn):
    """The probe's step: ``fn`` then y / (‖y‖ + 1e-30), so that k steps
    in a row neither overflow nor vanish."""
    def step(x):
        y = fn(x)
        return y / (torch.linalg.vector_norm(y) + 1e-30)
    return step


def probes(A, M, x0: torch.Tensor) -> list[tuple[str, str, object, torch.Tensor]]:
    """(key, label, component x -> y, start vector) of every probe, in the
    order and with the keys of JAX's ``tools/profile_unstr.py``; level l's
    start vector is ``RandomState(l).rand(n_l)``."""
    out = [("fine_spmv", "fine SpMV (A·p)", A.spmv, x0)]
    for l in range(1, len(M.mats)):
        op = M._mat(l)
        nl = M.mats[l].n_nodes
        vl = torch.as_tensor(np.random.RandomState(l).rand(nl), device=x0.device).to(x0.dtype)
        out.append((f"spmv_l{l}", f"level-{l} SpMV (n={nl:,})", op.spmv, vl))
    out += [
        ("transfer_pair_l0", "transfer down+up (level 0)",
         lambda x: M._prolong(0, M._restrict(0, x)), x0),
        ("cheb_smooth_l0", "cheb fine smoother (x=None)",
         lambda x: M._smooth_cheb(0, x), x0),
        ("vcycle", "full V-cycle apply", M.apply, x0),
        ("precise_dot", "compensated dot (pair)",
         lambda x: x * (precise_dot(x, x) / (precise_dot(x, x) + 1.0)), x0),
    ]
    return out


def model_ms(ms: dict, deg: int) -> float:
    """(2·deg+1)·fine + the level-0 transfer pair + every coarser level's
    SpMV: JAX's model of one iteration, without dots and vector updates."""
    return ((2 * deg + 1) * ms["fine_spmv"] + ms["transfer_pair_l0"]
            + sum(v for k, v in ms.items() if k.startswith("spmv_l")))


def components(A, M, x0: torch.Tensor, reps: int = 3, verbose: bool = True):
    """(ms of each probe by JAX's key, the model ms/iter) of the CG
    operator ``A`` and the AMG cycle ``M`` from the start vector ``x0``."""
    ms = {}
    for key, label, fn, v in probes(A, M, x0):
        k1, k2 = K_PAIRS.get(key, (2, 8))
        ms[key] = slope_ms(renormalised(fn), v, k1, k2, reps)
        if verbose:
            print(f"[prof] {label:<28s} {ms[key]:9.4f} ms", flush=True)
    return ms, model_ms(ms, M._deg(0))


def measured_ms_per_iter(A, b, M, x0, rtol: float) -> tuple[float, int]:
    """(ms per iteration, iterations) of one ``pcg_chunked`` solve (chunk 1,
    compensated dots, as the bench's) after one untimed solve."""
    def solve():
        return pcg_chunked(A, b, M, x0, rtol, 0.0, 1000, use_precise_dot=True, chunk=1)

    solve()
    t, (_, k, _) = elapsed_s(solve, b.device)
    return t * 1e3 / max(k, 1), k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m arcanefem_tpu_torch.tools.profile_unstr",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_unstr: no CUDA device is available; pass --device cpu",
              file=sys.stderr)
        return 1
    from ..bench import primary_args
    from ..bench_unstructured import gpu_name_and_power, mesh_key, solve_sphere_cut
    from ..bench_unstructured import sphere_cut_system
    from ..utils.cache import CACHE_DIR, cache_enabled

    env = os.environ
    _, _, rtol, opts = primary_args(env)
    h = float(env.get("BENCH_UNSTR_H", "5"))
    refine = int(env.get("BENCH_UNSTR_REFINE", "2"))
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, topo = sphere_cut_system(h, refine, order=opts["order"])
    prefix = (os.path.join(CACHE_DIR, mesh_key(h, refine, opts["order"]))
              if cache_enabled() else None)
    res = solve_sphere_cut(mesh, topo, device=args.device, dtype=dtype, penalty=1e12,
                           rtol=rtol, cache=prefix, **opts)
    A, M = res["op"], res["M"]
    n = topo.n_nodes
    print(f"[prof] {n:,} nodes, W={topo.width}, nnz={topo.nnz:,}; AMG levels "
          f"{res['levels']} (cached={res['amg_setup_cached']})", flush=True)
    x0 = torch.as_tensor(np.random.RandomState(0).rand(n), device=args.device).to(dtype)
    ms, model = components(A, M, x0)
    deg = M._deg(0)
    system = res["system"]
    meas, iters = measured_ms_per_iter(A, system["b"], M, system["x0"], rtol)
    print(f"[prof] model ms/iter ≈ (2·deg+1)·fine + transfers + coarse = {model:.4f} ms "
          f"(deg={deg}; excludes dots/axpys); measured {meas:.4f} ms/iter over "
          f"{iters} iterations", flush=True)
    line = {"h": h, "refine": refine, "n_dofs": int(n), "levels": res["levels"],
            "spmv_path": res["spmv_path"], "deg": deg, "ms": ms,
            "model_ms_per_iter": model, "measured_ms_per_iter": meas,
            "iterations": iters, "device": args.device, "dtype": str(dtype)[6:]}
    if args.device == "cuda":
        line["gpu"] = gpu_name_and_power()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
