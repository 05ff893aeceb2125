"""Per-component timing of the structured MG-PCG iteration.

    BENCH_N=224 python -m arcanefem_tpu_torch.tools.profile_iter [--device cuda|cpu]

The counterpart of ``tools/profile_iter.py``: it times each piece of one
preconditioned-CG iteration on the bench's box (``bench_structured``;
``BENCH_N``, 224 by default: 11.4M DoF, float32, and the SECONDARY's
``BENCH_*`` knobs, ``bench.secondary_args``) in two lists:

* the plain list (JAX's ``main``), on the flat band-major operator and the
  flat-vector V-cycle of ``--precond mg_flat`` (``bench_structured.
  solve_mg_flat``): ``spmv A@x`` (K8a), ``residual b-Ax`` and ``jacobi
  sweep`` (K8b's residual and sweep modes), ``precise_dot+axpy``,
  ``plaindot+axpy`` and ``V-cycle apply``;
* the padded list (JAX's ``_profile_padded``), on the bench's own padded
  system and hierarchy (``bench_structured.solve_mg``: fused assembly, bf16
  hierarchy bands unless ``BENCH_MG_BF16=0``): ``cg body (no loop)``,
  ``vcycle apply``, ``spmv_p`` (K5 on the CG operator), ``residual_p
  masked`` (K7) and ``jacobi_p sweep`` (K6) on the V-cycle's own fine
  level, ``smooth0 elementwise``, ``restrict+prolong hop``, ``coarse chain
  (l>=1)`` and the two dots.

On the TPU the V-cycle probes were opt-in (a worker fault); here both
lists run whole.  Each op is a step v -> v' applied k times in a row; its
time is the slope (t(10) − t(2)) / 8 of CUDA events around the k steps,
the best of 3 at each k (``utils/timing.py::slope_ms``).  Beside each list
it prints the measured ms per iteration of one ``pcg_chunked`` solve of
its system (``mg_flat``'s and ``mg``'s, with the bench's residual
replacement) and one JSON line.  ``--device cpu`` (float64, default
``BENCH_N`` 16) is for small boxes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..solver.iterative import pcg_chunked, precise_dot
from ..utils.timing import elapsed_s, slope_ms

K1, K2 = 2, 10


def plain_ops() -> list[tuple[str, object]]:
    """(name, op(A, M, b, v) -> v') of the plain list: A the flat
    band-major operator, M the flat-vector V-cycle."""
    return [
        ("spmv A@x", lambda A, M, b, v: A.spmv(v)),
        ("residual b-Ax", lambda A, M, b, v: A.residual(b, v)),
        ("jacobi sweep", lambda A, M, b, v: A.jacobi_sweep(v, b, 0.8)),
        ("precise_dot+axpy", lambda A, M, b, v: v + precise_dot(v, b) * 1e-9 * b),
        ("plaindot+axpy", lambda A, M, b, v: v + torch.dot(v, b) * 1e-9 * b),
        ("V-cycle apply", lambda A, M, b, v: M.apply(v)),
    ]


def _restrict_hop(A, M, b, v):
    rc = M._restrict(0, v) * M.maskmul_p[1]
    return v + 1e-9 * M._prolong(0, rc)


def _coarse_chain(A, M, b, v):
    # everything below the fine level: restrict, recurse, prolong
    rc = M._restrict(0, v) * M.maskmul_p[1]
    xc = M._vcycle(1, rc) * M.maskmul_p[1]
    return v + 1e-9 * M._prolong(0, xc)


def _cg_body(A, M, b, v):
    # one PCG body on padded vectors, straight-line: the spmv, two
    # compensated dots, three axpys and the V-cycle
    Ap = A.spmv(v)
    alpha = precise_dot(v, Ap) * 1e-9 + 1.0
    x = v + alpha * Ap
    r = b - alpha * Ap
    z = M.apply(r)
    beta = precise_dot(r, z) * 1e-9 + 1.0
    return z + beta * x


def padded_ops() -> list[tuple[str, object]]:
    """(name, op(A, M, b, v) -> v') of the padded list: A the padded CG
    operator, M the padded V-cycle (``MGPrecondP``), b and v padded."""
    return [
        ("cg body (no loop)", _cg_body),
        ("vcycle apply", lambda A, M, b, v: M.apply(v)),
        ("spmv_p", lambda A, M, b, v: A.spmv(v)),
        ("residual_p masked", lambda A, M, b, v: M.mats[0].residual(b, v, M.maskmul_p[0])),
        ("jacobi_p sweep", lambda A, M, b, v:
            M.mats[0].jacobi_sweep(v, b, M.inv_diags_p[0], 0.8)),
        ("smooth0 elementwise", lambda A, M, b, v: 0.8 * M.inv_diags_p[0] * (b + 1e-9 * v)),
        ("restrict+prolong hop", _restrict_hop),
        ("coarse chain (l>=1)", _coarse_chain),
        ("precise_dot+axpy", lambda A, M, b, v: v + precise_dot(v, b) * 1e-9 * b),
        ("plaindot+axpy", lambda A, M, b, v:
            v + torch.dot(v.reshape(-1), b.reshape(-1)) * 1e-9 * b),
    ]


def systems(s, opts) -> dict:
    """The two lists' systems on the box system ``s``: name -> (A, M, b,
    the start vector, the solve's x0), each from one solve of the bench's
    path (``solve_mg_flat``, ``solve_mg``).  The start vector is JAX's:
    the Dirichlet values plus 1e-3 everywhere."""
    from ..bench_structured import solve_mg, solve_mg_flat

    out = {}
    for name, solve in (("plain", solve_mg_flat), ("padded", solve_mg)):
        r = solve(s, opts=opts)
        A = r["A"]
        if name == "padded":
            v = A.pad_vec(A.unpad_vec(r["x0"]) + 1e-3)
        else:
            v = r["x0"] + 1e-3
        out[name] = (A, r["M"], r["b"], v, r["x0"])
    return out


def profile(ops, A, M, b, v, reps: int = 3, verbose: bool = True) -> dict:
    """name -> ms per application of each op of ``ops``."""
    ms = {}
    for name, op in ops:
        ms[name] = slope_ms(lambda x, op=op: op(A, M, b, x), v, K1, K2, reps)
        if verbose:
            print(f"{name:22s} {ms[name]:9.4f} ms", flush=True)
    return ms


def measured_ms_per_iter(A, b, M, x0, opts, replace_every: int) -> tuple[float, int]:
    """(ms per iteration, iterations) of one ``pcg_chunked`` solve as the
    bench runs it, timed after one untimed solve."""
    def solve():
        return pcg_chunked(A, b, M, x0, opts.rtol, 0.0, 5000, use_precise_dot=True,
                           chunk=opts.chunk, replace_every=replace_every)

    solve()
    t, (_, k, _) = elapsed_s(solve, b.device)
    return t * 1e3 / max(k, 1), k


def run(s, opts, verbose: bool = True) -> dict:
    """Both lists on the box system ``s``: {list: {"ms": {op: ms},
    "measured_ms_per_iter": ..., "iterations": ...}}."""
    from ..bench_structured import REPLACE_EVERY

    out = {}
    for name, (A, M, b, v, x0) in systems(s, opts).items():
        if verbose:
            print(f"[{name}]", flush=True)
        ms = profile(plain_ops() if name == "plain" else padded_ops(), A, M, b, v,
                     verbose=verbose)
        meas, k = measured_ms_per_iter(A, b, M, x0, opts, REPLACE_EVERY)
        out[name] = {"ms": ms, "measured_ms_per_iter": meas, "iterations": k}
        if verbose:
            print(f"measured {meas:.4f} ms/iter over {k} iterations "
                  f"({'mg_flat' if name == 'plain' else 'mg'} PCG)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m arcanefem_tpu_torch.tools.profile_iter",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_iter: no CUDA device is available; pass --device cpu",
              file=sys.stderr)
        return 1
    from ..bench import secondary_args
    from ..bench_structured import box_system
    from ..bench_unstructured import gpu_name_and_power

    env = dict(os.environ)
    env.setdefault("BENCH_N", "224" if args.device == "cuda" else "16")
    n, _, opts = secondary_args(env)
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    torch.backends.cuda.matmul.allow_tf32 = False
    s = box_system(n, args.device, dtype)
    print(f"device={args.device} grid={n}^3 nodes={s.box.n_nodes:,} nu={opts.nu}",
          flush=True)
    out = run(s, opts)
    line = {"n": n, "n_dofs": s.box.n_nodes, "nu": opts.nu, "mg_bf16": opts.mg_bf16,
            "lists": out, "device": args.device, "dtype": str(dtype)[6:]}
    if args.device == "cuda":
        line["gpu"] = gpu_name_and_power()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
