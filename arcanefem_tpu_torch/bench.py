"""The north-star benchmark line of ``bench.py``, from the port, on one CUDA card.

    python -m arcanefem_tpu_torch.bench

runs the PRIMARY (the unstructured sphere_cut Poisson system, BELL
assembly and AMG-PCG to 1e-8, ``bench_unstructured``) and the SECONDARY
(the 224³ Kuhn box, fused stencil assembly and MG-PCG, ``bench_structured``)
each in a child process of its own, as ``bench.py::_run_subprocess_metrics``
does, and prints ``bench.py``'s one JSON line: ``metric``, ``value``
(seconds, assembly + solve of the PRIMARY), ``unit``, ``vs_baseline`` (the
A100 roofline estimate of the reference's pipeline on the same system over
``value``, :func:`reference_roofline_estimate`) and ``extra`` (the
PRIMARY's fields, ``secondary_metric``, ``secondary_value``,
``secondary_assembly_mdofs``, ``baseline_kind``, ``baseline_estimate_s``,
and the card's ``gpu`` and ``power_limit`` as nvidia-smi reports them).

Knobs (environment, as ``bench.py`` reads them):

- ``BENCH_UNSTR=0`` / ``BENCH_BOX=0`` skip the PRIMARY / the SECONDARY;
  ``BENCH_UNSTR_H``, ``BENCH_UNSTR_REFINE`` (6, 3: 8,865,969 DoF),
  ``BENCH_RTOL`` (1e-8), ``BENCH_N`` (224);
- the PRIMARY's routes, ``bench_unstructured``'s flags: ``BENCH_UNSTR_SPMV``
  (``ell``, the default, also under ``bench.py``'s name ``window``;
  ``supernode``; ``compact``), ``AFEM_SPMV`` (``compact``, ``diag``),
  ``BENCH_SN_BLOCK``, ``BENCH_SN_BF16``, ``BENCH_UNSTR_BF16``,
  ``AFEM_ASM_COORDS``, ``AFEM_ASM_COMPACT``, ``AFEM_BAND_PRE``,
  ``BENCH_UNSTR_ORDER``, ``BENCH_AMG_SMOOTHER``, ``BENCH_AMG_CHEB_DEG``,
  ``BENCH_AMG_CYCLE``, ``BENCH_AMG_THETA`` (0.03, the set-up's strength
  threshold, part of the AMG cache key) and ``BENCH_AMG_CHEB_APPLY`` (a
  Chebyshev degree applied to the hierarchy built at
  ``BENCH_AMG_CHEB_DEG``, which stays its cache key).  The defaults are the port's own route (ELL on
  SELL, split assembly, supernode order), not the TPU's compact default;
  the line's route fields say which route ran;
- the SECONDARY's: ``BENCH_PRECOND`` (``mg``, ``jacobi``, ``mg_flat``),
  ``BENCH_NU``, ``BENCH_SMOOTHER`` (``jacobi``, ``cheb``),
  ``BENCH_MG_BF16``, ``BENCH_FUSED``, ``BENCH_CHUNK``;
- ``BENCH_BUDGET_S`` (1500; 0 means no limit) bounds the children as
  ``bench.py``'s budget does, ``BENCH_SECONDARY_S`` (420) the time the
  SECONDARY needs to start; ``BENCH_NO_CACHE=1`` skips the AMG and SELL
  caches.

Knobs that name TPU-plan machinery with no counterpart in the port
(:data:`NO_COUNTERPART`) raise when set to anything but their default.
Nothing falls back: without a CUDA device the bench exits non-zero and
prints no line; a child that fails, times out or is skipped for lack of
budget leaves the line of what completed, with the failure in
``extra.error``, and the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# knob: its default; any other value has no counterpart in the port
NO_COUNTERPART = {
    "AFEM_SPMV_WCAP": "16",  # wide-row subrow split of the compact plan
    "AFEM_PRE_ROWS": "1024",  # rows per compact pre-gather tile
    "AFEM_ASM_MAX_GB": "6",  # the window-assembly plan's HBM cap
    "BENCH_SN_MAX_GB": "5",  # the supernode blocks' HBM cap
    "BENCH_SUBPROC": "1",  # the port runs each metric in its own child
    "BENCH_CPU": "0",  # no CPU path
}
SPMV_NAMES = {"ell": "ell", "window": "ell", "supernode": "supernode",
              "compact": "compact"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def reference_roofline_estimate(n_dofs: int, nnz: int) -> float:
    """Estimated seconds for the reference's A100 pipeline on this system.

    Bandwidth-roofline model of CUDA BSR atomic assembly
    (reference femutils/BSRFormat.h:842-898) + fp64 Hypre BoomerAMG-PCG
    (HypreDoFLinearSystem.cc:686-742) to rtol 1e-8, with every constant at
    the A100-favourable end; derivation + sources in BASELINE.md
    ("Reference-path roofline estimate").  AMG setup excluded on both
    sides (separate HypreSetup phase).
    """
    ref_assembly_s = n_dofs / 400e6          # 400 MDoF/s atomic assembly
    spmv_bytes = 12 * nnz + 16 * n_dofs      # fp64 CSR + x gather + y write
    ref_iter_s = 7 * spmv_bytes / 1.4e12     # 7 SpMV-equivalents @1.4TB/s
    return ref_assembly_s + 14 * ref_iter_s  # 14 PCG iterations


def final_json(primary: dict | None, secondary: dict | None) -> dict:
    """The single output line from whatever completed, as
    ``bench.py::_final_json`` assembles it."""
    if primary is None:
        primary = secondary
        secondary = None
    if primary is None:
        return {
            "metric": "none", "value": None, "unit": "s",
            "vs_baseline": None,
            "extra": {"error": "no benchmark completed in budget"},
        }
    extra = {k: v for k, v in primary.items() if k not in ("metric", "value")}
    if secondary is not None:
        extra["secondary_metric"] = secondary["metric"]
        extra["secondary_value"] = secondary["value"]
        extra["secondary_assembly_mdofs"] = secondary.get("assembly_mdofs")
    vs = None
    if "n_dofs" in primary and "nnz_stored" in primary:
        ref_s = reference_roofline_estimate(
            primary["n_dofs"], primary["nnz_stored"]
        )
        extra["baseline_kind"] = "a100-roofline-estimate"
        extra["baseline_estimate_s"] = round(ref_s, 4)
        # bench.py computes the ratio on "tpu" only; a CUDA card's number
        # is measured on the device as the TPU's was, so it gets one too
        if primary.get("platform") in ("tpu", "cuda"):
            vs = round(ref_s / primary["value"], 3)
        else:
            extra["platform"] = "cpu-fallback"
    return {
        "metric": primary["metric"],
        "value": primary["value"],
        "unit": "s",
        "vs_baseline": vs,
        "extra": extra,
    }


def _flag(env, name: str, default: str) -> bool:
    v = env.get(name, default)
    if v not in ("0", "1"):
        raise ValueError(f"{name} must be 0 or 1, got {v!r}")
    return v == "1"


def check_knobs(env) -> None:
    """Raise for a knob with no counterpart in the port set to anything
    but its default."""
    for name, default in NO_COUNTERPART.items():
        v = env.get(name, default)
        if v != default:
            raise ValueError(f"{name}={v!r} has no counterpart in the port "
                             f"(its default is {default!r}); unset it")


def primary_args(env) -> tuple[float, int, float, dict]:
    """(h, refine, rtol, route options of ``bench_unstructured``) from
    ``env``; raises for a value or a combination the port does not run."""
    from .bench_unstructured import _check_options, _cheb_deg

    spmv = env.get("BENCH_UNSTR_SPMV", "ell")
    if spmv not in SPMV_NAMES:
        raise ValueError(f"BENCH_UNSTR_SPMV must be one of {tuple(SPMV_NAMES)}, "
                         f"got {spmv!r}")
    spmv = SPMV_NAMES[spmv]
    afem = env.get("AFEM_SPMV", "")
    if afem:
        if afem not in ("compact", "diag"):
            raise ValueError(f"AFEM_SPMV must be compact or diag, got {afem!r}")
        if "BENCH_UNSTR_SPMV" in env and spmv != afem:
            raise ValueError(f"BENCH_UNSTR_SPMV={env['BENCH_UNSTR_SPMV']} and "
                             f"AFEM_SPMV={afem} name two SpMV routes")
        spmv = afem
    opts = {"spmv": spmv,
            "sn_block": _flag(env, "BENCH_SN_BLOCK", "0"),
            "sn_bf16": _flag(env, "BENCH_SN_BF16", "0"),
            "vcycle_bf16": _flag(env, "BENCH_UNSTR_BF16", "0"),
            "asm_coords": env.get("AFEM_ASM_COORDS", "split"),
            "asm_compact": _flag(env, "AFEM_ASM_COMPACT", "0"),
            "band_pre": _flag(env, "AFEM_BAND_PRE", "0"),
            "asm_reduce": env.get("AFEM_UNSTR_ASM", "window"),
            "order": env.get("BENCH_UNSTR_ORDER", "sn"),
            "smoother": env.get("BENCH_AMG_SMOOTHER", "chebyshev"),
            "cheb_deg": _cheb_deg(env.get("BENCH_AMG_CHEB_DEG", "2")),
            "cycle": env.get("BENCH_AMG_CYCLE", "V"),
            "theta": float(env.get("BENCH_AMG_THETA", "0.03")),
            "cheb_apply": (_cheb_deg(env["BENCH_AMG_CHEB_APPLY"])
                           if env.get("BENCH_AMG_CHEB_APPLY") else None)}
    _check_options(**{k: v for k, v in opts.items()
                      if k not in ("cheb_deg", "theta", "cheb_apply")})
    return (float(env.get("BENCH_UNSTR_H", "6")),
            int(env.get("BENCH_UNSTR_REFINE", "3")),
            float(env.get("BENCH_RTOL", "1e-8")), opts)


def default_cache_paths(env, device="cuda") -> dict[str, tuple[str, dict | None]]:
    """{role: (path, the key fields its meta record must hold, or None for a
    file without one)} of every cache file the PRIMARY reads under the
    knobs of ``env`` on ``device``: the mesh and topology npz of the node
    order it runs in and, unless ``BENCH_NO_CACHE=1``, the fine SELL layout
    and the AMG hierarchy; nothing with ``BENCH_UNSTR=0``.  Each name comes
    from the function that writes the file (``tools/verify_caches.py``
    checks them)."""
    from .bench_unstructured import (
        DTYPE,
        PENALTY,
        amg_cache_key,
        mesh_files,
        mesh_key,
        sell_cache_key,
    )
    from .utils.cache import cache_dir, cache_enabled

    h, refine, _, opts = primary_args(env)
    if env.get("BENCH_UNSTR", "1") not in ("1", "force"):
        return {}
    d = cache_dir(env)
    out = {role: (path, None) for role, path in
           mesh_files(mesh_key(h, refine, "rcm"), opts["order"], d).items()}
    if cache_enabled(env):
        prefix = os.path.join(d, mesh_key(h, refine, opts["order"]))
        out["sell"] = sell_cache_key(prefix)
        out["amg"] = amg_cache_key(prefix, smoother=opts["smoother"],
                                   cheb_deg=opts["cheb_deg"], penalty=PENALTY,
                                   device=device, dtype=DTYPE, theta=opts["theta"],
                                   env=env)
    return out


def secondary_args(env):
    """(n, precond, ``bench_structured.Options``) from ``env``."""
    from .bench_structured import SOLVERS, Options

    precond = env.get("BENCH_PRECOND", "mg")
    if precond not in SOLVERS:
        raise ValueError(f"BENCH_PRECOND must be one of {tuple(SOLVERS)}, got "
                         f"{precond!r}")
    opts = Options(nu=int(env.get("BENCH_NU", "1")),
                   smoother=env.get("BENCH_SMOOTHER", "jacobi"),
                   mg_bf16=_flag(env, "BENCH_MG_BF16", "1"),
                   fused=_flag(env, "BENCH_FUSED", "1"),
                   chunk=int(env.get("BENCH_CHUNK", "1")),
                   rtol=float(env.get("BENCH_RTOL", "1e-8")))
    return int(env.get("BENCH_N", "224")), precond, opts


def _child(role: str) -> dict:
    if role == "primary":
        from .bench_unstructured import bench_unstructured

        h, refine, rtol, opts = primary_args(os.environ)
        return bench_unstructured(h, refine, rtol=rtol, **opts)
    from .bench_structured import bench_structured

    return bench_structured(*secondary_args(os.environ))


def _run_child(role: str, timeout: float | None) -> tuple[dict | None, str | None]:
    """(the child's result, None) or (None, why it has none)."""
    log(f"[bench] {role} subprocess (timeout "
        f"{'none' if timeout is None else f'{timeout:.0f} s'})")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "arcanefem_tpu_torch.bench", "--child", role],
            stdout=subprocess.PIPE, text=True, timeout=timeout, cwd=_ROOT)
    except subprocess.TimeoutExpired:
        return None, f"{role}: timed out after {timeout:.0f} s"
    lines = [ln.strip() for ln in (proc.stdout or "").splitlines()]
    js = [ln for ln in lines if ln.startswith("{")]
    for ln in lines:
        if ln and not ln.startswith("{"):
            log(ln)
    if proc.returncode != 0 or not js:
        return None, f"{role}: exit code {proc.returncode}" + (
            "" if js else ", no JSON line")
    try:
        res = json.loads(js[-1])
    except json.JSONDecodeError as e:
        return None, f"{role}: unreadable JSON line ({e})"
    if res.get("value") is None:
        return None, f"{role}: no value"
    return res, None


def run_metrics(env) -> tuple[dict, list[str]]:
    """The PRIMARY and the SECONDARY, each in its child, as ``env``'s
    ``BENCH_UNSTR``, ``BENCH_BOX``, ``BENCH_BUDGET_S`` and
    ``BENCH_SECONDARY_S`` ask: ({role: result or None}, the failures)."""
    t0 = time.time()
    budget = float(env.get("BENCH_BUDGET_S", "1500"))

    def left() -> float:
        return budget - (time.time() - t0) if budget > 0 else float("inf")

    run_p = env.get("BENCH_UNSTR", "1") in ("1", "force")
    run_s = env.get("BENCH_BOX", "1") == "1"
    if not (run_p or run_s):
        return {}, ["BENCH_UNSTR and BENCH_BOX skip both metrics"]
    results, errors = {}, []
    if run_p:
        results["primary"], err = _run_child(
            "primary", None if budget <= 0 else max(left() - 60, 120) + 180)
        errors += [err] if err else []
    if run_s:
        reserve = float(env.get("BENCH_SECONDARY_S", "420"))
        if left() > reserve or results.get("primary") is None:
            results["secondary"], err = _run_child(
                "secondary",
                None if budget <= 0 else max(min(left() - 30, 900), 120) + 180)
            errors += [err] if err else []
        else:
            errors.append(f"secondary: skipped, {left():.0f} s of "
                          f"BENCH_BUDGET_S left < BENCH_SECONDARY_S {reserve:g}")
    return results, errors


def check_env(env) -> None:
    """Raise on a knob the port does not run, before anything runs."""
    check_knobs(env)
    primary_args(env)
    secondary_args(env)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--sweep"]:
        from .bench_sweep import main as sweep_main

        return sweep_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", choices=("primary", "secondary"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device is available; the bench measures an "
              "NVIDIA card", file=sys.stderr)
        return 1
    env = os.environ
    check_env(env)
    if args.child:
        print(json.dumps(_child(args.child)), flush=True)
        return 0

    results, errors = run_metrics(env)
    if not results:
        log(f"[bench] {errors[0]}")
        return 1
    out = final_json(results.get("primary"), results.get("secondary"))
    if errors:
        out["extra"]["error"] = "; ".join(errors)
    print(json.dumps(out), flush=True)
    return 1 if errors or out["value"] is None else 0


if __name__ == "__main__":
    sys.exit(main())
