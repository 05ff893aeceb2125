"""Fail when a cache that the port's bench reads is missing.

    python -m arcanefem_tpu_torch.tools.verify_caches

The counterpart of ``tools/verify_caches.py``.  A cache-key bump that lands
without its regenerated cache makes the next bench run pay the whole host
set-up inside its time budget: at 8.9M DoF that is minutes of priming (the
mesh, its orders and topologies) and of AMG set-up.  Run this gate after a
change to a cache key, to the bench's knobs or to the files' writers, and
before a bench run that must find its caches.

It lists the files of :func:`arcanefem_tpu_torch.bench.default_cache_paths`
under the bench's knobs in the environment (``BENCH_UNSTR_H``,
``BENCH_UNSTR_REFINE``, ``BENCH_UNSTR_ORDER``, ``BENCH_AMG_SMOOTHER``,
``BENCH_AMG_CHEB_DEG``, ``BENCH_AMG_THETA``, ``BENCH_NO_CACHE``,
``AFEM_NATIVE_AMG``, ``AFEM_CACHE_DIR``, ...): the mesh and topology npz
files of the node order the bench runs in, the fine SELL layout
``sell_<key>_v1.npz`` and the AMG hierarchy ``amg_<key>_..._v1.npz``, each
named by the function that writes it.  For each it prints ``ok``,
``MISSING`` or ``STALE``, its size and its path.  A SELL or AMG file is
``STALE`` when its meta record (read alone, without the arrays) differs
from the key fields of this environment (``what``, ``mesh``, ``smoother``,
``cheb_deg``, ``theta``, ``platform``, ``penalty``, ``dtype``) or cannot be
read.  The digests of the operator's columns and values are not checked:
they need the assembled operator, and the bench checks them when it loads
the file.  It runs on the host and needs no card.

Exit 0: every file is present and its key fields match.  Exit 1: a file is
missing or stale (the bench would rebuild it), or a knob is one the port
does not run.  Warnings, which leave the exit code as it is: orphaned
``*.tmp<pid>`` files of an interrupted write, files of other key versions
beside a listed one, a kernel library for the current ``csrc/`` sources
and flags absent from ``build/afem_kernels/`` (the first run pays
``nvcc``), and a native set-up library absent from ``build/afem_native/``.
"""

from __future__ import annotations

import glob
import os
import re
import sys
import zipfile


def check(env=os.environ, device: str = "cuda") -> tuple[list[str], list[str], int]:
    """(report lines, warnings, the number of missing or stale files) of the
    caches the bench reads under ``env`` on ``device``."""
    from ..bench import check_knobs, default_cache_paths
    from ..utils import kernels, native
    from ..utils.cache import cache_dir, cache_enabled, read_meta

    check_knobs(env)
    paths = default_cache_paths(env, device)
    lines, warns, bad = [], [], 0
    for role, (path, key) in paths.items():
        status, why = "ok", ""
        if not os.path.exists(path):
            status = "MISSING"
        elif key is not None:
            try:
                meta = read_meta(path)
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
                status, why = "STALE", f" (meta record unreadable: {e!r})"
            else:
                diff = sorted(k for k in set(key) | {"amg_setup"}
                              if meta.get(k) != key.get(k))
                if diff:
                    status, why = "STALE", f" ({', '.join(diff)} differ)"
        size = (f"{os.path.getsize(path) / 1e9:7.3f} GB" if status != "MISSING"
                else " " * 10)
        lines.append(f"  {status:<7} {role:<9} {size}  {path}{why}")
        bad += status != "ok"
        stem = re.match(r"(.*)_v\d+\.npz$", os.path.basename(path))
        if stem:
            for other in sorted(glob.glob(os.path.join(
                    os.path.dirname(path), glob.escape(stem.group(1)) + "_v*.npz"))):
                if other != path:
                    warns.append(f"{other}: another key version of the {role} cache; "
                                 "the bench never reads it")
    d = cache_dir(env)
    for tmp in sorted(glob.glob(os.path.join(glob.escape(d), "*.tmp[0-9]*"))):
        warns.append(f"{tmp}: an interrupted cache write; delete it")
    if not os.path.exists(kernels.library_path()):
        warns.append(f"{kernels.library_path()}: no kernel library for the current "
                     "csrc/ sources and flags; the first run pays nvcc")
    if not os.path.exists(native.library_path()):
        warns.append(f"{native.library_path()}: no native set-up library; the "
                     "first run builds it")
    if not paths:
        lines.append("  BENCH_UNSTR=0: the bench runs no PRIMARY and reads no cache")
    elif not cache_enabled(env):
        lines.append("  BENCH_NO_CACHE=1: the bench reads no SELL layout or AMG "
                     "hierarchy cache; only its mesh and topology files are listed")
    return lines, warns, bad


def main(env=os.environ, device: str = "cuda") -> int:
    """Print the report of :func:`check` and return the exit code; the
    command line checks the bench's own platform, the card."""
    try:
        lines, warns, bad = check(env, device)
    except ValueError as e:
        print(f"FAIL: {e}")
        return 1
    for ln in lines:
        print(ln)
    for w in warns:
        print(f"  warn: {w}")
    print("  (meta records checked for their key fields; the digests of the "
          "operator are checked by the bench when it loads a file)")
    if bad:
        print(f"\nFAIL: {bad} cache file(s) missing or stale: the bench would rebuild "
              "them inside its budget.  Prime them (python -m "
              "arcanefem_tpu_torch.bench_unstructured --h H --refine R --prime, then "
              "one bench run) or revert the key change.")
        return 1
    print("\nall caches the bench reads are present")
    return 0


if __name__ == "__main__":
    sys.exit(main())
