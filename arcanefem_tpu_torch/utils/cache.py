"""Set-up artifact cache: its directory and checked npz files.

``CACHE_DIR`` is the port's copy of ``arcanefem_tpu/utils/cache.py::
CACHE_DIR``, resolved the same way, so the port and ``bench.py`` share
their mesh and topology npz caches: ``$AFEM_CACHE_DIR`` if set, else
``.cache/afem_meshes`` at the repository root when the tree is writable,
else ``~/.cache/afem``.  Nothing is created at import time.

:func:`save_npz` and :func:`load_npz` keep host set-up products (the AMG
hierarchy, SELL layouts) as plain ``.npz`` files, the port's form of
``bench.py::_pickle_cache``: no pickle, written to a temporary name and
renamed into place, and stored with a JSON ``meta`` record (the key and
digests of the inputs) that a load must match exactly.  A file that is
missing, unreadable, truncated or built from other inputs is a miss: the
caller rebuilds and rewrites it, and one line on stderr says why.
``BENCH_NO_CACHE=1`` turns these caches off, as it turns off
``bench.py``'s pickles.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import zipfile

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_META = "__meta__"


def _default_cache_dir() -> str:
    d = os.path.join(_REPO_ROOT, ".cache", "afem_meshes")
    if os.path.isdir(d) or os.access(_REPO_ROOT, os.W_OK):
        return d
    return os.path.join(os.path.expanduser("~"), ".cache", "afem")


def cache_dir(env=os.environ) -> str:
    """The cache directory under the environment ``env``."""
    return env.get("AFEM_CACHE_DIR", _default_cache_dir())


CACHE_DIR = cache_dir()


def cache_enabled(env=os.environ) -> bool:
    """False when ``BENCH_NO_CACHE=1`` in ``env``."""
    return env.get("BENCH_NO_CACHE") != "1"


def log(msg: str) -> None:
    print(f"[cache] {msg}", file=sys.stderr, flush=True)


def digest(*arrays: np.ndarray) -> str:
    """SHA-256 of the arrays' dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def _canonical(meta: dict) -> str:
    return json.dumps(meta, sort_keys=True)


def save_npz(path: str, arrays: dict[str, np.ndarray], meta: dict) -> None:
    """Write ``arrays`` and ``meta`` (JSON-serialisable) to ``path``
    through a temporary file and ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays, **{_META: np.array(_canonical(meta))})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def read_meta(path: str) -> dict:
    """The meta record of a :func:`save_npz` file, read without its arrays;
    raises ``OSError``, ``ValueError``, ``KeyError`` or
    ``zipfile.BadZipFile`` where there is none to read."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z[_META]))


def load_npz(path: str, meta: dict, what: str) -> dict[str, np.ndarray] | None:
    """The arrays of ``path`` when its stored meta equals ``meta``; else
    None, after one stderr line that names ``what`` and the reason."""
    if not os.path.exists(path):
        log(f"{what}: no cache file {path}; building")
        return None
    meta = json.loads(_canonical(meta))
    try:
        with np.load(path, allow_pickle=False) as z:
            stored = json.loads(str(z[_META]))
            if _canonical(stored) != _canonical(meta):
                diff = sorted(k for k in set(stored) | set(meta)
                              if stored.get(k) != meta.get(k))
                log(f"{what}: {path} was built from other inputs "
                    f"({', '.join(diff)} differ); rebuilding")
                return None
            return {k: z[k] for k in z.files if k != _META}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
        log(f"{what}: {path} is unreadable ({e!r}); rebuilding")
        return None
