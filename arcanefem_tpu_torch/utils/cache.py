"""Set-up artifact cache directory.

The port's copy of ``arcanefem_tpu/utils/cache.py::CACHE_DIR``, resolved
the same way, so the port and ``bench.py`` share their mesh and topology
npz caches: ``$AFEM_CACHE_DIR`` if set, else ``.cache/afem_meshes`` at the
repository root when the tree is writable, else ``~/.cache/afem``.
Nothing is created at import time.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _default_cache_dir() -> str:
    d = os.path.join(_REPO_ROOT, ".cache", "afem_meshes")
    if os.path.isdir(d) or os.access(_REPO_ROOT, os.W_OK):
        return d
    return os.path.join(os.path.expanduser("~"), ".cache", "afem")


CACHE_DIR = os.environ.get("AFEM_CACHE_DIR", _default_cache_dir())
