"""Checkpoint/resume of transient state.

The port's copy of ``arcanefem_tpu/fem/checkpoint.py`` in its npz form
only (the JAX module writes through orbax where it imports, else this
form): ``<path>.npz`` holds ``__meta__``, a JSON string with ``t``,
``step`` and ``keys`` (the sorted state names), beside one array per
state name.  A file written here is read by the JAX ``restore``, and an
npz the JAX package wrote by :func:`restore`, so a transient run can stop
in one package and resume in the other.  Tensors are saved from the host,
in their own dtype.

    save(path, t, step, {"T": T})
    t, step, state = restore(path)
"""

from __future__ import annotations

import json

import numpy as np


def _host(v) -> np.ndarray:
    """A host numpy array of ``v`` (a numpy array, a tensor on any device,
    or a scalar)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def save(path: str, t: float, step: int, state: dict) -> None:
    """state: name -> array or tensor.  Writes ``<path>.npz``."""
    arrays = {k: _host(v) for k, v in state.items()}
    meta = {"t": float(t), "step": int(step), "keys": sorted(arrays)}
    np.savez(path + ".npz", __meta__=json.dumps(meta), **arrays)


def restore(path: str) -> tuple[float, int, dict]:
    """(t, step, the state as a dict of host numpy arrays) of
    ``<path>.npz``."""
    with np.load(path + ".npz", allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        state = {k: z[k] for k in meta["keys"]}
    return float(meta["t"]), int(meta["step"]), state
