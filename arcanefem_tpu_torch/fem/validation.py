"""Golden-file result validation.

The port's copy of ``arcanefem_tpu/fem/validation.py``.  Mirrors
checkNodeResultFile (reference femutils/FemUtils.cc:104-236,
FemUtils.h:484-527): files of ``uid v [v2 v3]`` lines keyed by 1-based
node unique ids; comparison is relative with a min-value floor:
values are "different" if both exceed min_value in magnitude and
|ref - v| > epsilon * max(|ref|, |v|).
"""

from __future__ import annotations

import numpy as np


def read_node_result_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (uids (n,), values (n, k)) for k = 1, 2 or 3."""
    data = np.loadtxt(path, ndmin=2)
    uids = data[:, 0].astype(np.int64)
    return uids, data[:, 1:]


def check_node_results(
    node_uids: np.ndarray,
    values: np.ndarray,
    filename: str,
    epsilon: float,
    min_value: float = 0.0,
    min_value_rel: float = 0.0,
) -> int:
    """Compare per-node values against a golden file.

    values: (n_nodes, k). Returns the number of mismatching nodes and raises
    AssertionError if any (the ARCANE_FATAL behaviour).
    Nodes missing from the file are skipped, as in the reference.

    min_value_rel: noise floor as a fraction of the golden field's max
    magnitude. The reference's absolute min_value (FemUtils.cc:85-90)
    assumes golden and test were produced by the *same* solver with the
    same roundoff/convergence trace; cross-solver, components this far
    below the field scale are unconverged-solver noise (verified against
    dense LU solutions), not physics.
    """
    ref_uids, ref_vals = read_node_result_file(filename)
    if min_value_rel > 0.0 and ref_vals.size:
        min_value = max(min_value, min_value_rel * np.abs(ref_vals).max())
    if values.ndim == 1:
        values = values[:, None]
    k = min(values.shape[1], ref_vals.shape[1])

    pos = {int(u): i for i, u in enumerate(ref_uids)}
    idx = np.array([pos.get(int(u), -1) for u in node_uids])
    have = idx >= 0
    cur = np.asarray(values)[have, :k].astype(np.float64)
    ref = ref_vals[idx[have], :k]

    below_floor = (np.abs(ref) < min_value) & (np.abs(cur) < min_value)
    denom = np.maximum(np.abs(ref), np.abs(cur))
    rel = np.where(denom > 0, np.abs(ref - cur) / np.where(denom == 0, 1.0, denom), 0.0)
    bad = (~below_floor) & (rel > epsilon)
    nodes_bad = bad.any(axis=1)
    nb_error = int(nodes_bad.sum())
    if nb_error:
        uids_arr = np.asarray(node_uids)[have][nodes_bad][:10]
        worst = rel[nodes_bad].max()
        raise AssertionError(
            f"golden-file check failed: {nb_error} nodes differ "
            f"(eps={epsilon}, worst rel err={worst:.3e}, first uids={uids_arr.tolist()})"
        )
    return nb_error
