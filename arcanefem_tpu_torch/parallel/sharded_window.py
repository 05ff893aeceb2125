"""The sharded AMG-PCG step under the name of the JAX window-kernel step.

The counterpart of ``arcanefem_tpu/parallel/sharded_window.py``.  There,
the fast fine SpMV under ``shard_map`` is the Mosaic window sweep, which
needs a per-shard window plan with one static key for every shard
(``ShardedWindowPlan``, ``build_sharded_window_plan`` and the virtual
concatenation of the shards' column spaces).  That plan is TPU machinery:
on the card the fast per-shard SpMV is K1 (``sell_spmv``) on each shard's
own SELL layout, which ``sharded_amg.make_poisson_amg_step`` already runs,
so the plan is not ported and :func:`make_window_amg_step` is that step.
"""

from __future__ import annotations

from .comm import Comm
from .partition import ShardedProblem
from .sharded_amg import ShardedAMG, make_poisson_amg_step


def make_window_amg_step(sp: ShardedProblem, comm: Comm, samg: ShardedAMG,
                         rtol: float = 1.0e-7, atol: float = 0.0,
                         max_iter: int = 200):
    """Sharded AMG-PCG with K1 as the fine SpMV:
    ``sharded_amg.make_poisson_amg_step`` (the JAX step's window plan
    argument has no counterpart)."""
    return make_poisson_amg_step(sp, comm, samg, rtol=rtol, atol=atol,
                                 max_iter=max_iter)
