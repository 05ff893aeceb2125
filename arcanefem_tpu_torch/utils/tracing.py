"""The port's spans and counters.

Spans name the layers of a solve on the profiler's timeline and add up
their host time; counters count the port's kernel launches and
collectives.  Both live here and nowhere else.

**Profiling a solve.**  Run it under ``torch.profiler``, then read the
spans' totals or the chrome trace::

    from torch.profiler import ProfilerActivity, profile
    from arcanefem_tpu_torch.utils import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x, k, rel = pcg(A, b, M, x0, 1e-8, 0.0, 1000, use_precise_dot=True)
    for name, r in sorted(tracing.report().items()):
        print(name, r["calls"], r["incl_s"], r["self_s"], r["parent"], r["counts"])
    prof.export_chrome_trace("solve.json")

``report()`` maps each span name to its ``calls``, ``incl_s`` (host
seconds from entry to exit), ``self_s`` (``incl_s`` less the spans opened
inside it), ``parent`` (the span it was opened in first, or None) and
``counts`` (the counters charged while it was the innermost open span).
``reset()`` empties it.  The spans, outermost first:

- ``asm``: ``TetraAssembler.__call__``, one lhs assembly on the sphere;
  ``mg.assemble`` and ``mg.build``: the box's fused assembly and its
  multigrid hierarchy in ``bench_structured.solve_mg``;
- ``cg``: one ``pcg_chunked`` call, inside it ``cg.spmv`` (every product
  with A), ``cg.dot`` (every dot product), ``cg.update`` (the vector
  updates of x, r and p), ``cg.replace`` (residual replacement),
  ``cg.test`` (each host read of the device: the stopping test, the last
  one with the returned ``rel``) and ``vcycle`` (the preconditioner's
  apply);
- inside ``vcycle``, on the AMG and the MG route alike,
  ``vcycle.l{l}.smooth`` (pre- and post-smoothing of level l),
  ``vcycle.l{l}.residual``, ``vcycle.l{l}.restrict`` and
  ``vcycle.l{l}.prolong`` (each with its mask multiply and its add), and
  ``vcycle.coarse`` (the dense inverse, or the MG's coarse sweeps);
- inside those, on the MG route, ``vcycle.sweep`` (each Jacobi sweep of a
  smoothing from x = 0 after its first: the coarse solve's) and
  ``vcycle.restrict.axis`` and ``vcycle.prolong.axis`` (the transfer along
  one axis), so that no span holds more than a few dozen host operations
  of its own.

While no profiler records, :func:`span` hands back one shared object that
does nothing, and nothing is added to the report.  The instrumented entry
points read :func:`active` once and pass it down, so a span that does not
record costs one call.  While a profiler records, a span opens a
function-scope record on the profiler's host timeline (no device
annotation: the device timeline shows kernels only), takes the host clock
at entry and exit, and adds to the report.

**Counters** are always on.  ``count(name)`` adds to a counter, and while
a span records also to that span's ``counts``.  Each module registers its
names with :func:`counters` and reads them back with :func:`counts`
(``sell.launch_counts()`` and the like are such views).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

# True while a torch.profiler records (any activity)
active = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns

# -- counters -----------------------------------------------------------------

_COUNTS: dict[str, int] = {}


def counters(*names: str) -> tuple[str, ...]:
    """Register the counters ``names`` (at 0 if new) and return them."""
    for n in names:
        _COUNTS.setdefault(n, 0)
    return names


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost recording
    span's counts."""
    _COUNTS[name] += n
    if _STACK:
        c = _STACK[-1].agg.counts
        c[name] = c.get(name, 0) + n


def counts(names) -> dict[str, int]:
    """The counters ``names``, in that order."""
    return {n: _COUNTS[n] for n in names}


def reset_counts(names) -> None:
    for n in names:
        _COUNTS[n] = 0


def restore_counts(saved: dict[str, int]) -> None:
    """Set counters back to values :func:`counts` read earlier."""
    for n, v in saved.items():
        _COUNTS[n] = v


# -- spans --------------------------------------------------------------------

CG, CG_SPMV, CG_DOT, CG_UPDATE = "cg", "cg.spmv", "cg.dot", "cg.update"
CG_TEST, CG_REPLACE = "cg.test", "cg.replace"
VCYCLE, VCYCLE_COARSE, VCYCLE_SWEEP = "vcycle", "vcycle.coarse", "vcycle.sweep"
RESTRICT_AXIS, PROLONG_AXIS = "vcycle.restrict.axis", "vcycle.prolong.axis"
ASM, MG_ASSEMBLE, MG_BUILD = "asm", "mg.assemble", "mg.build"


class LevelSpans(NamedTuple):
    """The span names of one V-cycle level."""

    smooth: str
    residual: str
    restrict: str
    prolong: str


_LEVELS: list[LevelSpans] = []


def level(l: int) -> LevelSpans:
    """The span names of V-cycle level ``l``, made once per level."""
    while len(_LEVELS) <= l:
        k = len(_LEVELS)
        _LEVELS.append(LevelSpans(*(f"vcycle.l{k}.{p}" for p in LevelSpans._fields)))
    return _LEVELS[l]


class _Agg:
    __slots__ = ("calls", "incl_ns", "self_ns", "parent", "counts")

    def __init__(self, parent: str | None):
        self.calls = self.incl_ns = self.self_ns = 0
        self.parent = parent
        self.counts: dict[str, int] = {}


_AGG: dict[str, _Agg] = {}
_STACK: list["_Span"] = []


class _Span:
    __slots__ = ("name", "agg", "rec", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        agg = _AGG.get(self.name)
        if agg is None:
            agg = _AGG[self.name] = _Agg(_STACK[-1].name if _STACK else None)
        self.agg = agg
        self.rec = _RecordFunctionFast(self.name)
        self.rec.__enter__()
        self.child_ns = 0
        _STACK.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self.t0
        _STACK.pop()
        agg = self.agg
        agg.calls += 1
        agg.incl_ns += dt
        agg.self_ns += dt - self.child_ns
        if _STACK:
            _STACK[-1].child_ns += dt
        self.rec.__exit__(None, None, None)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, on: bool | None = None):
    """A context manager that records the span ``name`` when ``on`` (by
    default :func:`active`), else one shared object that does nothing."""
    if on is None:
        on = active()
    return _Span(name) if on else _NO_SPAN


def report() -> dict[str, dict]:
    """{name: {calls, incl_s, self_s, parent, counts}} of the spans
    recorded since :func:`reset`."""
    return {n: {"calls": a.calls, "incl_s": a.incl_ns / 1e9, "self_s": a.self_ns / 1e9,
                "parent": a.parent, "counts": dict(a.counts)}
            for n, a in _AGG.items()}


def reset() -> None:
    """Empty the report (the counters keep their values)."""
    _AGG.clear()
