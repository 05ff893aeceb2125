"""Assembly-strategy laboratory (the reference's `testlab` module).

The counterpart of ``arcanefem_tpu/testlab.py``.  The reference's testlab is
a Poisson clone with 11 switchable bilinear-assembly strategies
(modules/testlab/FemModule.cc:166-254), cache-warming timed runs,
cross-validation of every format against the legacy assembly, and a JSON
time-stats dump (FemModule.cc:19-56).  Every strategy below produces the
values of the same BELL matrix (SELL storage, ``sparse/bell.py``) over the
same topology, and they differ in how the sum of the element entries is
scheduled:

* ``bell-segsum``  — ``sparse/bell.py::assemble_bell``: each SELL slot sums
                     its entries (one ``slot_reduce``);
* ``bell-sorted``  — the same lists, built from one stable sort of every
                     bucket's slots (JAX: a sorted ``segment_sum``);
* ``bell-scatter`` — ``index_add_`` per bucket: the atomic analogue by
                     design, whose sum order on the card changes from run
                     to run; no other path of the port scatters with atomics;
* ``csr-segsum``   — one ``slot_reduce`` into the nnz CSR slots, then one
                     permutation copy into SELL (the CsrFormat +
                     translateToLinearSystem analogue);
* ``coo``, ``coo-sorted`` — ``sparse/coo.py::CooMatrix`` (+ ``sorted()``),
                     then ``to_bell``;
* ``dia-stencil``  — structured boxes only: K4 stiffness-only
                     (``mesh/stencil_assembly.py::assemble_stiffness_kernel``)
                     in :func:`run_lab`, the plain ``StructuredBox.
                     assemble_stiffness`` in :func:`cross_validate`, as the
                     JAX package splits ``backend="auto"`` and ``"xla"``.

The index work of each format (JAX: host steps traced once under
``jax.jit``) is a plan, built once per (topology, layout, format) on the
layout's device with torch (sorts, ``unique``, ``searchsorted``) and
cached on the topology; a format's call is then its value path.  The five
fixed-order formats sum each slot's entries in entry order in float64,
rounded once, so they are equal bit for bit with each other and from run
to run; ``bell-scatter`` differs by round-off.

Cross-validation mirrors testlab's CROSS_VALIDATION: every format must
agree with the first.  Entry points run on the card unless the caller
asks for the CPU (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .fem.problem import torch_dtype
from .fem.timer import PhaseTimer
from .mesh.core import Mesh, read_msh
from .mesh.generate import box_tetra_mesh, rect_tria_mesh
from .ops import elements
from .sparse.bell import BellMatrix, assemble_bell, fine_layout, sell_slots, slot_contributors
from .sparse.coo import CooMatrix
from .sparse.sell import SellLayout
from .sparse.slot_reduce import group_by_slot, slot_reduce
from .sparse.topology import Topology, build_topology

# --------------------------------------------------------------------------
# plans: the index work of each format, once per (topology, layout)
# --------------------------------------------------------------------------


def lab_layout(topo: Topology, device) -> SellLayout:
    """The SELL layout the lab assembles into on ``device``
    (``fine_layout``), built once per topology and device."""
    cache = topo.__dict__.setdefault("_testlab_layouts", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = fine_layout(topo, device)
    return cache[key]


def _diag(topo: Topology, layout: SellLayout) -> torch.Tensor:
    return torch.as_tensor(layout.ell_to_sell[np.asarray(topo.diag_slot, np.int64)],
                           device=layout.device)


def _plan_segsum(topo, layout):
    return slot_contributors(topo, list(topo.slot_maps), layout), _diag(topo, layout)


def _plan_sorted(topo, layout):
    # one stable sort of every bucket's slots (group_by_slot)
    return group_by_slot(sell_slots(topo, list(topo.slot_maps), layout),
                         layout.n_slots), _diag(topo, layout)


def _plan_scatter(topo, layout):
    return [sell_slots(topo, [name], layout) for name in topo.slot_maps], _diag(topo, layout)


def _plan_csr(topo, layout):
    dev = layout.device
    c2e = torch.as_tensor(np.asarray(topo.csr_to_ell, np.int64), device=dev)
    e2c = torch.full((topo.n_slots,), -1, dtype=torch.int32, device=dev)
    e2c[c2e] = torch.arange(topo.nnz, dtype=torch.int32, device=dev)
    parts = [e2c[torch.as_tensor(topo.slot_maps[name], device=dev).reshape(-1)]
             for name in topo.slot_maps]
    lists = group_by_slot(torch.cat(parts), topo.nnz)
    del parts, e2c
    e2s = torch.as_tensor(layout.ell_to_sell, device=dev)
    return lists, e2s[c2e], _diag(topo, layout)


def _coo_pattern(topo, layout):
    """The COO pattern (JAX ``assemble_coo``: rows and cols from the slot
    maps), its plans kept on it."""
    dev = layout.device
    ell_cols = torch.as_tensor(np.asarray(topo.ell_cols, np.int32), device=dev).reshape(-1)
    rows, cols = [], []
    for name in topo.slot_maps:
        slots = torch.as_tensor(topo.slot_maps[name], device=dev).reshape(-1)
        rows.append(torch.div(slots, topo.width, rounding_mode="floor"))
        cols.append(ell_cols[slots])
    return CooMatrix(torch.cat(rows), torch.cat(cols), None, topo.n_nodes)


def _plan_coo(topo, layout):
    pattern = _cached(topo, layout, _coo_pattern)
    pattern.bell_plan(topo, layout)
    return pattern


def _plan_coo_sorted(topo, layout):
    pattern = _cached(topo, layout, _coo_pattern)
    pattern.sorted_pattern().bell_plan(topo, layout)
    return pattern


_PLANS = {"bell-segsum": _plan_segsum, "bell-sorted": _plan_sorted,
          "bell-scatter": _plan_scatter, "csr-segsum": _plan_csr,
          "coo": _plan_coo, "coo-sorted": _plan_coo_sorted}


def _cached(topo, layout, build):
    cache = topo.__dict__.setdefault("_testlab_plans", {})
    key = (build.__name__, id(layout))
    hit = cache.get(key)
    if hit is None or hit[0] is not layout:  # the layout is kept: its id stays its own
        hit = cache[key] = (layout, build(topo, layout))
    return hit[1]


def plan(topo: Topology, layout: SellLayout, name: str):
    """The index plan of format ``name`` for ``topo`` and ``layout``, built
    on the layout's device at the first call and cached on the topology
    (the two COO formats share their pattern, and each adds its own
    sort and search to it)."""
    return _cached(topo, layout, _PLANS[name])


def _table(topo: Topology, mats: dict) -> torch.Tensor:
    parts = [mats[name].reshape(-1) for name in topo.slot_maps]
    return (parts[0] if len(parts) == 1 else torch.cat(parts)).contiguous()


def _layout_of(topo, mats, layout):
    return layout if layout is not None else lab_layout(
        topo, next(iter(mats.values())).device)


# --------------------------------------------------------------------------
# assembly strategies: fn(topo, mats, dtype, layout=None) -> BellMatrix
# --------------------------------------------------------------------------


def assemble_bell_segsum(topo, mats, dtype, layout=None) -> BellMatrix:
    layout = _layout_of(topo, mats, layout)
    lists, diag = plan(topo, layout, "bell-segsum")
    ordered = {name: mats[name] for name in topo.slot_maps}
    return assemble_bell(topo, ordered, device=layout.device, dtype=torch_dtype(dtype),
                         layout=layout, contributors=lists, diag_slot=diag)


def assemble_bell_sorted(topo, mats, dtype, layout=None) -> BellMatrix:
    """Pre-sorted entries: the sort is static (once per topology)."""
    layout = _layout_of(topo, mats, layout)
    (ptr, ids), diag = plan(topo, layout, "bell-sorted")
    vals = slot_reduce(ptr, ids, _table(topo, mats)).to(torch_dtype(dtype))
    return BellMatrix(vals, layout, diag)


def assemble_bell_scatter(topo, mats, dtype, layout=None) -> BellMatrix:
    layout = _layout_of(topo, mats, layout)
    slots, diag = plan(topo, layout, "bell-scatter")
    dtype = torch_dtype(dtype)
    vals = torch.zeros(layout.n_slots, dtype=dtype, device=layout.device)
    for name, s in zip(topo.slot_maps, slots):
        vals.index_add_(0, s, mats[name].reshape(-1).to(dtype))
    return BellMatrix(vals, layout, diag)


def assemble_csr_segsum(topo, mats, dtype, layout=None) -> BellMatrix:
    """Assemble CSR values, then expand into the SELL layout (the
    CsrFormatMatrix::translateToLinearSystem role)."""
    layout = _layout_of(topo, mats, layout)
    (ptr, ids), csr_to_sell, diag = plan(topo, layout, "csr-segsum")
    dtype = torch_dtype(dtype)
    vals = torch.zeros(layout.n_slots, dtype=dtype, device=layout.device)
    vals[csr_to_sell] = slot_reduce(ptr, ids, _table(topo, mats)).to(dtype)
    return BellMatrix(vals, layout, diag)


def assemble_coo(topo, mats, dtype, layout=None, sort=False) -> BellMatrix:
    """Standalone COO triplets (duplicates kept), then translate — the
    CooBiliAssembly / CooSortBiliAssembly strategies (sort=True)."""
    layout = _layout_of(topo, mats, layout)
    coo = plan(topo, layout, "coo").with_values(_table(topo, mats).to(torch_dtype(dtype)))
    if sort:
        coo = coo.sorted()
    return coo.to_bell(topo, layout)


FORMATS = {
    "bell-segsum": assemble_bell_segsum,
    "bell-sorted": assemble_bell_sorted,
    "bell-scatter": assemble_bell_scatter,
    "csr-segsum": assemble_csr_segsum,
    "coo": assemble_coo,
    "coo-sorted": lambda topo, mats, dtype, layout=None: assemble_coo(
        topo, mats, dtype, layout, sort=True),
}

# ``dia-stencil`` (the build-less-CSR analogue: sparsity derived from mesh
# structure, zero search/sort) only exists for generated structured boxes —
# it assembles a DiaMatrix (mesh/structured.py, mesh/stencil_assembly.py)
# rather than BELL values over a Topology, so it is dispatched separately
# in run_lab/cross_validate and validated by SpMV equivalence instead of a
# value-array diff.
STRUCTURED_FORMATS = ("dia-stencil",)


# --------------------------------------------------------------------------
# the lab
# --------------------------------------------------------------------------


def _mats(coords: torch.Tensor, conns: dict) -> dict:
    return {ct: elements.stiffness(ct, coords[conn]) for ct, conn in conns.items()}


def _device_arrays(mesh: Mesh, dtype, device):
    coords = torch.as_tensor(mesh.coords, device=device).to(torch_dtype(dtype))
    conns = {ct: torch.as_tensor(c, device=device).long() for ct, c in mesh.cells.items()}
    return coords, conns


def element_matrices(mesh: Mesh, dtype, device="cuda") -> dict:
    """Cell type -> (nc, npc, npc) stiffness matrices on ``device``."""
    return _mats(*_device_arrays(mesh, dtype, device))


def cross_validate(mesh: Mesh, dtype=torch.float64, rtol=1e-12, box=None,
                   device="cuda") -> dict:
    """Every strategy against the first one (testlab CROSS_VALIDATION).

    With a StructuredBox, additionally validates the dia-stencil assembly
    by SpMV equivalence (its DIA layout has no BELL value array to diff)."""
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    mats = element_matrices(mesh, dtype, device)
    ref = refA = None
    report = {}
    for name, fn in FORMATS.items():
        A = fn(topo, mats, dtype)
        v = A.values
        if ref is None:
            ref, refA = v, A
            report[name] = 0.0
        else:
            report[name] = float((v - ref).abs().max() / ref.abs().max())
            assert report[name] < rtol, (name, report[name])
    if box is not None:
        c3d = torch.as_tensor(mesh.coords, device=device).to(torch_dtype(dtype))
        Ad = box.assemble_stiffness(c3d.reshape(box.shape + (3,)))
        np_dtype = np.float64 if torch_dtype(dtype) == torch.float64 else np.float32
        x = torch.as_tensor(np.random.RandomState(0).rand(mesh.n_nodes).astype(np_dtype),
                            device=device)
        yd, yb = Ad.spmv(x), refA.spmv(x)
        err = float((yd - yb).abs().max() / yb.abs().max())
        report["dia-stencil"] = err
        assert err < rtol, ("dia-stencil", err)
    return report


def box_sparsity(box) -> tuple[int, int]:
    """(nnz, ELL width padded to 8) of a structured box's node graph, as
    ``build_topology(..., pad_width_to=8)`` gives them: offset d couples
    every node pair of the grid that it joins."""
    from .sparse.dia_stencil import offsets3d

    shape = np.array(box.shape)
    nnz = sum(int(np.prod(np.maximum(shape - np.abs(d), 0))) for d in offsets3d(box))
    return nnz, -(-len(box.offsets) // 8) * 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best(fn, reps: int, device: torch.device) -> float:
    """The fastest of ``reps`` synchronised runs of ``fn``, after one."""
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times)


def run_lab(
    mesh: Mesh,
    formats=None,
    cache_warming: int = 5,
    dtype=torch.float32,
    json_path: str | None = None,
    box=None,
    *,
    device="cuda",
    topo: Topology | None = None,
) -> dict:
    """Timed assembly runs per format (run-benchmark.sh semantics:
    CACHE_WARMING repeats, per-phase stats, JSON dump).  ``box`` (a
    StructuredBox matching the mesh) enables the dia-stencil strategy.

    Each format's index plan is built once, timed as the ``plan:<format>``
    phase of ``time_stats``; a timed run is the element matrices and the
    format's value path, synchronised, and each format's figure the best
    of ``cache_warming`` runs after one untimed run.  ``topo``, the mesh's
    topology, saves building it (``build-topology``); a run of structured
    formats alone builds none and takes nnz and width from the box."""
    timer = PhaseTimer(verbose=False)
    device = torch.device(device)
    names = list(formats) if formats else (
        list(FORMATS) + (list(STRUCTURED_FORMATS) if box is not None else []))
    for name in names:
        if name not in FORMATS and name not in STRUCTURED_FORMATS:
            raise ValueError(f"unknown format {name!r}")
        if name in STRUCTURED_FORMATS and box is None:
            raise ValueError(f"'{name}' needs a structured mesh (run with --box)")
    if topo is None and any(n in FORMATS for n in names):
        with timer.phase("build-topology"):
            topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    nnz, width = (topo.nnz, topo.width) if topo is not None else box_sparsity(box)
    coords, conns = _device_arrays(mesh, dtype, device)

    stats = {
        "nbNode": mesh.n_nodes,
        "nbElement": mesh.n_cells,
        "nnz": nnz,
        "ell_width": width,
        "cache_warming": cache_warming,
        # the JAX output's list, kept as it is: the reference lab's 11
        # strategies (testlab/FemModule.cc:166-254) less the 4 GPU-atomic
        # and DOK variants the JAX lab has no strategy for; the port adds
        # none (bell-scatter is its one atomic strategy)
        "strategies_not_applicable_on_tpu": [
            "legacy-dok", "coo-gpu-atomic", "coo-sort-gpu-atomic",
            "csr-gpu-atomic",
        ],
        "formats": {},
    }
    for name in names:
        if name in STRUCTURED_FORMATS:
            from .mesh.stencil_assembly import assemble_stiffness_kernel

            c3d = coords.reshape(box.shape + (3,))

            def assemble():
                return assemble_stiffness_kernel(box, c3d).bands
        else:
            layout = lab_layout(topo, device)
            with timer.phase(f"plan:{name}"):
                plan(topo, layout, name)
            fn = FORMATS[name]

            def assemble():
                return fn(topo, _mats(coords, conns), dtype, layout).values
        best = _best(assemble, cache_warming, device)
        stats["formats"][name] = {
            "lhs-matrix-assembly": best,
            "mdof_per_s": mesh.n_nodes / best / 1e6,
        }

    stats["time_stats"] = timer.stats
    if json_path:
        with open(json_path, "w") as f:
            json.dump(stats, f, indent=2)
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="arcanefem_tpu_torch testlab",
                                description="assembly-format laboratory")
    p.add_argument("--mesh", help=".msh file (default: generated box)")
    p.add_argument("--box", type=int, default=0, help="generated box n^3")
    p.add_argument("--rect", type=int, default=0, help="generated rect n^2")
    p.add_argument("--formats", default="",
                   help="comma list (default: all applicable, incl. "
                        "dia-stencil on generated boxes)")
    p.add_argument("--cache-warming", type=int, default=5)
    p.add_argument("--json", dest="json_path")
    p.add_argument("--cross-validate", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="float64 lab runs (the device stays --device's)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default: cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("arcanefem_tpu_torch testlab: no CUDA device is available; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 1

    box = None
    if args.mesh:
        mesh = read_msh(args.mesh)
    elif args.rect:
        mesh = rect_tria_mesh(args.rect, args.rect)
    else:
        from .mesh.structured import StructuredBox

        n = args.box or 20
        box = StructuredBox(n, n, n)
        mesh = box_tetra_mesh(n, n, n)

    if args.cross_validate:
        report = cross_validate(mesh, box=box, device=device)
        print(json.dumps({"cross_validation_max_rel": report}))
        return 0

    fmts = args.formats.split(",") if args.formats else None
    stats = run_lab(
        mesh,
        formats=fmts,
        cache_warming=args.cache_warming,
        dtype=torch.float64 if args.f64 else torch.float32,
        json_path=args.json_path,
        box=box,
        device=device,
    )
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
