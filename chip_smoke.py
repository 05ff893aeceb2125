#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (arcanefem_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failed check raises, and the
script then exits non-zero without the final line:

1. device: the card's name and power limit; TF32 off;
2. build: compile csrc/*.cu with nvcc, while the 1.9M sphere's host
   set-up (mesh, orders, topologies into the npz caches; phase 4 loads
   them) runs in a subprocess beside phases 2 and 3
   (``bench_unstructured --prime``, its stages printed as ``[prime]``);
3. kernel parity: each ELL kernel against its plain twin on random inputs
   (n = 1M, W in 1, 8, 25, 136, with padding), f32 and f64: K1 (in its
   SELL-32-σ layout, also held to the (n, W) definition) and K2, the
   batched K3b (on the same SELL layout) and K3a for B in 1, 3, 8 tables,
   contiguous and channel-minor (strided) tables and results, and K1 with
   bf16 weights;
   then, once the prime has ended and the host is idle, the host cost of
   one launch of every wrapper beside a PyTorch op of the same size
   (``[launch]`` lines, tools/launch_cost.py);
4. main path at 1.9M DoF (sphere_cut h=5, refine=2): assembly (the
   element kernel tet_element and the slot-sorted reduction slot_reduce;
   K2 must not run), AMG set-up and AMG-PCG to rtol 1e-8 through the
   kernels, with the launch counts of that run and the SELL layout of
   every operator K1 ran on (``[sell]`` lines); then each kernel timed
   against its plain twin at the shapes of the path (tet_element in both
   input modes, slot_reduce beside one index_add_ of all its entries), K1
   at both σ, and a torch.profiler breakdown of one solve; then
   ``[cache]``: the same system through the AMG hierarchy's npz cache in
   a fresh directory, cold (phase 4's solve: set-up, saved) and warm
   (loaded, no SELL layout build): every array equal bit for bit, the same
   iterations and x, bit for bit, with both ``amg_setup_s``; then
   ``[caches]``: the cache gate (``tools/verify_caches.py``) with phase 4's
   knobs on that directory (the mesh and topology files linked in) exits
   0, and on an empty one exits 1 with all four files MISSING;
``[testlab]`` (run right after 4, on its mesh, topology and operator): the
   assembly-format laboratory.  L1: ``testlab.run_lab`` on the 1.9M sphere
   in float32, each of the six formats in its own call (cache_warming 5):
   ``lhs-matrix-assembly``, MDoF/s, the plan's build seconds, the kernel
   launches of one value-path call by kind (``slot_reduce``, PyTorch's
   ``index_add`` and elementwise kernels, from torch.profiler) and peak
   memory; the five fixed-order formats bit-equal with each other and
   from run to run, bell-scatter (atomics) within ``LAB_SCATTER_RTOL`` of
   their largest value.  L2: dia-stencil (K4 stiffness-only) through
   ``run_lab`` at 225^3 nodes, held to the plain bands by SpMV.  L3: a
   Testlab case per ``_FLAG_TO_FORMAT`` flag on a 49x49-node rect and a
   13^3-node tetra box (``build/testlab_cases/``), on the CPU (float64, the
   golden file), in process on the card and, one mesh per flag, through
   the CLI: the card's u within 1e-9 of the CPU's, every flag within 1e-9
   of the Poisson codename's u, iterations ± 1; ``testlab --box 16
   --json`` through the CLI on the card.  L4: ``TetraAssembler`` with
   ``reduce`` window, segsum and reorder on the sphere, within 1 float32
   ulp per slot of the window route.  L5: ``BlockedGather`` (b = 2: the
   sliced BSR-2 kernel, its σ, slots per block and layout build seconds,
   and the parent's time beside it; b = 4: the BSR-b kernel) on phase 4's
   fine operator, held to its twin and to K1, one launch per call,
   ``kernels`` records beside cuSPARSE BSR at the same b;
9. (run right after ``[testlab]``, on phase 4's mesh, operator and AMG hierarchy) the
   supernode route and the other bench knobs of the sphere: (a) the
   supernode operator, (b) with the block-Jacobi fine smoother, (c) with
   bf16 fine-level blocks too, (d) the ELL operator with the block-Jacobi
   smoother, (e) the bf16 V-cycle, (f) the batched coordinate gather; each
   solve checked and printed with its launch counts as an ``[sn]`` line,
   (a)-(c) with every supernode SpMV one ``bsr8_spmv`` launch (no K3a) and
   24, 22 and 25 iterations ± 1; two assemblies on each of the four
   assembly routes (``ASM_ROUTES``), all eight equal bit for bit
   (``[asm]``); then ``bsr8_spmv`` on f32 and bf16 blocks held to its
   twin (and K1) and timed beside cuSPARSE BSR, K3a at its three shapes
   (the supernode column gather and row reduce, which no path runs since
   ``bsr8_spmv``, as kernel checks), K3b on the fine operator's own SELL
   layout with 8 channel-minor tables and K1 bf16 held against their plain
   twins and timed;
g-i. (run after 9, on the same state) the compact route: (g) ``--spmv
   compact`` (pre-gather K2), (h) with ``--band-pre`` (each pre-gather of
   the CG operator, the levels and the transfers one K9a launch over its
   narrow and wide tiles: no K2), (i) with ``--asm-compact --asm-coords
   batched`` too (K9b, then K3a 9 times); each solve checked against the
   ELL run's iterations and printed with its launch counts as a
   ``[compact]`` line; the compact corners held equal to the split
   gather's; K2 at (g)'s CG pre-gather, K9a at (h)'s
   (``BandedGather.__call__``) and K9b at (i)'s coordinates
   (``call_batched``) held to their plain twins and timed; and
   ``--spmv diag`` must raise on this system, where plan_diag declines;
``[fem]`` (run after g-i, on phase 4's mesh and solution): the FEM core
   and the Poisson/Laplace model.  F1: cases written into
   ``build/fem_cases/`` (``tools/write_msh.py``): Laplace u = x on a 128x128
   ``rect_tria_mesh`` and a 24^3 ``box_tetra_mesh`` with each Dirichlet
   method (Aleph default: Jacobi-CG to 1e-12), a Poisson case with a
   Neumann group and the Hypre (AMG), poly and dense (8x8) routes; each run
   in-process on the CPU (float64, its u written as the case's golden
   file), in-process on the card and, the ``_cli_cases`` (in order, each
   case that brings a codename or a solver route no earlier one brought,
   and the output cases; the same rule in M1, B1 and T1), through
   ``python -m arcanefem_tpu_torch run`` in a subprocess (the card by
   default, the golden file checked; six at a time beside the in-process
   runs; the two runs alone that
   timed the CLI went to make room for ``[parallel]``): the card's u
   within 1e-9 of max|u| of the CPU's, within 1e-6 of
   x on the Laplace cases, iterations equal ± 1.  F2: ``models/poisson.solve``
   on phase 4's mesh (−Δu = 1, Penalty Cut = 0 and sphere = 1, AMG-PCG to
   1e-8) in float32 (its float64 run and its profiled solve went to make
   room for ``[models]``, whose electrostatics is this system with another
   source in both dtypes and whose GMRES solve is profiled), with its
   launch counts (``slot_reduce`` once, ``tet_element`` never,
   ``sell_spmv``), its ``PhaseTimer`` phases, AMG set-up seconds, peak
   memory and true free-row residual (<= 1e-6); u within 1e-4 of max|u|
   of phase 4's x on the free nodes; the assembly's ``slot_reduce`` held
   to ``slot_reduce_plain`` within 4 ulps at the mesh's shapes;
``[models]`` (run after ``[fem]``): the Fourier,
   Electrostatics, Acoustics and Aerodynamics models.  M1: 14 cases
   written into ``build/model_cases/`` (a 96x96 tria3 rect, a 96x96 quad4
   rect with λ regions, a 16^3 tetra4 box, quadratized 48x48 tria6 and 8^3
   tetra10 meshes; the Hypre, Aleph-default, gmres, bicgstab, bicgstab2
   and dense routes; ``MODEL_OUTPUT_CASE`` with ``--output-dir``), each on
   the CPU (float64, the golden file), in-process on the card and, the
   ``_cli_cases`` and ``MODEL_OUTPUT_CASE``, through the CLI: the card's
   fields (φ and E, u and ψ, u) within 1e-9 of the
   CPU's, iterations ± 1 (5% for BiCGStab on 1e30 penalty rows and for
   unpreconditioned BiCGStab on the Helmholtz system, whose counts
   round-off sets), ``slot_reduce`` once, ``sell_spmv``; the
   post-processing file read back (legacy VTK on a machine without h5py)
   and held to the card's φ.  M2, at full width, each with its
   iterations, monitored and true residuals, solve_s, ms/iter, the
   launches of ``sell_spmv`` and ``slot_reduce`` and peak memory: (a)
   electrostatics on the h=5 refine=1 sphere (phase 4's before the
   ``[transient]`` phase, cut in depth to make room for it), AMG-CG to
   1e-8, float32 and float64, E over every
   cell; (b) aerodynamics there (farfield penalty on the
   sphere, 0 on Cut), GMRES(30) + AMG in float32 with the compensated
   dots to 1e-8; (c) the same system through bicgstab and bicgstab2 + AMG
   in float32 and float64, GMRES once more under torch.profiler (busy
   share); (d) Fourier on a 1414^2 quad4 rect (two λ regions, the
   manufactured solution), its error against the exact field held to the
   CPU's at 64^2 (the one-point quad4 element's own); (e) Fourier on the
   quadratized h=5 sphere (tetra10; refine=1 until PR 12, cut in depth to
   refine=0 in PR 13 to make room for ``[blocks]``), AMG-CG in float32,
   with ``slot_reduce`` at its shapes held to its twin within 4 ulps and
   timed (a ``kernels`` record); (f) acoustics (unpreconditioned BiCGStab,
   the model's forcing) in float64 on the h=5 refine=1 sphere (phase 4's
   until PR 12);
``[blocks]`` (run after ``[models]``): the Bilaplacian,
   Elasticity and Elastodynamics models (block BELL, the scalar expansion
   of b×b blocks assembled by ``block_slot_reduce``).  B1: 14 cases written
   into ``build/block_cases/`` (a tria3 rect with a point group, a tetra4
   box, a tria3 square; every Dirichlet method, body force and traction;
   the Aleph default (Jacobi-CG, bicgstab under RowElimination), gmres with
   AMG, Hypre (AMG with the rigid body modes) and dense routes; Newmark-β
   and Generalized-α, Rayleigh damping, a CaseTable traction; and, in
   process only, block-Jacobi and the consistent initial acceleration),
   each on the CPU (float64, the golden file), in-process on the card and,
   the ``_cli_cases``, through the CLI: the card's fields within 1e-12 of
   the CPU's largest (1e-10 for the dense bilaplacian, cuSOLVER's LU against LAPACK's, and
   for BiCGStab on the RowElimination system, whose count round-off sets
   and which is held to 10%), iterations ± 1 otherwise, one
   ``block_slot_reduce`` per assembled operator.  B2: (a) elasticity on the h=5 refine=1 sphere
   (732,549 DoF; phase 4's, 5,678,067 DoF, before the ``[transient]``
   phase, cut in depth to make room for it), f32, body force, Penalty u = 0 on Cut, block-Jacobi-CG to 1e-7,
   ``fail_action="raise"``): iterations, ms/iter, the true free-row
   residual, phases, peak memory; ``block_slot_reduce`` at phase 4's
   5.68M-DoF block shapes (0 ulps from its twin, bit-equal from run to
   run, beside ``index_add_``; a ``[kernel] ... was`` line sets the earlier
   slot-map kernel's times from PERF.md beside them) and K1 on that
   operator (beside CSR
   ``torch.mv``) as ``kernels`` records (taken in ``[transient]`` T2 (c)
   on passmo's layout of the same mesh); one profiled
   solve (busy share); (b) elasticity with AMG and
   the rigid body modes on the h=5 refine=0 sphere (refine=1, 732,549
   DoF, before the ``[transient]`` phase): set-up seconds and level
   sizes; (c) elastodynamics on the refine=1 sphere, 10 Newmark steps
   with a CaseTable traction on the sphere, Jacobi-CG; (d) the dense
   bilaplacian on a 100x100 rect (20,402 DoF);
``[transient]`` (run after ``[blocks]``, on phase 4's mesh): the Heat,
   Soildynamics and Passmo models and the fixed-order RHS and face-matrix
   sums.  T1: 8 cases in ``build/transient_cases/`` (heat on a tria3 rect
   by Penalty and RowElimination, convection, a constant qdot, one with
   ``--output-dir`` whose temporal file is read back, and an in-process
   resume through ``fem/checkpoint.py``; soildynamics with paraxial on
   three sides, a CaseTable traction and a double couple; passmo on a
   tetra4 box and on a hexa8/pyramid5/penta6/tetra4 box with imposed
   U/V/A curves, a Ricker incident wave, Generalized-α, initial node
   conditions and the recovered fields written), each on the CPU (float64,
   the golden file), twice in process on the card and, the
   ``_cli_cases``, through the CLI: the card's fields within 1e-12 of the CPU's largest, the two card runs
   bit-equal, the iterations of every step equal ± 1, the fixed-order
   sums (``slot_sum``) launched and no atomic scatter-add called on a CUDA
   tensor.  T2, 10 steps each: (a) heat on a 1414² tria3 rect (2,002,225
   DoF, f32, AMG-CG to 1e-6, convection, a constant qdot; then the same
   options in f64: each last step's free-row residual under its dtype's
   limit, the f32 T held to the f64 T), (b)
   soildynamics there (4,004,450 DoF, f64, Jacobi-CG, paraxial on three
   sides, a CaseTable traction, the double couple at the centre), (c)
   passmo on phase 4's sphere (5,678,067 DoF, f32, Newmark, Jacobi-CG,
   paraxial on the sphere with the inner cells' ρ, cp, cs, an imposed
   velocity on Cut, the recovery): iterations per step, the last step's
   monitored and free-row residuals, solve seconds, ms/iter, phases, peak
   memory, launches; ``block_slot_reduce`` at (b)'s b = 2 shapes and
   ``slot_reduce`` as the RHS reducer at (c)'s paraxial faces held to
   their twins (0 ulps, bit-equal reruns) and timed beside one
   ``index_add_`` (``kernels`` records; the b = 2 one with its ``was``
   line);
``[parallel]`` (run after ``[transient]``): the sharded
   solves over torch.distributed (``arcanefem_tpu_torch/parallel/``).  (a)
   ``python -m arcanefem_tpu_torch.parallel --nproc 1 --device cuda
   --sphere 5,1 --f64`` (NCCL, one rank; its output in
   ``build/parallel/cli.txt``): the dryrun's eight paths at their sizes
   (RCB Jacobi-PCG, x-slab, x-slab MG, AMG-PCG, the window step, one
   V-cycle, block elasticity, elastodynamics) and the refine-1 sphere
   (244,183 nodes) through
   ``make_window_amg_step`` in float64 to 1e-8, each held by the rank to
   its single-process solve (the sphere within 1e-6 of the largest value)
   and printed with its iterations, true residual, difference, the rank's
   K1 and ``slot_reduce`` launches, collectives per iteration and ms per
   iteration; the sphere must launch K1 and ``slot_reduce``.  (b) while
   (a) runs, ``build_sharded`` of (a)'s refine-1 sphere into 4 parts on
   the host, and ``[bench]`` (below), then K1 on shard 0's rectangular
   [owned | halo] SELL layout in float64,
   its halo filled on the host through the partition's maps, held to its
   plain twin (1e-12 of Σ|v·x|, padding rows 0) and timed beside CSR
   ``torch.mv`` (a ``kernels`` record whose launches are (a)'s sphere's);
``[ilu]`` (run after ``[parallel]``): ``tools/ilu_decision.py``'s three
   float64 systems (a 90x90 Poisson rect, a 22^3 Poisson box, a 50x50
   elasticity rect) assembled on the card (``slot_reduce`` twice,
   ``block_slot_reduce`` once at b = 2: their ``ilu_launches`` in the
   ``kernels`` records) and on the CPU, the card's CSR within 1e-12 of the
   CPU's largest value; the experiment's rows of both (PCG iterations with
   Jacobi, Chebyshev(3), IC(0) and ILUT, the factors' level depths) in
   spawned processes: n, nnz and depths equal, Jacobi/Chebyshev/IC(0)
   within 1, ILUT within 10% or both at the cap; then the card's
   reckoning of each system: a chain of ``depth`` dependent single-block K1
   launches for each factor against three K1 on its SELL layout (CUDA
   events), per PCG iteration and to convergence;
``[amg]`` (after ``[ilu]``): the h=5 refine=1 sphere (244,183 DoF) in
   float32 with the native AMG set-up and with ``AFEM_NATIVE_AMG=0`` (the
   scipy branch): each branch's set-up seconds, levels, iterations and
   residuals; both converge, true residual <= 1e-4, iterations within 1;
j. the RCM-ordered sphere at h=5, refine=1 (244,183 DoF): the ELL route,
   then ``--spmv diag`` (K10) on the same system, ``[diag]`` lines; K10
   held to its twin and timed there and on the 80^3 RCM box, beside K1 and
   CSR ``torch.mv`` on the same operator; the gather probes P1-P3
   (``tools/probe_gather.py``) at (K, G) = (160, 64) (window in shared
   memory) and (1024, 64) (L1/L2), each with its host µs per call beside
   ``torch.gather``'s;
5. the same system at h=8 with the plain twins in place of the kernels,
   and in float64 on the CPU: iterations and solutions must agree, on the
   ELL route and (9b) on the supernode route with the block smoother, also
   with bf16 V-cycle blocks (9c);
6. structured kernel parity: the stencil kernel (K5-K8) in every mode and
   layout, f32 and bf16 bands, and the stencil assembly (K4), stiffness
   only and fused with the BC, against their plain twins on a 96x80x136
   box (two 128-thread blocks per z row);
7. the structured path at 224^3 (11.4M DoF): the MG-PCG bench pass with
   the launch counts of one solve, a torch.profiler breakdown of one solve
   (the operator table in build/profile/), the Jacobi-PCG variant (K8a)
   and the flat-vector MG variant (K8a, K8b), each with its own counts
   and bench line, ``[chunk]``: the pass with ``pcg_chunked``, chunk 4 (a
   multiple of 4 iterations within 4 of ``pcg``'s, true residual <= 1e-4)
   and chunk 1 (equal to ``pcg`` bit for bit), ``[unfused]``: the pass with
   the unfused assembly and MG build (K4's stiffness-only mode on every
   level; 13 ± 1 iterations, true residual <= 1e-4), then each kernel held
   against its plain twin and timed at the path's shapes (CUDA events and
   profiler device time), and two fused 225^3 assemblies held equal bit
   for bit;
8. the MG path at 64^3 through the kernels, on the plain twins (float32 on
   the CPU) and in float64 on the CPU: iterations and solutions must agree;
``[bench]`` (run inside ``[parallel]``, while its CLI runs):
   ``python -m arcanefem_tpu_torch.bench`` once at check size (sphere h=8
   refine=0, box 64^3) in a fresh cache directory: bench.py's keys and
   metric names, a numeric ``vs_baseline``, the AMG hierarchy built (its
   second, warm run went to make room for ``[parallel]``);
``[sweep]`` (run inside ``[parallel]`` too, a subprocess started with its
   CLI): ``python -m arcanefem_tpu_torch.bench --sweep --sizes 32,64,96
   --devices 1`` with the headline at ``[bench]``'s check size in a fresh
   cache directory (its output in ``build/sweep/``): the six format rows
   of every size with finite times, ``slot_reduce`` launched by the
   assembly axis, the P = 1 devices row (NCCL, one rank) invariant with
   its iterations, both headline rows with a ``value``, and one TSV line
   per row;
``[profile]`` (after ``[cache]`` on phase 4's operator and hierarchy, and
   in phase 7 on its box): ``tools/profile_unstr.components`` on the 1.9M
   sphere (each component the slope of CUDA events over k runs) beside the
   model and the measured ms per iteration of one ``pcg_chunked`` solve,
   with K1's launches; ``tools/profile_iter.run``'s plain list (the flat
   band-major operator and V-cycle: K8a, K8b) and padded list (the bench's
   system: K5-K7) at 224^3, each beside its measured ms per iteration,
   with the stencil kernels' launches.

Then one JSON line with the kernels' records and, last, the device line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.

A record's ``bound_ms`` is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its flops over 67 TFLOP/s
(the H100 SXM's HBM3 rate and non-tensor f32 rate, at 700 W); K1's counts
the nonzeros (8 bytes each, 12 per row), and ``slot_bound_ms`` the SELL
slots it stores.  ``ms`` is the CUDA-event time of back-to-back calls;
most records add ``device_ms``, the profiler's time per call of the
record's own kernel (null where the profiler did not trace it, with the
events it traced and expected in ``device_events``), because for a kernel
of a few microseconds the former measures the host's rate of issuing
launches.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile
import time

BOX_N, CHECK_N = 224, 64  # box sizes of phases 7 and 8
PARITY_BOX = (96, 80, 136)  # phase 6: nz + 3 = 139 pads to two z blocks
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel call."""
    tb, tf = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


_T0 = time.perf_counter()  # the run's start, for the [elapsed] lines


def _elapsed(done: str) -> None:
    """An [elapsed] line: the seconds since the run started, after ``done``
    (the script's time limit is the whole run's)."""
    print(f"[elapsed] {time.perf_counter() - _T0:.1f} s after {done}", flush=True)


def _assemblies(counts: dict) -> int:
    """The slot_reduce launches of scalar assemblies: all of them less the
    fixed-order RHS and face-matrix sums (``slot_sum``)."""
    return counts.get("slot_reduce", 0) - counts.get("slot_sum", 0)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rel_err(got, want, scale) -> float:
    """max |got - want| / scale, per row; scale is sum_w |v·x| of the row."""
    import torch

    err = (got.double() - want.double()).abs()
    return float((err / scale.double().clamp(min=torch.finfo(torch.float64).tiny)).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs on "
              "an NVIDIA card", file=sys.stderr)
        return 1

    import arcanefem_tpu_torch  # noqa: F401  (outside the repo this raises here)

    dev = torch.device("cuda", 0)
    prime = _start_prime()
    try:
        return _main(dev, prime)
    finally:
        if prime.poll() is None:
            prime.kill()
            prime.wait()


def _start_prime():
    """The 1.9M sphere's host set-up (``bench_unstructured --h 5 --refine 2
    --prime``: mesh, refinements, orders and topologies into the npz
    caches that phase 4's ``sphere_cut_system`` reads), started in a
    subprocess to run beside the build and phase 3."""
    import subprocess

    return subprocess.Popen([sys.executable, "-m", "arcanefem_tpu_torch.bench_unstructured",
                             "--h", "5", "--refine", "2", "--prime"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _main(dev, prime) -> int:
    import torch

    from arcanefem_tpu_torch.bench_unstructured import (
        gpu_name_and_power,
        mesh_key,
        solve_sphere_cut,
        sphere_cut_system,
    )
    from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
    from arcanefem_tpu_torch.sparse.ell_gather import (
        ell_gather_sum,
        ell_gather_sum_plain,
        ell_spmv_plain,
    )
    from arcanefem_tpu_torch.sparse.sell import SellLayout, sell_spmv, sell_spmv_plain
    from arcanefem_tpu_torch.tools.launch_cost import measure_all
    from arcanefem_tpu_torch.utils import kernels
    from arcanefem_tpu_torch.utils.timing import time_op

    # 1. device
    smi = gpu_name_and_power()
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    print(f"[build] {kernels.library_path()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    _elapsed("device and build")
    # 3. kernel parity on random ELL inputs; K1 on the SELL layout of the
    #    real slots (built on the host), held to its SELL twin and to the
    #    (n, W) definition
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for W in (1, 8, 25, 136):
            n = 1_000_000
            cols = torch.randint(0, n, (n, W), generator=gen, device=dev,
                                 dtype=torch.int32)
            vals = torch.rand((n, W), generator=gen, device=dev,
                              dtype=dtype) * 2 - 1
            pad = torch.rand((n, W), generator=gen, device=dev) < 0.2
            pad[:: 97] = True  # empty rows
            vals[pad] = 0
            ucols = torch.where(pad, -1, cols)
            x = torch.rand(n, generator=gen, device=dev, dtype=dtype) * 2 - 1
            lay = SellLayout.build(cols.cpu().numpy(), (~pad).cpu().numpy(),
                                   device=dev)
            sv = lay.from_ell(vals)
            y, u = sell_spmv(sv, lay, x), ell_gather_sum(ucols, x)
            torch.cuda.synchronize()
            scale = ell_spmv_plain(vals.abs(), cols, x.abs())
            e1 = max(_rel_err(y, sell_spmv_plain(sv, lay, x), scale),
                     _rel_err(y, ell_spmv_plain(vals, cols, x), scale))
            e2 = _rel_err(u, ell_gather_sum_plain(ucols, x),
                          ell_gather_sum_plain(ucols, x.abs()))
            print(f"[parity] {str(dtype)[6:]} W={W}: sell_spmv {e1:.2e} (sigma "
                  f"{lay.sigma}, {lay.n_slots / max(lay.nnz, 1):.3f} slots per "
                  f"nonzero), ell_gather_sum {e2:.2e} (rtol {rtol:g} of sum |v x|)",
                  flush=True)
            _check(e1 <= rtol and e2 <= rtol, f"parity {dtype} W={W}")
            _batched_parity(vals, cols, ucols, lay, sv, gen, dtype, rtol)
            if dtype == torch.float32:
                vb, xf = sv.bfloat16(), x.float()
                e3 = _rel_err(sell_spmv(vb, lay, xf), sell_spmv_plain(vb, lay, xf),
                              sell_spmv_plain(vb.abs(), lay, xf.abs()))
                print(f"[parity] bf16 weights W={W}: sell_spmv {e3:.2e} (rtol 1e-5)",
                      flush=True)
                _check(e3 <= 1e-5, f"bf16 sell_spmv parity W={W}")
                del vb, xf
            del cols, vals, pad, ucols, x, y, u, sv, scale, lay

    # the sphere's host set-up, primed beside the build and the parity runs
    t0 = time.perf_counter()
    out, err = prime.communicate(timeout=1200)
    print(f"[prime] exit {prime.returncode} after {time.perf_counter() - _T0:.1f} s of the "
          f"run ({time.perf_counter() - t0:.1f} s waited for): {out.strip()}", flush=True)
    _check(prime.returncode == 0, f"[prime] the sphere's host set-up failed: {err[-2000:]}")
    # the host cost of one launch of each wrapper, where the card and the
    # host are idle
    for rec in measure_all(2000):
        print(f"[launch] {json.dumps(rec)}", flush=True)

    _elapsed("3: parity and launch costs")
    # 4. main path at 1.9M DoF; its solve runs cold through the npz cache
    #    that [cache] then loads
    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(5.0, 2)
    host_s = time.perf_counter() - t0
    print(f"[main] host set-up (mesh, orders, topology) loaded from the primed caches in "
          f"{host_s:.1f} s", flush=True)
    cache_dir = tempfile.mkdtemp(dir="build")
    _reset_all()
    builds = SellLayout.builds
    res = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                           penalty=1e12, timed=True,
                           cache=os.path.join(cache_dir, mesh_key(5.0, 2)))
    torch.cuda.synchronize()
    cold_builds = SellLayout.builds - builds
    counts = _counts_all()
    n, iters = topo.n_nodes, res["iterations"]
    main_line = {
        "n_dofs": n, "nnz_stored": topo.nnz, "width": topo.width,
        "n_cells": int(mesh.cells["tetra4"].shape[0]),
        "assembly_s": res["assembly_s"], "amg_setup_s": res["amg_setup_s"],
        "solve_s": res["solve_s"], "iterations": iters,
        "ms_per_iter": res["solve_s"] / max(iters, 1) * 1e3,
        "rel": res["rel"], "true_residual": res["true_residual"],
        "amg_levels": res["levels"], "launches": counts,
    }
    print(f"[main] {json.dumps(main_line)}", flush=True)
    for rec in res["sell"]:
        print(f"[sell] {json.dumps(rec)}", flush=True)
    _check(res["rel"] <= 1e-8, f"monitored residual {res['rel']:.3e} > 1e-8")
    _check(res["true_residual"] <= 1e-4,
           f"true interior residual {res['true_residual']:.3e} > 1e-4")
    _check(bool(torch.isfinite(res["x"]).all()), "non-finite solution")
    _check(res["x"].shape == (n,), "solution shape")
    _check(counts["sell_spmv"] > 0 and counts["tet_element"] > 0
           and counts["slot_reduce"] > 0,
           f"K1 or an assembly kernel never ran: {counts}")
    _check(counts["ell_gather_sum"] == 0,
           f"the default assembly route launched K2: {counts}")

    # the kernels at the main path's shapes, against their plain twins; K1
    # also against the (N, W) definition and at the other sigma
    A = res["A"]
    lay = A.layout
    xr = torch.rand(n, generator=gen, device=dev) * 2 - 1
    ell_vals = A.ell_values()
    ell_cols = torch.as_tensor(topo.ell_cols.astype("int32"), device=dev)
    y, yp = sell_spmv(A.values, lay, xr), sell_spmv_plain(A.values, lay, xr)
    scale = ell_spmv_plain(ell_vals.abs(), ell_cols, xr.abs())
    e1 = max(_rel_err(y, yp, scale),
             _rel_err(y, ell_spmv_plain(ell_vals, ell_cols, xr), scale))
    _check(e1 <= 1e-5, f"fine-level sell_spmv parity {e1:.2e}")
    alt = SellLayout.build(topo.ell_cols, topo.ell_valid, device=dev,
                           sigma=1 if lay.sigma > 1 else 1024)
    alt_vals = alt.from_ell(ell_vals)
    e_alt = _rel_err(sell_spmv(alt_vals, alt, xr), yp, scale)
    _check(e_alt <= 1e-5, f"fine-level sell_spmv at sigma {alt.sigma}: {e_alt:.2e}")
    asm = TetraAssembler(topo, mesh.cells["tetra4"], device=dev, layout=lay)
    crow = torch.as_tensor(topo.row_ptr, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(
        crow, torch.as_tensor(topo.csr_cols, device=dev, dtype=torch.int64),
        ell_vals.reshape(-1)[torch.as_tensor(topo.csr_to_ell, device=dev,
                                             dtype=torch.int64)],
        size=(n, n))
    e_csr = float((csr @ xr - yp).abs().max() / yp.abs().max())
    print(f"[kernel] CSR library SpMV vs plain: {e_csr:.3e} of max|y|", flush=True)

    def slot_bound(layout, value_bytes):
        """Bytes of the SELL slots K1 reads, x and y, the permutation."""
        perm = 0 if layout.perm is None else 4 * n
        return _bound(layout.n_slots * (value_bytes + 4) + n * 8 + perm,
                      2 * layout.n_slots)[0]

    k1_ms = time_op(sell_spmv, A.values, lay, xr, reps=50, outer=3) * 1e3
    alt_ms = time_op(sell_spmv, alt_vals, alt, xr, reps=50, outer=3) * 1e3
    k1 = {"name": "sell_spmv", "route": "cuda",
         "source": "arcanefem_tpu_torch/csrc/sell_spmv.cu",
         "replaces": "arcanefem_tpu/sparse/pallas_spmv.py:398",
         "launches": counts["sell_spmv"],
         "max_abs_err": float((y - yp).abs().max()),
         "ms": k1_ms,
         **dict(zip(("device_ms", "device_events"),
                    _device_ms(lambda: sell_spmv(A.values, lay, xr), "sell_spmv.cu"))),
         "plain_ms": time_op(sell_spmv_plain, A.values, lay, xr, reps=5,
                             outer=2) * 1e3,
         "library_ms": time_op(torch.mv, csr, xr, reps=50, outer=3) * 1e3,
         **dict(zip(("bound_ms", "bound_by"), _bound(
             topo.nnz * 8 + n * 12, 2 * topo.nnz))),
         "slot_bound_ms": slot_bound(lay, 4),
         "sigma": lay.sigma, "slots": lay.n_slots, "nnz": topo.nnz,
         "alt_sigma": alt.sigma, "alt_ms": alt_ms,
         **dict(zip(("alt_device_ms", "alt_device_events"),
                    _device_ms(lambda: sell_spmv(alt_vals, alt, xr), "sell_spmv.cu"))),
         "alt_slots": alt.n_slots, "alt_slot_bound_ms": slot_bound(alt, 4),
         "shape": [n, topo.width], "dtype": "float32"}
    print(f"[kernel] sell_spmv {k1['shape']}: {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms, library {k1['library_ms']:.4f} ms, bound "
          f"{k1['bound_ms']:.4f} ms, max_abs_err {k1['max_abs_err']:.3e}", flush=True)
    records = [k1, *_assembly_records(asm, mesh, counts)]
    print(f"[kernel] sell_spmv sigma {k1['sigma']}: {k1['slots']} slots "
          f"({k1['slots'] / k1['nnz']:.4f} per nonzero), {k1['ms']:.4f} ms, device "
          f"{_fmt_ms(k1['device_ms'])}, slot bound {k1['slot_bound_ms']:.4f} ms; sigma "
          f"{k1['alt_sigma']}: {k1['alt_slots']} slots, {k1['alt_ms']:.4f} ms, device "
          f"{_fmt_ms(k1['alt_device_ms'])}, slot bound {k1['alt_slot_bound_ms']:.4f} ms; "
          f"nonzero bound {k1['bound_ms']:.4f} ms, CSR torch.mv "
          f"{k1['library_ms']:.4f} ms", flush=True)
    del A, asm, xr, y, yp, csr, ell_vals, ell_cols, alt, alt_vals, scale
    torch.cuda.empty_cache()

    # device time by kernel of one main-path solve (its true-residual check
    # included), on phase 4's operator and hierarchy
    def solve_ell():
        return solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, system=res["system"])

    solve_ell()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_ell()
    torch.cuda.synchronize()
    _profile(solve_ell, os.path.join("build", "profile", "ell.txt"),
             time.perf_counter() - t0, groups=SPHERE_GROUPS)
    torch.cuda.empty_cache()
    cache_phase(dev, mesh, topo, res, cache_dir, cold_builds)
    profile_unstr_phase(dev, res)
    _elapsed("4: main path, records, profile, [cache], [profile]")
    records += testlab_phase(dev, mesh, topo, res, counts)
    _elapsed("[testlab]")

    records += supernode_phase(dev, gen, mesh, topo, res)
    _elapsed("9: supernode routes")
    res["system"].pop("sn", None)  # 1.35 GB of blocks no later phase reads
    records += compact_phase(dev, gen, mesh, topo, res)
    _elapsed("g-i: compact routes")
    fem_phase(dev, mesh, res)
    _elapsed("[fem]")
    del res
    records += models_phase(dev)
    _elapsed("[models]")
    blocks_phase(dev)
    _elapsed("[blocks]")
    records += transient_phase(dev, mesh)
    _elapsed("[transient]")
    records += parallel_phase(dev)
    _elapsed("[parallel], [bench] and [sweep]")
    ilu_launches = ilu_phase(dev)
    amg_phase(dev)
    _elapsed("[ilu], [amg]")
    del mesh, topo
    torch.cuda.empty_cache()
    records += diag_phase(dev, gen)
    records += probe_phase(dev)
    _elapsed("j: [diag], [probe]")
    torch.cuda.empty_cache()

    # 5. the kernel path against the plain path, and against float64 on
    #    the CPU, at h=8; 9b, 9c. the same for the supernode route with the
    #    block smoother, also with bf16 V-cycle blocks, on each run's own
    #    operator and hierarchy
    systems: dict = {}
    mesh, topo = sphere_cut_system(8.0, 0)
    setups = {"kernel": dict(device=dev, dtype=torch.float32, penalty=1e12),
              "plain": dict(device=dev, dtype=torch.float32, penalty=1e12,
                            plain=True),
              "cpu_f64": dict(device="cpu", dtype=torch.float64, penalty=1e30)}
    for route, opts in (("h8", {}), ("h8sn", dict(spmv="supernode", sn_block=True)),
                        ("h8snbf16", dict(spmv="supernode", sn_block=True, sn_bf16=True))):
        runs = {}
        for name, kw in setups.items():
            runs[name] = solve_sphere_cut(mesh, topo, **kw, **opts,
                                          system=systems.get(name))
            systems[name] = runs[name]["system"]
        xk = runs["kernel"]["x"].double().cpu()
        for name, r in runs.items():
            diff = float((xk - r["x"].double().cpu()).abs().max()
                         / r["x"].double().abs().max().cpu())
            print(f"[{route}] {name}: {r['iterations']} iterations, rel {r['rel']:.2e}, "
                  f"true residual {r['true_residual']:.2e}, max diff from the "
                  f"kernel path {diff:.2e} ({r['spmv_path']})", flush=True)
            _check(abs(r["iterations"] - runs["kernel"]["iterations"]) <= 1,
                   f"{route} iterations, {name}")
            _check(diff <= 1e-4, f"{route} solution, {name}")
            _check(r["rel"] <= 1e-8 and r["true_residual"] <= 1e-4,
                   f"{route} residuals, {name}")
        del runs, xk
    del systems, mesh, topo
    torch.cuda.empty_cache()

    records += structured_phases(dev, gen)
    _elapsed("5, 9b, 9c, 6-8: h=8 comparisons and the structured path")

    _add_ilu_launches(records, ilu_launches)
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _batched_parity(vals, cols, ucols, lay, sv, gen, dtype, rtol) -> None:
    """Phase 3, batched: K3b on the SELL layout ``lay`` (values ``sv``) of
    a K1/K2 case and K3a on its (n, W) index array, for B in 1, 3, 8
    tables, contiguous and channel-minor (tables and results strided), each
    table held against the single-table (n, W) definition."""
    import torch

    from arcanefem_tpu_torch.sparse.ell_gather import (
        ell_gather_sum_batched,
        ell_gather_sum_plain,
        ell_spmv_plain,
    )
    from arcanefem_tpu_torch.sparse.sell import sell_spmv_batched

    n, W = cols.shape
    for B in (1, 3, 8):
        tab = torch.rand((B, n), generator=gen, device=vals.device, dtype=dtype) * 2 - 1
        want = [(ell_spmv_plain(vals, cols, t), ell_spmv_plain(vals.abs(), cols, t.abs()),
                 ell_gather_sum_plain(ucols, t), ell_gather_sum_plain(ucols, t.abs()))
                for t in tab]
        for minor in (False, True):
            t = tab.T.contiguous().T if minor else tab
            outs = [torch.empty((n, B), dtype=dtype, device=vals.device).T
                    if minor else None for _ in range(2)]
            y = sell_spmv_batched(sv, lay, t, out=outs[0])
            u = ell_gather_sum_batched(ucols, t, out=outs[1])
            torch.cuda.synchronize()
            e1 = max(_rel_err(y[b], w[0], w[1]) for b, w in enumerate(want))
            e2 = max(_rel_err(u[b], w[2], w[3]) for b, w in enumerate(want))
            print(f"[parity] {str(dtype)[6:]} W={W} B={B} "
                  f"{'channel-minor' if minor else 'contiguous'}: sell_spmv_batched "
                  f"{e1:.2e}, ell_gather_sum_batched {e2:.2e} (rtol {rtol:g})", flush=True)
            _check(e1 <= rtol and e2 <= rtol, f"batched parity {dtype} W={W} B={B}")
            del y, u, t
        del tab, want


ASM_ROUTES = {  # the assembly's corner fetch (--asm-coords, --asm-compact, --band-pre)
    "split": {}, "batched": dict(coords_batched=True),
    "compact": dict(coords_compact=True),
    "compact batched banded": dict(coords_compact=True, coords_batched=True,
                                   band_pre=True)}


def _assembly_records(asm, mesh, counts) -> list[dict]:
    """Phase 4: tet_element (both input modes, which must agree exactly)
    and slot_reduce at the main path's shapes, held to their twins (the
    element table to 4 ulps of each cell's max |ke|, the reduction exactly)
    and timed; slot_reduce beside one index_add_ of all 16·nc entries, the
    reduction it replaces."""
    import torch

    from arcanefem_tpu_torch.ops.lane_assembly import (
        tet_corners_plain,
        tet_element,
        tet_element_gathered,
        tet_element_plain,
    )
    from arcanefem_tpu_torch.sparse.slot_reduce import slot_reduce, slot_reduce_plain
    from arcanefem_tpu_torch.utils.timing import time_op

    dev = asm.corner_cols.device
    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    cols, ptr, ids = asm.corner_cols, asm.ptr, asm.ids
    nc, n_slots, E = asm.n_cells, ptr.numel() - 1, ids.numel()

    def ulps(yk, yp):
        m = yp.abs().amax(dim=1, keepdim=True)
        e = float(((yk - yp).abs() / (torch.nextafter(m, m * 2 + 1) - m)).max())
        _check(e <= 4, f"tet_element: {e:.2f} ulps of a cell's max|ke| from its twin")
        return e

    def equal(yk, yp):
        _check(torch.equal(yk, yp), "slot_reduce differs from its twin")
        return 0.0

    corners = tet_corners_plain(coords, cols)
    ke, ke_g = tet_element(coords, cols), tet_element_gathered(corners)
    torch.cuda.synchronize()
    _check(torch.equal(ke, ke_g), "tet_element: the two input modes differ")
    e_g = ulps(ke_g, tet_element_plain(corners))
    table = ke.view(-1)
    slot_of = torch.repeat_interleave(torch.arange(n_slots, device=dev),
                                      (ptr[1:] - ptr[:-1]).long(), output_size=E)
    entries = table[ids.long()]
    recs = [
        _kernel_record(
            "tet_element", "tet_assembly.cu", "sparse/pallas_spmv.py:444",
            lambda: tet_element(coords, cols),
            lambda: tet_element_plain(tet_corners_plain(coords, cols)), None,
            (nc * 56 + coords.shape[0] * 12, 182 * nc), counts["tet_element"],
            [nc, 10], ulps),
        _kernel_record(
            "slot_reduce", "tet_assembly.cu", "sparse/pallas_spmv.py:444",
            lambda: slot_reduce(ptr, ids, table),
            lambda: slot_reduce_plain(ptr, ids, table),
            lambda: torch.zeros(n_slots, device=dev).index_add_(0, slot_of, entries),
            (8 * n_slots + 4 + 4 * E + 40 * nc, E), counts["slot_reduce"],
            [n_slots, E], equal)]
    recs[0]["gathered_ms"] = time_op(tet_element_gathered, corners, reps=20, outer=3) * 1e3
    recs[0]["gathered_device_ms"], recs[0]["gathered_device_events"] = _device_ms(
        lambda: tet_element_gathered(corners), "tet_assembly.cu")
    recs[0]["gathered_ulps"] = e_g
    recs[1]["max_contributors"] = int((ptr[1:] - ptr[:-1]).max())
    print(f"[kernel] tet_element on gathered corners (3, {4 * nc}): "
          f"{recs[0]['gathered_ms']:.4f} ms, device {_fmt_ms(recs[0]['gathered_device_ms'])}, "
          f"{e_g:.2f} ulps from its twin; slot_reduce: {E} contributors, at most "
          f"{recs[1]['max_contributors']} per slot", flush=True)
    return recs


SN_CONFIGS = {  # phase 9: bench_unstructured's flags of each configuration
    "a": dict(spmv="supernode"),
    "b": dict(spmv="supernode", sn_block=True),
    "c": dict(spmv="supernode", sn_block=True, sn_bf16=True),
    "d": dict(sn_block=True),
    "e": dict(vcycle_bf16=True),
    "f": dict(asm_coords="batched"),
}
# the supernode routes' iteration counts at 1.9M, held ± 1: (a) and (b)
# take the ELL operator's counts (phase 4, and (d) for the block smoother);
# (c)'s bf16 V-cycle blocks, whose exact products bsr8_spmv sums in f64
# (the three-step SpMV summed each block's 8 in f32 and took 28), take 25
SN_ITERS = {"a": 24, "b": 22, "c": 25}


def supernode_phase(dev, gen, mesh, topo, res4) -> list[dict]:
    """Phase 9: the configurations of SN_CONFIGS on phase 4's operator and
    AMG hierarchy (``res4``), then bsr8_spmv, K3a, K3b and K1 bf16 at the route's
    shapes; returns their records."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import (
        operator_self_check,
        solve_sphere_cut,
    )
    from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler, tet_corners_plain
    from arcanefem_tpu_torch.sparse.ell_gather import (
        ell_gather_sum_batched,
        ell_gather_sum_batched_plain,
        ell_spmv_batched_plain,
    )
    from arcanefem_tpu_torch.sparse.sell import (
        sell_spmv,
        sell_spmv_batched,
        sell_spmv_batched_plain,
        sell_spmv_plain,
    )
    import numpy as np

    from arcanefem_tpu_torch.sparse.supernode import block_products
    from arcanefem_tpu_torch.utils.timing import time_op

    system = res4["system"]
    runs, counts = {}, {}
    for key, opts in SN_CONFIGS.items():
        _reset_all()
        r = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                             penalty=1e12, timed=True, system=system, **opts)
        torch.cuda.synchronize()
        counts[key] = _counts_all()
        runs[key] = r
        line = {"config": key, "flags": opts, "spmv_path": r["spmv_path"],
                "iterations": r["iterations"], "rel": r["rel"],
                "true_residual": r["true_residual"], "solve_s": r["solve_s"],
                "ms_per_iter": r["solve_s"] / max(r["iterations"], 1) * 1e3,
                "assembly_s": r["assembly_s"],
                **{k: r[k] for k in ("sn_setup_s", "sn_check", "sn_blocks",
                                     "sn_bytes") if k in r},
                "launches": {k: v for k, v in counts[key].items() if v}}
        print(f"[sn] {json.dumps(line)}", flush=True)
        _check(r["rel"] <= 1e-8, f"[sn] {key}: monitored residual {r['rel']:.3e}")
        _check(r["true_residual"] <= 1e-4,
               f"[sn] {key}: true interior residual {r['true_residual']:.3e}")
        _check(bool(torch.isfinite(r["x"]).all()), f"[sn] {key}: non-finite x")
        _check(counts[key]["sell_spmv"] > 0, f"[sn] {key}: K1 never ran")
        if opts.get("spmv") == "supernode":
            # every supernode SpMV is one bsr8_spmv launch: no K3a
            _check(r["spmv_path"] == "SupernodeMatrix", f"[sn] {key}: spmv path")
            _check(counts[key]["bsr8_spmv"] > 0
                   and counts[key]["ell_gather_sum_batched"] == 0,
                   f"[sn] {key}: the supernode SpMV did not run through "
                   f"bsr8_spmv alone: {counts[key]}")
            _check(abs(r["iterations"] - SN_ITERS[key]) <= 1,
                   f"[sn] {key}: {r['iterations']} iterations, not {SN_ITERS[key]} ± 1")
        del r["x"]
    _check(counts["c"]["bsr8_spmv_bf16"] > 0, "[sn] c: bsr8_spmv on bf16 blocks never ran")
    _check(counts["e"]["sell_spmv_bf16"] > 0, "[sn] e: bf16 K1 never ran")
    _check(counts["f"]["ell_gather_sum_batched"] > 0
           and counts["f"]["ell_gather_sum"] == 0,
           f"[sn] f: the assembly did not gather through K3a alone: {counts['f']}")
    # device time by kernel of one (a) solve (its self-check included)
    def solve_a():
        return solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, system=system, **SN_CONFIGS["a"])

    solve_a()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_a()
    torch.cuda.synchronize()
    _profile(solve_a, os.path.join("build", "profile", "supernode_a.txt"),
             time.perf_counter() - t0, groups=SPHERE_GROUPS)
    print(f"[sn] iterations: ELL (phase 4) {res4['iterations']}, (b) supernode + "
          f"block-Jacobi {runs['b']['iterations']}, (d) ELL + block-Jacobi "
          f"{runs['d']['iterations']}", flush=True)

    # every assembly route feeds the same corners to the same element
    # kernel and sums each slot in one fixed order: two assemblies on each
    # route equal each other and the split route's, bit for bit, with no
    # deterministic-algorithms switch
    conn = mesh.cells["tetra4"]
    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    lay = system["A"].layout
    asm_b = TetraAssembler(topo, conn, device=dev, coords_batched=True, layout=lay)
    gs, gb = tet_corners_plain(coords, asm_b.corner_cols), asm_b.gather_corners(coords)
    same = all(torch.equal(gs[k], gb[k]) for k in range(3))
    print(f"[sn] (f) corners equal to the split gather's: {same}", flush=True)
    _check(same, "(f) batched coordinate gather != split gather")
    del gs, gb
    first, equal = None, {}
    for route, kw in ASM_ROUTES.items():
        asm_r = asm_b if kw == dict(coords_batched=True) else TetraAssembler(
            topo, conn, device=dev, layout=lay, **kw)
        v1, v2 = asm_r(coords), asm_r(coords)
        first = v1 if first is None else first
        equal[route] = [torch.equal(v1, v2), torch.equal(v1, first)]
        del asm_r, v1, v2
    print(f"[asm] two assemblies on each route: [equal to each other, equal to the "
          f"split route's] {json.dumps(equal)}", flush=True)
    _check(all(a and b for a, b in equal.values()),
           f"assembled values differ between runs or routes: {equal}")
    del first

    # the kernels at the route's shapes, against their plain twins
    A = system["A"]
    sn = system["sn"]
    n, W = A.n_nodes, A.width
    nnz, lay = topo.nnz, A.layout
    ell_vals = A.ell_values()
    ell_cols = torch.as_tensor(topo.ell_cols.astype("int32"), device=dev)
    nnzb, n_sup = sn.blocks.shape[0], sn.n_sup
    e_sn = operator_self_check(sn, A)
    print(f"[sn] supernode SpMV vs K1 sell_spmv on a unit-random x: {e_sn:.2e} of "
          f"each row's sum |a x| (tol 1e-5); {nnzb} blocks, {sn.nbytes / 1e9:.3f} GB",
          flush=True)
    _check(e_sn <= 1e-5, f"supernode SpMV vs K1: {e_sn:.2e}")
    x = torch.rand(n, generator=gen, device=dev) * 2 - 1
    records = _bsr8_records(sn, A, x, counts)
    # K3a's supernode role before bsr8_spmv, which no path runs any more:
    # the column gather into (nnzb, 8) and the row reduce of the block
    # products, kept at the route's shapes as kernel checks
    deg = np.diff(sn.bptr)
    rb = np.full((n_sup, int(deg.max())), -1, np.int32)
    rb[sn.brow, np.arange(nnzb) - np.repeat(sn.bptr[:-1], deg)] = np.arange(
        nnzb, dtype=np.int32)
    row_blocks = torch.as_tensor(rb, device=dev)
    sn_cols = sn.cols.view(-1, 1)
    xb = torch.nn.functional.pad(x, (0, n_sup * 8 - n)).view(n_sup, 8)
    xg = torch.empty((nnzb, 8), device=dev)
    yp = block_products(sn.blocks, ell_gather_sum_batched(sn_cols, xb.T, out=xg.T).T)
    yb = torch.empty((n_sup, 8), device=dev)
    bcol = torch.as_tensor(sn.bcol, device=dev)
    rsum = torch.sparse_csr_tensor(
        torch.as_tensor(sn.bptr, device=dev), torch.arange(nnzb, device=dev),
        torch.ones(nnzb, device=dev), size=(n_sup, nnzb))
    X8 = torch.rand((n, 8), generator=gen, device=dev) * 2 - 1
    Y8 = torch.empty((n, 8), device=dev)
    X8t, Y8t = X8.T.contiguous(), torch.empty((8, n), device=dev)
    crow = torch.as_tensor(topo.row_ptr, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(
        crow, torch.as_tensor(topo.csr_cols, device=dev, dtype=torch.int64),
        ell_vals.reshape(-1)[torch.as_tensor(topo.csr_to_ell, device=dev,
                                             dtype=torch.int64)], size=(n, n))
    asm_corner = asm_b.corner_cols
    vbf = A.values.bfloat16()
    perm_bytes = 0 if lay.perm is None else 4 * n
    cases = [
        # name, source line, kernel, plain twin, library call, (bytes, flops),
        # launches, shape, bytes of the SELL slots read (SELL kernels)
        ("ell_gather_sum_batched (sn cols)", "sparse/pallas_spmv.py:478",
         lambda: ell_gather_sum_batched(sn_cols, xb.T, out=xg.T),
         lambda: ell_gather_sum_batched_plain(sn_cols, xb.T),
         lambda: xb.index_select(0, bcol), (nnzb * 36 + n_sup * 32, 0),
         0, [nnzb, 1, 8], None),
        ("ell_gather_sum_batched (sn rows)", "sparse/pallas_spmv.py:478",
         lambda: ell_gather_sum_batched(row_blocks, yp.T, out=yb.T),
         lambda: ell_gather_sum_batched_plain(row_blocks, yp.T),
         lambda: torch.sparse.mm(rsum, yp),
         (nnzb * 32 + row_blocks.numel() * 4 + n_sup * 32, nnzb * 8),
         0, [n_sup, row_blocks.shape[1], 8], None),
        ("ell_gather_sum_batched (coords)", "sparse/pallas_spmv.py:478",
         lambda: ell_gather_sum_batched(asm_corner, coords.T),
         lambda: ell_gather_sum_batched_plain(asm_corner, coords.T),
         lambda: coords.index_select(0, asm_corner[:, 0].long()),
         (asm_corner.numel() * 16 + n * 12, 0),
         counts["f"]["ell_gather_sum_batched"], [asm_corner.shape[0], 1, 3], None),
        # K3b: 8 channel-minor tables on the fine operator's own SELL layout;
        # its floor, as K1's, counts the nonzeros: 8 bytes each, and per row
        # the permutation, 8 table values and 8 outputs
        ("sell_spmv_batched", "sparse/pallas_spmv.py:513",
         lambda: sell_spmv_batched(A.values, lay, X8.T, out=Y8.T),
         lambda: sell_spmv_batched_plain(A.values, lay, X8.T),
         lambda: torch.sparse.mm(csr, X8),
         (nnz * 8 + n * 64 + perm_bytes, 16 * nnz), 0, [n, W, 8],
         lay.n_slots * 8 + n * 64 + perm_bytes),
        # the same on table-major (8, n) tables, the layout JAX's
        # call_batched stacks: eight 4-byte loads from eight rows per slot
        ("sell_spmv_batched (table-major)", "sparse/pallas_spmv.py:513",
         lambda: sell_spmv_batched(A.values, lay, X8t, out=Y8t),
         lambda: sell_spmv_batched_plain(A.values, lay, X8t),
         lambda: torch.sparse.mm(csr, X8t.T),
         (nnz * 8 + n * 64 + perm_bytes, 16 * nnz), 0, [n, W, 8],
         lay.n_slots * 8 + n * 64 + perm_bytes),
        ("sell_spmv (bf16 weights)", "sparse/pallas_spmv.py:398",
         lambda: sell_spmv(vbf, lay, x), lambda: sell_spmv_plain(vbf, lay, x),
         None, (nnz * 6 + n * 12, 2 * nnz), counts["e"]["sell_spmv_bf16"], [n, W],
         lay.n_slots * 6 + n * 8 + perm_bytes),
    ]
    # sums are held to 1e-5 of each row's sum |v x|, as K1/K2; the W=1
    # gathers copy values and must equal their twins
    scales = {
        "ell_gather_sum_batched (sn rows)": ell_gather_sum_batched_plain(
            row_blocks, yp.T.abs()),
        "sell_spmv_batched": ell_spmv_batched_plain(ell_vals.abs(), ell_cols, X8.T.abs()),
        "sell_spmv_batched (table-major)": ell_spmv_batched_plain(
            ell_vals.abs(), ell_cols, X8t.abs()),
        "sell_spmv (bf16 weights)": sell_spmv_plain(vbf.abs(), lay, x.abs()),
    }
    # each of K3b's tables sums in K1's order: reported, not required
    yk = sell_spmv_batched(A.values, lay, X8.T, out=Y8.T)
    same = all(torch.equal(yk[b], sell_spmv(A.values, lay, X8[:, b].contiguous()))
               for b in range(8))
    e_def = _rel_err(yk, ell_spmv_batched_plain(ell_vals, ell_cols, X8.T),
                     scales["sell_spmv_batched"])
    print(f"[kernel] sell_spmv_batched: each table equal to K1 sell_spmv on it: {same}; "
          f"{e_def:.2e} of each row's sum |v x| from the (n, W) definition", flush=True)
    _check(e_def <= 1e-5, f"sell_spmv_batched vs the (n, W) definition: {e_def:.2e}")
    del yk
    for name, rep_, fk, fp, lib, (nbytes, flops), launches, shape, slot_bytes in cases:
        yk, yp_ = fk(), fp()
        torch.cuda.synchronize()
        err = float((yk.double() - yp_.double()).abs().max())
        if name in scales:
            rel = _rel_err(yk, yp_, scales[name])
            _check(rel <= 1e-5, f"{name} at the route's shape: {rel:.2e}")
        else:
            rel = err
            _check(torch.equal(yk, yp_), f"{name} at the route's shape: {err:.2e}")
        del yk, yp_
        sell = slot_bytes is not None
        src = "sell_spmv.cu" if sell else "ell_gather.cu"
        ms = time_op(fk, reps=20, outer=3) * 1e3
        dms, events = _device_ms(fk, src)
        pms = time_op(fp, reps=3, outer=2) * 1e3
        lms = time_op(lib, reps=20, outer=3) * 1e3 if lib else None
        bms, bby = _bound(nbytes, flops)
        records.append({
            "name": name, "route": "cuda", "source": f"arcanefem_tpu_torch/csrc/{src}",
            "replaces": f"arcanefem_tpu/{rep_}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dms, "device_events": events,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "library_ms": lms,
            "shape": shape,
            "dtype": "bfloat16 weights, float32" if "bf16" in name else "float32",
            **({"slot_bound_ms": _bound(slot_bytes, 0)[0], "sigma": lay.sigma,
                "slots": lay.n_slots} if sell else {})})
        print(f"[kernel] {name} {shape}: {ms:.4f} ms, device {_fmt_ms(dms)} "
              f"({events[0]} of {events[1]} kernel events traced; bound "
              f"{bms:.4f} ms, {bby}), plain {pms:.3f} ms, library "
              f"{'n/a' if lms is None else f'{lms:.4f} ms'}, max_abs_err {err:.3e} "
              f"({rel:.2e} held), launches {launches}", flush=True)
    # the 8x8 block products of the three-step SpMV, PyTorch ops (an XLA
    # einsum in the JAX package, no Pallas kernel) that the block-Jacobi
    # apply still runs; torch.bmm of the same, for the record
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = [time_op(f, *a, reps=20, outer=3) * 1e3 for f, a in (
        (block_products, (sn.blocks, xg)),
        (torch.bmm, (sn.blocks, xg.unsqueeze(-1))),
        (block_products, (sn.blocks.bfloat16(), xg)))]
    print(f"[kernel] 8x8 block products {[nnzb, 8, 8]} (PyTorch ops, no TPU kernel): "
          f"elementwise product and sum {ms[0]:.4f} ms, torch.bmm {ms[1]:.4f} ms, "
          f"bf16 blocks {ms[2]:.4f} ms; bytes bound "
          f"{_bound(nnzb * 320, nnzb * 128)[0]:.4f} ms", flush=True)
    return records


def _bsr8_records(sn, A, x, counts) -> list[dict]:
    """Phase 9: bsr8_spmv at the 1.9M route's shapes, on f32 blocks (the CG
    operator of (a)-(c)) and bf16 blocks (the V-cycle's fine level on
    (c)), through ``SupernodeSpmv``: held to its plain twin (1e-6 of each
    row's sum |a·x|) and, on f32 blocks, to K1 on the same operator (1e-5);
    timed beside the twin and cuSPARSE BSR (``torch.sparse_bsr_tensor`` of
    the same blocks times x, padded to 8 n_sup), whose refusal is recorded
    in its own words."""
    import torch

    from arcanefem_tpu_torch.sparse.sell import sell_spmv, sell_spmv_plain
    from arcanefem_tpu_torch.sparse.supernode import bsr8_spmv_plain

    n, n_sup, nnzb = sn.n, sn.n_sup, sn.blocks.shape[0]
    k1, k1_scale = (sell_spmv(A.values, A.layout, x),
                    sell_spmv_plain(A.values.abs(), A.layout, x.abs()))
    crow, bcol = sn.ptr.long(), sn.cols.long()
    xp = torch.nn.functional.pad(x, (0, 8 * n_sup - n))
    records = []
    for op, label, launches in ((sn, "f32 blocks", counts["a"]["bsr8_spmv"]),
                                (sn.as_bf16(), "bf16 blocks", counts["c"]["bsr8_spmv_bf16"])):
        blk = op.blocks
        bf16 = blk.dtype == torch.bfloat16
        scale = bsr8_spmv_plain(blk.abs(), op.cols, op.ptr, x.abs())

        def held(yk, yp, scale=scale, bf16=bf16, label=label):
            e = _rel_err(yk, yp, scale)
            _check(e <= 1e-6, f"bsr8_spmv ({label}) vs its twin: {e:.2e}")
            if not bf16:
                e1 = _rel_err(yk, k1, k1_scale)
                print(f"[sn] bsr8_spmv ({label}) vs K1 sell_spmv: {e1:.2e} of each "
                      "row's sum |a x| (tol 1e-5)", flush=True)
                _check(e1 <= 1e-5, f"bsr8_spmv ({label}) vs K1: {e1:.2e}")
            return e

        xl = xp.bfloat16() if bf16 else xp
        lib, note = None, None
        try:
            bsr = torch.sparse_bsr_tensor(crow, bcol, blk, size=(8 * n_sup, 8 * n_sup))
            yl = torch.mv(bsr, xl)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            note = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        else:
            lib = lambda bsr=bsr, xl=xl: torch.mv(bsr, xl)  # noqa: E731
            note = (f"{_rel_err(yl[:n], bsr8_spmv_plain(blk, op.cols, op.ptr, x), scale):.2e}"
                    " of each row's sum |a x| from the twin")
            del yl
        print(f"[sn] cuSPARSE BSR ({label}, torch.sparse_bsr_tensor @ x): {note}", flush=True)
        nbytes = blk.numel() * blk.element_size() + 4 * nnzb + 4 * (n_sup + 1) + 8 * n
        rec = _kernel_record(
            f"bsr8_spmv ({label})", "bsr8_spmv.cu", "sparse/pallas_spmv.py:478",
            lambda op=op: op(x), lambda blk=blk, op=op: bsr8_spmv_plain(blk, op.cols, op.ptr, x),
            lib, (nbytes, 128 * nnzb), launches, [n_sup, nnzb, 8, 8], held,
            dtype="bfloat16 blocks, float32" if bf16 else "float32")
        rec.update(library="cuSPARSE BSR (torch.sparse_bsr_tensor @ x)", library_note=note)
        records.append(rec)
        del scale
    return records


def _reset_all() -> None:
    from arcanefem_tpu_torch.bench_unstructured import reset_launch_counts

    reset_launch_counts()


def _counts_all() -> dict:
    """Every kernel's launch count, and ``slot_sum``: the slot_reduce
    launches of the fixed-order RHS and face-matrix sums."""
    from arcanefem_tpu_torch.bench_unstructured import launch_counts
    from arcanefem_tpu_torch.sparse.slot_reduce import sum_launch_counts

    return {**launch_counts(), **sum_launch_counts()}


def _route_run(tag, mesh, topo, dev, system, ell_iters, **opts):
    """One timed solve of a route with its launch counts, checked (rel <=
    1e-8, true residual <= 1e-4, finite x, iterations within 1 of the ELL
    run on the same system) and printed as a ``[tag]`` line."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut

    _reset_all()
    r = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                         penalty=1e12, timed=True, system=system, **opts)
    torch.cuda.synchronize()
    counts = _counts_all()
    line = {"flags": opts, "spmv_path": r["spmv_path"], "iterations": r["iterations"],
            "ell_iterations": ell_iters, "rel": r["rel"],
            "true_residual": r["true_residual"], "solve_s": r["solve_s"],
            "ms_per_iter": r["solve_s"] / max(r["iterations"], 1) * 1e3,
            "assembly_s": r["assembly_s"],
            **{k: r[k] for k in ("compact_setup_s", "compact_check", "vcycle_compact",
                                 "vcycle_band", "diag_setup_s", "diag_check") if k in r},
            "launches": {k: v for k, v in counts.items() if v}}
    print(f"[{tag}] {json.dumps(line)}", flush=True)
    _check(r["rel"] <= 1e-8, f"[{tag}] {opts}: monitored residual {r['rel']:.3e}")
    _check(r["true_residual"] <= 1e-4,
           f"[{tag}] {opts}: true interior residual {r['true_residual']:.3e}")
    _check(bool(torch.isfinite(r["x"]).all()), f"[{tag}] {opts}: non-finite x")
    _check(abs(r["iterations"] - ell_iters) <= 1,
           f"[{tag}] {opts}: {r['iterations']} iterations, ELL {ell_iters}")
    return r, counts


COMPACT_CONFIGS = {  # phases g-i: bench_unstructured's flags
    "g": dict(spmv="compact"),
    "h": dict(spmv="compact", band_pre=True),
    "i": dict(spmv="compact", band_pre=True, asm_compact=True, asm_coords="batched"),
}


def _global_names(text: str) -> tuple[str, ...]:
    """The names of the ``__global__ void`` functions in CUDA source
    ``text``; a ``__launch_bounds__(...)`` before the name may hold
    parentheses of its own (they are matched, not cut at the first ``)``)."""
    names = []
    for m in re.finditer(r"__global__\s+void\s+", text):
        i = m.end()
        if text.startswith("__launch_bounds__", i):
            i = text.index("(", i)
            depth = 0
            for i in range(i, len(text)):
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                if depth == 0:
                    break
            i += 1
        name = re.match(r"\s*(\w+)\s*\(", text[i:])
        _check(name is not None, f"no name after __global__ at offset {m.start()}")
        names.append(name.group(1))
    return tuple(names)


def _kernel_names(src: str) -> tuple[str, ...]:
    """The ``__global__`` functions of ``arcanefem_tpu_torch/csrc/<src>``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "arcanefem_tpu_torch", "csrc", src)
    with open(path) as fh:
        names = _global_names(fh.read())
    _check(bool(names), f"no __global__ function found in {src}")
    return names


def _record_kernel(name: str, src: str, kernel: str | None = None) -> str:
    """The ``__global__`` function a ``[kernel]`` record times: ``kernel``
    if given, else ``<the record name's first word>_kernel``, else the one
    kernel of ``src``; the check fails when it is not among the kernels
    parsed from ``src`` (the record would read no device time)."""
    names = _kernel_names(src)
    if kernel is None:
        guess = re.match(r"\w+", name).group(0) + "_kernel"
        kernel = guess if guess in names or len(names) != 1 else names[0]
    _check(kernel in names, f"[kernel] {name}: its kernel {kernel} is not among the "
                            f"__global__ functions parsed from {src}: {names}")
    return kernel


def _own_events_ms(events, names, calls: int) -> tuple[float | None, list[int]]:
    """(median ms, [n, calls]) of the n (name, µs) ``events`` whose kernel
    is one of ``names``; the ms is None, not measured, when n is under
    calls / 2 or at least 2 * calls."""
    pattern = re.compile(r"(?<!\w)(?:" + "|".join(names) + r")(?!\w)")
    mine = sorted(us for name, us in events if pattern.search(name))
    ok = calls <= 2 * len(mine) < 4 * calls
    return (mine[len(mine) // 2] / 1e3 if ok else None), [len(mine), calls]


def _device_ms(fn, src: str, calls: int = 20,
               kernel: str | None = None) -> tuple[float | None, list[int]]:
    """(device ms per call, [events traced, events expected]) of fn, whose
    wrapper launches one kernel of ``src`` per call, from torch.profiler
    over ``calls`` calls: only the events of the kernels defined in
    ``src`` are read, and their median duration is the time
    (``_own_events_ms``).  Late in a long run the profiler loses events
    and has returned stray events of other kernels, so a trace that does
    not give a time is taken again, up to three times, and after that
    the time is None.  For kernels longer than the host's ~15 µs per
    launch the CUDA-event time of back-to-back calls is the device time as
    well; for a kernel of a few microseconds the event time measures the
    host's rate of issuing launches, and this is the number to read.
    ``kernel``: read that kernel's events alone (it must be one of
    ``src``'s, or the check fails)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = _kernel_names(src)
    if kernel is not None:
        _check(kernel in names, f"{kernel} is not among the __global__ functions "
                                f"parsed from {src}: {names}")
        names = (kernel,)
    fn()
    torch.cuda.synchronize()
    best: tuple = (None, [0, calls])
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = _own_events_ms([(e.name, e.device_time_total) for e in prof.events()
                              if e.device_type == DeviceType.CUDA], names, calls)
        if got[0] is not None:
            return got
        best = max(best, got, key=lambda r: r[1][0])
    return best


def _fmt_ms(ms: float | None) -> str:
    """A device time for a [kernel] line: its ms, or that none was read."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _kernel_record(name, src, rep_, fk, fp, lib, nbytes_flops, launches, shape,
                   check, dtype="float32", kernel=None):
    """Hold fk() to fp() with ``check`` (returns the held error, raises on
    failure), then time kernel, twin and library call (CUDA events, best of
    3×20; the twin 2×3); one ``kernels`` record.  Its device time reads the
    record's own kernel (``_record_kernel``), which must parse from
    ``src``."""
    import torch

    from arcanefem_tpu_torch.utils.timing import time_op

    kernel = _record_kernel(name, src, kernel)
    yk, yp = fk(), fp()
    torch.cuda.synchronize()
    err = float((yk.double() - yp.double()).abs().max())
    held = check(yk, yp)
    del yk, yp
    ms = time_op(fk, reps=20, outer=3) * 1e3
    pms = time_op(fp, reps=3, outer=2) * 1e3
    lms = time_op(lib, reps=20, outer=3) * 1e3 if lib else None
    dms, events = _device_ms(fk, src, kernel=kernel)
    bms, bby = _bound(*nbytes_flops)
    print(f"[kernel] {name} {shape}: {ms:.4f} ms, device {_fmt_ms(dms)} "
          f"({events[0]} of {events[1]} kernel events traced; bound "
          f"{bms:.4f} ms, {bby}), plain {pms:.3f} ms, library "
          f"{'n/a' if lms is None else f'{lms:.4f} ms'}, max_abs_err {err:.3e} "
          f"({held:.2e} held), launches {launches}", flush=True)
    return {"name": name, "route": "cuda", "source": f"arcanefem_tpu_torch/csrc/{src}",
            "replaces": f"arcanefem_tpu/{rep_}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dms, "device_events": events,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "library_ms": lms,
            "shape": shape, "dtype": dtype}


def _equal(yk, yp) -> float:
    """A gather's check: equal to its plain twin."""
    import torch

    _check(torch.equal(yk, yp), "a gather differs from its plain twin")
    return 0.0


def compact_phase(dev, gen, mesh, topo, res4) -> list[dict]:
    """Phases g-i on phase 4's mesh, operator and AMG hierarchy, the
    compact corners against the split gather's, K2 at route (g)'s CG
    pre-gather and K9a and K9b at their routes' shapes, and the diag
    route's refusal on this system; returns the kernels' records."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut
    from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler, tet_corners_plain
    from arcanefem_tpu_torch.sparse import band_gather as bg
    from arcanefem_tpu_torch.sparse.ell_gather import ell_gather_sum, ell_gather_sum_plain

    system = res4["system"]
    counts = {}
    for key, opts in COMPACT_CONFIGS.items():
        r, counts[key] = _route_run("compact", mesh, topo, dev, system,
                                    res4["iterations"], **opts)
        _check(r["spmv_path"] == "CompactMatrix", f"[compact] {key}: spmv path")
        _check(counts[key]["sell_spmv"] > 0, f"[compact] {key}: K1 never ran")
        del r
    # device time by kernel of one (h) solve (its self-check included)
    def solve_h():
        return solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, system=system, **COMPACT_CONFIGS["h"])

    solve_h()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_h()
    torch.cuda.synchronize()
    _profile(solve_h, os.path.join("build", "profile", "compact_h.txt"),
             time.perf_counter() - t0, groups=SPHERE_GROUPS)
    _check(counts["g"]["band_gather"] == 0 and counts["g"]["ell_gather_sum"] > 0,
           f"[compact] g: K9a ran without --band-pre, or K2 never ran: {counts['g']}")
    _check(counts["h"]["band_gather"] > 0, "[compact] h: K9a never ran")
    # the banded pre-gathers are one launch each: no K2 for their wide tiles,
    # and on (i) K3a only for the 9 assemblies' remap gathers
    for key in "hi":
        _check(counts[key]["ell_gather_sum"] == 0,
               f"[compact] {key}: K2 ran beside the banded pre-gathers: {counts[key]}")
    _check(counts["i"]["band_gather_batched"] > 0, "[compact] i: K9b never ran")
    _check(counts["i"]["ell_gather_sum_batched"] == 9,
           f"[compact] i: K3a ran {counts['i']['ell_gather_sum_batched']} times, not 9")

    # the compact corners equal the split gather's; K9a on the CG operator's
    # pre-gather, K9b on the compact coordinates', each a whole band plan
    # (narrow and wide tiles) in one launch
    conn = mesh.cells["tetra4"]
    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    t0 = time.perf_counter()
    lay = system["A"].layout
    asm_c = TetraAssembler(topo, conn, device=dev, layout=lay, coords_batched=True,
                           coords_compact=True, band_pre=True)
    host_s = time.perf_counter() - t0
    gs = tet_corners_plain(coords, asm_c.corner_cols)
    gc = asm_c.gather_corners(coords)
    same = all(torch.equal(gs[k], gc[k]) for k in range(3))
    cb = asm_c.compact.pre
    print(f"[compact] (i) corners equal to the split gather's: {same}; coordinate "
          f"pre-gather {cb.n_narrow} of {cb.n_tiles} tiles narrow, "
          f"{asm_c.compact.remap.shape[0]} requests, host build {host_s:.1f} s", flush=True)
    _check(same, "(i) compact coordinate gather != split gather")
    del gs, gc

    cg = system[("compact", True)][0]
    band = cg.pre
    n = topo.n_nodes
    print(f"[compact] CG pre-gather: {band.n_narrow} of {band.n_tiles} tiles narrow, "
          f"{band.n_rows} outputs", flush=True)
    x = torch.rand(n, generator=gen, device=dev) * 2 - 1

    def requests(g):
        """Every request of a band plan as plain indices, pads at 0: the
        library call's index."""
        bases, lcols = g._narrow()
        idx = torch.where((lcols >= 0) & (lcols < g.K * 128),
                          bases.long()[:, None] * 128 + lcols.long(), 0).reshape(-1)
        if g.wide_cols is None:
            return idx
        return torch.cat([idx, g.wide_cols.long().clamp(min=0)])

    gidx, cgidx = requests(band), requests(cb)
    nreq, creq = band.n_rows, cb.n_rows
    # K2 as route (g) runs it: the CG operator's pre-gather x[uniq] (the
    # V-cycle's levels and transfers run it at smaller shapes; the count
    # is all of them)
    ucols = system[("compact", False)][0].pre.cols
    uidx = ucols[:, 0].long()
    records = [
        _kernel_record(
            "ell_gather_sum", "ell_gather.cu", "sparse/pallas_spmv.py:444",
            lambda: ell_gather_sum(ucols, x), lambda: ell_gather_sum_plain(ucols, x),
            lambda: x[uidx], (ucols.numel() * 8 + n * 4, 0),
            counts["g"]["ell_gather_sum"], list(ucols.shape), _equal,
            kernel="ell_gather_kernel"),
        _kernel_record(
            "band_gather", "band_gather.cu", "sparse/band_gather.py:52",
            lambda: band(x),
            lambda: bg.banded_gather_plain(*band._narrow(), band.wide_cols, x, band.K),
            lambda: x[gidx], (nreq * 8 + n * 4, 0), counts["h"]["band_gather"],
            [band.n_narrow, band.n_tiles - band.n_narrow, 128], _equal),
        _kernel_record(
            "band_gather_batched (coords)", "band_gather.cu", "sparse/band_gather.py:109",
            lambda: cb.call_batched(coords.T),
            lambda: bg.banded_gather_batched_plain(*cb._narrow(), cb.wide_cols,
                                                   coords.T, cb.K),
            lambda: coords.index_select(0, cgidx), (creq * 16 + n * 12, 0),
            counts["i"]["band_gather_batched"],
            [cb.n_narrow, cb.n_tiles - cb.n_narrow, 128, 3], _equal),
    ]
    del asm_c, x, gidx, cgidx, uidx

    # no fallback: the diag SpMV raises on this (supernode-ordered) system
    try:
        solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32, penalty=1e12,
                         system=system, spmv="diag")
    except ValueError as e:
        print(f"[compact] --spmv diag on the 1.9M system raises: {e}", flush=True)
    else:
        _check(False, "--spmv diag ran on the 1.9M system, where plan_diag declines")
    return records


def _rcm_box(n: int, dev, gen):
    """The 80^3-style RCM box of the JAX tools/bench_spmv.py: W padded to 8,
    random f32 values on the valid slots."""
    import torch

    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh
    from arcanefem_tpu_torch.sparse.topology import build_topology
    from arcanefem_tpu_torch.utils.ordering import rcm_order, renumber_mesh

    mesh = box_tetra_mesh(n, n, n)
    t = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    mesh = renumber_mesh(mesh, rcm_order(mesh.n_nodes, t.row_ptr, t.csr_cols))
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    valid = torch.as_tensor(topo.ell_valid, device=dev)
    vals = torch.rand(valid.shape, generator=gen, device=dev) * valid
    return topo, vals


def diag_phase(dev, gen) -> list[dict]:
    """Phase j: the RCM sphere at 244k, ELL then diag on the same system;
    K10 there and on the 80^3 RCM box beside K1 and CSR torch.mv."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system
    from arcanefem_tpu_torch.sparse.bell import BellMatrix
    from arcanefem_tpu_torch.sparse.diag_spmv import DiagEllMatrix, diag_spmv_plain
    from arcanefem_tpu_torch.sparse.ell_gather import ell_spmv_plain
    from arcanefem_tpu_torch.sparse.sell import SellLayout
    from arcanefem_tpu_torch.utils.timing import time_op

    t0 = time.perf_counter()
    mesh, topo = sphere_cut_system(5.0, 1, order="rcm")
    print(f"[diag] host set-up of the RCM sphere h=5 r=1 ({topo.n_nodes} nodes, "
          f"W={topo.width}) {time.perf_counter() - t0:.1f} s", flush=True)
    _reset_all()
    ell = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32, penalty=1e12,
                           timed=True, order="rcm")
    torch.cuda.synchronize()
    line = {"flags": {"order": "rcm"}, "iterations": ell["iterations"], "rel": ell["rel"],
            "true_residual": ell["true_residual"], "solve_s": ell["solve_s"],
            "ms_per_iter": ell["solve_s"] / ell["iterations"] * 1e3,
            "launches": {k: v for k, v in _counts_all().items() if v}}
    print(f"[diag] {json.dumps(line)}", flush=True)
    _check(ell["rel"] <= 1e-8 and ell["true_residual"] <= 1e-4, "[diag] ELL route residuals")
    r, counts = _route_run("diag", mesh, topo, dev, ell["system"], ell["iterations"],
                           order="rcm", spmv="diag")
    _check(r["spmv_path"] == "DiagEllMatrix" and counts["diag_spmv"] > 0,
           "[diag] K10 never ran on the diag route")
    A = ell["A"]
    t0 = time.perf_counter()
    btopo, bvals = _rcm_box(80, dev, gen)
    print(f"[diag] host set-up of the 80^3 RCM box {time.perf_counter() - t0:.1f} s",
          flush=True)
    blay = SellLayout.build(btopo.ell_cols, btopo.ell_valid, device=dev)
    records = []
    for label, K1, tp in (("sphere h=5 r=1 rcm", A, topo),
                          ("box 80^3 rcm", BellMatrix(blay.from_ell(bvals), blay), btopo)):
        vals = K1.ell_values()
        cols = torch.as_tensor(tp.ell_cols.astype("int32"), device=dev)
        n, W = vals.shape
        t0 = time.perf_counter()
        D = DiagEllMatrix(vals, tp.ell_cols)
        p = D.plan
        print(f"[diag] {label}: {n} x {W}, plan {time.perf_counter() - t0:.1f} s, "
              f"mean probes {float(p.scnt.mean()):.1f}, S {p.n_probes}, window "
              f"{p.window}", flush=True)
        x = torch.rand(n, generator=gen, device=dev) * 2 - 1
        scale = ell_spmv_plain(vals.abs(), cols, x.abs()).double()

        def held(yk, yp, scale=scale):
            e = _rel_err(yk, yp, scale)
            _check(e <= 1e-5, f"diag_spmv at {label}: {e:.2e}")
            return e

        crow = torch.as_tensor(tp.row_ptr, device=dev, dtype=torch.int64)
        csr = torch.sparse_csr_tensor(
            crow, torch.as_tensor(tp.csr_cols, device=dev, dtype=torch.int64),
            vals.reshape(-1)[torch.as_tensor(tp.csr_to_ell, device=dev,
                                             dtype=torch.int64)], size=(n, n))
        rec = _kernel_record(
            f"diag_spmv ({label})", "diag_spmv.cu", "sparse/pallas_spmv_diag.py:158",
            lambda: D.spmv(x),
            lambda: diag_spmv_plain(D.lo, D.c0, D.scnt, D.lcols, D.vals_tiled, x, W),
            lambda: torch.mv(csr, x), (n * W * 8 + n * 8, 2 * n * W),
            counts["diag_spmv"] if label.startswith("sphere") else 0, [n, W], held)
        rec["k1_ms"] = time_op(K1.spmv, x, reps=20, outer=3) * 1e3
        e1 = _rel_err(D.spmv(x), K1.spmv(x), scale)
        print(f"[diag] {label}: K10 {rec['ms']:.4f} ms, K1 on the same operator "
              f"{rec['k1_ms']:.4f} ms, CSR torch.mv {rec['library_ms']:.4f} ms; K10 vs "
              f"K1 {e1:.2e} of each row's sum |a x|", flush=True)
        _check(e1 <= 1e-5, f"K10 vs K1 at {label}")
        records.append(rec)
        del D, x, scale, csr, K1, vals, cols
    del ell, r, A, mesh, topo, btopo, bvals, blay
    return records


def probe_phase(dev) -> list[dict]:
    """The gather probes P1-P3: the probe tool's entry point at (K, G) =
    (160, 64) (P1 and P2 checked against numpy, P3 timed at K = 160 and
    1024) with its launch count, then each probe at K = 160 and 1024 held
    to its twin and timed (tools/probe_gather.py::measure)."""
    from arcanefem_tpu_torch.tools import probe_gather as pg

    pg.reset_launch_counts()
    pg.main(["160", "64"])
    launches = pg.launch_counts()["window_take"]
    print(f"[probe] the probe tool launched window_take {launches} times", flush=True)
    _check(launches > 0, "the probe tool never launched window_take")
    ok = [f(K, 64, dev) for K in (160, 1024) for f in (pg.probe_A, pg.probe_B)]
    _check(all(ok), f"gather probes against numpy: {ok}")
    records = []
    for K in (160, 1024):
        for name, line, mode, nb in (("P1 column take", 19, "column", 1),
                                     ("P2 flat take", 42, "flat", 1),
                                     ("P3 column take over 256 windows", 66, "column", 256)):
            m = pg.measure(mode, K, 64, nb, device=dev)
            _check(m["equal"], f"{name} K={K}: differs from its plain twin")
            win, idx = pg._inputs(nb, K, 64, mode, dev)
            m["device_ms"], m["device_events"] = _device_ms(
                lambda: pg.window_take(win, idx, mode), "window_gather.cu")
            print(f"[probe] {name} K={K} G=64 nb={nb}: {m['ms']:.4f} ms, device "
                  f"{_fmt_ms(m['device_ms'])}, "
                  f"{m['gelem_s']:.2f} Gelem/s, plain {m['plain_ms']:.4f} ms, library "
                  f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms; host "
                  f"{m['host_us']:.2f} us per call, torch.gather {m['gather_host_us']:.2f} "
                  f"us ({'shared memory' if K <= pg.SMEM_MAX_K else 'L1/L2'})", flush=True)
            records.append({
                "name": f"window_take ({name}, K={K})", "route": "cuda",
                "source": "arcanefem_tpu_torch/csrc/window_gather.cu",
                "replaces": f"arcanefem_tpu/tools/probe_gather.py:{line}",
                "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "device_ms": m["device_ms"], "device_events": m["device_events"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": m["library_ms"], "gelem_s": m["gelem_s"],
                "host_us": m["host_us"], "gather_host_us": m["gather_host_us"],
                "window_in": "shared memory" if K <= pg.SMEM_MAX_K else "L1/L2",
                "shape": [nb, K, 64], "dtype": "float32"})
    return records


def _structured_parity(dev, gen) -> None:
    """Phase 6: K4-K8 against their plain twins on the card."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.mesh.structured import StructuredBox
    from arcanefem_tpu_torch.sparse import dia_stencil as ds

    box = StructuredBox(*PARITY_BOX)
    nyp, nzp = ds._pads(box)
    real = torch.zeros((box.nx + 1, nyp, nzp), dtype=torch.bool, device=dev)
    real[:, 1 : box.ny + 2, 1 : box.nz + 2] = True

    def vec():
        return torch.where(real, torch.rand(real.shape, generator=gen,
                                            device=dev) * 2 - 1, 0.0)

    x, b, aux = vec(), vec(), vec()
    for band_major in (False, True):
        shape = (15, box.nx + 1, nyp, nzp) if band_major else (box.nx + 1, 15, nyp, nzp)
        for bdt in (torch.float32, torch.bfloat16):
            bands = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(bdt)
            kw = dict(band_major=band_major, ny=box.ny, nz=box.nz)
            scale = (ds.dia_stencil_plain("spmv", bands.abs(), x.abs(), **kw)
                     + b.abs() + x.abs())
            for mode, extra in (("spmv", {}),
                                ("jacobi", dict(b=b, aux=aux, omega=0.8)),
                                ("residual", dict(b=b, aux=aux))):
                y = ds.dia_stencil(mode, bands, x, **kw, **extra)
                torch.cuda.synchronize()
                e = _rel_err(y, ds.dia_stencil_plain(mode, bands, x, **kw, **extra),
                             scale)
                print(f"[parity] dia_stencil {mode} {str(bdt)[6:]} bands "
                      f"{'band' if band_major else 'x'}-major {box.shape}: {e:.2e} "
                      f"(rtol 1e-5 of sum |band x| + |b| + |x|)", flush=True)
                _check(e <= 1e-5, f"dia_stencil {mode} {bdt} {band_major}")
                _check(bool((y[~real] == 0).all()), f"dia_stencil {mode} pads")

    c3 = torch.as_tensor(box.grid_coords(np.float32, jitter=0.1), device=dev)
    mask = box.boundary_mask(("xmin", "xmax"))
    g = np.where(box.boundary_mask(("xmax",)), 1.0, 0.0)
    mask_p = torch.as_tensor(ds.pad_host_vec(box, mask), device=dev)
    pg_p = torch.as_tensor(ds.pad_host_vec(box, 1e12 * g * mask), device=dev)
    A, Ap = sa.assemble_stiffness_kernel(box, c3), sa.assemble_stiffness_plain(box, c3)
    e, tol = float((A.bands - Ap.bands).abs().max() / Ap.bands.abs().max()), _asm_tol(box)
    print(f"[parity] stencil_assembly stiffness {box.shape}: {e:.2e} of max|band| "
          f"(tol {tol:.2e})", flush=True)
    _check(e <= tol, "stencil assembly, stiffness")
    (Mk, rk), (Mp, rp) = (f(box, c3, mask_p, pg_p, 1e12, 1.0) for f in
                          (sa.assemble_system, sa.assemble_system_plain))
    torch.cuda.synchronize()
    free = torch.as_tensor(~mask, device=dev)
    eb = max(float((Mk.unpad_vec(Mk.bands_p[:, d]) - Mp.unpad_vec(Mp.bands_p[:, d]))[free]
                   .abs().max()) for d in range(15)) / float(Ap.bands.abs().max())
    er = float((Mk.unpad_vec(rk) - Mp.unpad_vec(rp))[free].abs().max()
               / Mp.unpad_vec(rp)[free].abs().max())
    print(f"[parity] stencil_assembly fused with BC {box.shape}: bands {eb:.2e}, "
          f"rhs {er:.2e} on free rows (tol {tol:.2e}); Dirichlet rows equal: "
          f"{torch.equal(Mk.bands_p[:, ds.D0][mask_p > 0], Mp.bands_p[:, ds.D0][mask_p > 0])}",
          flush=True)
    _check(eb <= tol and er <= tol, "stencil assembly, fused")
    _check(torch.equal(rk[mask_p > 0], rp[mask_p > 0]), "fused BC rhs rows")
    _check(bool((rk[~real] == 0).all()) and bool((Mk.bands_p.movedim(1, 0)[:, ~real] == 0).all()),
           "fused assembly pads")


def _asm_tol(box) -> float:
    """K4's tolerance against its plain twin, relative to the largest band
    entry: 4·eps32·n for n hexes along the finest axis.  A float32
    coordinate difference of size h = 1/n carries a relative rounding of
    eps32·n, and the kernel and its twin take the differences in different
    orders (1.1e-4 at n = 224)."""
    return 4 * 1.1920929e-07 * max(box.nx, box.ny, box.nz)


STRUCTURED_GROUPS = {
    "stencil_assembly": "stencil_assembly_kernel",
    "dia_stencil spmv": "dia_stencil_kernel<0,",
    "dia_stencil jacobi": "dia_stencil_kernel<1,",
    "dia_stencil residual (bf16)": "dia_stencil_kernel<2, __nv_bfloat16",
    "dia_stencil residual (f64 replacement)": "dia_stencil_kernel<2, float, double",
    "cat/stack copies": "CatArrayBatchedCopy", "reductions": "reduce_kernel"}
SPHERE_GROUPS = {
    "K1 sell_spmv": "sell_spmv_kernel<float, float>",
    "K1 sell_spmv, bf16 weights": "sell_spmv_kernel<__nv_bfloat16",
    "K2 ell_gather_sum": "ell_gather_kernel", "K9a band_gather": "band_gather_kernel",
    "tet_element": "tet_element_kernel", "block_slot_reduce": "block_slot_reduce_kernel",
    "slot_reduce": "slot_reduce_kernel",
    "K10 diag_spmv": "diag_spmv_kernel", "cat/stack copies": "CatArrayBatchedCopy",
    "bsr8_spmv": "bsr8_spmv_kernel", "reductions": "reduce_kernel"}


def _profile(fn, path: str, wall_s: float, top: int = 12,
             groups: dict = STRUCTURED_GROUPS) -> None:
    """Device time by kernel of one call of fn, from torch.profiler: the
    sum over kernel events, and its share of ``wall_s`` (one unprofiled
    call); the operator table goes to ``path``.  ``groups`` sums kernels by
    the first name fragment they contain."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.device_time_total
            t[1] += 1
    total = max(sum(t for t, _ in by_name.values()), 1e-9)
    print(f"[profile] kernel time of one solve {total / 1e3:.3f} ms in "
          f"{sum(n for _, n in by_name.values())} launches; unprofiled wall "
          f"{wall_s * 1e3:.3f} ms, busy share {total / 1e6 / wall_s:.3f} "
          f"(table: {path})", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile] {t / 1e3:9.3f} ms {t / total:6.1%} {n:5d}x {name[:100]}",
              flush=True)
    sums = {g: [0.0, 0] for g in (*groups, "other (elementwise, copies, fills)")}
    for name, (t, n) in by_name.items():
        g = next((g for g, key in groups.items() if key in name),
                 "other (elementwise, copies, fills)")
        sums[g][0] += t
        sums[g][1] += n
    for g, (t, n) in sums.items():
        print(f"[profile] group {g}: {t / 1e3:.3f} ms {t / total:.1%} {n}x", flush=True)


def cache_phase(dev, mesh, topo, res4, cache_dir: str, cold_builds: int) -> None:
    """[cache]: phase 4's system through the AMG hierarchy's npz cache in
    the fresh directory ``cache_dir``, cold (phase 4's own solve: set-up,
    then saved, ``cold_builds`` SELL layouts built) and warm (loaded here):
    every array of the two hierarchies equal bit for bit, the warm run
    without a SELL layout build, its solve equal to phase 4's, bit for bit;
    then ``[caches]`` (:func:`caches_gate`) on ``cache_dir``.  Removes
    ``cache_dir``."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.bench_unstructured import mesh_key, solve_sphere_cut
    from arcanefem_tpu_torch.sparse.sell import SellLayout

    try:
        builds = SellLayout.builds
        warm = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32,
                                penalty=1e12, cache=os.path.join(cache_dir, mesh_key(5.0, 2)))
        warm_builds = SellLayout.builds - builds
        files = {f: os.path.getsize(os.path.join(cache_dir, f))
                 for f in sorted(os.listdir(cache_dir))}
        caches_gate(cache_dir, 5.0, 2)
    finally:
        shutil.rmtree(cache_dir)
    cold = res4
    Mc, Mw = cold["system"]["M"], warm["system"]["M"]
    same = []
    for role in ("mats", "P", "Pt"):
        for a, b in zip(getattr(Mc, role), getattr(Mw, role), strict=True):
            la, lb = a.layout.to_arrays(), b.layout.to_arrays()
            same.append(torch.equal(a.values, b.values) and la.keys() == lb.keys()
                        and all(np.array_equal(la[k], lb[k]) and la[k].dtype == lb[k].dtype
                                for k in la))
    for a, b in zip(Mc.inv_diags + (Mc.coarse_inv,), Mw.inv_diags + (Mw.coarse_inv,),
                    strict=True):
        same.append(torch.equal(a, b))
    same.append((Mc.omegas, Mc.rhos, Mc.smoother, Mc.cheb_deg, Mc.nu, Mc.cycle)
                == (Mw.omegas, Mw.rhos, Mw.smoother, Mw.cheb_deg, Mw.nu, Mw.cycle))
    line = {"amg_setup_s": [cold["amg_setup_s"], warm["amg_setup_s"]],
            "amg_setup_cached": [cold["amg_setup_cached"], warm["amg_setup_cached"]],
            "sell_layout_builds": [cold_builds, warm_builds],
            "iterations": [cold["iterations"], warm["iterations"]],
            "arrays_equal": all(same), "arrays": len(same),
            "x_equal": torch.equal(cold["x"], warm["x"]), "file_bytes": files}
    print(f"[cache] {json.dumps(line)}", flush=True)
    _check(not cold["amg_setup_cached"] and warm["amg_setup_cached"],
           f"[cache] cached flags {line['amg_setup_cached']}")
    _check(cold_builds > 0 and warm_builds == 0,
           f"[cache] SELL layouts built cold {cold_builds}, warm {warm_builds}")
    _check(all(same), "[cache] the loaded hierarchy differs from the built one")
    _check(cold["iterations"] == warm["iterations"] and line["x_equal"],
           "[cache] the loaded hierarchy does not solve bit for bit like the built one")
    del warm, Mc, Mw


def chunk_unfused_phases(s, res) -> None:
    """[chunk]: the 224^3 bench pass with pcg_chunked, chunk 4 (a multiple
    of 4 iterations, within 4 of pcg's, true residual <= 1e-4) and chunk 1
    (pcg itself: equal bit for bit); [unfused]: the pass with the unfused
    assembly and MG build (K4's stiffness-only mode on every level), 13 ± 1
    iterations, true residual <= 1e-4."""
    import torch

    from arcanefem_tpu_torch.bench_structured import Options, bench_line, solve_mg
    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.sparse import dia_stencil as ds

    iters = res["iterations"]
    for tag, opts in (("chunk", Options(chunk=4)), ("chunk", Options(chunk=1)),
                      ("unfused", Options(fused=False))):
        ds.reset_launch_counts()
        sa.reset_launch_counts()
        r = solve_mg(s, opts=opts)
        torch.cuda.synchronize()
        counts = {**sa.launch_counts(), **ds.launch_counts()}
        line = bench_line(s, r, "mg", opts)  # raises on a failed residual check
        line.update(launches=counts, pcg_iterations=iters,
                    x_equal_pcg=torch.equal(r["x"], res["x"]))
        print(f"[{tag}] {json.dumps(line)}", flush=True)
        k = r["iterations"]
        if opts.chunk == 4:
            _check(k % 4 == 0 and 0 <= k - iters < 4,
                   f"[chunk] chunk 4: {k} iterations, pcg {iters}")
        elif tag == "chunk":
            _check(k == iters and line["x_equal_pcg"],
                   "[chunk] chunk 1 differs from pcg")
        else:
            _check(abs(k - 13) <= 1 and counts["stencil_assembly"] > 0,
                   f"[unfused] {k} iterations, launches {counts}")
        del r


def bench_phase() -> None:
    """[bench]: ``python -m arcanefem_tpu_torch.bench`` once at check size
    (sphere h=8 refine=0, box 64^3) in a fresh cache directory: bench.py's
    keys and metric names, a numeric vs_baseline, the AMG hierarchy built
    (not loaded) and its SELL layouts built.  The second, warm run that
    loaded the hierarchy from the cache went to make room for
    ``[parallel]``; ``[cache]`` holds the same npz cache, cold and warm, at
    1.9M."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory(dir="build") as tmp:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BENCH_", "AFEM_"))}
        env.update(AFEM_CACHE_DIR=tmp, BENCH_UNSTR_H="8", BENCH_UNSTR_REFINE="0",
                   BENCH_N=str(CHECK_N))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch.bench"],
                              env=env, stdout=subprocess.PIPE, text=True, timeout=900)
        _check(proc.returncode == 0, f"[bench] exited {proc.returncode}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[bench] run 1 in {time.perf_counter() - t0:.1f} s: {json.dumps(line)}",
              flush=True)
    box_n = (CHECK_N + 1) ** 3
    ex = line["extra"]
    _check(set(line) == {"metric", "value", "unit", "vs_baseline", "extra"},
           f"[bench] keys {sorted(line)}")
    _check({"secondary_metric", "secondary_value", "secondary_assembly_mdofs",
            "baseline_kind", "baseline_estimate_s", "gpu", "power_limit"} <= set(ex)
           and "error" not in ex, f"[bench] extra keys {sorted(ex)}")
    _check(line["metric"] == f"poisson3d_sphere_cut_{ex['n_dofs'] / 1e6:.1f}MDoF_"
           "assembly+amgpcg_to_1e-08_s"
           and ex["secondary_metric"] == f"poisson3d_box_{box_n / 1e6:.3g}MDoF_"
           "assembly+cg_to_1e-08_s", f"[bench] metric names {line['metric']}, "
           f"{ex['secondary_metric']}")
    _check(isinstance(line["vs_baseline"], float) and line["vs_baseline"] > 0,
           f"[bench] vs_baseline {line['vs_baseline']}")
    _check(ex["amg_setup_cached"] is False and ex["sell_layout_builds"] > 0,
           f"[bench] a fresh cache: cached {ex['amg_setup_cached']}, SELL builds "
           f"{ex['sell_layout_builds']}")


SWEEP_SIZES = (32, 64, 96)  # [sweep]: the JAX sweep's sizes on an accelerator
SWEEP_TIMEOUT = 900


def _sweep_start(log_dir: str):
    """[sweep]'s command, started in a fresh cache directory with the
    headline at [bench]'s check size: (process, its cache directory, the
    TSV path, stdout and stderr files)."""
    import subprocess

    os.makedirs(log_dir, exist_ok=True)
    cache = tempfile.mkdtemp(dir="build")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "AFEM_"))}
    env.update(AFEM_CACHE_DIR=cache, BENCH_UNSTR_H="8", BENCH_UNSTR_REFINE="0",
               BENCH_N=str(CHECK_N))
    tsv = os.path.join(log_dir, "bench_sweep.tsv")
    out = open(os.path.join(log_dir, "stdout.txt"), "w")
    err = open(os.path.join(log_dir, "stderr.txt"), "w")
    cmd = [sys.executable, "-m", "arcanefem_tpu_torch.bench", "--sweep", "--sizes",
           ",".join(map(str, SWEEP_SIZES)), "--devices", "1", "--tsv", tsv]
    return subprocess.Popen(cmd, env=env, stdout=out, stderr=err, text=True), cache, tsv, out, err


def _check_sweep(rows: list[dict], tsv: str, launches: dict,
                 sizes=SWEEP_SIZES, formats=None) -> None:
    """[sweep]'s checks: each format's row at each size with finite,
    positive times; slot_reduce launched by the assembly axis; one P = 1
    devices row, invariant, with its iterations; a headline row with a
    numeric value for each of the PRIMARY and the SECONDARY; one TSV line
    per row under the header."""
    import math

    if formats is None:
        from arcanefem_tpu_torch.testlab import FORMATS as formats
    for n in sizes:
        for f in formats:
            got = [r for r in rows if r.get("axis") == "assembly"
                   and r.get("size") == f"box{n}" and r.get("format") == f]
            _check(len(got) == 1, f"[sweep] {len(got)} rows of {f} at box{n}")
            t, rate = got[0].get("lhs_matrix_assembly_s"), got[0].get("mdof_per_s")
            _check(isinstance(t, float) and math.isfinite(t) and t > 0
                   and isinstance(rate, float) and math.isfinite(rate) and rate > 0,
                   f"[sweep] {f} at box{n}: {t} s, {rate} MDoF/s")
    _check(launches.get("slot_reduce", 0) > 0,
           f"[sweep] the assembly axis launched no slot_reduce: {launches}")
    dev = [r for r in rows if r.get("axis") == "devices"]
    _check(len(dev) == 1 and dev[0].get("devices") == 1 and not dev[0].get("error")
           and dev[0].get("invariant") is True
           and isinstance(dev[0].get("iterations"), int) and dev[0]["iterations"] > 0,
           f"[sweep] devices rows {dev}")
    head = [r for r in rows if r.get("axis") == "headline"]
    for what in ("poisson3d_sphere_cut_", "poisson3d_box_"):
        got = [r for r in head if str(r.get("metric", "")).startswith(what)]
        _check(len(got) == 1 and isinstance(got[0].get("value"), float)
               and math.isfinite(got[0]["value"]) and got[0]["value"] > 0,
               f"[sweep] headline {what}*: {got}")
    lines = tsv.splitlines()
    _check(len(lines) == len(rows) + 1 and lines[0].split("\t")[:2] == ["axis", "size"],
           f"[sweep] {len(lines)} TSV lines for {len(rows)} rows")


def _sweep_finish(started, t0: float) -> None:
    """Wait for [sweep]'s command, print its rows and check them."""
    proc, cache, tsv, out, err = started
    try:
        rc = proc.wait(timeout=SWEEP_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
        shutil.rmtree(cache, ignore_errors=True)
    with open(out.name) as f:
        rows = [json.loads(ln) for ln in f.read().splitlines() if ln.startswith("{")]
    with open(err.name) as f:
        log = f.read()
    for r in rows:
        print(f"[sweep] {json.dumps(r)}", flush=True)
    marks = [ln for ln in log.splitlines() if ln.startswith("[sweep] assembly launches ")]
    launches = json.loads(marks[-1].split("launches ", 1)[1]) if marks else {}
    print(f"[sweep] exit {rc}, done by {time.perf_counter() - t0:.1f} s of [parallel]; "
          "assembly-axis "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})} (its output: "
          f"{os.path.dirname(out.name)})", flush=True)
    _check(rc == 0, f"[sweep] exited {rc}: {log[-2000:]}")
    with open(tsv) as f:
        _check_sweep(rows, f.read(), launches)


def _check_profile_unstr(ms: dict, model: float, measured: float, n_levels: int) -> None:
    """[profile]'s checks of ``profile_unstr.components``: JAX's keys for
    ``n_levels`` operator levels, finite and non-negative, the fine SpMV
    and the V-cycle above zero; a finite model and a measured time."""
    import math

    keys = (["fine_spmv"] + [f"spmv_l{l}" for l in range(1, n_levels)]
            + ["transfer_pair_l0", "cheb_smooth_l0", "vcycle", "precise_dot"])
    _check(list(ms) == keys, f"[profile] unstructured keys {list(ms)}, want {keys}")
    _check(all(isinstance(v, float) and math.isfinite(v) and v >= 0 for v in ms.values())
           and ms["fine_spmv"] > 0 and ms["vcycle"] > 0,
           f"[profile] unstructured times {ms}")
    _check(math.isfinite(model) and model > 0 and math.isfinite(measured) and measured > 0,
           f"[profile] unstructured model {model}, measured {measured}")


def _check_profile_iter(out: dict) -> None:
    """[profile]'s checks of ``profile_iter.run``: both lists, every op
    with a finite, non-negative time, the SpMVs and V-cycles above zero,
    and each list's measured ms per iteration."""
    import math

    from arcanefem_tpu_torch.tools.profile_iter import padded_ops, plain_ops

    for which, ops, positive in (("plain", plain_ops(), ("spmv A@x", "V-cycle apply")),
                                 ("padded", padded_ops(), ("spmv_p", "vcycle apply"))):
        _check(which in out, f"[profile] no {which} list")
        got = out[which]
        ms = got.get("ms", {})
        _check(list(ms) == [name for name, _ in ops], f"[profile] {which} ops {list(ms)}")
        _check(all(isinstance(v, float) and math.isfinite(v) and v >= 0
                   for v in ms.values()) and all(ms[k] > 0 for k in positive),
               f"[profile] {which} times {ms}")
        meas = got.get("measured_ms_per_iter")
        _check(isinstance(meas, float) and math.isfinite(meas) and meas > 0
               and got.get("iterations", 0) > 0,
               f"[profile] {which} measured {meas} ms/iter, {got.get('iterations')} iterations")


def profile_unstr_phase(dev, res) -> None:
    """[profile] on phase 4's operator and hierarchy."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.tools import profile_unstr

    A, M = res["op"], res["M"]
    x0 = torch.as_tensor(np.random.RandomState(0).rand(A.n_nodes), device=dev).float()
    _reset_all()
    ms, model = profile_unstr.components(A, M, x0)
    torch.cuda.synchronize()
    counts = _counts_all()
    system = res["system"]
    meas, iters = profile_unstr.measured_ms_per_iter(A, system["b"], M, system["x0"], 1e-8)
    print(f"[profile] unstructured {A.n_nodes} DoF, levels {res['levels']}: "
          f"{json.dumps(ms)}; model {model:.4f} ms/iter (deg {M._deg(0)}, no dots "
          f"or axpys), measured {meas:.4f} ms/iter over {iters} iterations; the "
          f"probes' launches {json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    _check_profile_unstr(ms, model, meas, len(M.mats))
    _check(counts.get("sell_spmv", 0) > 0, f"[profile] the probes launched no K1: {counts}")


def profile_iter_phase(s) -> None:
    """[profile] on phase 7's box: both of profile_iter's lists."""
    import torch

    from arcanefem_tpu_torch.bench_structured import DEFAULT
    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.sparse import dia_stencil as ds
    from arcanefem_tpu_torch.tools import profile_iter

    ds.reset_launch_counts()
    sa.reset_launch_counts()
    out = profile_iter.run(s, DEFAULT)
    torch.cuda.synchronize()
    counts = {**sa.launch_counts(), **ds.launch_counts()}
    for which, got in out.items():
        print(f"[profile] box {s.box.shape} {which}: {json.dumps(got['ms'])}; measured "
              f"{got['measured_ms_per_iter']:.4f} ms/iter over {got['iterations']} "
              "iterations", flush=True)
    print(f"[profile] box launches {json.dumps(counts)}", flush=True)
    _check_profile_iter(out)
    for k in ("dia_spmv", "dia_sweep", "dia_spmv_p", "dia_jacobi_p", "dia_residual_p"):
        _check(counts.get(k, 0) > 0, f"[profile] {k} never ran in profile_iter: {counts}")


FEM_METHODS = ("Penalty", "WeakPenalty", "RowElimination", "RowColumnElimination")
FEM_2D_N, FEM_3D_N, FEM_DENSE_N = 128, 24, 8  # [fem] F1 mesh sizes
FEM_CLI_WORKERS = 6  # F1's, M1's, B1's and T1's CLI subprocesses at a time
# F1's CLI cases also timed alone: none, to leave room for [parallel]
# (a written case took 7.8-9.2 s alone; PERF.md has the runs)
FEM_CLI_ALONE: tuple = ()


def _fem_cases(root: str) -> list[dict]:
    """F1's meshes and case files (no result file yet): (name, path,
    exact) with exact True where u = x."""
    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
    from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

    os.makedirs(root, exist_ok=True)
    meshes = {"rect": (rect_tria_mesh(FEM_2D_N, FEM_2D_N), "left", "right", "top"),
              "box": (box_tetra_mesh(FEM_3D_N, FEM_3D_N, FEM_3D_N), "xmin", "xmax",
                      "ymax"),
              "tiny": (rect_tria_mesh(FEM_DENSE_N, FEM_DENSE_N), "left", "right", "top")}
    for name, (m, *_g) in meshes.items():
        write_msh(os.path.join(root, f"{name}.msh"), m)
    hypre = {"name": "HypreLinearSystem", "rtol": "1e-10"}
    specs = [(f"{mesh}_{meth}", mesh, meth, None, {}) for mesh in ("rect", "box")
             for meth in FEM_METHODS]
    specs += [("rect_neumann", "rect", "Penalty", hypre,
               dict(codename="Poisson", f=1.0, neumann=True)),
              ("box_hypre", "box", "Penalty", hypre, {}),
              ("rect_poly", "rect", "Penalty",
               {"name": "AlephLinearSystem", "preconditioner": "poly",
                "epsilon": "1e-10"}, {}),
              ("tiny_dense", "tiny", "Penalty",
               {"name": "SequentialBasicLinearSystem"}, {})]
    cases = []
    for name, mesh, meth, ls, extra in specs:
        _m, left, right, top = meshes[mesh]
        path = os.path.join(root, f"{name}.arc")
        write_arc(path, f"{mesh}.msh", codename=extra.get("codename", "Laplace"),
                  f=extra.get("f"), dirichlet=[(left, 0.0, meth), (right, 1.0, meth)],
                  neumann=[(top, 0.5)] if extra.get("neumann") else [],
                  linear_system=ls)
        cases.append({"name": name, "path": path, "exact": "neumann" not in name})
    return cases


def _cli_cases(cases: list[dict], also: tuple = ()) -> set:
    """The names of the written cases (F1, M1, B1, T1) that also run
    through the CLI: in order, each .arc case that brings a codename or a
    solver route (method and preconditioner, as ``load_case`` reads them)
    that no case chosen before it has; and the output cases and ``also``.
    The others run on the CPU and the card only, to keep the script inside
    its time limit."""
    from arcanefem_tpu_torch.fem.arc import load_case

    seen, names = set(), {c["name"] for c in cases if c.get("output")} | set(also)
    for c in cases:
        if c.get("path"):
            arc = load_case(c["path"])
            keys = {arc.codename, (arc.solver.method, arc.solver.preconditioner)}
            if not keys <= seen:
                seen |= keys
                names.add(c["name"])
    return names


def _fem_cli(path: str, alone: bool = False, extra: list | None = None) -> dict:
    """``python -m arcanefem_tpu_torch run path [extra]`` (the card by
    default): exit code, wall seconds and the ``done:`` line's dict.
    ``alone``: the only process at work, in the caller's environment;
    otherwise one of FEM_CLI_WORKERS beside the in-process solves, with two
    host threads each to keep them from crowding the host's cores."""
    import ast
    import subprocess

    t0 = time.perf_counter()
    env = os.environ if alone else dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch", "run", path,
                           *(extra or [])],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=600, env=env)
    done = [m for m in (re.match(r"done: \w+Result (\{.*\})$", ln)
                        for ln in proc.stdout.splitlines()) if m]
    return {"code": proc.returncode, "s": time.perf_counter() - t0,
            "info": ast.literal_eval(done[-1].group(1)) if done else None,
            "stderr": proc.stderr[-2000:]}


def fem_cli_phase(dev) -> None:
    """[fem] F1: each case on the CPU (float64; its u becomes the case's
    golden file), in-process on the card, and the ``_cli_cases`` through
    the CLI in a subprocess: the FEM_CLI_ALONE cases alone first, then the rest
    FEM_CLI_WORKERS at a time while the in-process runs go on."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from arcanefem_tpu_torch.fem.runner import run_case

    cases = _fem_cases(os.path.join("build", "fem_cases"))
    cli_names = _cli_cases(cases)
    for c in cases:
        t0 = time.perf_counter()
        cpu = run_case(c["path"], device="cpu")
        c["cpu_s"] = time.perf_counter() - t0
        c["cpu_u"], c["cpu_iters"] = cpu.u, cpu.iterations
        golden = os.path.abspath(c["path"][:-4] + ".golden.txt")
        np.savetxt(golden, np.column_stack([cpu.problem.mesh.node_uids, cpu.u]),
                   fmt=["%d", "%.17g"])
        with open(c["path"]) as f:
            text = f.read().replace("</fem>", f"  <result-file>{golden}</result-file>\n  </fem>")
        with open(c["path"], "w") as f:
            f.write(text)
        c["x"] = cpu.problem.mesh.coords[:, 0]
    for c in cases:
        if c["name"] in FEM_CLI_ALONE:
            c["cli_alone"] = _fem_cli(c["path"], alone=True)
    with ThreadPoolExecutor(FEM_CLI_WORKERS) as pool:
        clis = [pool.submit(_fem_cli, c["path"]) if c["name"] in cli_names else None
                for c in cases]
        for c in cases:
            _reset_all()
            t0 = time.perf_counter()
            card = run_case(c["path"], device=dev)  # checks the golden file too
            c["card_s"] = time.perf_counter() - t0
            c["launches"] = {k: v for k, v in _counts_all().items() if v}
            c["card_u"], c["card_iters"] = card.u, card.iterations
        for c, fut in zip(cases, clis):
            c["cli"] = fut.result() if fut else None
    for c in cases:
        scale = float(np.abs(c["cpu_u"]).max())
        diff = float(np.abs(c["card_u"] - c["cpu_u"]).max()) / scale
        exact = float(np.abs(c["card_u"] - c["x"]).max()) if c["exact"] else None
        cli = c["cli"]
        line = {"case": c["name"], "n_nodes": len(c["cpu_u"]),
                "iterations": {"cpu": c["cpu_iters"], "card": c["card_iters"],
                               "cli": cli and cli["info"] and cli["info"]["iterations"]},
                "card_vs_cpu": diff, "card_vs_x": exact, "cpu_s": c["cpu_s"],
                "card_s": c["card_s"], "cli_s": cli and cli["s"],
                "cli_code": cli and cli["code"],
                "cli_alone_s": c["cli_alone"]["s"] if "cli_alone" in c else None,
                "launches": c["launches"]}
        print(f"[fem] F1 {json.dumps(line)}", flush=True)
        its = (c["cpu_iters"], c["card_iters"])
        if cli is not None:
            _check(cli["code"] == 0 and cli["info"] is not None,
                   f"[fem] F1 {c['name']}: the CLI exited {cli['code']}: {cli['stderr']}")
            its += (cli["info"]["iterations"],)
        _check(diff <= 1e-9, f"[fem] F1 {c['name']}: card u {diff:.3e} of max|u| "
               "from the CPU's")
        _check(exact is None or exact <= 1e-6,
               f"[fem] F1 {c['name']}: card u {exact} from u = x")
        if "cli_alone" in c:
            alone = c["cli_alone"]
            _check(alone["code"] == 0 and alone["info"] is not None,
                   f"[fem] F1 {c['name']}: the CLI alone exited {alone['code']}: "
                   f"{alone['stderr']}")
            its += (alone["info"]["iterations"],)
        _check(max(its) - min(its) <= 1, f"[fem] F1 {c['name']}: iterations {its}")
        _check(_assemblies(c["launches"]) == 1 and c["launches"].get("sell_spmv", 0) > 0,
               f"[fem] F1 {c['name']}: launches {c['launches']}")
    del cases
    torch.cuda.empty_cache()


def fem_full_width_phase(dev, mesh, res4) -> None:
    """[fem] F2: models/poisson.solve on phase 4's mesh in float32 (see
    the module docstring)."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.fem.bcs import BoundaryConditions, DirichletBC
    from arcanefem_tpu_torch.fem.timer import PhaseTimer
    from arcanefem_tpu_torch.models import poisson
    from arcanefem_tpu_torch.ops import elements
    from arcanefem_tpu_torch.solver.linear_system import SolverOptions
    from arcanefem_tpu_torch.sparse.bell import slot_contributors
    from arcanefem_tpu_torch.sparse.slot_reduce import slot_reduce, slot_reduce_plain

    cfg = poisson.PoissonConfig(
        f=1.0, bcs=BoundaryConditions(dirichlet=[DirichletBC("Cut", 0.0),
                                                 DirichletBC("sphere", 1.0)]),
        solver=SolverOptions(method="cg", preconditioner="amg", rtol=1e-8))
    fixed = np.zeros(mesh.n_nodes, bool)
    fixed[mesh.group_nodes("Cut")] = True
    fixed[mesh.group_nodes("sphere")] = True
    x4 = res4["x"].double().cpu().numpy()
    # float32 only: the [models] electrostatics runs are this system with
    # another source, in float32 and float64
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer(verbose=False)
    _reset_all()
    t0 = time.perf_counter()
    r = poisson.solve(mesh, cfg, dtype=torch.float32, timer=timer, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts_all()
    peak = torch.cuda.max_memory_allocated()
    u = r.u
    scale = float(np.abs(u).max())
    vs4 = float(np.abs(u[~fixed] - x4[~fixed]).max()) / scale
    line = {"dtype": "float32", "n_dofs": int(mesh.n_nodes),
            "n_cells": int(mesh.cells["tetra4"].shape[0]),
            "iterations": r.iterations, "residual": r.residual,
            "true_residual": r.info["true_residual"],
            "free_residual": r.info["free_residual"],
            "amg_setup_s": r.info["precond_setup_s"], "solve_s": r.info["solve_s"],
            "ms_per_iter": r.info["solve_s"] / max(r.iterations, 1) * 1e3,
            "phases_s": timer.stats, "wall_s": wall,
            "peak_mem_gb": peak / 1e9, "base_mem_gb": base / 1e9,
            "vs_phase4": vs4,
            "launches": {k: v for k, v in counts.items() if v}}
    print(f"[fem] F2 {json.dumps(line)}", flush=True)
    _check(_assemblies(counts) == 1 and counts["tet_element"] == 0
           and counts["sell_spmv"] > 0, f"[fem] F2: launches {counts}")
    _check(r.residual <= 1e-8, f"[fem] F2: monitored residual {r.residual:.3e}")
    _check(r.info["free_residual"] <= 1e-6,
           f"[fem] F2: true free-row residual {r.info['free_residual']:.3e}")
    _check(u.shape == (mesh.n_nodes,) and bool(np.isfinite(u).all()),
           f"[fem] F2: u of shape {u.shape}, finite {np.isfinite(u).all()}")
    _check(u.dtype == np.float32, f"[fem] F2: u is {u.dtype}")
    _check(vs4 <= 1e-4, f"[fem] F2: float32 u {vs4:.3e} of max|u| from "
           "phase 4's x on the free nodes")
    # the assembly's reduction at these shapes, kernel against twin
    prob = r.problem
    table = elements.stiffness("tetra4", prob.cell_xyz("tetra4")).reshape(-1)
    ptr, ids = slot_contributors(prob.topo, ["tetra4"], prob.layout)
    yk = slot_reduce(ptr, ids, table.contiguous())
    yp = slot_reduce_plain(ptr, ids, table)
    ulps = float(((yk.double() - yp.double()).abs()
                  / (torch.finfo(torch.float32).eps
                     * yp.double().abs().clamp(min=torch.finfo(torch.float32).tiny))
                  ).max())
    print(f"[fem] F2 assembly: slot_reduce vs slot_reduce_plain on "
          f"{table.numel()} entries into {prob.layout.n_slots} slots: "
          f"{ulps:.2f} ulps", flush=True)
    _check(ulps <= 4, f"[fem] F2 assembly: slot_reduce {ulps:.2f} ulps from "
           "its plain twin")
    del prob, table, ptr, ids, yk, yp, r, u
    torch.cuda.empty_cache()


def fem_phase(dev, mesh, res4) -> None:
    """[fem]: F1 then F2, with the phase's wall time."""
    t0 = time.perf_counter()
    fem_cli_phase(dev)
    t1 = time.perf_counter()
    fem_full_width_phase(dev, mesh, res4)
    print(f"[fem] wall time: F1 {t1 - t0:.1f} s, F2 {time.perf_counter() - t1:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# [testlab]: the assembly-format laboratory (testlab.py, the Testlab
# codename), TetraAssembler's reduce orders and the blocked SpMV (BSR-b)

LAB_WARMING = 5  # L1, L2: run_lab's cache_warming
# L1: bell-scatter (index_add_, float32 atomics in a varying order) against
# the fixed-order values, of their largest |value|: a slot sums at most ~44
# float32 entries, each rounding ≤ 2^-24 of the running sum, so ~3e-6
# bounds it; the fixed-order formats are held bit-equal
LAB_SCATTER_RTOL = 1e-5
LAB_BOX = 224  # L2: dia-stencil (K4 stiffness-only) at 225^3 nodes
LAB_2D_N, LAB_3D_N = 48, 12  # L3: the written cases' rect and box
LAB_CLI_WORKERS = 6  # L3: CLI subprocesses at a time
LAB_BLOCKS = (2, 4)  # L5: BSR-b block sizes
BSR2_WAS = "0.2723-0.2733"  # L5: ms of the b = 2 kernel before the slices (PERF.md)


def _lab_launches(fn) -> dict:
    """Kernel launches of one fn() call by kind, from torch.profiler:
    slot_reduce, index_add (PyTorch's indexFunc kernels), elementwise
    (PyTorch's elementwise kernels, the indexing gathers among them) and
    other, with the call's summed device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"slot_reduce": 0, "index_add": 0, "elementwise": 0, "other": 0}
    busy = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        busy += e.device_time_total
        kind = ("slot_reduce" if "slot_reduce" in e.name else
                "index_add" if "indexFunc" in e.name else
                "elementwise" if "elementwise" in e.name else "other")
        out[kind] += 1
    out["device_ms"] = busy / 1e3
    return out


def _lab_formats(dev, mesh, topo) -> None:
    """[testlab] L1: run_lab on phase 4's mesh and topology, float32, each
    format in its own call (its plan built once, cache_warming 5): its
    lhs-matrix-assembly, MDoF/s, plan seconds, launches of one value-path
    call, peak memory; the five fixed-order formats bit-equal with each
    other and from run to run, bell-scatter within LAB_SCATTER_RTOL."""
    import torch

    from arcanefem_tpu_torch import testlab

    f32 = torch.float32
    report, values = {}, {}
    for name in testlab.FORMATS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = testlab.run_lab(mesh, formats=[name], cache_warming=LAB_WARMING,
                                dtype=f32, device=dev, topo=topo)
        peak = torch.cuda.max_memory_allocated() / 1e9
        report.update(stats["formats"])
        layout = testlab.lab_layout(topo, dev)
        coords, conns = testlab._device_arrays(mesh, f32, dev)

        def value_path(name=name, layout=layout, coords=coords, conns=conns):
            return testlab.FORMATS[name](topo, testlab._mats(coords, conns), f32,
                                         layout).values

        launches = _lab_launches(value_path)
        values[name] = (value_path(), value_path())
        del coords, conns
        line = {"format": name, **stats["formats"][name],
                "plan_s": stats["time_stats"][f"plan:{name}"], "launches": launches,
                "peak_gb": peak, "nbNode": stats["nbNode"], "nbElement": stats["nbElement"],
                "nnz": stats["nnz"], "ell_width": stats["ell_width"]}
        print(f"[testlab] L1 {json.dumps(line)}", flush=True)
        _check(launches["slot_reduce"] == (0 if name == "bell-scatter" else
                                           2 if name == "coo-sorted" else 1),
               f"[testlab] L1 {name}: slot_reduce launches {launches}")
        _check((launches["index_add"] > 0) == (name == "bell-scatter"),
               f"[testlab] L1 {name}: index_add launches {launches}")
    ref = values["bell-segsum"][0]
    for name, (a, b) in values.items():
        _check(a.dtype == f32 and a.shape == ref.shape and bool(torch.isfinite(a).all()),
               f"[testlab] L1 {name}: values {a.dtype} {tuple(a.shape)}")
        if name != "bell-scatter":
            _check(torch.equal(a, ref) and torch.equal(b, ref),
                   f"[testlab] L1 {name}: not bit-equal to bell-segsum, run to run")
    scale = float(ref.abs().max())
    a, b = values["bell-scatter"]
    dist = float((a - ref).abs().max()) / scale
    rerun = float((a - b).abs().max()) / scale
    print(f"[testlab] L1 bit-equal: {', '.join(n for n in values if n != 'bell-scatter')} "
          f"(twice each); bell-scatter {dist:.3e} of max|value| from them (tol "
          f"{LAB_SCATTER_RTOL:g}), {rerun:.3e} between its two runs, "
          f"{int((a != ref).sum())} of {ref.numel()} slots differ", flush=True)
    _check(dist <= LAB_SCATTER_RTOL, f"[testlab] L1 bell-scatter {dist:.3e}")
    for attr in ("_testlab_plans", "_testlab_layouts"):
        topo.__dict__.pop(attr, None)
    del values, ref, a, b


def _lab_box(dev) -> None:
    """[testlab] L2: dia-stencil (K4 stiffness-only) through run_lab at
    LAB_BOX^3 hexes, float32, no topology; K4 held to
    assemble_stiffness_plain by SpMV in float64 (1e-12 of max|y|), as
    cross_validate holds it to BELL."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch import testlab
    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.mesh.structured import StructuredBox

    t0 = time.perf_counter()
    box = StructuredBox(LAB_BOX, LAB_BOX, LAB_BOX)
    mesh = box.to_mesh()
    mesh_s = time.perf_counter() - t0
    sa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = testlab.run_lab(mesh, formats=["dia-stencil"], cache_warming=LAB_WARMING,
                            box=box, device=dev)
    launches = sa.launch_counts()["stencil_assembly"]
    c3d = torch.as_tensor(mesh.coords, device=dev).reshape(box.shape + (3,))
    del mesh
    Ad, Ap = sa.assemble_stiffness_kernel(box, c3d), sa.assemble_stiffness_plain(box, c3d)
    x = torch.as_tensor(np.random.RandomState(0).rand(box.n_nodes), device=dev)
    yd, yp = Ad.spmv(x), Ap.spmv(x)
    err = float((yd - yp).abs().max() / yp.abs().max())
    line = {"format": "dia-stencil", **stats["formats"]["dia-stencil"],
            "nbNode": stats["nbNode"], "nbElement": stats["nbElement"],
            "nnz": stats["nnz"], "ell_width": stats["ell_width"],
            "stencil_assembly_launches": launches, "spmv_vs_plain": err,
            "mesh_s": mesh_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "time_stats": stats["time_stats"]}
    print(f"[testlab] L2 {json.dumps(line)}", flush=True)
    _check(launches == LAB_WARMING + 1, f"[testlab] L2 K4 launches {launches}")
    _check("build-topology" not in stats["time_stats"], "[testlab] L2 built a topology")
    _check(err <= 1e-12, f"[testlab] L2 dia-stencil SpMV {err:.3e} from the plain bands")
    del Ad, Ap, c3d, x, yd, yp


def _lab_cases(root: str) -> list[dict]:
    """L3's case files: a Poisson problem (f = 1.5, u = 0 and 1 on two
    opposite faces by penalty) for each flag of _FLAG_TO_FORMAT on the rect
    and on the box, and the Poisson codename's case of each mesh."""
    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
    from arcanefem_tpu_torch.models.testlab_model import _FLAG_TO_FORMAT
    from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

    os.makedirs(root, exist_ok=True)
    meshes = {"rect": (rect_tria_mesh(LAB_2D_N, LAB_2D_N), "left", "right"),
              "box": (box_tetra_mesh(LAB_3D_N, LAB_3D_N, LAB_3D_N), "xmin", "xmax")}
    cases = []
    for mesh, (m, left, right) in meshes.items():
        write_msh(os.path.join(root, f"{mesh}.msh"), m)
        bcs = [(left, 0.0), (right, 1.0)]
        poisson = os.path.join(root, f"{mesh}_poisson.arc")
        write_arc(poisson, f"{mesh}.msh", codename="Poisson", f=1.5, dirichlet=bcs)
        for flag in _FLAG_TO_FORMAT:
            path = os.path.join(root, f"{mesh}_{flag}.arc")
            write_arc(path, f"{mesh}.msh", codename="Testlab", f=1.5,
                      values={flag: "true"}, dirichlet_bc=bcs)
            cases.append({"name": f"{mesh}_{flag}", "flag": flag, "path": path,
                          "poisson": poisson})
    return cases


def _lab_cli_cases(cases: list[dict]) -> list[dict]:
    """L3's cases that also run through the CLI: the first flag of each
    format, on the rect and the box in turn (the other flags run on the
    CPU and the card only, to keep the script inside its time limit)."""
    from arcanefem_tpu_torch.models.testlab_model import _FLAG_TO_FORMAT

    formats = list(dict.fromkeys(_FLAG_TO_FORMAT.values()))
    first = {fmt: next(f for f, v in _FLAG_TO_FORMAT.items() if v == fmt) for fmt in formats}
    return [c for c in cases if first[_FLAG_TO_FORMAT[c["flag"]]] == c["flag"]
            and c["name"].startswith("box" if formats.index(_FLAG_TO_FORMAT[c["flag"]]) % 2
                                     else "rect")]


def _lab_cli(args: list) -> dict:
    """``python -m arcanefem_tpu_torch *args`` (the card by default), one of
    LAB_CLI_WORKERS: exit code, wall seconds, stdout's last line."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "arcanefem_tpu_torch", *args],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = proc.stdout.strip().splitlines()
    return {"code": proc.returncode, "s": time.perf_counter() - t0,
            "last": lines[-1] if lines else "", "stdout": proc.stdout,
            "stderr": proc.stderr[-2000:]}


def _lab_written(dev) -> None:
    """[testlab] L3: each Testlab case on the CPU (float64; its u becomes
    the golden file), in process on the card and, the first flag of each
    format (on the rect and the box in turn), through ``python -m
    arcanefem_tpu_torch run`` beside the in-process runs; the card's u
    within 1e-9 of the CPU's largest, every flag within 1e-9 of the
    Poisson codename's u of its mesh, iterations ± 1, the launches of the
    format; and ``testlab --box 16 --json`` through the CLI on the card."""
    import ast
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from arcanefem_tpu_torch import testlab
    from arcanefem_tpu_torch.fem.runner import run_case
    from arcanefem_tpu_torch.models.testlab_model import _FLAG_TO_FORMAT

    root = os.path.join("build", "testlab_cases")
    cases = _lab_cases(root)
    poisson = {}
    for c in cases:
        if c["poisson"] not in poisson:
            poisson[c["poisson"]] = run_case(c["poisson"], device="cpu").u
        cpu = run_case(c["path"], device="cpu")
        c["cpu_u"], c["cpu_iters"] = cpu.u, cpu.iterations
        golden = os.path.abspath(c["path"][:-4] + ".golden.txt")
        np.savetxt(golden, np.column_stack([cpu.problem.mesh.node_uids, cpu.u]),
                   fmt=["%d", "%.17g"])
        with open(c["path"]) as f:
            text = f.read().replace("</fem>", f"  <result-file>{golden}</result-file>\n  </fem>")
        with open(c["path"], "w") as f:
            f.write(text)
    cli_cases = _lab_cli_cases(cases)
    lab_json = os.path.join(root, "lab.json")
    with ThreadPoolExecutor(LAB_CLI_WORKERS) as pool:
        clis = {c["name"]: pool.submit(_lab_cli, ["run", c["path"]]) for c in cli_cases}
        lab = pool.submit(_lab_cli, ["testlab", "--box", "16", "--cache-warming", "2",
                                     "--json", lab_json])
        for c in cases:
            _reset_all()
            card = run_case(c["path"], device=dev)  # checks the golden file too
            c["launches"] = {k: v for k, v in _counts_all().items() if v}
            c["card_u"], c["card_iters"] = card.u, card.iterations
        for c in cli_cases:
            c["cli"] = clis[c["name"]].result()
        lab = lab.result()
    for c in cases:
        scale = float(np.abs(c["cpu_u"]).max())
        diff = float(np.abs(c["card_u"] - c["cpu_u"]).max()) / scale
        pu = poisson[c["poisson"]]
        vs_poisson = max(float(np.abs(u - pu).max()) for u in (c["card_u"], c["cpu_u"])) \
            / float(np.abs(pu).max())
        its = [c["cpu_iters"], c["card_iters"]]
        cli = c.get("cli")
        if cli is not None:
            m = re.match(r"done: \w+Result (\{.*\})$", cli["last"])
            _check(cli["code"] == 0 and m is not None,
                   f"[testlab] L3 {c['name']}: the CLI exited {cli['code']}: {cli['stderr']}")
            its.append(ast.literal_eval(m.group(1))["iterations"])
        line = {"case": c["name"], "format": _FLAG_TO_FORMAT[c["flag"]],
                "n_nodes": len(c["cpu_u"]), "iterations": its, "card_vs_cpu": diff,
                "vs_poisson": vs_poisson, "cli_s": cli and cli["s"],
                "launches": c["launches"]}
        print(f"[testlab] L3 {json.dumps(line)}", flush=True)
        _check(diff <= 1e-9, f"[testlab] L3 {c['name']}: card u {diff:.3e} from the CPU's")
        _check(vs_poisson <= 1e-9, f"[testlab] L3 {c['name']}: u {vs_poisson:.3e} from "
               "the Poisson codename's")
        _check(max(its) - min(its) <= 1, f"[testlab] L3 {c['name']}: iterations {its}")
        scatter = _FLAG_TO_FORMAT[c["flag"]] == "bell-scatter"
        _check(_assemblies(c["launches"]) == (0 if scatter else 1)
               and c["launches"].get("sell_spmv", 0) > 0,
               f"[testlab] L3 {c['name']}: launches {c['launches']}")
    _check(lab["code"] == 0, f"[testlab] L3 testlab --box 16: exit {lab['code']}: "
           f"{lab['stderr']}")
    with open(lab_json) as f:
        stats = json.load(f)
    print(f"[testlab] L3 CLI testlab --box 16 (the card): {lab['s']:.1f} s, formats "
          f"{ {k: round(v['lhs-matrix-assembly'] * 1e3, 3) for k, v in stats['formats'].items()} } "
          "ms", flush=True)
    _check(list(stats["formats"]) == [*testlab.FORMATS, "dia-stencil"],
           f"[testlab] L3 testlab --box 16 formats {list(stats['formats'])}")
    del cases
    torch.cuda.empty_cache()


def _lab_reduces(dev, mesh, topo, res4) -> None:
    """[testlab] L4: TetraAssembler with reduce window, segsum and reorder
    on phase 4's sphere and layout: each one slot_reduce over its own list
    order, within 1 float32 ulp per slot of the window route, the
    differing slots counted; each list build and assembly timed."""
    import torch

    from arcanefem_tpu_torch.ops.lane_assembly import REDUCES, TetraAssembler
    from arcanefem_tpu_torch.utils.timing import time_op

    coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
    layout = res4["A"].layout
    ref = None
    for reduce in REDUCES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asm = TetraAssembler(topo, mesh.cells["tetra4"], device=dev, layout=layout,
                             reduce=reduce)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _reset_all()
        v = asm(coords)
        torch.cuda.synchronize()
        counts = _counts_all()
        ms = time_op(asm, coords, reps=5, outer=2) * 1e3
        if ref is None:
            ref = v
        ulp = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))) - ref.abs()
        worst = float(((v - ref).abs() / ulp).max())
        line = {"reduce": reduce, "lists_s": build_s, "assembly_ms": ms,
                "differing_slots": int((v != ref).sum()), "slots": ref.numel(),
                "max_ulps": worst, "launches": {k: c for k, c in counts.items() if c}}
        print(f"[testlab] L4 {json.dumps(line)}", flush=True)
        _check(counts["tet_element"] == 1 and counts["slot_reduce"] == 1,
               f"[testlab] L4 {reduce}: launches {counts}")
        _check(worst <= 1, f"[testlab] L4 {reduce}: {worst} ulps from the window route")
        del asm, v
    torch.cuda.empty_cache()


def _lab_blocked(dev, topo, res4, counts4) -> list[dict]:
    """[testlab] L5: BlockedGather (BSR-b, b in LAB_BLOCKS) on phase 4's
    fine operator, float32: held to its twin (1e-6 of each row's sum
    |a·x|; at b = 2 the twin on its slices and the BSR twin) and to K1
    (1e-5), one launch per call, a ``kernels`` record each beside cuSPARSE
    BSR (``torch.sparse_bsr_tensor`` of the same blocks at the same b,
    times x padded to whole blocks) as the library call; the BSR arrays
    (``csr_to_bsr``) are built here for the BSR twin and cuSPARSE.  The
    b = 2 record adds its slices' σ, slots per block and build seconds; its
    text line also gives the slices' own byte bound and the time of the
    warp-per-block-row kernel it replaced (``BSR2_WAS``, not measured
    here)."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.sparse import blocked as blk
    from arcanefem_tpu_torch.sparse.sell import sell_spmv, sell_spmv_plain

    A = res4["A"]
    n = topo.n_nodes
    ell = A.ell_values().reshape(-1)
    data = ell[torch.as_tensor(topo.csr_to_ell, device=dev).long()]
    x = torch.as_tensor(np.random.RandomState(5).rand(n) * 2 - 1, device=dev).float()
    k1 = sell_spmv(A.values, A.layout, x)
    k1_scale = sell_spmv_plain(A.values.abs(), A.layout, x.abs())
    records = []
    for b in LAB_BLOCKS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks, bcol, bptr, _ = blk.csr_to_bsr(topo.csr_cols, topo.row_ptr, data, n, b=b,
                                               device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = blk.BlockedGather(blocks, bcol, bptr, n, n, len(topo.csr_cols))
        torch.cuda.synchronize()
        build_s, layout_s = time.perf_counter() - t0, time.perf_counter() - t1
        nnzb, nb = blocks.shape[0], bptr.numel() - 1
        scale = blk.bsr_spmv_plain(blocks.abs(), bcol, bptr, x.abs(), n)
        sl = g.slices
        if sl is None:
            twin = lambda bk=blocks, bc=bcol, bp=bptr: blk.bsr_spmv_plain(  # noqa: E731
                bk, bc, bp, x, n)
        else:
            twin = lambda sl=sl: blk.bsr2_slices_plain(sl, x, n)  # noqa: E731

        def held(yk, yp, scale=scale, b=b, g=g, bk=blocks, bc=bcol, bp=bptr):
            e = _rel_err(yk, yp, scale)
            _check(e <= 1e-6, f"bsr_spmv b={b} vs its twin: {e:.2e}")
            if g.slices is not None:
                eb = _rel_err(yk, blk.bsr_spmv_plain(bk, bc, bp, x, n), scale)
                _check(eb <= 1e-6, f"bsr_spmv b={b} vs the BSR twin: {eb:.2e}")
            e1 = _rel_err(yk, k1, k1_scale)
            print(f"[testlab] L5 bsr_spmv b={b} vs K1 sell_spmv: {e1:.2e} of each row's "
                  "sum |a x| (tol 1e-5)", flush=True)
            _check(e1 <= 1e-5, f"bsr_spmv b={b} vs K1: {e1:.2e}")
            blk.reset_launch_counts()
            g(x)
            torch.cuda.synchronize()
            _check(blk.launch_counts() == {"bsr_spmv": 1, "bsr_spmv_bf16": 0},
                   f"bsr_spmv b={b}: one call launched {blk.launch_counts()}")
            return e

        lib, note = None, None
        xp = torch.nn.functional.pad(x, (0, nb * b - n))
        try:
            bsr = torch.sparse_bsr_tensor(bptr.long(), bcol.long(), blocks,
                                          size=(nb * b, nb * b))
            yl = torch.mv(bsr, xp)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            note = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        else:
            lib = lambda bsr=bsr, xp=xp: torch.mv(bsr, xp)  # noqa: E731
            note = f"{_rel_err(yl[:n], g(x), scale):.2e} of each row's sum |a x| from the kernel"
            del yl
        print(f"[testlab] L5 cuSPARSE BSR b={b} (torch.sparse_bsr_tensor @ x): {note}",
              flush=True)
        nbytes = nnzb * (4 * b * b + 4) + 4 * (nb + 1) + 8 * n
        rec = _kernel_record(
            f"bsr_spmv (b={b})", "bsr8_spmv.cu" if sl is None else "bsr2_slice_spmv.cu",
            "sparse/pallas_spmv.py:478", lambda g=g: g(x), twin, lib,
            (nbytes, 2 * b * b * nnzb), counts4.get("bsr_spmv", 0), [nb, nnzb, b, b], held)
        rec.update(library="cuSPARSE BSR (torch.sparse_bsr_tensor @ x)", library_note=note,
                   fill=g.fill, blocks=nnzb, build_s=build_s,
                   replaces_role="K3a's blocked role, arcanefem_tpu/sparse/blocked.py:184")
        if sl is not None:
            rec.update(sigma=sl.sigma, slots=sl.n_slots, slots_per_block=g.slots_per_block,
                       layout_build_s=layout_s)
            perm = 0 if sl.perm is None else 4 * nb
            slot_bound = _bound(sl.n_slots * 20 + perm + 8 * (sl.n_slices + 1) + 8 * n,
                                8 * sl.n_slots)[0]
            print(f"[testlab] L5 bsr_spmv b=2: was {BSR2_WAS} ms (one warp per block row, "
                  f"PERF.md), now {rec['ms']:.4f} ms, device {_fmt_ms(rec['device_ms'])}, "
                  f"{rec['bound_ms'] / rec['ms']:.3f} of its {rec['bound_ms']:.4f} ms bound; "
                  f"slices: sigma {sl.sigma}, {sl.n_slots} slots ({g.slots_per_block:.4f} per "
                  f"block), their own bound {slot_bound:.4f} ms, layout build "
                  f"{layout_s:.3f} s", flush=True)
        print(f"[testlab] L5 bsr_spmv b={b}: {nnzb} blocks, fill {g.fill:.3f}, "
              f"{g.nbytes / 1e9:.3f} GB, build {build_s:.2f} s", flush=True)
        records.append(rec)
        del g, sl, scale, xp, twin, held, blocks, bcol, bptr
        torch.cuda.empty_cache()
    return records


def testlab_phase(dev, mesh, topo, res4, counts4) -> list[dict]:
    """[testlab] L1-L5 (run right after phase 4, on its mesh, topology and
    operator); ``counts4`` the launch counts of phase 4's main path."""
    t0 = time.perf_counter()
    split = {}
    for part, fn, args in (("L1", _lab_formats, (dev, mesh, topo)), ("L2", _lab_box, (dev,)),
                           ("L3", _lab_written, (dev,)),
                           ("L4", _lab_reduces, (dev, mesh, topo, res4)),
                           ("L5", _lab_blocked, (dev, topo, res4, counts4))):
        t1 = time.perf_counter()
        records = fn(*args)
        split[part] = round(time.perf_counter() - t1, 1)
    print(f"[testlab] phase {time.perf_counter() - t0:.1f} s: {split}", flush=True)
    return records


# ---------------------------------------------------------------------------
# [models]: the Fourier, Electrostatics, Acoustics and Aerodynamics models

MODEL_2D_N, MODEL_3D_N, MODEL_P2_2D_N, MODEL_P2_3D_N = 96, 16, 48, 8  # M1 meshes
MODEL_SOLVERS = {
    "aleph": None,  # Jacobi-CG, rtol 1e-12
    "hypre": {"name": "HypreLinearSystem", "rtol": "1e-11"},
    "dense": {"name": "SequentialBasicLinearSystem"},
    **{m: {"name": "AlephLinearSystem", "solver-method": m, "preconditioner": "amg",
           "epsilon": "1e-11"} for m in ("gmres", "bicgstab", "bicgstab2")},
}
# the M1 case whose CLI run also writes the post-processing file
MODEL_OUTPUT_CASE = "es_rect_hypre"
# M2: acoustics runs on the h=5 sphere refined ACOUSTICS_REFINE times, with
# unpreconditioned BiCGStab (the model's forcing) allowed this many iterations
ACOUSTICS_REFINE = 1
ACOUSTICS_MAX_ITER = 20000
FOURIER_QUAD_N = 1414  # M2: 1414^2 quad4 cells, 2,002,225 nodes
P2_SPHERE_REFINE = 0  # M2: the h=5 sphere, quadratized
# M2: electrostatics, aerodynamics and (c)'s Krylov runs on the h=5 sphere at
# this refine (phase 4's, refine=2, before [transient]; cut in depth to make
# room for it)
M2_REFINE = 1


def _model_cases(root: str) -> list[dict]:
    """M1's meshes and case files (no result file yet): name, path,
    codename, the result's field names, and the iteration tolerance
    against the CPU run."""
    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, quadratize, rect_tria_mesh
    from arcanefem_tpu_torch.tools.write_msh import rect_quad_mesh, write_arc, write_msh

    os.makedirs(root, exist_ok=True)
    n2, n3, p2, p3 = MODEL_2D_N, MODEL_3D_N, MODEL_P2_2D_N, MODEL_P2_3D_N
    meshes = {"rect": rect_tria_mesh(n2, n2), "quad": rect_quad_mesh(n2, n2, regions=True),
              "box": box_tetra_mesh(n3, n3, n3), "tria6": quadratize(rect_tria_mesh(p2, p2)),
              "tetra10": quadratize(box_tetra_mesh(p3, p3, p3)),
              "tiny": rect_tria_mesh(8, 8)}
    for name, m in meshes.items():
        write_msh(os.path.join(root, f"{name}.msh"), m)
    faces = {"rect": ("left", "right", "bottom"), "quad": ("left", "right", "bottom"),
             "tria6": ("left", "right", "bottom"), "tiny": ("left", "right", "bottom"),
             "box": ("xmin", "xmax", "zmin"), "tetra10": ("xmin", "xmax", "zmin")}
    es = dict(values={"rho": 1.0, "epsilon": 2.0})
    fo = dict(values={"lambda": 1.5, "qdot": 1.0}, materials=[("west", 2.0), ("east", 0.5)])
    rc = "RowColumnElimination"
    specs = [  # name, mesh, codename, solver, write_arc fields, Dirichlet method
        ("es_rect_hypre", "rect", "Electrostatics", "hypre",
         dict(es, post_processing=["Phi", "E"]), None),
        ("es_box_aleph", "box", "Electrostatics", "aleph", es, None),
        ("es_rect_bicgstab2", "rect", "Electrostatics", "bicgstab2", es, rc),
        ("fo_quad_hypre", "quad", "Fourier", "hypre", fo, None),
        ("fo_quad_gmres", "quad", "Fourier", "gmres", fo, rc),
        ("fo_rect_manufactured", "rect", "Fourier", "aleph",
         dict(values={"lambda": 1.0}, manufactured={"dirichlet": "manufacturedDirichlet",
                                                    "source": "manufacturedSource"}), "none"),
        ("fo_tria6_hypre", "tria6", "Fourier", "hypre", dict(values={"lambda": 2.0}), None),
        ("fo_tetra10_hypre", "tetra10", "Fourier", "hypre", dict(values={"lambda": 1.0}), None),
        ("fo_tetra10_bicgstab", "tetra10", "Fourier", "bicgstab", dict(values={"lambda": 1.0}), rc),
        ("ac_box", "box", "Acoustics", "aleph", dict(values={"kc2": 3.0}), "none"),
        ("ac_tiny_dense", "tiny", "Acoustics", "dense", dict(values={"kc2": 3.0}), "none"),
        ("ae_rect_gmres", "rect", "Aerodynamics", "gmres", {}, "none"),
        ("ae_rect_bicgstab", "rect", "Aerodynamics", "bicgstab", {}, "none"),
        ("ae_box_bicgstab2", "box", "Aerodynamics", "bicgstab2", {}, "none"),
    ]
    cases = []
    for name, mesh, codename, solver, kw, method in specs:
        left, right, other = faces[mesh]
        kw = dict(kw)
        if codename == "Acoustics":
            kw["neumann"] = [(left, 1.0)]
        if codename == "Aerodynamics":
            kw.update(farfield=[(left, 0.1), (right, 0.1)], dirichlet_bc=[(other, 0.0)])
        if method != "none":
            # no Dirichlet 0: a 1e30 penalty row holds ~1e-30 there, which
            # the golden file's relative test (FemUtils.cc:104-236, no
            # floor) cannot hold between two solves
            m = () if method is None else (method,)
            kw["dirichlet"] = [(left, 0.25, *m), (right, 1.0, *m)]
        path = os.path.join(root, f"{name}.arc")
        write_arc(path, f"{mesh}.msh", codename=codename,
                  linear_system=MODEL_SOLVERS[solver], **kw)
        fields = {"Electrostatics": ("phi", "E"), "Aerodynamics": ("u", "psi")}.get(
            codename, ("u",))
        cases.append({"name": name, "path": path, "codename": codename, "fields": fields,
                      # BiCGStab on 1e30 penalty rows and unpreconditioned on
                      # the Helmholtz system: counts set by round-off
                      # (ROADMAP Queue 3), held to 5%
                      "roundoff_count": name in ("ae_rect_bicgstab", "ac_box")})
    return cases


def _field_scale_diff(got, want) -> float:
    """max |got - want| / max |want| over an array or a dict of arrays."""
    import numpy as np

    if isinstance(want, dict):
        got = np.concatenate([np.ravel(got[k]) for k in sorted(want)])
        want = np.concatenate([np.ravel(want[k]) for k in sorted(want)])
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _read_vtk_point_data(path: str, name: str):
    """The SCALARS ``name`` block of a legacy VTK file's POINT_DATA."""
    import numpy as np

    lines = open(path).read().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("POINT_DATA")).split()[1])
    k = lines.index(f"SCALARS {name} double 1")
    return np.array([float(v) for v in lines[k + 2:k + 2 + n]])


def models_cli_phase(dev) -> None:
    """[models] M1: each case on the CPU (float64; its field becomes the
    case's golden file where the codename checks one), in-process on the
    card, and the ``_cli_cases`` through the CLI in a subprocess,
    MODEL_OUTPUT_CASE with --output-dir (its file read back and held to the
    card's field)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from arcanefem_tpu_torch.fem.runner import run_case

    root = os.path.join("build", "model_cases")
    out_dir = os.path.join(root, "out")
    cases = _model_cases(root)
    cli_names = _cli_cases(cases, (MODEL_OUTPUT_CASE,))
    for c in cases:
        t0 = time.perf_counter()
        cpu = run_case(c["path"], device="cpu")
        c["cpu_s"] = time.perf_counter() - t0
        c["cpu"] = {f: getattr(cpu, f) for f in c["fields"]}
        c["cpu_iters"] = cpu.iterations
        c["n_nodes"] = cpu.problem.mesh.n_nodes
        if c["codename"] != "Aerodynamics":  # the one model without a golden check
            golden = os.path.abspath(c["path"][:-4] + ".golden.txt")
            np.savetxt(golden, np.column_stack([cpu.problem.mesh.node_uids,
                                                c["cpu"][c["fields"][0]]]),
                       fmt=["%d", "%.17g"])
            with open(c["path"]) as f:
                text = f.read().replace(
                    "</fem>", f"  <result-file>{golden}</result-file>\n  </fem>")
            with open(c["path"], "w") as f:
                f.write(text)
    with ThreadPoolExecutor(FEM_CLI_WORKERS) as pool:
        clis = [pool.submit(_fem_cli, c["path"], False,
                            ["--output-dir", out_dir] if c["name"] == MODEL_OUTPUT_CASE
                            else []) if c["name"] in cli_names else None
                for c in cases]
        for c in cases:
            _reset_all()
            t0 = time.perf_counter()
            card = run_case(c["path"], device=dev)  # checks the golden file too
            c["card_s"] = time.perf_counter() - t0
            c["launches"] = {k: v for k, v in _counts_all().items() if v}
            c["card"] = {f: getattr(card, f) for f in c["fields"]}
            c["card_iters"] = card.iterations
        for c, fut in zip(cases, clis):
            c["cli"] = fut.result() if fut else None
    for c in cases:
        diffs = {f: _field_scale_diff(c["card"][f], c["cpu"][f]) for f in c["fields"]}
        cli = c["cli"]
        line = {"case": c["name"], "codename": c["codename"], "n_nodes": c["n_nodes"],
                "iterations": {"cpu": c["cpu_iters"], "card": c["card_iters"],
                               "cli": cli and cli["info"] and cli["info"]["iterations"]},
                "card_vs_cpu": diffs, "cpu_s": c["cpu_s"], "card_s": c["card_s"],
                "cli_s": cli and cli["s"], "cli_code": cli and cli["code"],
                "launches": c["launches"]}
        print(f"[models] M1 {json.dumps(line)}", flush=True)
        its = (c["cpu_iters"], c["card_iters"])
        if cli is not None:
            _check(cli["code"] == 0 and cli["info"] is not None,
                   f"[models] M1 {c['name']}: the CLI exited {cli['code']}: {cli['stderr']}")
            its += (cli["info"]["iterations"],)
        _check(max(diffs.values()) <= 1e-9,
               f"[models] M1 {c['name']}: card fields {diffs} of max|.| from the CPU's")
        tol = max(1, c["cpu_iters"] // 20) if c["roundoff_count"] else 1
        _check(max(its) - min(its) <= tol, f"[models] M1 {c['name']}: iterations {its}")
        _check(_assemblies(c["launches"]) == 1 and c["launches"].get("sell_spmv", 0) > 0,
               f"[models] M1 {c['name']}: launches {c['launches']}")
        if c["name"] == MODEL_OUTPUT_CASE:
            phi = c["card"]["phi"]
            hdf, vtk = (os.path.join(out_dir, f"{c['name']}.{e}") for e in ("hdf", "vtk"))
            if os.path.exists(hdf):
                import h5py

                with h5py.File(hdf, "r") as f:
                    back = f["VTKHDF/PointData/Phi"][()]
                path = hdf
            else:
                back, path = _read_vtk_point_data(vtk, "Phi"), vtk
            diff = float(np.abs(back - phi).max() / np.abs(phi).max())
            print(f"[models] M1 --output-dir wrote {sorted(os.listdir(out_dir))}; Phi read "
                  f"back from {os.path.basename(path)}: {diff:.2e} of max|phi| from the "
                  "card's phi", flush=True)
            # the legacy file keeps 10 significant digits
            _check(diff <= (0.0 if path == hdf else 1e-9),
                   f"[models] M1 --output-dir: Phi {diff:.2e} from the card's phi")
    del cases
    torch.cuda.empty_cache()


def _model_line(tag: str, r, counts: dict, peak: float, wall: float, timer=None,
                **extra) -> dict:
    """One M2 line: iterations, monitored and true residuals, solve_s,
    ms/iter, the launches of sell_spmv and slot_reduce, peak memory."""
    line = {"run": tag, "iterations": r.iterations, "residual": r.residual,
            "true_residual": r.info.get("true_residual"),
            "free_residual": r.info.get("free_residual"),
            "precond_setup_s": r.info.get("precond_setup_s"),
            "solve_s": r.info.get("solve_s"),
            "ms_per_iter": r.info["solve_s"] / max(r.iterations, 1) * 1e3,
            "launches": {k: counts.get(k, 0) for k in ("sell_spmv", "slot_reduce")},
            "peak_mem_gb": peak / 1e9, "wall_s": wall, **extra}
    if timer is not None:
        line["phases_s"] = timer.stats
    print(f"[models] M2 {json.dumps(line)}", flush=True)
    return line


def _run_model(tag: str, solve, *args, **kw):
    """solve(*args, **kw) on a fresh launch count and peak-memory mark;
    (result, counts, peak bytes, wall seconds, timer)."""
    import torch

    from arcanefem_tpu_torch.fem.timer import PhaseTimer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer(verbose=False)
    _reset_all()
    t0 = time.perf_counter()
    r = solve(*args, timer=timer, **kw)
    torch.cuda.synchronize()
    return r, _counts_all(), torch.cuda.max_memory_allocated(), time.perf_counter() - t0, timer


def _check_model(tag: str, r, counts: dict, rtol: float, n: int) -> None:
    import numpy as np

    u = getattr(r, "phi", None)
    u = r.u if u is None else u
    _check(r.residual <= rtol, f"[models] M2 {tag}: monitored residual {r.residual:.3e}")
    _check(u.shape == (n,) and bool(np.isfinite(u).all()), f"[models] M2 {tag}: u")
    _check(_assemblies(counts) == 1 and counts["sell_spmv"] > 0
           and counts["tet_element"] == 0, f"[models] M2 {tag}: launches {counts}")


def _aero_system(prob, config):
    """The aerodynamics model's finalized system on ``prob``, its boundary
    conditions set by models/aerodynamics.py: (A, b, x0)."""
    from arcanefem_tpu_torch.models import aerodynamics
    from arcanefem_tpu_torch.ops import elements

    system = prob.new_system(prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz)))
    aerodynamics.apply_boundary_conditions(prob, system, config)
    A, b = system.finalized()
    return A, b, system.initial_guess()


def _krylov_line(tag, fn, A, b, M, x0, rtol, **kw) -> dict:
    """One solve of a Krylov function of solver/iterative.py on a built
    system and preconditioner: its M2 line."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    t0 = time.perf_counter()
    x, k, rel = fn(A, b, M, x0, rtol, 0.0, 1000, **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = _counts_all()
    b64 = b.double()
    A64 = A.with_values(A.values.double())
    true = float(torch.linalg.vector_norm(b64 - A64.spmv(x.double()))
                 / torch.linalg.vector_norm(b64))
    line = {"run": tag, "iterations": k, "residual": rel, "true_residual": true,
            "solve_s": s, "ms_per_iter": s / max(k, 1) * 1e3,
            "launches": {"sell_spmv": counts["sell_spmv"], "slot_reduce": counts["slot_reduce"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[models] M2 {json.dumps(line)}", flush=True)
    _check(rel <= rtol and bool(torch.isfinite(x).all()),
           f"[models] M2 {tag}: residual {rel:.3e}")
    _check(counts["sell_spmv"] > 0, f"[models] M2 {tag}: launches {counts}")
    return line


def models_full_width_phase(dev) -> list[dict]:
    """[models] M2 (the module docstring); returns the record of
    slot_reduce at the tetra10 shapes."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
    from arcanefem_tpu_torch.fem.bcs import (
        BoundaryConditions,
        DirichletBC,
        ManufacturedSolution,
        NeumannBC,
    )
    from arcanefem_tpu_torch.mesh.generate import quadratize
    from arcanefem_tpu_torch.models import acoustics, aerodynamics, electrostatics, fourier
    from arcanefem_tpu_torch.solver import iterative as it
    from arcanefem_tpu_torch.solver.linear_system import SolverOptions
    from arcanefem_tpu_torch.tools.write_msh import rect_quad_mesh

    dirichlet = [DirichletBC("Cut", 0.0), DirichletBC("sphere", 1.0)]
    # (a) electrostatics, Hypre-mapped AMG-CG, E over every cell, on the h=5
    #     refine=M2_REFINE sphere
    emesh = sphere_cut_system(5.0, M2_REFINE)[0]
    for dtype, m in ((torch.float32, emesh), (torch.float64, emesh)):
        cfg = electrostatics.ElectrostaticsConfig(
            rho=1.0, epsilon=1.0, bcs=BoundaryConditions(dirichlet=list(dirichlet)),
            solver=SolverOptions(method="cg", preconditioner="amg", rtol=1e-8))
        tag = f"electrostatics {str(dtype)[6:]}"
        r, counts, peak, wall, timer = _run_model(tag, electrostatics.solve, m, cfg,
                                                  dtype=dtype, device=dev)
        E = r.E["tetra4"]
        _model_line(tag, r, counts, peak, wall, timer, E_shape=list(E.shape),
                    n_nodes=m.n_nodes)
        _check_model(tag, r, counts, 1e-8, m.n_nodes)
        _check(E.shape == (m.cells["tetra4"].shape[0], 3) and bool(np.isfinite(E).all()),
               f"[models] M2 {tag}: E of shape {E.shape}")
        prob64 = r.problem  # the last: float64, for (c)
        del r, E
    # (b) aerodynamics, GMRES(30) + AMG in float32 with the compensated dots
    ae = dict(farfield=[aerodynamics.FarfieldBC("sphere", 0.1)],
              bcs=BoundaryConditions(dirichlet=[DirichletBC("Cut", 0.0)]))
    cfg = aerodynamics.AerodynamicsConfig(**ae, solver=SolverOptions(
        method="gmres", gmres_restart=30, preconditioner="amg", rtol=1e-8))
    r, counts, peak, wall, timer = _run_model("aerodynamics gmres float32", aerodynamics.solve,
                                              emesh, cfg, dtype=torch.float32, device=dev)
    _model_line("aerodynamics gmres float32", r, counts, peak, wall, timer,
                n_nodes=emesh.n_nodes)
    _check_model("aerodynamics gmres float32", r, counts, 1e-8, emesh.n_nodes)
    prob32 = r.problem
    del r, emesh
    # (c) the same system through bicgstab and bicgstab2 + AMG, float32 and
    #     float64, and GMRES again: a profiled solve and its peak memory
    for dtype in (torch.float32, torch.float64):
        # each dtype's problem (topology, SELL layout) from an earlier run
        prob = prob32 if dtype == torch.float32 else prob64
        _reset_all()
        A, b, x0 = _aero_system(prob, cfg)
        t0 = time.perf_counter()
        M = it.make_precond(A, "amg")
        torch.cuda.synchronize()
        print(f"[models] M2 aerodynamics {str(dtype)[6:]}: AMG set-up "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        precise = dtype == torch.float32
        for name in ("bicgstab", "bicgstab2"):
            _krylov_line(f"aerodynamics {name} {str(dtype)[6:]}", getattr(it, name), A, b, M,
                         x0, 1e-8, use_precise_dot=precise)
        if dtype == torch.float32:
            gm = _krylov_line("aerodynamics gmres float32 (built system)", it.gmres, A, b, M,
                              x0, 1e-8, restart=30, use_precise_dot=True)
            _profile(lambda: it.gmres(A, b, M, x0, 1e-8, 0.0, 1000, restart=30,
                                      use_precise_dot=True),
                     os.path.join("build", "profile", "gmres.txt"), gm["solve_s"],
                     groups=SPHERE_GROUPS)
        del A, b, x0, M, prob
    del prob32, prob64
    torch.cuda.empty_cache()
    # (d) Fourier on quad4 cells, two λ regions, the manufactured solution
    qmesh = rect_quad_mesh(FOURIER_QUAD_N, FOURIER_QUAD_N, regions=True)
    fns = fourier.make_standard_functions(1.0)
    ms = ManufacturedSolution(dirichlet=fns["manufacturedDirichlet"],
                              source=fns["manufacturedSource"])

    def quad_fourier(m, device, **kw):
        cfg = fourier.FourierConfig(
            lam=1.0, materials=[("west", 1.0), ("east", 1.0)],
            bcs=BoundaryConditions(manufactured=ms),
            solver=SolverOptions(method="cg", preconditioner="amg", rtol=1e-8))
        return fourier.solve(m, cfg, dtype=torch.float64, device=device, **kw)

    small = rect_quad_mesh(64, 64, regions=True)
    err_small = float(np.abs(quad_fourier(small, "cpu").u
                             - np.sin(small.coords[:, 0]) - np.cos(small.coords[:, 1])).max())
    r, counts, peak, wall, timer = _run_model("fourier quad4 float64", quad_fourier, qmesh,
                                              device=dev)
    err = float(np.abs(r.u - np.sin(qmesh.coords[:, 0]) - np.cos(qmesh.coords[:, 1])).max())
    _model_line("fourier quad4 float64", r, counts, peak, wall, timer, n_nodes=qmesh.n_nodes,
                max_err_vs_exact=err, max_err_vs_exact_64x64_cpu=err_small)
    _check_model("fourier quad4 float64", r, counts, 1e-8, qmesh.n_nodes)
    # the one-point quad4 element's own error (ROADMAP Queue 3), not the solve's
    _check(abs(err - err_small) <= 0.01 * err_small,
           f"[models] M2 fourier quad4: error {err:.4e} against the exact field, "
           f"{err_small:.4e} at 64x64 on the CPU")
    del r, qmesh
    # (e) Fourier on the quadratized sphere (tetra10), AMG-CG, float32, and
    #     slot_reduce at its shapes
    t0 = time.perf_counter()
    pmesh = quadratize(sphere_cut_system(5.0, P2_SPHERE_REFINE)[0])
    host_s = time.perf_counter() - t0
    cfg = fourier.FourierConfig(lam=1.0, bcs=BoundaryConditions(dirichlet=list(dirichlet)),
                                solver=SolverOptions(method="cg", preconditioner="amg",
                                                     rtol=1e-8))
    r, counts, peak, wall, timer = _run_model("fourier tetra10 float32", fourier.solve, pmesh,
                                              cfg, dtype=torch.float32, device=dev)
    _model_line("fourier tetra10 float32", r, counts, peak, wall, timer,
                n_nodes=pmesh.n_nodes, n_cells=int(pmesh.cells["tetra10"].shape[0]),
                mesh_host_s=host_s)
    _check_model("fourier tetra10 float32", r, counts, 1e-8, pmesh.n_nodes)
    rec = _p2_slot_reduce_record(r.problem, counts["slot_reduce"])
    del r, pmesh
    torch.cuda.empty_cache()
    # (f) acoustics, unpreconditioned BiCGStab (the model forces it), float64
    cfg = acoustics.AcousticsConfig(
        kc2=1e-4, bcs=BoundaryConditions(neumann=[NeumannBC("sphere", 1.0)]),
        solver=SolverOptions(method="bicgstab", rtol=1e-8, max_iter=ACOUSTICS_MAX_ITER,
                             fail_action="raise"))
    amesh = sphere_cut_system(5.0, ACOUSTICS_REFINE)[0]
    r, counts, peak, wall, timer = _run_model("acoustics bicgstab float64", acoustics.solve,
                                              amesh, cfg, dtype=torch.float64, device=dev)
    _model_line("acoustics bicgstab float64", r, counts, peak, wall, timer,
                n_nodes=amesh.n_nodes, kc2=1e-4, max_iter=ACOUSTICS_MAX_ITER)
    _check_model("acoustics bicgstab float64", r, counts, 1e-8, amesh.n_nodes)
    del r, amesh
    torch.cuda.empty_cache()
    return [rec]


def _p2_slot_reduce_record(prob, launches: int) -> dict:
    """slot_reduce at the tetra10 model's shapes: its f32 Laplace element
    table (100 entries per cell), the slots and contributor lists of the
    run's layout; held to slot_reduce_plain within 4 ulps and timed beside
    one index_add_ of every entry (a kernels record)."""
    import torch

    from arcanefem_tpu_torch.ops import elements
    from arcanefem_tpu_torch.sparse.bell import slot_contributors
    from arcanefem_tpu_torch.sparse.slot_reduce import slot_reduce, slot_reduce_plain

    table = elements.stiffness("tetra10", prob.cell_xyz("tetra10")).reshape(-1).contiguous()
    ptr, ids = slot_contributors(prob.topo, ["tetra10"], prob.layout)
    n_slots, E = ptr.numel() - 1, ids.numel()
    nc = prob.mesh.cells["tetra10"].shape[0]
    counts = (ptr[1:] - ptr[:-1]).long()
    slot_of = torch.repeat_interleave(torch.arange(n_slots, device=ptr.device), counts,
                                      output_size=E)
    entries = table[ids.long()]
    tiny = torch.finfo(torch.float32).tiny

    def ulps(yk, yp):
        e = float(((yk.double() - yp.double()).abs()
                   / (torch.finfo(torch.float32).eps * yp.double().abs().clamp(min=tiny))).max())
        _check(e <= 4, f"[models] M2 tetra10: slot_reduce {e:.2f} ulps from its twin")
        return e

    rec = _kernel_record(
        "slot_reduce (tetra10)", "tet_assembly.cu", "sparse/pallas_spmv.py:444",
        lambda: slot_reduce(ptr, ids, table), lambda: slot_reduce_plain(ptr, ids, table),
        lambda: torch.zeros(n_slots, device=ptr.device).index_add_(0, slot_of, entries),
        (8 * n_slots + 4 + 4 * E + 4 * table.numel(), E), launches, [n_slots, E], ulps)
    rec["max_contributors"] = int(counts.max())
    rec["cells"] = int(nc)
    rec["ulps"] = ulps(slot_reduce(ptr, ids, table), slot_reduce_plain(ptr, ids, table))
    print(f"[models] M2 tetra10 slot_reduce: {nc} cells, {E} contributors into {n_slots} "
          f"slots, at most {rec['max_contributors']} per slot, {rec['ulps']:.2f} ulps from "
          "its twin", flush=True)
    return rec


def models_phase(dev) -> list[dict]:
    """[models]: M1 then M2, with the phase's wall time."""
    t0 = time.perf_counter()
    models_cli_phase(dev)
    t1 = time.perf_counter()
    recs = models_full_width_phase(dev)
    print(f"[models] wall time: M1 {t1 - t0:.1f} s, M2 {time.perf_counter() - t1:.1f} s",
          flush=True)
    return recs


# ---------------------------------------------------------------------------
# [blocks]: the Bilaplacian, Elasticity and Elastodynamics models (block BELL)

BLOCK_RECT, BLOCK_BOX = (48, 24), (12, 6, 6)  # B1 meshes (tria3 rect, tetra4 box)
BLOCK_DENSE_N = 100  # B2 (d): a 100x100 tria3 rect, 20,402 dofs
BLOCK_MAX_ITER = 40000  # B2 (a): block-Jacobi-CG's iteration cap at 5.68M dofs
# B2 (a), (b): elasticity (block-Jacobi; the rigid-body-mode AMG) on the h=5
# sphere at these refines (2, phase 4's, and 1 before [transient]; cut in
# depth to make room for it)
BLOCK_ELASTICITY_REFINE = 1
BLOCK_AMG_REFINE = 0
# B2 (c): elastodynamics steps on the h=5 refine=1 sphere
BLOCK_ED_STEPS, BLOCK_ED_DT = 10, 0.01
BLOCK_HYPRE = {"name": "HypreLinearSystem", "rtol": "1e-11"}
# B1's dense bilaplacian and round-off-count BiCGStab case: the card's
# fields against the CPU's (LU rounding; different stopping iterates)
BLOCK_DENSE_TOL = 1e-10
BLOCK_GMRES_AMG = {"name": "AlephLinearSystem", "solver-method": "gmres",
                   "preconditioner": "amg", "epsilon": "1e-11"}
# the traction series of B1's and B2 (c)'s CaseTable cases: time, t1, t2, t3
BLOCK_TABLE = [[0.0, 0.0, 0.0, 0.0], [0.02, 0.0, -1.0, 0.2], [0.05, 0.5, -0.5, 0.0],
               [1.0, 0.0, 0.0, 0.0]]


def _block_cases(root: str) -> list[dict]:
    """B1's meshes, traction table and case files (no result file yet):
    name, path (None for the in-process cases), codename, fields, and the
    in-process solve of the cases no .arc field selects."""
    import numpy as np

    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
    from arcanefem_tpu_torch.tools.write_msh import write_arc, write_msh

    inputs = os.path.join(root, "inputs")
    os.makedirs(inputs, exist_ok=True)
    rect = rect_tria_mesh(*BLOCK_RECT, lx=4.0, ly=2.0)
    rect.node_groups["corner"] = np.array(
        [int(np.argmax(rect.coords[:, 0] + rect.coords[:, 1]))])
    write_msh(os.path.join(inputs, "rect.msh"), rect)
    write_msh(os.path.join(inputs, "box.msh"), box_tetra_mesh(*BLOCK_BOX, lx=2.0))
    write_msh(os.path.join(inputs, "square.msh"), rect_tria_mesh(40, 40))
    np.savetxt(os.path.join(root, "traction.txt"), np.array(BLOCK_TABLE))
    el2 = dict(f=(None, -1.0), dirichlet_vector=[("left", (0.0, 0.0))],
               dirichlet_point=[("corner", (None, -0.01))], traction=[("right", (0.5, None))])
    el3 = dict(f=(0.0, 0.0, -1.0), dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))],
               traction=[("xmax", (None, 0.25, None))])
    mat = {"E": 21.0, "nu": 0.28}
    ed = {"E": 100.0, "nu": 0.25, "rho": 1.0, "tmax": 0.1, "dt": 0.01}
    rc = "RowColumnElimination"
    specs = [  # name, mesh, codename, write_arc fields
        ("bl_square_dense", "square.msh", "Bilaplacian",
         dict(f=-1.0, dirichlet_bc=[("left", 0.0), ("right", 0.0), ("top", 0.0)],
              linear_system={"name": "SequentialBasicLinearSystem"})),
        ("el_tria_penalty", "rect.msh", "Elasticity", dict(el2, values=mat)),
        ("el_tria_weak", "rect.msh", "Elasticity",
         dict(el2, values={**mat, "enforce-Dirichlet-method": "WeakPenalty"})),
        ("el_tria_rowelim", "rect.msh", "Elasticity",
         dict(el2, values={**mat, "enforce-Dirichlet-method": "RowElimination"})),
        ("el_tria_rowcol_hypre", "rect.msh", "Elasticity",
         dict(el2, values={**mat, "enforce-Dirichlet-method": rc}, linear_system=BLOCK_HYPRE)),
        ("el_tetra_hypre", "box.msh", "Elasticity",
         dict(el3, values=mat, linear_system=BLOCK_HYPRE)),
        ("el_tetra_rowcol", "box.msh", "Elasticity",
         dict(el3, values={**mat, "enforce-Dirichlet-method": rc})),
        ("el_tetra_gmres_amg", "box.msh", "Elasticity",
         dict(el3, values=mat, linear_system=BLOCK_GMRES_AMG)),
        ("ed_rect_newmark_table", "rect.msh", "Elastodynamics",
         dict(values={**ed, "time-discretization": "Newmark-beta"},
              dirichlet_vector=[("left", (0.0, 0.0))],
              traction=[("right", None, "traction.txt")])),
        ("ed_rect_genalpha_rayleigh", "rect.msh", "Elastodynamics",
         dict(values={**ed, "time-discretization": "Generalized-alpha", "alpm": 0.2,
                      "alpf": 0.4, "etam": 0.01, "etak": 0.001,
                      "enforce-Dirichlet-method": rc},
              dirichlet_vector=[("left", (0.0, 0.0))], traction=[("right", (0.0, -0.5))])),
        ("ed_box_newmark_hypre", "box.msh", "Elastodynamics",
         dict(values={**ed, "f1": 0.0, "f2": -1.0, "etak": 0.002},
              dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))],
              traction=[("xmax", None, "traction.txt")], linear_system=BLOCK_HYPRE)),
        ("ed_box_genalpha_table", "box.msh", "Elastodynamics",
         dict(values={**ed, "time-discretization": "Generalized-alpha", "alpm": 0.1,
                      "alpf": 0.3, "etam": 0.02},
              dirichlet_vector=[("xmin", (0.0, 0.0, 0.0))],
              traction=[("xmax", None, "traction.txt")])),
    ]
    cases = []
    for name, mesh, codename, kw in specs:
        path = os.path.join(inputs, f"{name}.arc")
        write_arc(path, mesh, codename=codename,
                  component_tags=codename == "Elastodynamics", **kw)
        fields = {"Bilaplacian": ("u1", "u2"), "Elastodynamics": ("u", "v", "a")}.get(
            codename, ("u",))
        cases.append({"name": name, "path": path, "codename": codename, "fields": fields,
                      "roundoff_count": "rowelim" in name})
    # the two routes no .arc field selects, in-process on the same files
    cases.append({"name": "el_tetra_block_jacobi", "path": None, "codename": "Elasticity",
                  "fields": ("u",), "roundoff_count": False,
                  "solve": _block_jacobi_solve(os.path.join(inputs, "el_tetra_rowcol.arc"))})
    cases.append({"name": "ed_rect_consistent", "path": None, "codename": "Elastodynamics",
                  "fields": ("u", "v", "a"), "roundoff_count": False,
                  "solve": _consistent_solve(os.path.join(inputs, "ed_rect_newmark_table.arc"))})
    return cases


def _block_jacobi_solve(path: str):
    """A solve(device) of elasticity with the block-Jacobi preconditioner
    (3x3 inverse diagonal blocks) on the case ``path``."""
    def solve(device):
        import dataclasses

        from arcanefem_tpu_torch.fem.arc import load_case, parse_bcs_vector, parse_null_vector
        from arcanefem_tpu_torch.mesh.core import read_msh
        from arcanefem_tpu_torch.models import elasticity

        case = load_case(path)
        cfg = elasticity.ElasticityConfig(
            E=21.0, nu=0.28, f=parse_null_vector(case.fem.findtext("f")),
            bcs=parse_bcs_vector(case.fem),
            solver=dataclasses.replace(case.solver, preconditioner="block-jacobi"))
        return elasticity.solve(read_msh(case.mesh_file), cfg, device=device)
    return solve


def _consistent_solve(path: str):
    """A solve(device) of elastodynamics with the consistent initial
    acceleration on the case ``path``."""
    def solve(device):
        from arcanefem_tpu_torch.fem.arc import load_case
        from arcanefem_tpu_torch.mesh.core import read_msh
        from arcanefem_tpu_torch.models import elastodynamics

        case = load_case(path)
        cfg = elastodynamics.parse_config(case, case.base_dir)
        cfg.initial_acceleration = "consistent"
        cfg.f = (0.0, -1.0)
        cfg.result_file = None  # the golden file is the Newmark case's
        return elastodynamics.solve(read_msh(case.mesh_file), cfg, device=device)
    return solve


def blocks_cli_phase(dev) -> None:
    """[blocks] B1: each case on the CPU (float64; its u, u1 or final u
    becomes the case's golden file where the model checks one), in-process
    on the card, and through the CLI in a subprocess (``_cli_cases``): the
    card's fields within 1e-12 of the CPU's largest, iterations equal (5%
    for BiCGStab, whose counts round-off sets), one block_slot_reduce
    launch per assembled operator, sell_spmv."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from arcanefem_tpu_torch.fem.runner import run_case

    cases = _block_cases(os.path.join("build", "block_cases"))
    cli_names = _cli_cases(cases)

    def run(c, device):
        return c["solve"](device) if c["path"] is None else run_case(c["path"], device=device)

    for c in cases:
        t0 = time.perf_counter()
        cpu = run(c, "cpu")
        c["cpu_s"] = time.perf_counter() - t0
        c["cpu"] = {f: getattr(cpu, f) for f in c["fields"]}
        c["cpu_iters"] = getattr(cpu, "iterations", None)
        c["n_nodes"] = cpu.problem.mesh.n_nodes
        if c["path"] is not None and c["codename"] != "Bilaplacian":
            golden = os.path.abspath(c["path"][:-4] + ".golden.txt")
            u = c["cpu"]["u"]
            np.savetxt(golden, np.column_stack([cpu.problem.mesh.node_uids, u]),
                       fmt=["%d"] + ["%.17g"] * u.shape[1])
            with open(c["path"]) as f:
                text = f.read().replace(
                    "</fem>", f"  <result-file>{golden}</result-file>\n  </fem>")
            with open(c["path"], "w") as f:
                f.write(text)
    with ThreadPoolExecutor(FEM_CLI_WORKERS) as pool:
        clis = [pool.submit(_fem_cli, c["path"]) if c["name"] in cli_names else None
                for c in cases]
        for c in cases:
            _reset_all()
            t0 = time.perf_counter()
            card = run(c, dev)  # checks the golden file too
            c["card_s"] = time.perf_counter() - t0
            c["launches"] = {k: v for k, v in _counts_all().items() if v}
            c["card"] = {f: getattr(card, f) for f in c["fields"]}
            c["card_iters"] = getattr(card, "iterations", None)
        for c, fut in zip(cases, clis):
            c["cli"] = fut.result() if fut else None
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)

    for c in cases:
        scale = max(float(np.abs(v).max()) for v in c["cpu"].values())
        diff = max(float(np.abs(c["card"][f] - c["cpu"][f]).max()) for f in c["fields"]) / scale
        cli = c["cli"]
        line = {"case": c["name"], "codename": c["codename"], "n_nodes": c["n_nodes"],
                "iterations": {"cpu": c["cpu_iters"], "card": c["card_iters"],
                               "cli": cli and cli["info"] and cli["info"].get("iterations")},
                "card_vs_cpu": diff, "cpu_s": c["cpu_s"], "card_s": c["card_s"],
                "cli_s": cli and cli["s"], "cli_code": cli and cli["code"],
                "launches": c["launches"]}
        print(f"[blocks] B1 {json.dumps(line)}", flush=True)
        if cli is not None:
            check(cli["code"] == 0 and cli["info"] is not None,
                  f"{c['name']}: the CLI exited {cli['code']}: {cli['stderr']}")
        # a dense solve is LU's, cuSOLVER's on the card and LAPACK's on the
        # CPU, which pivot and round differently; BiCGStab's round-off-set
        # count stops the two runs at different iterates
        tol = (BLOCK_DENSE_TOL if c["codename"] == "Bilaplacian" or c["roundoff_count"]
               else 1e-12)
        check(diff <= tol, f"{c['name']}: card fields {diff:.3e} of the CPU's largest "
              f"from the CPU's (tolerance {tol:g})")
        its = [c["cpu_iters"], c["card_iters"]]
        if cli is not None and cli["info"] is not None:
            its.append(cli["info"]["iterations"])
        # BiCGStab on the nonsymmetric RowElimination system: its count is
        # set by round-off (ROADMAP Queue 3), held to 10%; the others move
        # by one between runs on the card
        tol = max(1, c["cpu_iters"] // 10) if c["roundoff_count"] else 1
        check(max(its) - min(its) <= tol, f"{c['name']}: iterations {its}")
        n_ops = 3 if c["codename"] == "Elastodynamics" else 1
        check(c["launches"].get("block_slot_reduce") == n_ops
              and _assemblies(c["launches"]) == 0
              and (c["codename"] == "Bilaplacian" or c["launches"].get("sell_spmv", 0) > 0),
              f"{c['name']}: launches {c['launches']}")
    _check(not failed, "[blocks] B1: " + "; ".join(failed))
    del cases
    torch.cuda.empty_cache()


def _block_line(tag: str, r, counts: dict, peak: float, wall: float, timer, **extra) -> dict:
    """One B2 line: iterations, residuals, set-up and solve seconds,
    ms/iter, launches, peak memory, phases."""
    info = getattr(r, "info", {}) or {}
    iters = r.iterations
    line = {"run": tag, "n_nodes": int(r.problem.mesh.n_nodes), "n_dofs": int(r.problem.n_dofs),
            "iterations": iters, "residual": getattr(r, "residual", None),
            "true_residual": info.get("true_residual"),
            "free_residual": info.get("free_residual"),
            "precond_setup_s": info.get("precond_setup_s"), "solve_s": info.get("solve_s"),
            "ms_per_iter": (info["solve_s"] / max(iters, 1) * 1e3) if "solve_s" in info
            else None,
            "launches": {k: counts.get(k, 0) for k in ("sell_spmv", "block_slot_reduce",
                                                       "slot_reduce")},
            "peak_mem_gb": peak / 1e9, "wall_s": wall, "phases_s": timer.stats, **extra}
    print(f"[blocks] B2 {json.dumps(line)}", flush=True)
    return line


def blocks_full_width_phase(dev) -> None:
    """[blocks] B2: (a) elasticity on the h=5 refine=BLOCK_ELASTICITY_REFINE
    sphere (block-Jacobi-CG, float32) and a profiled solve; (b) elasticity
    with AMG and the rigid body modes on the refine=BLOCK_AMG_REFINE
    sphere and (c) elastodynamics on the refine=1 sphere; (d) the dense
    bilaplacian on a 100x100 rect.  The block slot_reduce and K1 records at
    phase 4's 5.68M-DoF block shapes are taken in [transient] T2 (c), on
    passmo's operator of the same mesh and layout."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
    from arcanefem_tpu_torch.fem.bcs import BoundaryConditions, DirichletBC
    from arcanefem_tpu_torch.fem.casetable import CaseTable
    from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
    from arcanefem_tpu_torch.models import bilaplacian, elastodynamics, elasticity
    from arcanefem_tpu_torch.solver.linear_system import SolverOptions, solve_finalized

    fixed = BoundaryConditions(dirichlet=[DirichletBC("Cut", values=(0.0, 0.0, 0.0))])
    # (a) elasticity, block-Jacobi-CG, float32
    smesh = sphere_cut_system(5.0, 1)[0]
    mesh = smesh if BLOCK_ELASTICITY_REFINE == 1 else sphere_cut_system(
        5.0, BLOCK_ELASTICITY_REFINE)[0]
    cfg = elasticity.ElasticityConfig(
        E=1.0, nu=0.3, f=(0.0, 0.0, -1.0), bcs=fixed,
        solver=SolverOptions(method="cg", preconditioner="block-jacobi", rtol=1e-7,
                             max_iter=BLOCK_MAX_ITER, fail_action="raise"))
    r, counts, peak, wall, timer = _run_model("elasticity", elasticity.solve, mesh, cfg,
                                              dtype=torch.float32, device=dev)
    line = _block_line("elasticity block-jacobi float32", r, counts, peak, wall, timer,
                       max_iter=BLOCK_MAX_ITER)
    n = mesh.n_nodes
    # the true free-row limit of PERF.md §2 (float32)
    _check(r.residual <= 1e-7 and r.info["free_residual"] <= 1e-4,
           f"[blocks] B2 (a): residual {r.residual:.3e}, free-row {r.info['free_residual']:.3e}")
    _check(r.u.shape == (n, 3) and bool(np.isfinite(r.u).all()), "[blocks] B2 (a): u")
    _check(counts["block_slot_reduce"] == 1 and _assemblies(counts) == 0
           and counts["sell_spmv"] >= r.iterations, f"[blocks] B2 (a): launches {counts}")
    prob = r.problem
    # one profiled solve of the finalized system (its true residual included)
    system = prob.new_system(prob.assemble_matrix(
        lambda ct, xyz: elasticity.element_blocks(ct, xyz, *elasticity.lame(cfg.E, cfg.nu))),
        cfg.solver)
    system.rhs = prob.vector_source_rhs(system.rhs, cfg.f)
    prob.apply_dirichlet_vector(system, mesh.group_nodes("Cut"), (0.0, 0.0, 0.0),
                                "Penalty", 1e12)
    A, b = system.finalized()
    x0 = system.initial_guess()
    del system
    _profile(lambda: solve_finalized(A, b, cfg.solver, x0),
             os.path.join("build", "profile", "elasticity.txt"), line["solve_s"],
             groups=SPHERE_GROUPS)
    del A, b, x0, prob, r, mesh
    torch.cuda.empty_cache()
    # (b) on the h=5 refine=BLOCK_AMG_REFINE sphere, (c) on the refine=1
    #     sphere
    t0 = time.perf_counter()
    amesh = sphere_cut_system(5.0, BLOCK_AMG_REFINE)[0]
    host_s = time.perf_counter() - t0
    cfg = elasticity.ElasticityConfig(
        E=1.0, nu=0.3, f=(0.0, 0.0, -1.0), bcs=fixed,
        solver=SolverOptions(method="cg", preconditioner="amg", rtol=1e-7,
                             fail_action="raise"))
    r, counts, peak, wall, timer = _run_model("elasticity amg", elasticity.solve, amesh, cfg,
                                              dtype=torch.float32, device=dev)
    _block_line("elasticity amg+rbm float32", r, counts, peak, wall, timer,
                mesh_host_s=host_s, amg_setup_s=r.info["precond_setup_s"],
                amg_rows=r.info["amg_rows"])
    _check(r.residual <= 1e-7 and bool(np.isfinite(r.u).all()), "[blocks] B2 (b): residual")
    del r, amesh
    table = CaseTable(np.array(BLOCK_TABLE)[:, 0], np.array(BLOCK_TABLE)[:, 1:])
    ecfg = elastodynamics.ElastodynamicsConfig(
        tmax=BLOCK_ED_STEPS * BLOCK_ED_DT, dt=BLOCK_ED_DT, rho=1.0, E=100.0, nu=0.3,
        bcs=fixed, tractions=[elastodynamics.TractionTBC("sphere", table=table)],
        solver=SolverOptions(method="cg", preconditioner="jacobi", rtol=1e-7,
                             max_iter=BLOCK_MAX_ITER, fail_action="raise"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from arcanefem_tpu_torch.fem.timer import PhaseTimer

    timer = PhaseTimer(verbose=False)
    _reset_all()
    t0 = time.perf_counter()
    r = elastodynamics.solve(smesh, ecfg, dtype=torch.float32, timer=timer, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts_all()
    eline = {"run": "elastodynamics newmark jacobi float32", "n_nodes": int(smesh.n_nodes),
             "n_dofs": int(r.problem.n_dofs), "steps": r.steps, "iterations": r.iterations,
             "launches": {k: counts.get(k, 0) for k in ("sell_spmv", "block_slot_reduce")},
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall,
             "phases_s": timer.stats,
             "max_abs_u": float(np.abs(r.u).max()), "max_abs_v": float(np.abs(r.v).max())}
    print(f"[blocks] B2 {json.dumps(eline)}", flush=True)
    _check(r.steps == BLOCK_ED_STEPS and all(bool(np.isfinite(a).all()) for a in (r.u, r.v, r.a))
           and float(np.abs(r.u).max()) > 0, "[blocks] B2 (c): the state")
    _check(counts["block_slot_reduce"] == 3, f"[blocks] B2 (c): launches {counts}")
    del r, smesh
    torch.cuda.empty_cache()
    # (d) the dense bilaplacian
    dmesh = rect_tria_mesh(BLOCK_DENSE_N, BLOCK_DENSE_N)
    bcfg = bilaplacian.BilaplacianConfig(
        f=-1.0, bcs=BoundaryConditions(dirichlet=[DirichletBC(g, 0.0) for g in
                                                  ("left", "right", "top", "bottom")]))
    r, counts, peak, wall, timer = _run_model("bilaplacian", bilaplacian.solve, dmesh, bcfg,
                                              dtype=torch.float64, device=dev)
    bline = {"run": "bilaplacian dense float64", "n_dofs": int(r.problem.n_dofs),
             "peak_mem_gb": peak / 1e9, "wall_s": wall, "phases_s": timer.stats,
             "launches": {k: counts.get(k, 0) for k in ("block_slot_reduce",)},
             "min_u1": float(r.u1.min()), "max_u1": float(r.u1.max())}
    print(f"[blocks] B2 {json.dumps(bline)}", flush=True)
    _check(r.problem.n_dofs == 2 * (BLOCK_DENSE_N + 1) ** 2
           and bool(np.isfinite(r.u1).all() and np.isfinite(r.u2).all()),
           "[blocks] B2 (d): u1, u2")
    del r, dmesh
    torch.cuda.empty_cache()


# block_slot_reduce before its redesign (the slot-map kernel), the ranges
# in PERF.md's kernel table: chip_smoke on NVIDIA H100 80GB HBM3, 700 W
BLOCK_SLOT_WAS_B3 = {"ms": [6.5238, 6.5693], "device_ms": [6.2363, 6.3327],
                     "plain_ms": [287.4, 289.7], "library_ms": [12.22, 12.28]}
BLOCK_SLOT_WAS_B2 = {"ms": [0.8779, 0.8963], "device_ms": [0.7384, 0.7515],
                     "plain_ms": [58.98, 59.36], "library_ms": [1.4616, 1.4682]}


def _block_was(was: dict, rec: dict, table) -> None:
    """Print the slot-map kernel's times (ranges from PERF.md) beside this
    run's, and one streaming read of the table (``table.sum()``, CUDA
    events) as the yardstick of the kernel's table reads.  They stay out of
    the ``kernels`` record, which holds only this run's measurements and
    bounds."""
    from arcanefem_tpu_torch.utils.timing import time_op

    read_ms = time_op(lambda: table.sum(), reps=20, outer=3) * 1e3
    print(f"[kernel] {rec['name']} was (slot-map kernel, PERF.md): "
          f"{was['ms'][0]}-{was['ms'][1]} ms, device {was['device_ms'][0]}-"
          f"{was['device_ms'][1]}; now {rec['ms']:.4f} ms, device "
          f"{_fmt_ms(rec['device_ms'])}, {rec['bound_ms'] / rec['ms']:.3f} of its "
          f"{rec['bound_ms']:.4f} ms bound by events"
          + ("" if rec["device_ms"] is None else
             f", {rec['bound_ms'] / rec['device_ms']:.3f} by device time")
          + f"; one read of its {table.numel() * table.element_size() / 1e9:.3f} GB "
          f"table (table.sum()) {read_ms:.4f} ms", flush=True)


def _block_records(prob, counts: dict, cfg) -> list[dict]:
    """The block slot_reduce and K1 records at phase 4's 5.68M-DoF block
    shapes (``prob``: T2 (c)'s passmo problem): the
    f32 elasticity table of the sphere into its expanded SELL slots
    (0 ulps from the twin, bit-equal from run to run, beside one
    index_add_ of every contributor's 9 entries), and K1 on the assembled
    5.68M-row operator (beside CSR torch.mv)."""
    import torch

    from arcanefem_tpu_torch.models import elasticity
    from arcanefem_tpu_torch.sparse.sell import sell_spmv, sell_spmv_plain
    from arcanefem_tpu_torch.sparse.slot_reduce import block_slot_reduce, block_slot_reduce_plain

    asm = prob.block_assembly
    lam, mu2 = elasticity.lame(cfg.E, cfg.nu)
    table = elasticity.element_blocks("tetra4", prob.cell_xyz("tetra4"), lam, mu2)
    table = table.reshape(-1).contiguous()
    ptr, ids, row_ptr, lay = asm.ptr, asm.ids, asm.row_ptr, asm.layout
    n_ns, E = ptr.numel() - 1, ids.numel()

    def fk():
        return block_slot_reduce(ptr, ids, table, row_ptr, lay, 3)

    def fp():
        return block_slot_reduce_plain(ptr, ids, table, row_ptr, lay, 3)

    def exact(yk, yp):
        _check(torch.equal(yk, yp), "[blocks] block_slot_reduce differs from its twin")
        _check(torch.equal(yk, fk()), "[blocks] block_slot_reduce differs from run to run")
        return 0.0

    node_slot = torch.repeat_interleave(torch.arange(n_ns, device=ptr.device),
                                        (ptr[1:] - ptr[:-1]).long(), output_size=E)
    entries = table.view(-1, 9)[ids.long()]

    def lib():
        return torch.zeros((n_ns, 9), device=ptr.device).index_add_(0, node_slot, entries)

    rec = _kernel_record(
        "block_slot_reduce (elasticity b=3)", "tet_assembly.cu",
        "sparse/pallas_spmv.py:444", fk, fp, lib,
        (36 * n_ns + 4 * (n_ns + 1) + 4 * E + 4 * table.numel(), 9 * E),
        counts["block_slot_reduce"], [n_ns, E, 9], exact)
    rec.update(node_slots=n_ns, contributors=E, out_slots=lay.n_slots, ulps=0.0,
               max_contributors=int((ptr[1:] - ptr[:-1]).max()),
               replaces_note="JAX sums the blocks with XLA segment_sum "
                             "(arcanefem_tpu/sparse/bell.py:124-136); K2's "
                             "window-reducer role is this kernel's")
    _block_was(BLOCK_SLOT_WAS_B3, rec, table)
    del entries, node_slot, table
    torch.cuda.empty_cache()
    # K1 on the assembled block operator
    A = prob.assemble_matrix(lambda ct, xyz: elasticity.element_blocks(ct, xyz, lam, mu2))
    lay = A.layout
    rows = lay.n_rows
    gen = torch.Generator(device=A.values.device).manual_seed(13)
    x = torch.rand(rows, generator=gen, device=A.values.device) * 2 - 1
    topo = prob.topo
    ell = A.ell_values()
    real = torch.as_tensor(lay.ell_to_sell >= 0, device=x.device).view(rows, -1)
    crow = torch.zeros(rows + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(real.sum(1), 0, out=crow[1:])
    ccols = torch.as_tensor(lay.ell_cols, device=x.device)[real].long()
    csr = torch.sparse_csr_tensor(crow, ccols, ell[real], size=(rows, rows))
    del ell, real, ccols
    nnz = lay.nnz

    def k1_check(yk, yp):
        scale = sell_spmv_plain(A.values.abs(), lay, x.abs())
        e = float(((yk.double() - yp.double()).abs()
                   / scale.double().clamp(min=1e-300)).max())
        _check(e <= 1e-5, f"[blocks] K1 on the block operator: {e:.2e}")
        return e

    k1 = _kernel_record(
        "sell_spmv (elasticity b=3)", "sell_spmv.cu", "sparse/pallas_spmv.py:398",
        lambda: sell_spmv(A.values, lay, x), lambda: sell_spmv_plain(A.values, lay, x),
        lambda: torch.mv(csr, x), (8 * nnz + 12 * rows, 2 * nnz),
        counts["sell_spmv"], [rows, lay.width], k1_check)
    k1.update(nnz=nnz, slots=lay.n_slots, sigma=lay.sigma, node_nnz=topo.nnz,
              library="CSR torch.mv")
    print(f"[blocks] K1 on the block operator: {rows} rows, {nnz} nonzeros, {lay.n_slots} "
          f"SELL slots ({lay.n_slots / nnz:.4f} per nonzero, sigma {lay.sigma})", flush=True)
    del A, csr, x
    torch.cuda.empty_cache()
    return [rec, k1]


def blocks_phase(dev) -> None:
    """[blocks]: B1 then B2, with the phase's wall time."""
    t0 = time.perf_counter()
    blocks_cli_phase(dev)
    t1 = time.perf_counter()
    blocks_full_width_phase(dev)
    print(f"[blocks] wall time: B1 {t1 - t0:.1f} s, B2 {time.perf_counter() - t1:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# [transient]: the Heat, Soildynamics and Passmo models, the fixed-order
# RHS and face-matrix sums

TRANS_RECT = (32, 16)  # T1's tria3 rect (heat, soildynamics)
TRANS_BOX = (6, 4, 4)  # T1's tetra4 box (passmo)
TRANS_MIXED = (3, 2)  # T1's mixed hexa8/pyramid5/penta6/tetra4 box (passmo)
TRANS_HEAT_N = 1414  # T2 (a), (b): a 1414x1414 tria3 rect, 2,002,225 nodes
TRANS_STEPS = 10  # T2's steps
# T1's and T2 (b)'s traction series (time, t1, t2, t3) and double-couple
# force series (time, f)
TRANS_TABLE = [[0.0, 0.0, 0.0, 0.0], [0.02, 0.0, -1.0, 0.2], [0.05, 0.5, -0.5, 0.0],
               [1.0, 0.0, 0.0, 0.0]]
TRANS_SOURCE = [[0.0, 0.0], [0.02, 1.0], [0.05, -0.5], [1.0, 0.0]]
# T1 passmo curves (time, x, y, z)
TRANS_CURVE = [[0.0, 0.0, 0.0, 0.0], [0.05, 1e-3, -2e-3, 0.0], [1.0, 0.0, 1e-3, 5e-4]]
TRANS_CARD_TOL = 1e-12  # T1: the card's fields from the CPU's, of the CPU's largest
# T2 (a): the last step's free-row residual, float32 and float64, and the
# float32 T from the float64 T (of its largest).  float32 holds the mass
# term M/dt, ~h²/dt of the stiffness at h = 1/1414, to few digits (PERF.md
# §5 has the readings these limits were set from)
HEAT_FREE_F32 = 1e-2
HEAT_FREE_F64 = 1e-4
HEAT_FIELD_F32 = 1e-1
TRANS_ATOMICS = ("index_add", "index_add_", "scatter_add", "scatter_add_")


def _nearest_nodes(mesh, points) -> dict:
    """Node groups of one node each: the mesh node nearest each (x, y)."""
    import numpy as np

    return {name: np.array([int(np.argmin(np.hypot(mesh.coords[:, 0] - x,
                                                    mesh.coords[:, 1] - y)))])
            for name, (x, y) in points.items()}


def _transient_cases(root: str) -> list[dict]:
    """T1's meshes, tables and case files (no result file yet): name, path
    (None for the in-process resume), codename, the fields held, dt."""
    import numpy as np

    from arcanefem_tpu_torch.mesh.generate import box_tetra_mesh, rect_tria_mesh
    from arcanefem_tpu_torch.tools.write_msh import mixed_box_mesh, write_arc, write_msh

    inputs = os.path.join(root, "inputs")
    os.makedirs(inputs, exist_ok=True)
    rect = rect_tria_mesh(*TRANS_RECT, lx=2.0, ly=1.0)
    rect.node_groups.update(_nearest_nodes(rect, {"N": (1.0, 0.5625), "S": (1.0, 0.4375),
                                                  "E": (1.0625, 0.5), "W": (0.9375, 0.5)}))
    write_msh(os.path.join(inputs, "rect.msh"), rect)
    box = box_tetra_mesh(*TRANS_BOX, lx=1.5)
    box.cell_groups["vol"] = {"tetra4": box.cells["tetra4"]}
    write_msh(os.path.join(inputs, "box.msh"), box)
    write_msh(os.path.join(inputs, "mixed.msh"), mixed_box_mesh(*TRANS_MIXED))
    np.savetxt(os.path.join(root, "traction.txt"), np.array(TRANS_TABLE))
    np.savetxt(os.path.join(root, "source.txt"), np.array(TRANS_SOURCE))
    np.savetxt(os.path.join(root, "curve.txt"), np.array(TRANS_CURVE))
    # tmax between two step times: the loop runs while t < tmax, and t sums dt
    heat = {"lambda": 1.5, "dt": 0.05, "tmax": 0.475, "Tinit": 0.25}
    soil = {"tmax": 0.1, "dt": 0.01, "rho": 2.0, "E": 50.0, "nu": 0.25}
    parax = [("paraxial-boundary-condition", {"surface": s}) for s in ("left", "right", "bottom")]
    dc = ("double-couple", {"north-node-name": "N", "south-node-name": "S",
                            "east-node-name": "E", "west-node-name": "W",
                            "double-couple-input-file": "source.txt"})
    conv = ("convection-boundary-condition", {"surface": "right", "h": 3.0, "Text": 0.5})
    rinf = 0.5
    am, af = (2 * rinf - 1) / (rinf + 1), rinf / (rinf + 1)
    mixed_blocks = [
        ("dirichlet-surface-condition", {"surface": "zmin", "Ux": 0.0, "Uy": 0.0, "Uz": 0.0}),
        ("dirichlet-surface-condition", {"surface": "xmax", "U-curve": "curve.txt",
                                         "x-axis": "true"}),
        ("dirichlet-surface-condition", {"surface": "ymax", "V-curve": "curve.txt",
                                         "y-axis": "true", "z-axis": "true"}),
        ("dirichlet-point-condition", {"node": "top_corner", "A-curve": "curve.txt",
                                       "x-axis": "true"}),
        ("paraxial-boundary-condition", {"surface": "ymin", "rhopar": 2.0, "cp": 3.0,
                                         "cs": 1.7, "input-motion-type": 2, "tp": 0.05,
                                         "ts": 0.04, "amplit": 1e-3, "normal-angle": 30.0}),
        ("initial-node-condition", {"node-group": "all", "V": "0.0 0.0 -1e-3"}),
        ("init-cell-condition", {"cell-group": "upper", "vol-stress": "1.0 2.0 3.0"}),
    ]
    specs = [  # name, mesh, codename, dt, write_arc fields
        ("heat_penalty_qdot", "rect.msh", "Heat", 0.05,
         dict(values={**heat, "qdot": 2.0}, dirichlet_bc=[("left", 1.0)])),
        ("heat_rowelim_convection", "rect.msh", "Heat", 0.05,
         dict(values={**heat, "enforce-Dirichlet-method": "RowElimination"},
              dirichlet_bc=[("left", 1.0)], blocks=[conv])),
        ("heat_convection_output", "rect.msh", "Heat", 0.05,
         dict(values={**heat, "qdot": -1.0}, dirichlet_bc=[("bottom", 0.0)], blocks=[conv],
              post_processing=["NodeTemperature"])),
        ("soil_paraxial_table", "rect.msh", "Soildynamics", 0.01,
         dict(values=soil, traction=[("top", None, "traction.txt")], blocks=parax,
              component_tags=True)),
        ("soil_double_couple", "rect.msh", "Soildynamics", 0.01,
         dict(values=soil, traction=[("top", (0.0, -0.5))], blocks=parax + [dc],
              component_tags=True)),
        ("passmo_tetra_box", "box.msh", "Passmo", 0.01,
         dict(values={"analysis-type": "3D", "final-time": 0.1, "deltat": 0.01, "gz": -9.81},
              mesh_init=[("Rho", "vol", 2.0), ("Lambda", "vol", 30.0), ("Mu", "vol", 20.0)],
              blocks=[("dirichlet-surface-condition",
                       {"surface": "xmin", "Ux": 0.0, "Uy": 0.0, "Uz": 0.0}),
                      ("paraxial-boundary-condition", {"surface": "xmax"}),
                      ("neumann-condition", {"surface": "zmax", "curve": "curve.txt"})])),
        ("passmo_mixed_output", "mixed.msh", "Passmo", 0.01,
         dict(values={"analysis-type": "3D", "final-time": 0.1, "deltat": 0.01,
                      "alfa_method": "true", "alfam": am, "alfaf": af,
                      "beta": 0.25 * (1 - am + af) ** 2, "gamma": 0.5 - am + af},
              mesh_init=[("Rho", "lower", 2.0), ("Lambda", "lower", 30.0),
                         ("Mu", "lower", 20.0), ("Rho", "upper", 1.5),
                         ("Lambda", "upper", 50.0), ("Mu", "upper", 25.0)],
              blocks=mixed_blocks, post_processing=["U", "StrainVol", "StressDev"])),
    ]
    fields = {"Heat": ("T",), "Soildynamics": ("u", "v", "a"), "Passmo": ("u", "v", "a")}
    cases = []
    for name, mesh, codename, dt, kw in specs:
        path = os.path.join(inputs, f"{name}.arc")
        write_arc(path, mesh, codename=codename, **kw)
        cases.append({"name": name, "path": path, "codename": codename, "dt": dt,
                      "fields": fields[codename], "output": "output" in name,
                      "assemblies": int(codename == "Heat")})
    cases.append({"name": "heat_resume", "path": None, "codename": "Heat", "dt": 0.05,
                  "fields": ("T",), "output": False, "assemblies": 3,
                  "solve": _heat_resume(os.path.join(inputs, "heat_penalty_qdot.arc"),
                                        os.path.join(root, "checkpoint"))})
    return cases


def _heat_resume(path: str, ck: str):
    """A solve(device) of the heat case ``path`` in two halves, through
    fem/checkpoint.py's save and restore, and its continuous run: the
    resumed result with ``continuous`` set to the other."""
    def solve(device):
        import dataclasses

        from arcanefem_tpu_torch.fem import checkpoint
        from arcanefem_tpu_torch.fem.arc import load_case
        from arcanefem_tpu_torch.mesh.core import read_msh
        from arcanefem_tpu_torch.models import heat

        case = load_case(path)
        mesh = read_msh(case.mesh_file)
        cfg = dataclasses.replace(heat.parse_config(case, check=False), solver=dataclasses.replace(
            case.solver, rtol=1e-12))
        full = heat.solve(mesh, cfg, device=device)
        half = heat.solve(mesh, dataclasses.replace(cfg, tmax=cfg.tmax / 2), device=device)
        checkpoint.save(ck, half.steps * cfg.dt, half.steps, {"T": half.T})
        t0, _step, state = checkpoint.restore(ck)
        res = heat.solve(mesh, dataclasses.replace(cfg, tmax=cfg.tmax - t0), T0=state["T"],
                         device=device)
        res.continuous = full
        return res
    return solve


def _state_diff(got: dict, want: dict, dt: float) -> float:
    """max |got − want| of the fields, u, v·dt, a·dt² (a Newmark state in
    displacement units) or T, over the largest of them in ``want``."""
    import numpy as np

    w = {"T": 1.0, "u": 1.0, "v": dt, "a": dt * dt}
    scale = max(float(np.abs(want[f]).max()) * w[f] for f in want)
    return max(float(np.abs(got[f] - want[f]).max()) * w[f] for f in want) / max(scale, 1e-300)


class _NoAtomics:
    """Counts the calls of the atomic scatter-adds (index_add, scatter_add,
    accumulating index_put) on a CUDA tensor while it is entered."""

    def __enter__(self):
        import torch

        self.calls: dict = {}
        self._saved = []
        for name in (*TRANS_ATOMICS, "index_put", "index_put_"):
            real = getattr(torch.Tensor, name)

            def wrapped(t, *a, _name=name, _real=real, **kw):
                accumulating = kw.get("accumulate", len(a) > 2 and a[2])
                if t.is_cuda and (_name in TRANS_ATOMICS or accumulating):
                    self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(t, *a, **kw)

            self._saved.append((name, real))
            setattr(torch.Tensor, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch

        for name, real in self._saved:
            setattr(torch.Tensor, name, real)


def transient_cli_phase(dev) -> None:
    """[transient] T1: each case on the CPU (float64; its T or u becomes the
    case's golden file), twice in process on the card (float64) and, the
    ``_cli_cases``, through the CLI: the card's fields within 1e-12 of the CPU's largest, the two
    card runs bit-equal, each step's iterations equal ± 1, the fixed-order
    sums launched and no atomic scatter-add called on a CUDA tensor; the
    output case's temporal file read back; the resumed heat run equal to
    the continuous one."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from arcanefem_tpu_torch.fem.runner import run_case

    root = os.path.join("build", "transient_cases")
    cases = _transient_cases(root)
    cli_names = _cli_cases(cases)

    def run(c, device, out=None):
        if c["path"] is None:
            return c["solve"](device)
        return run_case(c["path"], device=device, output_dir=out)

    def fields(r, c):
        return {f: np.asarray(getattr(r, f)) for f in c["fields"]}

    for c in cases:
        t0 = time.perf_counter()
        cpu = run(c, "cpu")
        c["cpu_s"] = time.perf_counter() - t0
        c["cpu"], c["cpu_iters"] = fields(cpu, c), cpu.step_iterations
        c["n_nodes"] = cpu.problem.mesh.n_nodes
        if c["path"] is not None:
            golden = os.path.abspath(c["path"][:-4] + ".golden.txt")
            u = c["cpu"][c["fields"][0]].reshape(c["n_nodes"], -1)
            np.savetxt(golden, np.column_stack([cpu.problem.mesh.node_uids, u]),
                       fmt=["%d"] + ["%.17g"] * u.shape[1])
            with open(c["path"]) as f:
                text = f.read().replace(
                    "</fem>", f"  <result-file>{golden}</result-file>\n  </fem>")
            with open(c["path"], "w") as f:
                f.write(text)
    with ThreadPoolExecutor(FEM_CLI_WORKERS) as pool:
        out_dir = os.path.join(root, "out")
        clis = [pool.submit(_fem_cli, c["path"],
                            extra=["--output-dir", os.path.join(out_dir, "cli")]
                            if c["output"] else None) if c["name"] in cli_names
                else None for c in cases]
        for c in cases:
            runs = []
            for k in range(2):
                _reset_all()
                t0 = time.perf_counter()
                with _NoAtomics() as guard:  # checks the golden file too
                    card = run(c, dev, os.path.join(out_dir, "card") if c["output"] else None)
                c[f"card_s{k}"] = time.perf_counter() - t0
                c["launches"] = {k2: v for k2, v in _counts_all().items() if v}
                c["atomics"] = guard.calls
                runs.append(card)
            c["card"], c["card2"] = fields(runs[0], c), fields(runs[1], c)
            c["card_iters"] = runs[0].step_iterations
            c["history"] = [t for t, _ in getattr(runs[1], "history", [])]
            if c["path"] is None:
                c["resume_diff"] = float(np.abs(runs[0].T - runs[0].continuous.T).max()
                                         / np.abs(runs[0].continuous.T).max())
            del runs, card
        for c, fut in zip(cases, clis):
            c["cli"] = fut.result() if fut else None
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)

    for c in cases:
        diff = _state_diff(c["card"], c["cpu"], c["dt"])
        equal = all(np.array_equal(c["card"][f], c["card2"][f]) for f in c["fields"])
        cli = c["cli"]
        line = {"case": c["name"], "codename": c["codename"], "n_nodes": c["n_nodes"],
                "steps": len(c["cpu_iters"]),
                "iterations": {"cpu": c["cpu_iters"], "card": c["card_iters"],
                               "cli": cli and cli["info"] and cli["info"].get("iterations")},
                "card_vs_cpu": diff, "card_runs_bit_equal": equal,
                "cpu_s": c["cpu_s"], "card_s": [c["card_s0"], c["card_s1"]],
                "cli_s": cli and cli["s"], "cli_code": cli and cli["code"],
                "launches": c["launches"], "atomics_on_card": c["atomics"]}
        if "resume_diff" in c:
            line["resume_vs_continuous"] = c["resume_diff"]
        print(f"[transient] T1 {json.dumps(line)}", flush=True)
        if cli is not None:
            check(cli["code"] == 0 and cli["info"] is not None,
                  f"{c['name']}: the CLI exited {cli['code']}: {cli['stderr']}")
            if cli["code"] == 0 and cli["info"] is not None:
                check(abs(cli["info"]["iterations"] - sum(c["cpu_iters"])) <= len(c["cpu_iters"]),
                      f"{c['name']}: CLI iterations {cli['info']['iterations']}")
        check(diff <= TRANS_CARD_TOL, f"{c['name']}: card fields {diff:.3e} of the CPU's "
              f"largest from the CPU's (tolerance {TRANS_CARD_TOL:g})")
        check(equal, f"{c['name']}: two card runs differ")
        check(len(c["cpu_iters"]) == len(c["card_iters"]) and all(
            abs(a - b) <= 1 for a, b in zip(c["cpu_iters"], c["card_iters"])),
            f"{c['name']}: iterations per step {c['cpu_iters']} {c['card_iters']}")
        check(not c["atomics"], f"{c['name']}: atomic scatter-adds on the card {c['atomics']}")
        blocks = {"Heat": 0, "Soildynamics": 3, "Passmo": 2}[c["codename"]]
        check(c["launches"].get("slot_sum", 0) > 0 and c["launches"].get("sell_spmv", 0) > 0
              and c["launches"].get("block_slot_reduce", 0) == blocks
              and _assemblies(c["launches"]) == c["assemblies"],
              f"{c['name']}: launches {c['launches']}")
        if "resume_diff" in c:
            check(c["resume_diff"] <= 1e-9, f"heat_resume: {c['resume_diff']:.3e} from the "
                  "continuous run")
        if c["output"]:
            check(_temporal_output_ok(c, out_dir), f"{c['name']}: the output file")
    _check(not failed, "[transient] T1: " + "; ".join(failed))
    del cases
    torch.cuda.empty_cache()


def _temporal_output_ok(c: dict, out_dir: str) -> bool:
    """The output case's files, the card's and the CLI's: heat's temporal
    VTKHDF (NSteps == len(history), the last slab the final T) or passmo's
    U and recovered cell fields; the legacy .vtk where h5py is missing."""
    import numpy as np

    from arcanefem_tpu_torch.fem import vtkhdf

    stem = os.path.basename(c["path"])[:-4]
    ok = True
    for who in ("card", "cli"):
        d = os.path.join(out_dir, who)
        if not vtkhdf.HAVE_H5PY:
            vtk = os.path.join(d, stem + ".vtk")
            print(f"[transient] T1 {c['name']} {who}: {vtk} (no h5py)", flush=True)
            ok &= os.path.exists(vtk)
            continue
        import h5py

        with h5py.File(os.path.join(d, stem + ".hdf")) as f:
            g = f["VTKHDF"]
            n = int(g["NumberOfPoints"][0])
            if c["codename"] == "Heat":
                steps = int(g["Steps"].attrs["NSteps"])
                last = g["PointData/NodeTemperature"][-n:]
                good = (steps == len(c["history"]) == len(c["cpu_iters"])
                        and np.array_equal(last, c["card"]["T"]))
                print(f"[transient] T1 {c['name']} {who}: NSteps {steps}, history "
                      f"{len(c['history'])}, last slab == T: {good}", flush=True)
            else:
                u = g["PointData/U"][()]
                good = (u.shape == c["card"]["u"].shape and "StrainVol" in g["CellData"]
                        and np.abs(u - c["card"]["u"]).max()
                        <= TRANS_CARD_TOL * np.abs(c["card"]["u"]).max())
                print(f"[transient] T1 {c['name']} {who}: U {u.shape}, cell fields "
                      f"{sorted(g['CellData'])}: {good}", flush=True)
            ok &= bool(good)
    return ok


def _transient_line(tag: str, r, counts: dict, peak: float, wall: float, timer,
                    **extra) -> dict:
    """One T2 line: iterations per step, the last step's monitored and true
    free-row residual, solve_s, ms/iter, phases, peak memory, launches."""
    iters = r.iterations
    line = {"run": tag, "n_nodes": int(r.problem.mesh.n_nodes),
            "n_dofs": int(r.problem.n_dofs), "steps": r.steps,
            "step_iterations": r.step_iterations, "iterations": iters,
            "residual": r.residual, "free_residual": r.info.get("free_residual"),
            "solve_s": r.solve_s, "ms_per_iter": r.solve_s / max(iters, 1) * 1e3,
            "phases_s": timer.stats, "peak_mem_gb": peak / 1e9, "wall_s": wall,
            "launches": {k: counts.get(k, 0) for k in ("sell_spmv", "slot_reduce",
                                                       "block_slot_reduce", "slot_sum")},
            **extra}
    print(f"[transient] T2 {json.dumps(line)}", flush=True)
    return line


def transient_full_width_phase(dev, mesh) -> list[dict]:
    """[transient] T2: (a) heat and (b) soildynamics on a 1414x1414 tria3
    rect, (c) passmo on phase 4's sphere, each 10 steps; the
    block_slot_reduce record at (b)'s b = 2 shapes and the slot_reduce RHS
    record at (c)'s paraxial faces."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.fem.casetable import CaseTable
    from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
    from arcanefem_tpu_torch.models import elasticity, heat, passmo, soildynamics
    from arcanefem_tpu_torch.models.elastodynamics import TractionTBC
    from arcanefem_tpu_torch.solver.linear_system import SolverOptions
    from arcanefem_tpu_torch.tools import heat_floor

    t0 = time.perf_counter()
    n = TRANS_HEAT_N
    rect = rect_tria_mesh(n, n)
    host_s = time.perf_counter() - t0
    # (a) heat, AMG-CG to 1e-6, 10 steps of dt 0.1 (tools/heat_floor.py)
    hcfg = heat_floor.config()
    # each step converges to its anchored tolerance (fail_action="raise");
    # the last step's free-row residual is held to its dtype's limit, and
    # the float32 T to the float64 run's with the same options
    T = {}
    for dtype, free_limit in ((torch.float32, HEAT_FREE_F32), (torch.float64, HEAT_FREE_F64)):
        name = str(dtype).split(".")[1]
        r, counts, peak, wall, timer = _run_model("heat", heat.solve, rect, hcfg,
                                                  dtype=dtype, device=dev)
        _transient_line(f"heat amg {name}", r, counts, peak, wall, timer,
                        mesh_host_s=host_s, amg_setup_s=r.info.get("precond_setup_s"),
                        amg_rows=r.info.get("amg_rows"),
                        n_cells=int(rect.cells["tria3"].shape[0]))
        _check(r.steps == TRANS_STEPS and r.T.shape == (rect.n_nodes,)
               and bool(np.isfinite(r.T).all()) and float(np.abs(r.T).max()) > 0,
               f"[transient] T2 (a) {name}: T")
        _check(r.info["free_residual"] <= free_limit,
               f"[transient] T2 (a) {name}: free-row residual {r.info['free_residual']:.3e}")
        _check(_assemblies(counts) == 1 and counts["slot_sum"] > 0,
               f"[transient] T2 (a) {name}: launches {counts}")
        T[name] = r.T.astype(np.float64)
        del r
    field = float(np.abs(T["float32"] - T["float64"]).max() / np.abs(T["float64"]).max())
    print(f"[transient] T2 (a) float32 T from float64 T: {field!r} of its largest",
          flush=True)
    _check(field <= HEAT_FIELD_F32, f"[transient] T2 (a): float32 T {field:.3e} from float64")
    # (b) soildynamics, float64, Jacobi-CG, 10 steps
    rect.node_groups.update(_nearest_nodes(rect, {"N": (0.5, 0.5 + 1.0 / n),
                                                  "S": (0.5, 0.5 - 1.0 / n),
                                                  "E": (0.5 + 1.0 / n, 0.5),
                                                  "W": (0.5 - 1.0 / n, 0.5)}))
    sdt = 1e-3
    table = CaseTable(np.array(TRANS_TABLE)[:, 0] / 20, np.array(TRANS_TABLE)[:, 1:])
    source = CaseTable(np.array(TRANS_SOURCE)[:, 0] / 20, np.array(TRANS_SOURCE)[:, 1:])
    scfg = soildynamics.SoildynamicsConfig(
        tmax=TRANS_STEPS * sdt, dt=sdt, rho=2.0, E=50.0, nu=0.25,
        tractions=[TractionTBC("top", table=table)], paraxial=["left", "right", "bottom"],
        double_couple=soildynamics.DoubleCouple("N", "S", "E", "W", source),
        solver=SolverOptions(method="cg", preconditioner="jacobi", rtol=1e-8,
                             fail_action="raise"))
    r, counts, peak, wall, timer = _run_model("soildynamics", soildynamics.solve, rect, scfg,
                                              dtype=torch.float64, device=dev)
    _transient_line("soildynamics jacobi float64", r, counts, peak, wall, timer,
                    max_abs_u=float(np.abs(r.u).max()))
    _check(r.steps == TRANS_STEPS and all(bool(np.isfinite(a).all()) for a in (r.u, r.v, r.a))
           and float(np.abs(r.u).max()) > 0, "[transient] T2 (b): the state")
    _check(counts["block_slot_reduce"] == 3 and counts["slot_sum"] > 0,
           f"[transient] T2 (b): launches {counts}")
    records = [_block_slot_record(r.problem, counts["block_slot_reduce"])]
    del r, rect
    torch.cuda.empty_cache()
    # (c) passmo on phase 4's sphere, float32, Newmark, Jacobi-CG, 10 steps
    mesh.cell_groups["vol"] = {"tetra4": mesh.cells["tetra4"]}
    pcfg = passmo.PassmoConfig(
        analysis_type="3d", tmax=TRANS_STEPS * 1e-3, dt=1e-3,
        rho={"vol": 2.0}, lam={"vol": 30.0}, mu={"vol": 20.0},
        conditions=[passmo.ImposedCond("Cut", is_surface=True, V=(0.0, 0.0, -1e-2))],
        paraxial=[passmo.ParaxialCond("sphere")],
        solver=SolverOptions(method="cg", preconditioner="jacobi", rtol=1e-6,
                             max_iter=BLOCK_MAX_ITER, fail_action="raise"))
    r, counts, peak, wall, timer = _run_model("passmo", passmo.solve, mesh, pcfg,
                                              dtype=torch.float32, device=dev)
    _transient_line("passmo newmark jacobi float32", r, counts, peak, wall, timer,
                    n_cells=int(mesh.cells["tetra4"].shape[0]),
                    max_abs_u=float(np.abs(r.u).max()),
                    max_abs_stress_vol=float(np.abs(r.stress_vol["tetra4"]).max()))
    _check(r.steps == TRANS_STEPS and all(bool(np.isfinite(a).all()) for a in (r.u, r.v, r.a))
           and float(np.abs(r.u).max()) > 0, "[transient] T2 (c): the state")
    _check(bool(np.isfinite(r.stress_vol["tetra4"]).all())
           and r.strain_dev["tetra4"].shape == (mesh.cells["tetra4"].shape[0], 3),
           "[transient] T2 (c): the recovered fields")
    _check(counts["block_slot_reduce"] == 2 and counts["slot_sum"] > 0
           and _assemblies(counts) == 0, f"[transient] T2 (c): launches {counts}")
    records.append(_rhs_slot_record(r.problem, counts["slot_reduce"]))
    # the b = 3 block_slot_reduce and K1 records at these 5.68M-DoF shapes:
    # elasticity's blocks (E = 1, ν = 0.3) on passmo's layout of the sphere
    records += _block_records(r.problem, counts, elasticity.ElasticityConfig(E=1.0, nu=0.3))
    del r
    mesh.cell_groups.pop("vol")
    torch.cuda.empty_cache()
    return records


def _block_slot_record(prob, launches: int) -> dict:
    """block_slot_reduce at T2 (b)'s b = 2 shapes: the float64 mass blocks
    of the 1414² rect into their expanded SELL slots, 0 ulps from the twin,
    bit-equal from run to run, beside one index_add_ of every
    contributor's 4 entries."""
    import torch

    from arcanefem_tpu_torch.ops import elements
    from arcanefem_tpu_torch.sparse.slot_reduce import block_slot_reduce, block_slot_reduce_plain

    asm = prob.block_assembly
    table = elements.mass_blocks("tria3", prob.cell_xyz("tria3"), 2).reshape(-1).contiguous()
    ptr, ids, row_ptr, lay = asm.ptr, asm.ids, asm.row_ptr, asm.layout
    n_ns, E = ptr.numel() - 1, ids.numel()

    def fk():
        return block_slot_reduce(ptr, ids, table, row_ptr, lay, 2)

    def exact(yk, yp):
        _check(torch.equal(yk, yp), "[transient] block_slot_reduce differs from its twin")
        _check(torch.equal(yk, fk()), "[transient] block_slot_reduce differs from run to run")
        return 0.0

    node_slot = torch.repeat_interleave(torch.arange(n_ns, device=ptr.device),
                                        (ptr[1:] - ptr[:-1]).long(), output_size=E)
    entries = table.view(-1, 4)[ids.long()]
    rec = _kernel_record(
        "block_slot_reduce (soildynamics b=2)", "tet_assembly.cu",
        "sparse/pallas_spmv.py:444", fk,
        lambda: block_slot_reduce_plain(ptr, ids, table, row_ptr, lay, 2),
        lambda: torch.zeros((n_ns, 4), dtype=table.dtype, device=ptr.device).index_add_(
            0, node_slot, entries),
        (32 * n_ns + 4 * (n_ns + 1) + 4 * E + 8 * table.numel(), 4 * E),
        launches, [n_ns, E, 4], exact, dtype="float64")
    rec.update(node_slots=n_ns, contributors=E, out_slots=lay.n_slots, ulps=0.0,
               max_contributors=int((ptr[1:] - ptr[:-1]).max()))
    _block_was(BLOCK_SLOT_WAS_B2, rec, table)
    del entries, node_slot, table
    torch.cuda.empty_cache()
    return rec


def _rhs_slot_record(prob, launches: int) -> dict:
    """slot_reduce as the RHS reducer at T2 (c)'s shapes: the paraxial
    faces' (nf, 3, 3) float32 contributions into the sphere's 5.68M dofs
    through their SlotSum, 0 ulps from the twin, bit-equal from run to run,
    beside one index_add_ of the same contributions."""
    import torch

    from arcanefem_tpu_torch.sparse.slot_reduce import slot_reduce, slot_reduce_plain

    (key, s), = [(k, v) for k, v in prob._sums.items() if k[0] == "dofs"
                 and k[1][0] == "nodes" and k[1][1][0] == "paraxial"]
    gen = torch.Generator(device=s.ptr.device).manual_seed(17)
    table = torch.rand(s.n_entries, generator=gen, device=s.ptr.device) * 2 - 1
    dofs = torch.empty(s.n_entries, dtype=torch.int64, device=s.ptr.device)
    dofs[s.ids.long()] = torch.repeat_interleave(
        torch.arange(s.n, device=s.ptr.device), (s.ptr[1:] - s.ptr[:-1]).long(),
        output_size=s.n_entries)

    def fk():
        return slot_reduce(s.ptr, s.ids, table)

    def exact(yk, yp):
        _check(torch.equal(yk, yp), "[transient] slot_reduce (RHS) differs from its twin")
        _check(torch.equal(yk, fk()), "[transient] slot_reduce (RHS) differs from run to run")
        return 0.0

    rec = _kernel_record(
        "slot_reduce (RHS, passmo paraxial)", "tet_assembly.cu", "sparse/pallas_spmv.py:444",
        fk, lambda: slot_reduce_plain(s.ptr, s.ids, table),
        lambda: torch.zeros(s.n, device=table.device).index_add_(0, dofs, table),
        (4 * s.n + 4 * (s.n + 1) + 8 * s.n_entries, s.n_entries), launches,
        [s.n, s.n_entries], exact)
    rec.update(dofs=s.n, contributors=s.n_entries, ulps=0.0,
               max_contributors=int((s.ptr[1:] - s.ptr[:-1]).max()),
               replaces_note="JAX sums the RHS with XLA scatter-add (.at[].add, "
                             "arcanefem_tpu/models/passmo.py:591); this kernel "
                             "is K2's window-reducer role")
    del table, dofs
    return rec


def transient_phase(dev, mesh) -> list[dict]:
    """[transient]: T1 then T2, with the phase's wall time."""
    t0 = time.perf_counter()
    transient_cli_phase(dev)
    t1 = time.perf_counter()
    recs = transient_full_width_phase(dev, mesh)
    print(f"[transient] wall time: T1 {t1 - t0:.1f} s, T2 {time.perf_counter() - t1:.1f} s",
          flush=True)
    return recs


# (a) and (b): the refine-1 sphere, 244,183 nodes: at phase 4's 1.9M the
# CLI's f64 reference set-up alone outlasts the rest of the phase
PARALLEL_SPHERE = (5.0, 1)
PARALLEL_SHARDS = 4  # (b): shard 0 of a build_sharded into this many parts
PARALLEL_TIMEOUT = 600  # (a): seconds before the CLI's ranks are killed


def _parallel_cli(log: str):
    """(a)'s command, started: ``python -m arcanefem_tpu_torch.parallel
    --nproc 1 --device cuda --sphere PARALLEL_SPHERE --f64`` with its
    output in ``log``."""
    import subprocess

    os.makedirs(os.path.dirname(log), exist_ok=True)
    fh = open(log, "w")
    cmd = [sys.executable, "-m", "arcanefem_tpu_torch.parallel", "--nproc", "1",
           "--device", "cuda", "--sphere", "%g,%d" % PARALLEL_SPHERE, "--f64",
           "--timeout", str(PARALLEL_TIMEOUT)]
    return subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, text=True), fh


def _shard_halo_nodes(sp, p: int):
    """The global node of each of shard p's halo columns, read through the
    partition's own maps (the pool slot ``halo_src`` names: its owner q and
    the position in q's ``send_idx``)."""
    import numpy as np

    src = sp.halo_src[p].astype(np.int64)
    q, pos = src // sp.s_max, src % sp.s_max
    return sp.owned_global[q, sp.send_idx[q, pos]]


def parallel_phase(dev) -> list[dict]:
    """[parallel]: (a) the sharded CLI on NCCL with one rank, the dryrun's
    paths and the PARALLEL_SPHERE sphere's AMG-PCG in float64, each path's
    record printed and checked; (b) meanwhile, on the host, a 4-part
    ``build_sharded`` of the same sphere, and the ``[bench]`` phase (a
    subprocess whose checks read no time), then K1 on shard 0's
    rectangular [owned | halo] SELL layout (float64), its halo filled on
    the host, held to its plain twin and timed (a ``kernels`` record whose
    launches are the K1 launches of (a)'s solve of that sphere)."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.bench_unstructured import sphere_cut_system
    from arcanefem_tpu_torch.parallel.dryrun import PATHS
    from arcanefem_tpu_torch.parallel.partition import build_sharded
    from arcanefem_tpu_torch.parallel.sharded import Shard
    from arcanefem_tpu_torch.sparse.sell import sell_spmv, sell_spmv_plain

    t0 = time.perf_counter()
    log = os.path.join("build", "parallel", "cli.txt")
    proc, fh = _parallel_cli(log)
    sweep = _sweep_start(os.path.join("build", "sweep"))
    try:
        mesh, topo = sphere_cut_system(*PARALLEL_SPHERE)
        t1 = time.perf_counter()
        sp = build_sharded(mesh, PARALLEL_SHARDS, topo=topo)
        build_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        sh = Shard(sp, 0, dev, torch.float64)
        shard_s = time.perf_counter() - t1
        bench_phase()  # a subprocess too; its checks read no time
        rc = proc.wait(timeout=PARALLEL_TIMEOUT + 120)
        _sweep_finish(sweep, t0)
    finally:
        for p in (proc, sweep[0]):
            if p.poll() is None:
                p.kill()
                p.wait()
        fh.close()
    with open(log) as f:
        out = f.read()
    lines = [ln for ln in out.splitlines()
             if ln.startswith("parallel(1): ") and " ok — " in ln]
    for ln in out.splitlines():
        if ln.startswith("parallel(1)") or "Error" in ln or "Traceback" in ln:
            print(f"[parallel] {ln}", flush=True)
    print(f"[parallel] (a) exit {rc} in {time.perf_counter() - t0:.1f} s "
          f"(its output: {log})", flush=True)
    _check(rc == 0, f"[parallel] the sharded CLI exited {rc}: {out[-2000:]}")
    recs = {}
    for ln in lines:
        what, rec = ln.split(": ", 1)[1].split(" ok — ", 1)
        recs[what] = json.loads(rec)
    _check(len(recs) == len(PATHS) + 1, f"[parallel] {len(recs)} paths reported")
    sphere = next(r for w, r in recs.items() if w.startswith("sphere_cut"))
    k1 = sphere["launches"]["sell_spmv"]
    _check(sphere["max_diff"] <= 1e-6 and sphere["rel"] <= 1e-8
           and sphere["true_residual"] <= 1e-6 and sphere["iterations"] > 0,
           f"[parallel] the sphere: {sphere}")
    _check(k1 > 0 and sphere["launches"]["slot_reduce"] > 0,
           f"[parallel] the sphere's sharded solve launched no K1 or slot_reduce: "
           f"{sphere['launches']}")
    for what, rec in recs.items():
        print(f"[parallel] {what}: {rec['iterations'] if 'iterations' in rec else '-'} "
              f"iterations, true residual {rec.get('true_residual', float('nan')):.2e}, "
              f"{rec['max_diff']:.2e} from the single-process solve, launches "
              f"{rec['launches']}, collectives per iteration "
              f"{rec['collectives_per_iter']}, {rec['ms_per_iter']:.4f} ms per "
              f"iteration", flush=True)

    # (b) K1 on shard 0 of 4: the rectangular shape one rank never builds
    lay = sh.layout
    n_own, N = sh.n_own, sh.n_own_max
    gen = torch.Generator(device=dev).manual_seed(17)
    vals = torch.rand(lay.n_slots, generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    vals[~torch.as_tensor(lay.real, device=dev)] = 0
    xg = np.random.RandomState(17).rand(mesh.n_nodes) * 2 - 1
    x_loc = np.zeros(N + sp.h_max)
    x_loc[:n_own] = xg[sp.owned_global[0, :n_own]]
    halo = _shard_halo_nodes(sp, 0)
    touched = np.unique(np.concatenate([mesh.cells[k][sp.cell_offsets[k][0][
        sp.cell_offsets[k][0] >= 0]].ravel() for k in mesh.cells]))
    n_halo = int((sp.part[touched] != 0).sum())
    _check(np.array_equal(halo[:n_halo], touched[sp.part[touched] != 0]),
           "[parallel] (b) shard 0's halo map differs from its cells' nodes")
    x_loc[N:N + n_halo] = xg[halo[:n_halo]]
    x = torch.as_tensor(x_loc, device=dev)
    real = torch.as_tensor(lay.real, device=dev)
    rows = lay.slot_rows(dev).long()[real]
    cols = lay.cols.long()[real]
    order = torch.argsort(rows * lay.n_cols + cols)
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=N), 0)
    csr = torch.sparse_csr_tensor(crow, cols[order], vals[real][order],
                                  size=(N, lay.n_cols))
    scale = sell_spmv_plain(vals.abs(), lay, x.abs())

    def check(yk, yp):
        err = _rel_err(yk, yp, scale)
        _check(err <= 1e-12 and bool((yk[n_own:] == 0).all()),
               f"[parallel] (b) K1 on shard 0: {err:.2e} of sum |v x|, padding rows "
               f"{float(yk[n_own:].abs().max()) if N > n_own else 0.0}")
        return err

    nnz = lay.nnz
    rec = _kernel_record(
        f"sell_spmv (shard 0 of {PARALLEL_SHARDS}, float64)", "sell_spmv.cu",
        "sparse/pallas_spmv.py:398", lambda: sell_spmv(vals, lay, x),
        lambda: sell_spmv_plain(vals, lay, x), lambda: torch.mv(csr, x),
        (nnz * 12 + N * 8 + lay.n_cols * 8, 2 * nnz), k1,
        [N, lay.width, lay.n_cols], check, dtype="float64", kernel="sell_spmv_kernel")
    rec.update(n_own=n_own, h_max=sp.h_max, sigma=lay.sigma, slots=lay.n_slots, nnz=nnz,
               build_sharded_s=build_s, shard_s=shard_s)
    print(f"[parallel] (b) build_sharded({mesh.n_nodes} nodes, {PARALLEL_SHARDS} parts) {build_s:.1f} s, "
          f"shard 0's plans {shard_s:.1f} s: {n_own} owned rows of {N}, {n_halo} halo "
          f"columns (h_max {sp.h_max}), sigma {lay.sigma}, {lay.n_slots} slots for "
          f"{nnz} nonzeros", flush=True)
    del mesh, topo, sp, sh, vals, x, csr, scale
    torch.cuda.empty_cache()
    return [rec]


ILU_CSR_TOL = 1e-12  # [ilu]: the card's CSR from the CPU's, of the CPU's largest
ILU_WORKERS = 6  # [ilu]: processes computing the experiment's rows
ILU_CHAIN_ROWS = 32  # [ilu]: one K1 slice, so one single-block launch per step
ILU_RECORDS = {"slot_reduce": "slot_reduce",  # the records given [ilu]'s launches
               "block_slot_reduce": "block_slot_reduce (soildynamics b=2)"}


def _csr_diff(A, B) -> float:
    """max |A - B| / max |B| of two scipy CSR matrices of one pattern;
    inf where the patterns differ."""
    import numpy as np

    if (A.shape != B.shape or not np.array_equal(A.indptr, B.indptr)
            or not np.array_equal(A.indices, B.indices)):
        return float("inf")
    return float(np.abs(A.data - B.data).max() / np.abs(B.data).max())


def _check_ilu(card: list[dict], cpu: list[dict], diffs: list[float],
               launches: dict) -> None:
    """[ilu]'s checks: three rows from the card's systems beside the CPU's,
    the card's CSR within ILU_CSR_TOL of the CPU's, n, nnz and the depths
    equal, Jacobi, Chebyshev(3) and IC(0) within 1 iteration, ILUT within
    10% or both at the cap; the card's assembly launched slot_reduce twice
    and block_slot_reduce once."""
    from arcanefem_tpu_torch.tools.ilu_decision import MAXITER, SIZES

    _check([r["system"] for r in card] == list(SIZES) == [r["system"] for r in cpu],
           f"[ilu] systems {[r['system'] for r in card]}")
    _check(len(diffs) == 3 and all(d <= ILU_CSR_TOL for d in diffs),
           f"[ilu] the card's CSR differs from the CPU's: {diffs}")
    for a, b in zip(card, cpu):
        for k in ("n", "nnz", "ic0_depth", "ilut_depth"):
            _check(a.get(k) == b.get(k) is not None, f"[ilu] {a['system']} {k}: "
                   f"{a.get(k)} on the card's system, {b.get(k)} on the CPU's")
        for k in ("jacobi", "cheb3", "ic0_iters"):
            _check(a.get(k) is not None and b.get(k) is not None
                   and abs(a[k] - b[k]) <= 1,
                   f"[ilu] {a['system']} {k}: {a.get(k)} and {b.get(k)}")
        x, y = a.get("ilut_iters"), b.get("ilut_iters")
        _check(x is not None and y is not None
               and (x == y == MAXITER or abs(x - y) <= 0.1 * y),
               f"[ilu] {a['system']} ilut_iters: {x} and {y}")
    _check(launches.get("slot_reduce") == 2 and launches.get("block_slot_reduce") == 1,
           f"[ilu] the card's assembly launches {launches}")


def ilu_experiment(dev):
    """[ilu]'s experiment: ``tools/ilu_decision.py``'s three systems
    assembled in float64 on ``dev`` (the card: ``slot_reduce`` for the
    Poisson operators, ``block_slot_reduce`` at b = 2 for elasticity, their
    launches counted) and on the CPU, and the rows of both, computed in
    ILU_WORKERS spawned processes.  Returns (``dev``'s systems, their rows,
    the CPU systems' rows, the CSR differences, the launches)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from arcanefem_tpu_torch.tools import ilu_decision as ilu

    with ProcessPoolExecutor(ILU_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        _reset_all()
        card = ilu.systems(dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        counts = _counts_all()
        launches = {k: counts[k] for k in ILU_RECORDS}
        rows = [pool.submit(ilu.decision_row, s.name, s.A, s.rhs) for s in card]
        cpu = ilu.systems("cpu")
        diffs = [_csr_diff(a.A, b.A) for a, b in zip(card, cpu)]
        rows += [pool.submit(ilu.decision_row, s.name, s.A, s.rhs) for s in cpu]
        rows = [f.result() for f in rows]
    return card, rows[:3], rows[3:], diffs, launches


def ilu_phase(dev) -> dict:
    """[ilu]: :func:`ilu_experiment` on the card, held by ``_check_ilu``.
    Then the card's reckoning, with the host idle: per system, a chain of
    ``depth`` dependent single-block K1 launches (a 32-row slice, each
    launch's input the last one's output) for the IC(0) and ILUT factors,
    and three K1 SpMVs on the system's own SELL layout, each timed with
    CUDA events (best of 5).  Returns the launches."""
    import numpy as np
    import torch

    from arcanefem_tpu_torch.sparse.sell import SellLayout, sell_spmv
    from arcanefem_tpu_torch.utils.timing import elapsed_s, time_op

    t0 = time.perf_counter()
    card, card_rows, cpu_rows, diffs, launches = ilu_experiment(dev)
    for r, d in zip(card_rows, diffs):
        print(f"[ilu] {json.dumps({**r, 'csr_diff_from_cpu': d})}", flush=True)
    print(f"[ilu] the CPU-built systems' rows: {json.dumps(cpu_rows)}; the card's "
          f"assembly launches {launches}; {time.perf_counter() - t0:.1f} s", flush=True)
    _check_ilu(card_rows, cpu_rows, diffs, launches)

    gen = torch.Generator(device=dev).manual_seed(20)
    for s, r in zip(card, card_rows):
        A = s.bell
        W = A.layout.width
        cols = (np.arange(ILU_CHAIN_ROWS)[:, None] + np.arange(W)[None, :]) % ILU_CHAIN_ROWS
        lay = SellLayout.build(cols, np.ones(cols.shape, bool), device=dev)
        v = lay.from_ell(torch.rand(cols.shape, generator=gen, device=dev,
                                    dtype=torch.float64) / W)
        x0 = torch.rand(ILU_CHAIN_ROWS, generator=gen, device=dev, dtype=torch.float64)

        def chain(depth):
            def run():
                y = x0
                for _ in range(depth):
                    y = sell_spmv(v, lay, y)
                return y
            run()
            return min(elapsed_s(run, dev)[0] for _ in range(5)) * 1e3

        x = torch.rand(A.layout.n_cols, generator=gen, device=dev, dtype=torch.float64)
        k1x3 = time_op(lambda: A.spmv(A.spmv(A.spmv(x))), reps=50, outer=5) * 1e3
        ic0 = chain(r["ic0_depth"])
        ilut = chain(r["ilut_depth"])
        line = {"system": r["system"], "n": r["n"], "ic0_depth": r["ic0_depth"],
                "ic0_chain_ms": ic0, "ilut_depth": r["ilut_depth"], "ilut_chain_ms": ilut,
                "step_us": ic0 / r["ic0_depth"] * 1e3, "k1x3_ms": k1x3,
                # per PCG iteration: IC(0) = one K1 (A·p) and L, Lᵀ solves;
                # Chebyshev(3) = three K1
                "ic0_iter_ms": k1x3 / 3 + 2 * ic0, "cheb3_iter_ms": k1x3,
                "ic0_solve_ms": r["ic0_iters"] * (k1x3 / 3 + 2 * ic0),
                "cheb3_solve_ms": r["cheb3"] * k1x3}
        print(f"[ilu] reckoning {json.dumps(line)}", flush=True)
        _check(all(np.isfinite(line[k]) and line[k] > 0 for k in line
                   if k.endswith("_ms")), f"[ilu] reckoning {line}")
    del card
    torch.cuda.empty_cache()
    return launches


def _add_ilu_launches(records: list[dict], launches: dict) -> None:
    """Give the ``kernels`` records of ILU_RECORDS the launches of
    [ilu]'s assembly as ``ilu_launches``."""
    by_name = {r["name"]: r for r in records}
    for kernel, name in ILU_RECORDS.items():
        _check(name in by_name, f"[ilu] no kernels record {name!r}")
        by_name[name]["ilu_launches"] = launches[kernel]


def _check_amg(runs: dict) -> None:
    """[amg]'s checks: both set-up branches solved (rel <= 1e-8, true
    residual <= 1e-4, K1 launched), within 1 iteration of each other."""
    _check(set(runs) == {"native", "scipy"}, f"[amg] branches {sorted(runs)}")
    for b, r in runs.items():
        _check(r["rel"] <= 1e-8 and r["true_residual"] <= 1e-4
               and r["launches"].get("sell_spmv", 0) > 0, f"[amg] {b}: {r}")
    _check(abs(runs["native"]["iterations"] - runs["scipy"]["iterations"]) <= 1,
           f"[amg] iterations native {runs['native']['iterations']}, scipy "
           f"{runs['scipy']['iterations']}")


def amg_phase(dev) -> None:
    """[amg]: the PARALLEL_SPHERE sphere (244,183 DoF) solved as the bench
    solves it (float32, AMG-PCG to 1e-8) with each AMG set-up branch:
    ``AFEM_NATIVE_AMG=1`` (the native pass) and ``0`` (the scipy branch);
    each with its set-up seconds (host clock, with the hierarchy's move to
    the card), levels, iterations, residuals and launches
    (``_check_amg``)."""
    import torch

    from arcanefem_tpu_torch.bench_unstructured import solve_sphere_cut, sphere_cut_system

    mesh, topo = sphere_cut_system(*PARALLEL_SPHERE)
    runs = {}
    old = os.environ.get("AFEM_NATIVE_AMG")
    try:
        for branch, knob in (("native", "1"), ("scipy", "0")):
            os.environ["AFEM_NATIVE_AMG"] = knob
            _reset_all()
            r = solve_sphere_cut(mesh, topo, device=dev, dtype=torch.float32, penalty=1e12)
            torch.cuda.synchronize()
            counts = {k: v for k, v in _counts_all().items() if v}
            runs[branch] = {"amg_setup_s": r["amg_setup_s"], "levels": r["levels"],
                            "iterations": r["iterations"], "rel": r["rel"],
                            "true_residual": r["true_residual"], "launches": counts}
            print(f"[amg] {branch} ({mesh.n_nodes} DoF): {json.dumps(runs[branch])}",
                  flush=True)
            del r
    finally:
        if old is None:
            os.environ.pop("AFEM_NATIVE_AMG", None)
        else:
            os.environ["AFEM_NATIVE_AMG"] = old
    _check_amg(runs)
    torch.cuda.empty_cache()


def _check_caches(full: tuple[int, str], empty: tuple[int, str]) -> None:
    """[caches]' checks: the gate (exit code, output) on the cold-built
    directory exits 0 with four ok lines, and on an empty directory exits 1
    with every file MISSING."""
    for (rc, out), want, status in ((full, 0, "ok"), (empty, 1, "MISSING")):
        n = sum(ln.startswith(f"  {status} ") for ln in out.splitlines())
        _check(rc == want and n == 4,
               f"[caches] exit {rc} (want {want}) with {n} {status} lines of 4:\n{out}")


def caches_gate(cache_dir: str, h: float, refine: int) -> None:
    """[caches]: ``python -m arcanefem_tpu_torch.tools.verify_caches`` with
    the knobs of the sphere (h, refine) on ``cache_dir``, which holds the
    SELL and AMG files of its cold solve on the card (the mesh and
    topology files linked in from CACHE_DIR, where its set-up wrote them),
    and on an empty directory, side by side (``_check_caches``)."""
    import subprocess

    from arcanefem_tpu_torch.bench_unstructured import mesh_files, mesh_key
    from arcanefem_tpu_torch.utils.cache import CACHE_DIR

    key = mesh_key(h, refine, "rcm")
    for src, dst in zip(mesh_files(key, "sn", CACHE_DIR).values(),
                        mesh_files(key, "sn", cache_dir).values()):
        try:
            os.link(src, dst)
        except OSError:  # another file system
            shutil.copyfile(src, dst)
    empty = tempfile.mkdtemp(dir="build")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "AFEM_"))}
    env.update(BENCH_UNSTR_H=f"{h:g}", BENCH_UNSTR_REFINE=str(refine))
    procs = []
    try:
        for d in (cache_dir, empty):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "arcanefem_tpu_torch.tools.verify_caches"],
                env={**env, "AFEM_CACHE_DIR": d}, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            out = p.communicate(timeout=300)[0]
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(empty)
    for tag, (rc, out) in zip(("cold-built", "empty"), outs):
        print(f"[caches] {tag} directory: exit {rc}", flush=True)
        for ln in out.splitlines():
            if ln.strip():
                print(f"[caches]   {ln.strip()}", flush=True)
    _check_caches(*outs)


def structured_phases(dev, gen) -> list[dict]:
    """Phases 6-8; returns the records of K4-K8."""
    import torch

    from arcanefem_tpu_torch.bench_structured import (
        PENALTY, bench_line, box_system, solve_jacobi, solve_mg, solve_mg_flat,
        true_residual)
    from arcanefem_tpu_torch.mesh import stencil_assembly as sa
    from arcanefem_tpu_torch.sparse import dia_stencil as ds
    from arcanefem_tpu_torch.utils.timing import time_op

    _structured_parity(dev, gen)

    # 7. the structured path at 224^3
    t0 = time.perf_counter()
    s = box_system(BOX_N, dev)
    print(f"[box] host set-up (coordinates, mask planes) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ds.reset_launch_counts()
    sa.reset_launch_counts()
    res = solve_mg(s)
    torch.cuda.synchronize()
    counts = {**sa.launch_counts(), **ds.launch_counts()}
    line = bench_line(s, res, "mg")
    iters = res["iterations"]
    line["launches"] = counts
    print(f"[box] {json.dumps(line)}", flush=True)
    print(f"[box] launches per CG iteration: "
          + ", ".join(f"{k} {v / iters:.2f}" for k, v in counts.items()), flush=True)
    _check(res["rel"] <= 1e-8, f"box monitored residual {res['rel']:.3e}")
    _check(line["true_residual"] <= 1e-4, f"box true residual {line['true_residual']:.3e}")
    _check(bool(torch.isfinite(res["x"]).all()), "box: non-finite solution")
    if BOX_N == 224:
        _check(abs(iters - 13) <= 1, f"box iterations {iters}, JAX 13 (BENCH_r05)")
    for k in ("stencil_assembly", "dia_spmv_p", "dia_jacobi_p", "dia_residual_p"):
        _check(counts[k] > 0, f"kernel {k} never ran on the structured path")
    r0 = solve_mg(s, replace_every=0)
    print(f"[box] without residual replacement: {r0['iterations']} iterations, "
          f"rel {r0['rel']:.3e}, true residual {true_residual(s, r0):.3e}", flush=True)
    del r0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_mg(s)
    torch.cuda.synchronize()
    _profile(lambda: solve_mg(s), os.path.join("build", "profile", "structured.txt"),
             time.perf_counter() - t0)

    variants = {}
    for name, solve in (("jacobi", solve_jacobi), ("mg_flat", solve_mg_flat)):
        ds.reset_launch_counts()
        sa.reset_launch_counts()
        r = solve(s)
        torch.cuda.synchronize()
        variants[name] = {**sa.launch_counts(), **ds.launch_counts()}
        vline = bench_line(s, r, name)  # raises on a failed residual check
        print(f"[box] {json.dumps({**vline, 'launches': variants[name]})}", flush=True)
        S = r["A"]
        del r
    jcounts, fcounts = variants["jacobi"], variants["mg_flat"]
    _check(jcounts["dia_spmv"] > 0, "K8a never ran on the Jacobi path")
    _check(fcounts["dia_spmv"] > 0 and fcounts["dia_sweep"] > 0,
           "K8a or K8b never ran on the flat MG path")
    chunk_unfused_phases(s, res)
    profile_iter_phase(s)

    # each kernel at the path's shapes
    box, N = s.box, s.box.n_nodes
    A, M = res["A"], res["M"]
    A1 = M.mats[0]  # the fine level in bf16
    mm, invd = M.maskmul_p[0], M.inv_diags_p[0]
    invd_bm = ds._inv_nonzero(S.bands_p[ds.D0])  # band-major fine level
    real = A.pad_vec(torch.ones(N, device=dev)) > 0

    def vec():
        return torch.where(real, torch.rand(real.shape, generator=gen, device=dev), 0.0)

    xr, br = vec(), vec()
    bands_dia = A.bands_p.movedim(1, 0)[:, :, 1 : box.ny + 2, 1 : box.nz + 2].reshape(15, -1)
    rows = torch.arange(N, device=dev)
    offs = torch.tensor(box.offsets, device=dev)
    cols = rows[None, :] + offs[:, None]
    keep = (cols >= 0) & (cols < N) & (bands_dia != 0)
    order = torch.argsort(rows.expand(15, N)[keep], stable=True)
    csr_rows = rows.expand(15, N)[keep][order]
    csr = torch.sparse_csr_tensor(
        torch.searchsorted(csr_rows, torch.arange(N + 1, device=dev)),
        cols[keep][order], bands_dia[keep][order], size=(N, N))
    del cols, keep, order, csr_rows, rows
    xflat = A.unpad_vec(xr)
    y_csr = csr @ xflat
    print(f"[kernel] CSR library SpMV of the {box.shape} operator vs K5: max_abs_err "
          f"{float((y_csr - A.unpad_vec(A.spmv(xr))).abs().max()):.3e}", flush=True)
    del y_csr

    def stencil(mode, bands, band_major, **extra):
        """(kernel, plain twin, error check) of one stencil-kernel call on
        xr.  The check holds it to 1e-5 of the magnitude its sums run over,
        per node: s = sum |band x| + |b|, and then s for spmv, |x| +
        omega |aux| s for jacobi, |aux| s for residual."""
        geo = dict(band_major=band_major, ny=box.ny, nz=box.nz)
        kw = {**geo, **extra}
        sums = ds.dia_stencil_plain("spmv", bands.abs(), xr.abs(), **geo)
        if mode == "jacobi":
            scale = xr.abs() + extra["omega"] * extra["aux"].abs() * (sums + extra["b"].abs())
        elif mode == "residual":
            scale = extra["aux"].abs() * (sums + extra["b"].abs())
        else:
            scale = sums

        def check(y, yp):
            e = _rel_err(y, yp, scale)
            _check(e <= 1e-5 and bool((y[~real] == 0).all()),
                   f"dia_stencil {mode} at {box.shape}: {e:.2e} of the sums' "
                   "magnitude, or a non-zero pad")
            return e
        return (lambda x: ds.dia_stencil(mode, bands, x, **kw),
                lambda x: ds.dia_stencil_plain(mode, bands, x, **kw), check)

    free = torch.as_tensor(~s.mask, device=dev)
    dir_p = s.mask_p > 0

    def check_assembly(out, want):
        """Fused K4 at the path's shape: bands and rhs on free rows to
        _asm_tol of their largest free-row value, Dirichlet rows equal and
        pads zero."""
        (Mk, rk), (Mp, rp) = out, want
        tol = _asm_tol(box)
        bk = torch.stack([Mk.unpad_vec(Mk.bands_p[:, d])[free] for d in range(15)])
        bp = torch.stack([Mp.unpad_vec(Mp.bands_p[:, d])[free] for d in range(15)])
        eb = float((bk - bp).abs().max() / bp.abs().max())
        fr = Mp.unpad_vec(rp)[free]
        er = float((Mk.unpad_vec(rk)[free] - fr).abs().max() / fr.abs().max())
        print(f"[kernel] stencil_assembly at {box.shape}: bands {eb:.2e}, rhs "
              f"{er:.2e} on free rows (tol {tol:.2e})", flush=True)
        _check(eb <= tol and er <= tol, f"stencil assembly at {box.shape}")
        _check(torch.equal(Mk.bands_p[:, ds.D0][dir_p], Mp.bands_p[:, ds.D0][dir_p])
               and torch.equal(rk[dir_p], rp[dir_p]), "fused BC rows at the path's shape")
        _check(bool((rk[~real] == 0).all())
               and bool((Mk.bands_p.movedim(1, 0)[:, ~real] == 0).all()),
               "fused assembly pads at the path's shape")
        return max(eb, er)

    n_tets = box.n_cells
    asm_args = (box, s.coords3d, s.mask_p, s.pg_p, PENALTY, 1.0)
    cases = [
        ("stencil_assembly", "stencil_assembly.cu", "mesh/pallas_stencil.py:168",
         (sa.assemble_system, sa.assemble_system_plain, check_assembly), asm_args,
         None, _bound(84 * N, 220 * n_tets), counts["stencil_assembly"], "float32"),
        ("dia_spmv_p", "dia_stencil.cu", "sparse/dia_pallas.py:307",
         stencil("spmv", A.bands_p, False), (xr,), (torch.mv, (csr, xflat)),
         _bound(68 * N, 30 * N), counts["dia_spmv_p"], "float32"),
        ("dia_jacobi_p", "dia_stencil.cu", "sparse/dia_pallas.py:330",
         stencil("jacobi", A1.bands_p, False, b=br, aux=invd, omega=0.8), (xr,),
         None, _bound(46 * N, 33 * N), counts["dia_jacobi_p"], "bfloat16 bands"),
        ("dia_residual_p", "dia_stencil.cu", "sparse/dia_pallas.py:354",
         stencil("residual", A1.bands_p, False, b=br, aux=mm), (xr,), None,
         _bound(46 * N, 32 * N), counts["dia_residual_p"], "bfloat16 bands"),
        ("dia_spmv", "dia_stencil.cu", "sparse/dia_pallas.py:69",
         stencil("spmv", S.bands_p, True), (xr,), (torch.mv, (csr, xflat)),
         _bound(68 * N, 30 * N), jcounts["dia_spmv"], "float32"),
        ("dia_sweep", "dia_stencil.cu", "sparse/dia_pallas.py:109",
         stencil("jacobi", S.bands_p, True, b=br, aux=invd_bm, omega=0.8), (xr,),
         None, _bound(76 * N, 33 * N), fcounts["dia_sweep"], "float32"),
    ]
    records = []
    for name, src, rep, (fk, fp, check), args, lib, (bms, bby), launches, dt in cases:
        yk, yp = fk(*args), fp(*args)
        torch.cuda.synchronize()
        rel = check(yk, yp)
        pairs = ([(yk[0].bands_p, yp[0].bands_p), (yk[1], yp[1])]
                 if isinstance(yk, tuple) else [(yk, yp)])
        err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
        del yp, pairs
        if name == "stencil_assembly":  # no atomics: the same bits every run
            y2 = fk(*args)
            same = torch.equal(yk[0].bands_p, y2[0].bands_p) and torch.equal(yk[1], y2[1])
            print(f"[kernel] stencil_assembly at {box.shape}: two fused assemblies "
                  f"equal bit for bit: {same}", flush=True)
            _check(same, "two fused assemblies differ")
            del y2
        del yk
        ms = time_op(fk, *args, reps=20, outer=3) * 1e3
        dms, events = _device_ms(lambda: fk(*args), src)
        pms = time_op(fp, *args, reps=3, outer=2) * 1e3
        lms = time_op(lib[0], *lib[1], reps=20, outer=3) * 1e3 if lib else None
        records.append({
            "name": name, "route": "cuda", "source": f"arcanefem_tpu_torch/csrc/{src}",
            "replaces": f"arcanefem_tpu/{rep}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dms, "device_events": events,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "library_ms": lms,
            "shape": [box.nx + 1] * 3, "dtype": dt})
        print(f"[kernel] {name} {box.shape}: {ms:.4f} ms, device {_fmt_ms(dms)} "
              f"({events[0]} of {events[1]} kernel events traced; bound "
              f"{bms:.4f} ms, {bby}), plain {pms:.3f} ms, library "
              f"{'n/a' if lms is None else f'{lms:.4f} ms'}, max_abs_err {err:.3e}, "
              f"held to its tolerance: {rel:.2e}", flush=True)
    del csr, S, res, A, M, A1, s
    torch.cuda.empty_cache()

    # 8. kernel path against the plain path and float64 on the CPU at 64^3
    systems = {"kernel": box_system(CHECK_N, dev),
               "plain_cpu_f32": box_system(CHECK_N, "cpu"),
               "cpu_f64": box_system(CHECK_N, "cpu", torch.float64)}
    out = {k: solve_mg(v) for k, v in systems.items()}
    xk = out["kernel"]["x"].double().cpu()
    for name, r in out.items():
        diff = float((xk - r["x"].double().cpu()).abs().max() / r["x"].double().abs().max().cpu())
        print(f"[box{CHECK_N}] {name}: {r['iterations']} iterations, rel {r['rel']:.2e}, "
              f"true residual {true_residual(systems[name], r):.2e}, max diff from "
              f"the kernel path {diff:.2e}", flush=True)
        _check(abs(r["iterations"] - out["kernel"]["iterations"]) <= 1,
               f"{CHECK_N}^3 iterations, {name}")
        _check(diff <= 1e-4, f"{CHECK_N}^3 solution, {name}")
    return records


if __name__ == "__main__":
    sys.exit(main())
