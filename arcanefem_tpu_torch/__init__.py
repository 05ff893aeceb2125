"""arcanefem_tpu_torch: the PyTorch and CUDA port of arcanefem_tpu.

The JAX package ``arcanefem_tpu`` stays the reference.  This package does
what it does on an NVIDIA Hopper card, with hand-written CUDA kernels where
the JAX package had Pallas ones (``csrc/``):

* the unstructured Poisson main path (sphere_cut P1 tetrahedra, BELL
  assembly, smoothed-aggregation AMG-preconditioned CG) and its routes,
  ``bench_unstructured.py``; the structured Kuhn-box path (stencil
  assembly into 15 DIA bands, geometric-multigrid-preconditioned CG),
  ``bench_structured.py``; the bench line of both, ``bench.py``;
* the FEM core and every model family of the reference, behind
  ``python -m arcanefem_tpu_torch run <case.arc>`` (``fem/``,
  ``models/``, ``solver/``);
* the assembly-format lab, ``python -m arcanefem_tpu_torch testlab``;
* the sharded solves over ``torch.distributed``, ``parallel/``;
* the measurement harness and tools: ``bench --sweep``, the profilers,
  the ILU decision experiment and the cache gate (``tools/``).

It imports ``torch`` and never ``jax`` nor anything of ``arcanefem_tpu``:
the host code it needs (mesh generation, topology, node orders, the
native C++ set-up library) is its own copy.
"""

__version__ = "0.2.0"
