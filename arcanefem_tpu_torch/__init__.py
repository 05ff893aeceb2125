"""arcanefem_tpu_torch: the PyTorch and CUDA port of arcanefem_tpu.

The JAX package ``arcanefem_tpu`` stays the reference.  This package runs
two of its paths on an NVIDIA Hopper card, with hand-written CUDA kernels
where the JAX package had Pallas ones (``csrc/``):

* the unstructured Poisson main path (sphere_cut P1 tetrahedra, BELL
  assembly, smoothed-aggregation AMG-preconditioned CG),
  ``bench_unstructured.py``;
* the structured Kuhn-box Poisson path (stencil assembly into 15 DIA
  bands, geometric-multigrid-preconditioned CG), ``bench_structured.py``.

It imports ``torch`` and never ``jax`` nor anything of ``arcanefem_tpu``:
the host code it needs (mesh generation, topology, node orders, the
native C++ set-up library) is its own copy.
"""

__version__ = "0.2.0"
