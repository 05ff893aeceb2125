"""arcanefem_tpu_torch: the PyTorch and CUDA port of arcanefem_tpu.

The JAX package ``arcanefem_tpu`` stays the reference.  This package runs
the same unstructured Poisson main path (sphere_cut P1 tetrahedra, BELL
assembly, smoothed-aggregation AMG-preconditioned CG) on an NVIDIA Hopper
card, with hand-written CUDA kernels where the JAX package had Pallas ones
(``csrc/``).  It imports ``torch`` and never ``jax``; of ``arcanefem_tpu`` it
uses only the framework-free host modules (mesh generation, topology, node
ordering, the native library).
"""

__version__ = "0.1.0"
