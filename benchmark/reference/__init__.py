"""The plain reference: P1 Poisson on tetrahedra in float64, in PyTorch.

It imports neither JAX nor either package of the repository, and takes
from the program nothing but the outputs it judges.
"""
