"""The sharded solves over torch.distributed: the port of the JAX
package's ``parallel/`` (RCB domain decomposition, halo-exchange SpMV,
distributed PCG, sharded AMG and multigrid, block and transient sharded
solves), one process per rank.  ``python -m arcanefem_tpu_torch.parallel``
runs them all (``dryrun.py``)."""
