"""Parallel layer of the port (sipp_tpu/parallel/): cyclic index sharding
over a mesh of cards, and the multi-process launcher.

Importing this package touches no card, so launcher.initialize (which
creates the process group) may run after it, as the JAX package's lazy
imports arrange for jax.distributed.initialize.
"""

from .sharded import Mesh, make_mesh, shard_cyclic, sipp_prove_sharded, unshard  # noqa: F401

