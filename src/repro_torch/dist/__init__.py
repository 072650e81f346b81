"""repro_torch.dist — cross-replica reduction (port of ``repro/dist``).

  collectives  dense and int8-compressed all-reduce of dW over the process
               groups of named mesh dimensions (``launch.mesh``), with the
               ambient mesh that the engine's dW reduction reads
               (``mesh_ctx``)

The JAX package's ``async_collectives`` (the overlapped transports),
``pipeline``, ``sharding``, ``api`` and ``hlo_analysis`` come with the rest
of ROADMAP A11 and A12.
"""
from repro_torch.dist.collectives import (compressed_psum,
                                          compressed_psum_tree, current_mesh,
                                          dense_psum, dense_psum_tree,
                                          mesh_ctx)

__all__ = ["compressed_psum", "compressed_psum_tree", "current_mesh",
           "dense_psum", "dense_psum_tree", "mesh_ctx"]
