"""repro_torch.dist — cross-replica reduction (port of ``repro/dist``).

  collectives        dense and int8-compressed all-reduce of dW over the
                     process groups of named mesh dimensions
                     (``launch.mesh``), with the ambient mesh that the
                     engine's dW reduction reads (``mesh_ctx``)
  async_collectives  the ring, psum and scatter transports with start/wait
                     handles, and the transport autotuner and its cache
                     (the engine's ``overlap``)
  pipeline           pipeline schedules: GPipe / 1F1B / interleaved-1F1B
                     tick tables, and the stage-sharded microbatch tick
                     loop under autograd (the engine's pipeline path),
                     its stages placed on a mesh's "pipe" ranks

The JAX package's ``sharding``, ``api`` and ``hlo_analysis`` come with the
rest of ROADMAP A11 and A12.
"""
from repro_torch.dist.async_collectives import (
    AsyncHandle, TRANSPORTS, all_gather_chunks, all_reduce_start,
    all_reduce_wait, clear_transport_cache, decide_transport,
    dump_transport_cache, group_size, load_transport_cache,
    prime_transport_cache, reduce_scatter_chunk, resolve_leaf_transports,
    ring_all_reduce, shard_chunk, transport_cache_snapshot,
    tree_all_reduce_start, tree_all_reduce_wait)
from repro_torch.dist.collectives import (compressed_psum,
                                          compressed_psum_tree, current_mesh,
                                          dense_psum, dense_psum_tree,
                                          mesh_ctx)
from repro_torch.dist.pipeline import (
    SCHEDULES, GPipeSchedule, Interleaved1F1BSchedule, OneFOneBSchedule,
    Schedule, SchedulePlan, bubble_fraction, get_schedule, pipeline_apply)

__all__ = ["AsyncHandle", "GPipeSchedule", "Interleaved1F1BSchedule",
           "OneFOneBSchedule", "SCHEDULES", "Schedule", "SchedulePlan",
           "TRANSPORTS", "all_gather_chunks", "all_reduce_start",
           "all_reduce_wait", "bubble_fraction", "clear_transport_cache",
           "compressed_psum", "compressed_psum_tree", "current_mesh",
           "decide_transport", "dense_psum", "dense_psum_tree",
           "dump_transport_cache", "get_schedule", "group_size",
           "load_transport_cache", "mesh_ctx", "pipeline_apply",
           "prime_transport_cache", "reduce_scatter_chunk",
           "resolve_leaf_transports", "ring_all_reduce", "shard_chunk",
           "transport_cache_snapshot", "tree_all_reduce_start",
           "tree_all_reduce_wait"]
