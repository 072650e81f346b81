"""repro_torch.dist — cross-replica reduction, pipelining and tensor
parallelism (port of ``repro/dist``).

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
  sharding           partition specs (``P``) of parameters, optimizer
                     state, batches and decode state, and the shards they
                     cut (``shard_tree``) and join (``gather_tree``)
  api                activation-sharding rules, perf options and
                     ``constrain``; the model axis of the ambient mesh

Tensor parallelism over a mesh's "model" axis is explicit: each rank holds
its shards and the layers call the model group's collectives
(``models.layers``, ``models.lm``).  The JAX package's ``hlo_analysis``
comes with ROADMAP A12.
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
                                          dense_pmax, dense_psum,
                                          dense_psum_tree, mesh_ctx)
from repro_torch.dist.api import (KNOWN_PERF_OPTS, UNCONSTRAINED,
                                  activation_sharding_ctx, constrain,
                                  current_rules, make_default_rules,
                                  model_axis_size_ctx, perf_opt,
                                  perf_options_ctx)
from repro_torch.dist.pipeline import (
    SCHEDULES, GPipeSchedule, Interleaved1F1BSchedule, OneFOneBSchedule,
    Schedule, SchedulePlan, bubble_fraction, get_schedule, pipeline_apply)
from repro_torch.dist.sharding import (P, Placement, batch_pspecs,
                                       decode_state_pspecs, gather_tree,
                                       opt_pspecs, param_pspecs, replicated,
                                       shard_tree, to_named)

__all__ = ["AsyncHandle", "GPipeSchedule", "Interleaved1F1BSchedule",
           "KNOWN_PERF_OPTS", "OneFOneBSchedule", "P", "Placement",
           "SCHEDULES", "Schedule", "SchedulePlan", "TRANSPORTS",
           "UNCONSTRAINED", "activation_sharding_ctx", "all_gather_chunks",
           "all_reduce_start", "all_reduce_wait", "batch_pspecs",
           "bubble_fraction", "clear_transport_cache", "compressed_psum",
           "compressed_psum_tree", "constrain", "current_mesh",
           "current_rules", "decide_transport", "decode_state_pspecs",
           "dense_pmax", "dense_psum", "dense_psum_tree",
           "dump_transport_cache", "gather_tree", "get_schedule",
           "group_size", "load_transport_cache", "make_default_rules",
           "mesh_ctx", "model_axis_size_ctx", "opt_pspecs", "param_pspecs",
           "perf_opt", "perf_options_ctx", "pipeline_apply",
           "prime_transport_cache", "reduce_scatter_chunk", "replicated",
           "resolve_leaf_transports", "ring_all_reduce", "shard_chunk",
           "shard_tree", "to_named", "transport_cache_snapshot",
           "tree_all_reduce_start", "tree_all_reduce_wait"]
