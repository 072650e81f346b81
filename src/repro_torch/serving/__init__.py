from repro_torch.serving.engine import (
    decode_step,
    greedy_generate,
    init_decode_state,
    init_paged_state,
    paged_decode_step,
    paged_prefill_chunk,
    paged_supported,
    prefill,
    quant_kv_rows,
)
from repro_torch.serving.paging import BlockPool, PoolExhausted, PrefixIndex
from repro_torch.serving.scheduler import (
    BatchScheduler,
    EngineHooks,
    Request,
    ServeConfig,
)

__all__ = ["decode_step", "greedy_generate", "init_decode_state",
           "prefill", "init_paged_state", "paged_decode_step", "paged_prefill_chunk",
           "paged_supported", "quant_kv_rows", "BlockPool", "PoolExhausted",
           "PrefixIndex", "BatchScheduler", "EngineHooks", "Request",
           "ServeConfig"]
