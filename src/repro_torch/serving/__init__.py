from repro_torch.serving.engine import (
    init_paged_state,
    paged_decode_step,
    paged_prefill_chunk,
    paged_supported,
    quant_kv_rows,
)
from repro_torch.serving.paging import BlockPool, PoolExhausted, PrefixIndex
from repro_torch.serving.scheduler import (
    BatchScheduler,
    EngineHooks,
    Request,
    ServeConfig,
)

__all__ = ["init_paged_state", "paged_decode_step", "paged_prefill_chunk",
           "paged_supported", "quant_kv_rows", "BlockPool", "PoolExhausted",
           "PrefixIndex", "BatchScheduler", "EngineHooks", "Request",
           "ServeConfig"]
