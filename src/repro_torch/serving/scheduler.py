"""Continuous batching over a fixed slot batch with a paged KV pool (port of
the paged mode of ``serving/scheduler.py``).

The scheduler is host-side control logic around the engine's device steps.
Prompts prefill in per-tick token budgets (chunked prefill) interleaved
with one batched decode step; admission is FIFO or priority against
free-block accounting; shared prompt prefixes reuse blocks copy-on-write
through the prefix index, with LRU eviction of cold prefixes when admission
runs short of blocks.

``ServeConfig`` keeps the JAX package's fields and defaults.  The JAX
package's contiguous mode, its legacy positional constructor and
``snapshot``/``restore`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.serving.paging import (BlockPool, PoolExhausted, PrefixIndex,
                                        blocks_for)

_CACHE_DTYPES = ("bfloat16", "float32", "int8")
_KERNEL_BACKENDS = ("auto", "off", "emulate", "int8")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0           # higher admits first under admission="priority"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine-facing serving configuration.  ``eos_id`` is required: the
    tokenizer's real id, or ``None`` to run every request to max_new_tokens."""
    num_slots: int
    eos_id: Optional[int]
    max_len: int = 64
    mode: str = "paged"                  # "paged" | "contiguous"
    block_size: int = 8
    num_blocks: Optional[int] = None     # None: 1 null + slots*(max_blocks+2)
    prefill_chunk: Optional[int] = None  # tokens/tick budget; None: block_size
    cache_dtype: str = "bfloat16"
    prefix_sharing: bool = True
    admission: str = "fifo"              # "fifo" | "priority"
    attn_impl: Optional[str] = None      # None/"ref" | "kernel" (paged decode)
    kernel_backend: Optional[str] = None  # None | "auto"/"off"/"emulate"/
    #   "int8": backend installed around the DECODE hook only, enabling the
    #   fused decode-prologue and fxp_matmul kernels (prefill stays unfused so
    #   prefix-shared block bytes are chunk-invariant)

    def __post_init__(self):
        if self.mode not in ("paged", "contiguous"):
            raise ValueError(f"mode must be 'paged' or 'contiguous', "
                             f"got {self.mode!r}")
        if self.admission not in ("fifo", "priority"):
            raise ValueError(f"admission must be 'fifo' or 'priority', "
                             f"got {self.admission!r}")
        if self.cache_dtype not in _CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {_CACHE_DTYPES}, "
                             f"got {self.cache_dtype!r}")
        if self.kernel_backend is not None \
                and self.kernel_backend not in _KERNEL_BACKENDS:
            raise ValueError(f"kernel_backend must be None or one of "
                             f"{_KERNEL_BACKENDS}, got {self.kernel_backend!r}")
        if self.attn_impl not in (None, "ref", "kernel"):
            raise ValueError(f"attn_impl must be None, 'ref' or 'kernel', "
                             f"got {self.attn_impl!r}")
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.mode == "paged":
            if self.block_size < 1:
                raise ValueError("block_size must be >= 1")
            if self.max_len % self.block_size:
                raise ValueError(
                    f"max_len ({self.max_len}) must be a multiple of "
                    f"block_size ({self.block_size})")
            if self.prefill_chunk is not None and self.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")

    @property
    def max_blocks_per_seq(self) -> int:
        return self.max_len // self.block_size

    @property
    def resolved_num_blocks(self) -> int:
        # +2 per slot: admission reserves COW-copy slack on top of each
        # request's worst-case footprint (see BatchScheduler._admit)
        if self.num_blocks is not None:
            return self.num_blocks
        return 1 + self.num_slots * (self.max_blocks_per_seq + 2)

    @property
    def chunk_tokens(self) -> int:
        return self.prefill_chunk or self.block_size

    def torch_cache_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8}[self.cache_dtype]

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class EngineHooks:
    """The device-step surface the scheduler drives (paged mode):

      decode(pool, tables [B,M], lens [B], tokens [B,1]) -> (logits, pool)
      prefill_chunk(pool, table [1,M], tokens [1,C], start) -> (logits, pool)
      copy_block(pool, src, dst) -> pool      (COW block copy on device)
      init_state: the block pool (dict of tensors)
      device: where the pool lives; the scheduler puts its inputs there
    """
    decode: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    copy_block: Optional[Callable] = None
    init_state: Any = None
    device: Any = "cpu"

    @classmethod
    def for_model(cls, params, cfg, serve: ServeConfig) -> "EngineHooks":
        """Closures over (params, cfg).  The pool goes on the params' device;
        ``serve.kernel_backend`` is installed around the DECODE hook only."""
        from repro_torch.kernels import ops as kops
        from repro_torch.serving import engine as E

        if serve.mode != "paged":
            raise NotImplementedError(
                "the port serves in paged mode; contiguous mode is not "
                "ported yet")
        device = params["embed"].device
        pool = E.init_paged_state(cfg, serve.resolved_num_blocks,
                                  serve.block_size, serve.torch_cache_dtype(),
                                  device)

        def decode(pool, tables, lens, toks):
            if serve.kernel_backend is None:
                return E.paged_decode_step(params, cfg, pool, tables, lens,
                                           toks, serve.attn_impl)
            with kops.kernel_backend_ctx(serve.kernel_backend, device):
                return E.paged_decode_step(params, cfg, pool, tables, lens,
                                           toks, serve.attn_impl)

        def chunk(pool, table, toks, start):
            return E.paged_prefill_chunk(params, cfg, pool, table, toks, start)

        def copy(pool, src, dst):
            # in place: every layer's block dst becomes a copy of block src
            for x in pool.values():
                x[:, dst] = x[:, src]
            return pool

        return cls(decode=decode, prefill_chunk=chunk, copy_block=copy,
                   init_state=pool, device=device)


class BatchScheduler:
    """Drives ``EngineHooks`` over a fixed slot batch in paged mode."""

    def __init__(self, config: ServeConfig, hooks: EngineHooks):
        if not isinstance(config, ServeConfig) \
                or not isinstance(hooks, EngineHooks):
            raise TypeError("BatchScheduler takes (ServeConfig, EngineHooks)")
        if config.mode != "paged":
            raise NotImplementedError("the port schedules paged mode only")
        if hooks.decode is None or hooks.prefill_chunk is None \
                or hooks.copy_block is None:
            raise ValueError("paged mode needs decode, prefill_chunk and "
                             "copy_block hooks")
        self.config = config
        self.hooks = hooks
        self.device = torch.device(hooks.device)
        self.num_slots = config.num_slots
        self.eos_id = config.eos_id
        self.pending: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self.next_tokens = np.zeros((self.num_slots, 1), np.int32)
        self.steps_run = 0
        self.tick_log: List[dict] = []
        self.stats = {"prefix_hits": 0, "reused_tokens": 0, "cow_copies": 0,
                      "prefill_tokens": 0, "prefix_evictions": 0,
                      "evicted_blocks": 0}
        self.pool = hooks.init_state
        self.block_pool = BlockPool(config.resolved_num_blocks)
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex() if config.prefix_sharing else None)
        self._tables: List[List[int]] = [[] for _ in range(self.num_slots)]
        self._pos = np.zeros(self.num_slots, np.int64)
        self._prefilling = np.zeros(self.num_slots, bool)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def submit(self, req: Request):
        total = len(req.prompt) + req.max_new_tokens
        if total > self.config.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+max_new ({total}) exceeds "
                f"max_len ({self.config.max_len})")
        self.pending.append(req)

    def _ensure_block(self, slot: int, bi: int):
        """Make the slot's table cover block index ``bi`` with an exclusively
        owned block: append a fresh one past the end, or copy-on-write a
        shared one (refcount > 1: a prefix entry or another request reads
        it)."""
        table = self._tables[slot]
        if bi == len(table):
            table.append(self.block_pool.alloc())
        elif self.block_pool.refs[table[bi]] > 1:
            src = table[bi]
            dst = self.block_pool.alloc()
            self.pool = self.hooks.copy_block(self.pool, src, dst)
            self.block_pool.release(src)
            table[bi] = dst
            self.stats["cow_copies"] += 1

    def _committed_blocks(self) -> int:
        """Blocks running requests will still allocate, plus one COW-copy
        slack each."""
        bs = self.config.block_size
        tot = 0
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            footprint = blocks_for(len(r.prompt) + r.max_new_tokens, bs)
            tot += max(0, footprint - len(self._tables[i])) + 1
        return tot

    def _admit(self):
        bs = self.config.block_size
        while self.pending:
            slot = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if slot is None:
                break
            if self.config.admission == "priority":
                req = max(self.pending, key=lambda r: r.priority)
            else:
                req = self.pending[0]
            p = len(req.prompt)
            reuse_n, reuse_blocks = 0, ()
            if self.prefix is not None:
                reuse_n, reuse_blocks = self.prefix.lookup(req.prompt, p - 1)
            # +2 slack: the partial boundary block and the request's own
            # final block can each need one COW copy beyond the count
            need = (blocks_for(p + req.max_new_tokens, bs)
                    - len(reuse_blocks) + 2)
            deficit = (need - self.block_pool.available()
                       + self._committed_blocks())
            if deficit > 0 and self.prefix is not None and len(self.prefix):
                freed = self.prefix.evict_lru(self.block_pool, deficit)
                if freed:
                    self.stats["prefix_evictions"] += 1
                    self.stats["evicted_blocks"] += freed
                    # eviction may have dropped the entry this request
                    # planned to reuse: re-resolve against the survivors
                    reuse_n, reuse_blocks = self.prefix.lookup(req.prompt,
                                                               p - 1)
                    need = (blocks_for(p + req.max_new_tokens, bs)
                            - len(reuse_blocks) + 2)
            if self.block_pool.available() - self._committed_blocks() < need:
                break  # head-of-line: wait for running requests to free
            self.pending.remove(req)
            for b in reuse_blocks:
                self.block_pool.retain(b)
            self.slots[slot] = req
            self._tables[slot] = list(reuse_blocks)
            self._pos[slot] = reuse_n
            self._prefilling[slot] = True
            self.next_tokens[slot, 0] = 0
            if reuse_n:
                self.stats["prefix_hits"] += 1
                self.stats["reused_tokens"] += reuse_n

    def _finish(self, i: int):
        req = self.slots[i]
        req.done = True
        for bid in self._tables[i]:
            self.block_pool.release(bid)
        self._tables[i] = []
        self._pos[i] = 0
        self._prefilling[i] = False
        self.next_tokens[i, 0] = 0
        self.slots[i] = None

    def _table_row(self, i: int) -> np.ndarray:
        row = np.zeros((1, self.config.max_blocks_per_seq), np.int32)
        t = self._tables[i]
        row[0, :len(t)] = t
        return row

    def _sampled(self, i: int, tok: int):
        """Record a sampled token; finish the request at eos / max_new."""
        req = self.slots[i]
        req.generated.append(tok)
        self.next_tokens[i, 0] = tok
        if (self.eos_id is not None and tok == self.eos_id) \
                or len(req.generated) >= req.max_new_tokens:
            self._finish(i)

    def _prefill_tick(self) -> int:
        """Spend up to ``chunk_tokens`` of prefill budget across prefilling
        slots; requests whose prompt completes sample their first token."""
        budget = self.config.chunk_tokens
        bs = self.config.block_size
        total = 0
        for i in range(self.num_slots):
            if budget <= 0:
                break
            req = self.slots[i]
            if req is None or not self._prefilling[i]:
                continue
            pos = int(self._pos[i])
            p = len(req.prompt)
            c = min(budget, p - pos)
            for bi in range(pos // bs, (pos + c - 1) // bs + 1):
                self._ensure_block(i, bi)
            toks = self._dev(np.asarray(req.prompt[pos:pos + c],
                                        np.int32)[None, :])
            logits, self.pool = self.hooks.prefill_chunk(
                self.pool, self._dev(self._table_row(i)), toks, pos)
            pos += c
            self._pos[i] = pos
            budget -= c
            total += c
            if pos == p:
                self._prefilling[i] = False
                if self.prefix is not None:
                    self.prefix.register(np.asarray(req.prompt, np.int32),
                                         self._tables[i], bs, self.block_pool)
                self._sampled(i, int(torch.argmax(logits[0])))
        self.stats["prefill_tokens"] += total
        return total

    def _decode_tick(self) -> int:
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and not self._prefilling[i]]
        if not active:
            return 0
        bs = self.config.block_size
        for i in active:
            # the incoming token writes at position _pos[i]
            self._ensure_block(i, int(self._pos[i]) // bs)
        m = self.config.max_blocks_per_seq
        tables = np.zeros((self.num_slots, m), np.int32)
        lens = np.zeros(self.num_slots, np.int32)
        toks = np.zeros((self.num_slots, 1), np.int32)
        for i in active:
            t = self._tables[i]
            tables[i, :len(t)] = t
            lens[i] = self._pos[i]
            toks[i, 0] = self.next_tokens[i, 0]
        # inactive rows stay all-null (block 0) / len 0 / token 0: their
        # writes land in the null block, which is never read unmasked
        logits, self.pool = self.hooks.decode(
            self.pool, self._dev(tables), self._dev(lens), self._dev(toks))
        out = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            self._pos[i] += 1
            self._sampled(i, int(out[i]))
        self.steps_run += 1
        return len(active)

    def step(self) -> int:
        """One scheduler tick.  Returns the number of slots that made
        progress (decoded or still prefilling); 0 means idle."""
        self._admit()
        pre = self._prefill_tick()
        n = self._decode_tick()
        prefilling = int(np.sum(self._prefilling))
        self.tick_log.append({"decoded": n, "prefill_tokens": pre,
                              "prefilling": prefilling})
        if n == 0 and pre == 0 and self.pending \
                and all(r is None for r in self.slots):
            raise PoolExhausted(
                "admission deadlock: pending requests cannot fit the block "
                "pool even after LRU prefix eviction, and no running "
                "request can free blocks; size num_blocks for "
                "num_slots * max_len")
        return n + prefilling

    def release_prefix_cache(self):
        """Drop every prefix-index entry, releasing its block references."""
        if self.prefix is not None:
            self.prefix.drop(self.block_pool)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        finished: dict = {}
        for _ in range(max_steps):
            for r in list(self.slots) + list(self.pending):
                if r is not None:
                    finished[r.uid] = r
            if self.step() == 0 and not self.pending:
                break
        return [r for r in finished.values() if r.done]
