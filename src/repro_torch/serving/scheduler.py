"""Continuous batching over a fixed slot batch, contiguous or paged KV (port
of ``serving/scheduler.py``).

The scheduler is host-side control logic around the engine's device steps.
Two cache regimes share one driver:

  * ``mode="contiguous"``: whole-prompt prefill into a per-slot contiguous
    cache (KV rings, a sliding window's included, SSM state, or both for
    the hybrid family), then
    batched decode; ``merge`` writes each leaf on its own batch axis.  As
    in the JAX package, ``merge`` sets the batch's ONE decode position to
    the last prefilled prompt's length and ``decode_step`` writes every
    slot there, so this mode is defined only for equal-length prompts
    admitted together (and finishing together); the port mirrors that and
    does not correct it.
  * ``mode="paged"``: a block pool (``serving.paging``) replaces per-slot
    caches.  Prompts prefill in per-tick token budgets (chunked prefill)
    interleaved with one batched decode step; admission is FIFO or
    priority against free-block accounting; shared prompt prefixes reuse
    blocks copy-on-write through the prefix index, with LRU eviction of
    cold prefixes when admission runs short of blocks.

API: ``BatchScheduler(ServeConfig(...), EngineHooks(...))``.  The legacy
positional ``BatchScheduler(num_slots, prefill_fn, decode_fn, merge_fn,
init_state, eos_id=...)`` still works through an adapter that emits a
DeprecationWarning, as does the ``eos_id=-1`` "never matches" sentinel.

``snapshot()`` captures queue state and the device cache as host numpy
arrays (in paged mode also the pool, the block accounting, the per-slot
tables and the prefix index), in the JAX package's format, so it rides
either package's checkpoint layer and either package's
``BatchScheduler.restore`` continues the stream with identical outputs.
numpy has no bfloat16: a bf16 cache is snapshotted widened to f32
(exactly) and restored into the hooks' cache dtype.  The kernel tuners are
not ported (ROADMAP A8), so a paged snapshot's ``tune_cache`` is written
empty and a JAX snapshot's decisions are not installed.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
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
        if self.eos_id == -1:
            warnings.warn(
                "eos_id=-1 was the legacy 'never matches' sentinel; pass "
                "eos_id=None explicitly", DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "eos_id", None)
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
    """The device-step surface the scheduler drives.

    contiguous mode:
      prefill(tokens [1,T]) -> (logits [1,V], slot_state)
      decode(state, tokens [B,1]) -> (logits [B,V], state)
      merge(state, slot_state, i) -> state
      init_state: the batched decode state
    paged mode:
      decode(pool, tables [B,M], lens [B], tokens [B,1]) -> (logits, pool)
      prefill_chunk(pool, table [1,M], tokens [1,C], start) -> (logits, pool)
      copy_block(pool, src, dst) -> pool      (COW block copy on device)
      init_state: the block pool (dict of tensors)
    device: where the state lives; the scheduler hands the hooks int32
    tensors there.
    """
    prefill: Optional[Callable] = None
    decode: Optional[Callable] = None
    merge: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    copy_block: Optional[Callable] = None
    init_state: Any = None
    device: Any = "cpu"

    @classmethod
    def for_model(cls, params, cfg, serve: ServeConfig) -> "EngineHooks":
        """Closures over (params, cfg) for either mode; the state goes on
        the params' device.  ``serve.kernel_backend`` is installed around
        the DECODE hook only (the fused decode-prologue and the MLP's
        ``fxp_matmul``).  The paged prefill stays unfused, so prefix-shared
        block bytes do not depend on chunking; the contiguous prefill runs
        under ``engine.prefill``'s own "auto" (int8 on CUDA), as the JAX
        package's does."""
        from repro_torch.kernels import ops as kops
        from repro_torch.serving import engine as E

        device = params["embed"].device
        dtype = serve.torch_cache_dtype()

        def _decode_backend(fn):
            if serve.kernel_backend is None:
                return fn

            def wrapped(*args):
                with kops.kernel_backend_ctx(serve.kernel_backend, device):
                    return fn(*args)
            return wrapped

        if serve.mode == "paged":
            pool = E.init_paged_state(cfg, serve.resolved_num_blocks,
                                      serve.block_size, dtype, device)

            def decode(pool, tables, lens, toks):
                return E.paged_decode_step(params, cfg, pool, tables, lens,
                                           toks, serve.attn_impl)

            def chunk(pool, table, toks, start):
                return E.paged_prefill_chunk(params, cfg, pool, table, toks,
                                             start)

            def copy(pool, src, dst):
                # in place: every layer's block dst becomes a copy of src
                for x in pool.values():
                    x[:, dst] = x[:, src]
                return pool

            return cls(decode=_decode_backend(decode), prefill_chunk=chunk,
                       copy_block=copy, init_state=pool, device=device)

        state = E.init_decode_state(cfg, serve.num_slots, serve.max_len,
                                    dtype, device)

        def prefill_one(tokens):
            return E.prefill(params, cfg, {"tokens": tokens}, serve.max_len,
                             dtype)

        def decode(state, toks):
            return E.decode_step(params, cfg, state, toks)

        def merge(state, slot_state, i):
            # in place: slot i's cache rows become the prompt's, on each
            # leaf's batch axis (not JAX's dst[:, i], which misses the
            # hybrid's [G, K, B, ...] Mamba leaves); the batch's one
            # position becomes this prompt's length (JAX's legacy pos)
            E.merge_slot(cfg, state["caches"], slot_state["caches"], i)
            return {"caches": state["caches"], "pos": slot_state["pos"]}

        return cls(prefill=prefill_one, decode=_decode_backend(decode),
                   merge=merge, init_state=state, device=device)


_LEGACY_CTOR_MSG = (
    "BatchScheduler(num_slots, prefill_fn, decode_fn, merge_fn, init_state) "
    "is deprecated; use BatchScheduler(ServeConfig(...), EngineHooks(...))")


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _to_host(tree):
    """A state tree as fresh host numpy arrays (a copy: on the CPU
    ``Tensor.numpy()`` shares memory with the tensor the run goes on
    writing); bf16 widened to f32, which holds it exactly."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


def _to_device(tree, like, device):
    """Host arrays as fresh tensors, on the device and in the dtype of the
    matching tensor of ``like`` where there is one (the hooks' own state:
    a bf16 cache comes back bf16, ``pos`` to the host), else on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, like.get(k) if isinstance(like, dict)
                              else None, device) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t.to(device)


class BatchScheduler:
    """Drives ``EngineHooks`` over a fixed slot batch (see the module
    docstring for the contiguous/paged split and the legacy adapter)."""

    def __init__(self, config, hooks=None, decode_fn=None, merge_fn=None,
                 init_state=None, eos_id=-1):
        if isinstance(config, ServeConfig):
            if not isinstance(hooks, EngineHooks):
                raise TypeError("new-style BatchScheduler takes "
                                "(ServeConfig, EngineHooks)")
        else:
            # legacy positional ctor: (num_slots, prefill, decode, merge,
            # init_state, eos_id=-1)
            warnings.warn(_LEGACY_CTOR_MSG, DeprecationWarning, stacklevel=2)
            num_slots = int(config)
            if eos_id == -1:
                warnings.warn(
                    "eos_id=-1 was the legacy 'never matches' sentinel; "
                    "pass an explicit eos_id (or None)",
                    DeprecationWarning, stacklevel=2)
                eos = None
            else:
                eos = eos_id
            config = ServeConfig(num_slots=num_slots, eos_id=eos,
                                 mode="contiguous")
            leaves = _tensors(init_state)
            hooks = EngineHooks(prefill=hooks, decode=decode_fn,
                                merge=merge_fn, init_state=init_state,
                                device=(leaves[0].device if leaves
                                        else "cpu"))
        self._setup(config, hooks)

    def _setup(self, config: ServeConfig, hooks: EngineHooks):
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
        if config.mode == "paged":
            if hooks.decode is None or hooks.prefill_chunk is None \
                    or hooks.copy_block is None:
                raise ValueError("paged mode needs decode, prefill_chunk and "
                                 "copy_block hooks")
            self.pool = hooks.init_state
            self.block_pool = BlockPool(config.resolved_num_blocks)
            self.prefix: Optional[PrefixIndex] = (
                PrefixIndex() if config.prefix_sharing else None)
            self._tables: List[List[int]] = [[] for _ in range(self.num_slots)]
            self._pos = np.zeros(self.num_slots, np.int64)
            self._prefilling = np.zeros(self.num_slots, bool)
        else:
            self.state = hooks.init_state

    # legacy attribute aliases (the old ctor stored the callables directly)
    @property
    def prefill_fn(self):
        return self.hooks.prefill

    @property
    def decode_fn(self):
        return self.hooks.decode

    @property
    def merge_fn(self):
        return self.hooks.merge

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def submit(self, req: Request):
        if self.config.mode == "paged":
            total = len(req.prompt) + req.max_new_tokens
            if total > self.config.max_len:
                raise ValueError(
                    f"request {req.uid}: prompt+max_new ({total}) exceeds "
                    f"max_len ({self.config.max_len})")
        self.pending.append(req)

    # ------------------------------------------------------------------
    # contiguous mode (the JAX package's legacy behavior)
    # ------------------------------------------------------------------

    def _fill_slots(self):
        for i in range(self.num_slots):
            if self.slots[i] is None and self.pending:
                req = self.pending.popleft()
                logits, slot_state = self.hooks.prefill(
                    self._dev(np.asarray(req.prompt, np.int32)[None, :]))
                self.state = self.hooks.merge(self.state, slot_state, i)
                tok = int(torch.argmax(logits[0]))
                req.generated.append(tok)
                self.next_tokens[i, 0] = tok
                self.slots[i] = req

    def _step_contiguous(self) -> int:
        self._fill_slots()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        logits, self.state = self.hooks.decode(
            self.state, self._dev(self.next_tokens))
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            req = self.slots[i]
            tok = int(toks[i])
            req.generated.append(tok)
            self.next_tokens[i, 0] = tok
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.slots[i] = None
        self.steps_run += 1
        return len(active)

    # ------------------------------------------------------------------
    # paged mode
    # ------------------------------------------------------------------
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

    def _step_paged(self) -> int:
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
        if self.config.mode == "paged" and self.prefix is not None:
            self.prefix.drop(self.block_pool)

    def step(self) -> int:
        """One scheduler tick.  Returns the number of slots that made
        progress (decoded or still prefilling); 0 means idle."""
        if self.config.mode == "paged":
            return self._step_paged()
        return self._step_contiguous()

    # -- checkpointability ------------------------------------------------

    @staticmethod
    def _pack(r: Request) -> dict:
        return {"uid": int(r.uid),
                "prompt": np.asarray(r.prompt, np.int32).copy(),
                "max_new_tokens": int(r.max_new_tokens),
                "generated": np.asarray(r.generated, np.int32),
                "done": bool(r.done),
                "priority": int(r.priority)}

    @staticmethod
    def _unpack(d: dict) -> Request:
        return Request(uid=int(d["uid"]),
                       prompt=np.asarray(d["prompt"], np.int32),
                       max_new_tokens=int(d["max_new_tokens"]),
                       generated=[int(t) for t in
                                  np.asarray(d["generated"]).ravel()],
                       done=bool(d["done"]),
                       priority=int(d.get("priority", 0)))

    def snapshot(self) -> dict:
        """Host-side copy of the whole scheduler state (numpy arrays, ints
        and bools, in the JAX package's layout), so it rides either
        package's ``save_checkpoint`` as it is.  Paged mode adds the pool,
        the block accounting, per-slot tables and the prefix index."""
        eos_enc = -1 if self.eos_id is None else int(self.eos_id)
        base = {
            "num_slots": int(self.num_slots),
            "eos_id": eos_enc,
            "steps_run": int(self.steps_run),
            "next_tokens": np.asarray(self.next_tokens).copy(),
            # slot occupancy: occupied slots packed with their index, so
            # the tree has no None leaves
            "slot_idx": np.asarray(
                [i for i, r in enumerate(self.slots) if r is not None],
                np.int32),
            "slot_reqs": [self._pack(r) for r in self.slots if r is not None],
            "pending": [self._pack(r) for r in self.pending],
        }
        if self.config.mode == "contiguous":
            base["state"] = _to_host(self.state)
            return base
        c = self.config
        for req, i in zip(base["slot_reqs"], base["slot_idx"]):
            req["table"] = np.asarray(self._tables[int(i)], np.int32)
            req["pos"] = int(self._pos[int(i)])
            req["prefilling"] = bool(self._prefilling[int(i)])
        base["serve"] = {
            "max_len": int(c.max_len),
            "block_size": int(c.block_size),
            "num_blocks": int(c.resolved_num_blocks),
            "prefill_chunk": int(c.chunk_tokens),
            "prefix_sharing": int(c.prefix_sharing),
            "admission_priority": int(c.admission == "priority"),
            # 0 = unset, else 1 + index into _KERNEL_BACKENDS (ints only, as
            # the JAX format keeps the serve dict)
            "kernel_backend": (0 if c.kernel_backend is None else
                               1 + _KERNEL_BACKENDS.index(c.kernel_backend)),
        }
        # the JAX format's tune-cache decisions, as JSON bytes; the port
        # has no tuner (ROADMAP A8), so there are none
        base["tune_cache"] = np.frombuffer(json.dumps({}).encode(),
                                           np.uint8).copy()
        base["pool"] = _to_host(self.pool)
        base["block_pool"] = self.block_pool.snapshot()
        base["prefix"] = (self.prefix.snapshot() if self.prefix is not None
                          else {"tokens": [], "blocks": []})
        return base

    @classmethod
    def restore(cls, snap: dict, prefill_fn: Optional[Callable] = None,
                decode_fn: Optional[Callable] = None,
                merge_fn: Optional[Callable] = None, *,
                hooks: Optional[EngineHooks] = None) -> "BatchScheduler":
        """Rebuild a scheduler from ``snapshot()`` output (the port's or the
        JAX package's); the continued stream is identical to the
        uninterrupted one (the hooks are stateless: only the snapshot
        carries state).  The state is copied into fresh tensors on the
        hooks' device, in the hooks' own state's dtypes where they carry
        one.  Contiguous snapshots accept the legacy positional callables
        (state on the CPU); paged snapshots need ``hooks=`` (decode /
        prefill_chunk / copy_block)."""
        eos = int(snap["eos_id"])
        eos = None if eos == -1 else eos
        if "pool" in snap:
            if hooks is None:
                raise ValueError("restoring a paged snapshot requires "
                                 "hooks=EngineHooks(...)")
            s = snap["serve"]
            kbi = int(s.get("kernel_backend", 0))
            kb = None if kbi == 0 else _KERNEL_BACKENDS[kbi - 1]
            pool = _to_device(snap["pool"], hooks.init_state, hooks.device)
            config = ServeConfig(
                num_slots=int(snap["num_slots"]), eos_id=eos, mode="paged",
                max_len=int(s["max_len"]), block_size=int(s["block_size"]),
                num_blocks=int(s["num_blocks"]),
                prefill_chunk=int(s["prefill_chunk"]),
                cache_dtype=str(pool["k"].dtype).replace("torch.", ""),
                prefix_sharing=bool(int(s["prefix_sharing"])),
                admission=("priority" if int(s["admission_priority"])
                           else "fifo"),
                kernel_backend=kb)
            tc = snap.get("tune_cache")
            if tc is not None and np.asarray(tc).size:
                n = len(json.loads(np.asarray(tc, np.uint8).tobytes()
                                   .decode()))
                if n:
                    print(f"[serve] snapshot carries {n} tune-cache "
                          f"decision(s); the port has no tuner and does not "
                          f"install them", flush=True)
            sched = cls(config, dataclasses.replace(hooks, init_state=pool))
            sched.block_pool = BlockPool.restore(snap["block_pool"])
            if config.prefix_sharing:
                sched.prefix = PrefixIndex.restore(snap["prefix"])
            for i, rd in zip(np.asarray(snap["slot_idx"]).ravel(),
                             snap["slot_reqs"]):
                i = int(i)
                sched.slots[i] = cls._unpack(rd)
                sched._tables[i] = [int(b) for b in
                                    np.asarray(rd["table"]).ravel()]
                sched._pos[i] = int(rd["pos"])
                sched._prefilling[i] = bool(rd["prefilling"])
        else:
            if hooks is None:
                hooks = EngineHooks(prefill=prefill_fn, decode=decode_fn,
                                    merge=merge_fn)
            config = ServeConfig(num_slots=int(snap["num_slots"]),
                                 eos_id=eos, mode="contiguous")
            state = _to_device(snap["state"], hooks.init_state, hooks.device)
            sched = cls(config, dataclasses.replace(hooks, init_state=state))
            for i, rd in zip(np.asarray(snap["slot_idx"]).ravel(),
                             snap["slot_reqs"]):
                sched.slots[int(i)] = cls._unpack(rd)
        sched.steps_run = int(snap["steps_run"])
        sched.next_tokens = np.asarray(snap["next_tokens"], np.int32).copy()
        for rd in snap["pending"]:
            sched.pending.append(cls._unpack(rd))
        return sched

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        finished: dict = {}
        for _ in range(max_steps):
            for r in list(self.slots) + list(self.pending):
                if r is not None:
                    finished[r.uid] = r
            if self.step() == 0 and not self.pending:
                break
        return [r for r in finished.values() if r.done]
