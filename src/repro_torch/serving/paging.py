"""Paged KV-cache bookkeeping: free-list block pool + prefix-sharing index.

The device side of paging is a block pool ([L, N_blocks, block, kv_heads,
head_dim] per K/V, see ``serving.engine.init_paged_state``); everything in
this module is HOST-side control state over the block axis:

  * ``BlockPool`` — free-list + refcounts.  Block 0 is reserved as the
    null block (masked slots write there; nothing reads it unmasked), so
    id 0 doubles as table padding.
  * ``PrefixIndex`` — prompt-prefix hash -> (token count, block ids).
    After a prefill completes, every block-aligned prefix boundary AND the
    full prompt length are registered; a later request reuses the longest
    matching registered prefix, paying retain() instead of prefill FLOPs.
    Because stored K/V is per-token (per-token int8 scales included), the
    reused bytes are bitwise what the request's own prefill would have
    written — the prefix-sharing bitwise test rests on this.

Copy-on-write: a reused boundary may sit mid-block (the entry's last block
is partially filled), and registration itself keeps a reference on a
request's final block.  Any write into a block with refcount > 1 must
therefore copy it first — the scheduler calls ``hooks.copy_block`` and
swaps the fresh id into the table (see ``BatchScheduler._ensure_block``).

Both structures snapshot to numpy pytrees and restore exactly, extending
the scheduler's checkpointability guarantee to the paged state.

This module is pure Python and numpy, copied from the JAX package's
``serving/paging.py``: the port keeps its own copy so that it imports
nothing of that package.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Deque, Dict, List, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """No free blocks left — admission control should have prevented this."""


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return -(-int(n_tokens) // int(block_size))


class BlockPool:
    """Host-side free-list + refcounts over the device pool's block axis."""

    NULL = 0  # reserved null block: table padding / masked-slot writes

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved null "
                             f"block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.refs = np.zeros(self.num_blocks, np.int32)
        self.refs[self.NULL] = 1  # permanently held
        self.free: Deque[int] = deque(range(1, self.num_blocks))

    def available(self) -> int:
        return len(self.free)

    def alloc(self) -> int:
        if not self.free:
            raise PoolExhausted(
                f"block pool exhausted ({self.num_blocks} blocks)")
        bid = self.free.popleft()
        assert self.refs[bid] == 0, bid
        self.refs[bid] = 1
        return bid

    def retain(self, bid: int):
        assert self.refs[bid] > 0, bid
        self.refs[bid] += 1

    def release(self, bid: int):
        assert self.refs[bid] > 0, bid
        self.refs[bid] -= 1
        if self.refs[bid] == 0:
            self.free.append(bid)

    # -- checkpointability -------------------------------------------------

    def snapshot(self) -> dict:
        return {"num_blocks": int(self.num_blocks),
                "refs": self.refs.copy(),
                "free": np.asarray(list(self.free), np.int32)}

    @classmethod
    def restore(cls, snap: dict) -> "BlockPool":
        pool = cls(int(snap["num_blocks"]))
        pool.refs = np.asarray(snap["refs"], np.int32).copy()
        pool.free = deque(int(b) for b in np.asarray(snap["free"]).ravel())
        return pool


class PrefixIndex:
    """Prompt-prefix hash -> (n_tokens, block ids), holding one reference
    per block per entry.  ``drop(pool)`` releases everything — after all
    requests complete AND the index is dropped, every non-null refcount is
    zero (tested).

    Entries are LRU-ordered: dict insertion order doubles as recency
    (``lookup`` hits move the entry to the MRU end), so ``evict_lru`` can
    release individual cold entries until a block deficit is covered —
    the admission gate's alternative to dropping the whole index.  The
    order survives snapshot/restore (both walk insertion order)."""

    def __init__(self):
        self._entries: Dict[bytes, Tuple[int, Tuple[int, ...]]] = {}
        # raw token prefixes, kept so snapshots can rebuild the hashes
        self._tokens: Dict[bytes, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key(tokens: np.ndarray) -> bytes:
        t = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return hashlib.sha1(t.tobytes()).digest() + len(t).to_bytes(4, "big")

    def insert(self, tokens: np.ndarray, block_ids: List[int], pool: BlockPool):
        k = self.key(tokens)
        if k in self._entries:
            return
        for bid in block_ids:
            pool.retain(bid)
        self._entries[k] = (len(tokens), tuple(int(b) for b in block_ids))
        self._tokens[k] = np.asarray(tokens, np.int32).copy()

    def register(self, prompt: np.ndarray, table: List[int], block_size: int,
                 pool: BlockPool):
        """Register every block boundary of a completed prefill, plus the
        full prompt (whose last block may be partial — the COW case)."""
        p = len(prompt)
        ends = list(range(block_size, p + 1, block_size))
        if p % block_size:
            ends.append(p)
        for e in ends:
            self.insert(prompt[:e], table[:blocks_for(e, block_size)], pool)

    def lookup(self, prompt: np.ndarray, limit: int
               ) -> Tuple[int, Tuple[int, ...]]:
        """Longest registered prefix of ``prompt`` with <= ``limit`` tokens
        (callers pass len(prompt)-1: at least one token must prefill so the
        first sampled token has logits).  Returns (0, ()) on miss."""
        lengths = sorted({n for n, _ in self._entries.values()
                          if n <= limit}, reverse=True)
        for n in lengths:
            k = self.key(prompt[:n])
            hit = self._entries.get(k)
            if hit is not None:
                self._touch(k)
                return hit
        return 0, ()

    def _touch(self, k: bytes):
        """Move an entry to the MRU end (dict insertion order is recency)."""
        self._entries[k] = self._entries.pop(k)
        self._tokens[k] = self._tokens.pop(k)

    def evict_lru(self, pool: BlockPool, need_free: int) -> int:
        """Release least-recently-used entries until at least ``need_free``
        blocks came back to the pool's free list (or the index is empty).
        Returns the number of blocks actually freed — less than the entry's
        block count when running requests still reference its blocks."""
        before = pool.available()
        while self._entries and pool.available() - before < need_free:
            k = next(iter(self._entries))
            _, blocks = self._entries.pop(k)
            del self._tokens[k]
            for bid in blocks:
                pool.release(bid)
        return pool.available() - before

    def drop(self, pool: BlockPool):
        for _, blocks in self._entries.values():
            for bid in blocks:
                pool.release(bid)
        self._entries.clear()
        self._tokens.clear()

    # -- checkpointability -------------------------------------------------

    def snapshot(self) -> dict:
        toks, blocks = [], []
        for k, (n, bids) in self._entries.items():
            toks.append(self._tokens[k])
            blocks.append(np.asarray(bids, np.int32))
        return {"tokens": toks, "blocks": blocks}

    @classmethod
    def restore(cls, snap: dict) -> "PrefixIndex":
        """Rebuild WITHOUT re-retaining: the pool snapshot's refcounts
        already include the index's references."""
        idx = cls()
        for t, b in zip(snap["tokens"], snap["blocks"]):
            t = np.asarray(t, np.int32)
            k = cls.key(t)
            idx._entries[k] = (len(t),
                               tuple(int(x) for x in np.asarray(b).ravel()))
            idx._tokens[k] = t.copy()
        return idx
