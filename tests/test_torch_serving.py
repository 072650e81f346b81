"""Port parity of the paged serving path: layers, the paged engine, the
scheduler and the serve entry point, against the JAX package on the CPU.

The model is the reduced qwen1.5-0.5b twin (``_reduce``: 4 layers, d_model
128, 4 heads of 32, vocab 512, f32) and, for GQA, the same twin with 2 KV
heads.  Parameters come from ``repro.models.lm.init_params`` and cross over
through ``params_from_numpy``; prompts are numpy arrays from a seed.  On
CPU tensors the port's kernel wrappers run their plain PyTorch versions;
the JAX package runs its Pallas kernels in interpret mode or its jnp
fallbacks, as its own tests do.

Tolerances, and why:
  * f32 compute, f32 KV cache: the frameworks sum in different orders, so
    logits agree to |d| <= 1e-4 * max|ref| (observed ~1e-6).
  * int8 KV cache or the int8 datapath: a K/V row or an activation that
    sits at a rounding tie in one framework may quantize one int8 step
    away in the other; |d| <= 2e-2 * max|ref| bounds a few such steps.
  * scheduler token streams: exactly equal (greedy argmax of f32 logits
    whose differences are far below the gap between the top two).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ops as JO
from repro.launch.train import _reduce as j_reduce
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving import BatchScheduler as JSched
from repro.serving import EngineHooks as JHooks
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving import engine as JE
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops as TO
from repro_torch.launch import serve as TSERVE
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serving import (BatchScheduler, BlockPool, EngineHooks,
                                 PoolExhausted, PrefixIndex, Request,
                                 ServeConfig)
from repro_torch.serving import engine as TE

BS, MAXB = 8, 6                    # block size, blocks per slot


def _cfgs(hkv=None):
    jc = j_reduce(j_get_config("qwen1.5-0.5b"))
    tc = TSERVE._reduce(t_get_config("qwen1.5-0.5b"))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    if hkv is not None:
        jc = dataclasses.replace(jc, num_kv_heads=hkv)
        tc = dataclasses.replace(tc, num_kv_heads=hkv)
    return jc, tc


_PARAMS = {}


def _params(jc):
    key = jc.num_kv_heads
    if key not in _PARAMS:
        jp = JLM.init_params(jax.random.key(0), jc)
        _PARAMS[key] = (jp, TLM.params_from_numpy(
            jax.tree.map(np.asarray, jp)))
    return _PARAMS[key]


def _close(t, j, frac):
    t = t.detach().to(torch.float32).numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= frac * np.abs(j).max(), (err, np.abs(j).max())


def test_params_from_numpy_keeps_layout():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(
        jax.tree.map(np.asarray, jp)))
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tuple(tp["blocks"]["attn"]["wq"].shape) == (
        tc.num_layers, tc.d_model, tc.num_heads, tc.head_dim)
    shapes = jax.tree.map(lambda x: x.shape, jp)
    ours = TLM.init_params(tc, seed=0)
    assert jax.tree.map(lambda x: tuple(x.shape), ours,
                        is_leaf=torch.is_tensor) == shapes


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
def test_rmsnorm_rope_mlp_parity(backend):
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    pos = np.array([[0, 1, 2, 40, 41], [3, 4, 5, 6, 300]], np.int32)
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = TLM.layer_params(tp["blocks"], 0)
    np.testing.assert_allclose(
        TL.rmsnorm(tb["attn_norm"], torch.from_numpy(x), tc.norm_eps).numpy(),
        np.asarray(JL.rmsnorm(jb["attn_norm"], jnp.asarray(x),
                              jc.norm_eps)), rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                      tc.rope_theta).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                 jc.rope_theta)), rtol=1e-5, atol=1e-5)
    with JO.kernel_backend_ctx(backend):
        want = JL.mlp(jb["mlp"], jnp.asarray(x), jc)
    with TO.kernel_backend_ctx(backend, "cpu"):
        got = TL.mlp(tb["mlp"], torch.from_numpy(x), tc)
    _close(got, want, 1e-4 if backend != "int8" else 2e-2)


# ---------------------------------------------------------------------------
# the paged engine: prefill chunks, then one decode step
# ---------------------------------------------------------------------------

_PLENS = (13, 8, 21)               # slot 3 stays inactive (null table)


_PREFILLED = {}


def _prefill_both(jc, tc, jp, tp, cache):
    """Prefill three slots in ragged 5-token chunks on both sides (once per
    cache dtype); returns the JAX pool, a copy of the port's pool, tables,
    lens and the next tokens."""
    if cache not in _PREFILLED:
        jdt = {"float32": jnp.float32, "int8": jnp.int8}[cache]
        tdt = {"float32": torch.float32, "int8": torch.int8}[cache]
        nb = 1 + 4 * MAXB
        jpool = JE.init_paged_state(jc, nb, BS, jdt)
        tpool = TE.init_paged_state(tc, nb, BS, tdt)
        jchunk = jax.jit(lambda pool, table, toks, start:
                         JE.paged_prefill_chunk(jp, jc, pool, table, toks,
                                                start))
        rng = np.random.default_rng(1)
        tables = np.zeros((4, MAXB), np.int32)
        toks = np.zeros((4, 1), np.int32)
        for i, p in enumerate(_PLENS):
            tables[i] = 1 + i * MAXB + np.arange(MAXB)
            prompt = rng.integers(0, tc.vocab_size,
                                  size=(1, p)).astype(np.int32)
            for s in range(0, p, 5):                   # ragged 5-token chunks
                c = prompt[:, s:s + 5]
                jl, jpool = jchunk(jpool, jnp.asarray(tables[i:i + 1]),
                                   jnp.asarray(c), np.int32(s))
                tl, tpool = TE.paged_prefill_chunk(
                    tp, tc, tpool, torch.from_numpy(tables[i:i + 1]),
                    torch.from_numpy(c), s)
                _close(tl, jl, 1e-4 if cache == "float32" else 2e-2)
            toks[i, 0] = int(np.argmax(np.asarray(jl)[0]))
        lens = np.array(list(_PLENS) + [0], np.int32)
        _PREFILLED[cache] = (jpool, tpool, tables, lens, toks)
    jpool, tpool, tables, lens, toks = _PREFILLED[cache]
    return jpool, {k: v.clone() for k, v in tpool.items()}, tables, lens, toks


@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
def test_paged_prefill_and_decode_parity(backend, attn_impl, cache):
    jc, tc = _cfgs(hkv=2)
    jp, tp = _params(jc)
    jpool, tpool, tables, lens, toks = _prefill_both(jc, tc, jp, tp, cache)
    with JO.kernel_backend_ctx(backend):
        want, jpool = JE.paged_decode_step(
            jp, jc, jpool, jnp.asarray(tables), jnp.asarray(lens),
            jnp.asarray(toks), attn_impl)
    with TO.kernel_backend_ctx(backend, "cpu"):
        got, tpool2 = TE.paged_decode_step(
            tp, tc, tpool, torch.from_numpy(tables), torch.from_numpy(lens),
            torch.from_numpy(toks), attn_impl)
    assert tpool2 is tpool                             # updated in place
    active = len(_PLENS)
    exact = backend != "int8" and cache == "float32"
    _close(got[:active], np.asarray(want)[:active], 1e-4 if exact else 2e-2)
    # the decode step wrote each active slot's token at its position
    for i in range(active):
        bid, off = tables[i, lens[i] // BS], lens[i] % BS
        row = tpool["k"][:, bid, off].to(torch.float32).numpy()
        assert np.abs(row).max() > 0
        _close(tpool["k"][:, bid, off],
               np.asarray(jpool["k"])[:, bid, off], 1e-4 if exact else 2e-2)


# ---------------------------------------------------------------------------
# the scheduler and the serve entry point
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, size=(16,)).astype(np.int32)
    reqs = []
    for i in range(6):
        tail = rng.integers(0, vocab, size=(3 + 4 * i,)).astype(np.int32)
        p = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
        reqs.append(cls(uid=i, prompt=p, max_new_tokens=6))
    return reqs


def test_scheduler_token_streams_match_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    kw = dict(num_slots=3, eos_id=None, max_len=48, block_size=BS,
              cache_dtype="float32", prefill_chunk=8)
    js = JSched(JServe(**kw), JHooks.for_model(jp, jc, JServe(**kw)))
    ts = BatchScheduler(ServeConfig(**kw),
                        EngineHooks.for_model(tp, tc, ServeConfig(**kw)))
    jreqs, treqs = _requests(JRequest, tc.vocab_size), \
        _requests(Request, tc.vocab_size)
    for a, b in zip(jreqs, treqs):
        js.submit(a)
        ts.submit(b)
    js.run_until_drained()
    ts.run_until_drained()
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert ts.stats == js.stats
    assert ts.stats["prefix_hits"] > 0 and ts.stats["cow_copies"] > 0
    assert ts.tick_log == js.tick_log
    ts.release_prefix_cache()
    assert int(ts.block_pool.refs[1:].sum()) == 0   # block 0: the null


def test_block_pool_accounting():
    pool = BlockPool(5)
    assert pool.available() == 4          # block 0 reserved
    a, b = pool.alloc(), pool.alloc()
    pool.retain(a)
    pool.release(a)
    assert pool.available() == 2          # a still referenced
    pool.release(a)
    pool.release(b)
    assert pool.available() == 4
    for _ in range(4):
        pool.alloc()
    with pytest.raises(PoolExhausted):
        pool.alloc()


def test_prefix_index_longest_match_and_partial_boundary():
    pool = BlockPool(10)
    idx = PrefixIndex()
    prompt = np.arange(20, dtype=np.int32)  # Bs=8: blocks at 8, 16, +20
    table = [pool.alloc() for _ in range(3)]
    idx.register(prompt, table, 8, pool)
    assert len(idx) == 3                   # ends 8, 16, and partial 20
    longer = np.concatenate([prompt, np.arange(100, 106, dtype=np.int32)])
    n, blocks = idx.lookup(longer, len(longer) - 1)
    assert n == 20 and list(blocks) == table
    fork = np.concatenate([prompt[:8], np.arange(50, 60, dtype=np.int32)])
    n, blocks = idx.lookup(fork, len(fork) - 1)
    assert n == 8 and list(blocks) == table[:1]
    n, _ = idx.lookup(prompt, len(prompt) - 1)
    assert n == 16
    idx.drop(pool)
    assert pool.refs[table].tolist() == [1, 1, 1]   # back to alloc-only


@pytest.mark.parametrize("backend,cache", [("auto", "float32"),
                                           ("int8", "int8")])
def test_serve_entry_point_on_cpu(backend, cache):
    report = TSERVE.main(["--device", "cpu", "--reduced", "--slots", "3",
                          "--requests", "5", "--prompt-len", "6",
                          "--prompt-len-max", "20", "--shared-prefix", "8",
                          "--max-new", "4", "--max-len", "32",
                          "--block-size", "8", "--kernel-backend", backend,
                          "--cache-dtype", cache])
    assert len(report["finished"]) == 5
    assert all(len(r.generated) == 4 for r in report["finished"])
    assert report["tokens"] == 20 and report["device"] == "cpu"
    assert report["stats"]["prefix_hits"] > 0
