"""Port parity of MLA (DeepSeek-V2's multi-head latent attention) on the
CPU: ``models/layers.py``'s ``init_mla``, ``mla_attention`` (the
materialised prefill, full and chunked), ``init_mla_cache`` and
``mla_decode`` (the absorbed decode), the MLA transformer block, ``lm``
(parameters, the loss and its gradients), the contiguous engine (prefill,
decode, greedy generation, an int8 cache), the scheduler's contiguous
mode with snapshot / restore, the paged refusal and the serve CLI
(``--profile`` included), against the JAX package.

Configs: ``tests/test_models.py::tiny("moe", use_mla=True, ...)`` with a
latent rank of 16 and heads of 8 + 8 (nope + rope) query/key dims and 8
value dims (2 layers, d 32, 4 heads, 4 experts of 48 and one shared
expert), top-2 ("k2") and top-3 ("k3"), f32 and a bf16 twin.  Parameters
come from ``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; inputs are numpy arrays from a seed.

Tolerances, and why:
  * f32 against jitted JAX: f32 sums in other orders, |d| <= 1e-5 *
    max|ref| (observed <= 3e-6).
  * bf16 against JAX run op by op (``jax.disable_jit``; jitted JAX fuses
    bf16 chains and moves by 1-2%): |d|/|ref| <= 1e-2 in L2, a few bf16
    steps (observed 0: the same bits on this seed).
  * an int8 cache (JAX's unscaled cast, mirrored): a latent at a
    truncation edge may land one int8 step away in the other framework:
    |d| <= 2e-2 * max|ref| (the contiguous suite's).
  * the absorbed decode against the materialised prefill of the same
    tokens, f32, the port alone: |d| <= 1e-4 * max|ref| (the same
    attention summed in another order: w_uk applied to q, not to the
    latents).
  * token streams, and streams continued after a restore: exactly equal.
"""
import copy
import dataclasses
import functools
import json
import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_models import tiny  # noqa: E402

from repro.ckpt import save_checkpoint as j_save  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.serving import BatchScheduler as JSched  # noqa: E402
from repro.serving import EngineHooks as JHooks  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServe  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.ckpt import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.serving import (BatchScheduler, EngineHooks,  # noqa: E402
                                 Request, ServeConfig, decode_step,
                                 greedy_generate, init_decode_state, prefill)
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path  # noqa: E402

F32_FRAC = 1e-5
BF16_REL = 1e-2
INT8_FRAC = 2e-2
ABSORB_FRAC = 1e-4
T = 13
PROMPT, STEPS, MAX_LEN = 12, 4, 20
TOPK = {"k2": 2, "k3": 3}
MLA_KEYS = {"wq", "w_dkv", "w_kpe", "w_uk", "w_uv", "wo", "ckv_norm/scale"}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mla_cfgs(k="k3", dtype="float32", **kw):
    """(JAX config, port config) of the tiny MLA moe model, top-``k``."""
    jc = tiny("moe", use_mla=True, kv_lora_rank=16, qk_nope_dim=8,
              qk_rope_dim=8, v_head_dim=8, experts_per_token=TOPK[k],
              compute_dtype=dtype, **kw)
    return jc, TMC(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def mla_jparams(k="k3"):
    """JAX's initial weights of ``mla_cfgs(k)`` as numpy (the same for
    either compute dtype: masters are f32)."""
    jc, _ = mla_cfgs(k)
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, jp)


def mla_params(k="k3"):
    """JAX's weights (JAX arrays) and the port's copy on the CPU."""
    jp = mla_jparams(k)
    return (jax.tree.map(jnp.asarray, jp),
            TLM.params_from_numpy(jp, device="cpu"))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _close(got, ref, frac=F32_FRAC):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    err = np.abs(g - r).max()
    assert err <= frac * np.abs(r).max(), (err, np.abs(r).max())


def _rel_l2(got, ref, tol=BF16_REL):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    rel = np.linalg.norm(g - r) / np.linalg.norm(r)
    assert rel <= tol, rel


def _check(dtype):
    return _close if dtype == "float32" else _rel_l2


def _jax_run(dtype, fn, *args):
    """``fn(*args)`` jitted in f32, op by op in bf16."""
    if dtype == "float32":
        return jax.jit(fn)(*args)
    with jax.disable_jit():
        return fn(*args)


def _x(jc, dtype, b=2, t=T, seed=7):
    x = np.random.default_rng(seed).standard_normal(
        (b, t, jc.d_model)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _pos(b, t):
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", list(TOPK))
def test_init_params_tree_matches_jax(k):
    """The port's initializer draws JAX's tree: MLA's six matrices and the
    latent norm's scale under ``attn``, with JAX's shapes and dtypes,
    stacked on the layer axis."""
    jc, tc = mla_cfgs(k)
    ref = {p: (v.shape, v.dtype) for p, v in
           tree_leaves_with_path(mla_jparams(k))}
    got = {p: (tuple(v.shape), np.dtype(str(v.dtype).split(".")[-1]))
           for p, v in tree_leaves_with_path(
               TLM.init_params(tc, seed=0, device="cpu"))}
    assert got == ref
    attn = {p[len("blocks/attn/"):] for p in got
            if p.startswith("blocks/attn/")}
    assert attn == MLA_KEYS
    L, D, H = jc.num_layers, jc.d_model, jc.num_heads
    assert got["blocks/attn/wq"][0] == (L, D, H, 16)
    assert got["blocks/attn/w_uk"][0] == (L, 16, H, 8)
    assert got["blocks/attn/wo"][0] == (L, H, 8, D)


# ---------------------------------------------------------------------------
# the layer: prefill (full and chunked), cache, decode
# ---------------------------------------------------------------------------

def _attn_params(jp, tp, i=1):
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["attn"]),
            TLM.layer_params(tp["blocks"], i)["attn"])


@pytest.mark.parametrize("return_cache", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(dtype, return_cache):
    jc, tc = mla_cfgs("k3", dtype)
    ja, ta = _attn_params(*mla_params())
    jx, tx = _x(jc, dtype)
    jpos, tpos = _pos(2, T)
    ref = _jax_run(dtype, lambda p, x: JL.mla_attention(
        p, x, jc, jpos, return_cache=return_cache), ja, jx)
    with torch.no_grad():
        got = TL.mla_attention(ta, tx, tc, tpos, return_cache=return_cache)
    if not return_cache:
        ref, got = (ref, ()), (got, ())
    assert got[0].dtype == tx.dtype
    _check(dtype)(got[0], ref[0])
    for g, r in zip(got[1], ref[1]):     # c_kv [B,T,r], k_pe [B,T,dr]
        assert g.dtype == tx.dtype
        _check(dtype)(g, r)
    if return_cache:
        assert tuple(got[1][0].shape) == (2, T, 16)
        assert tuple(got[1][1].shape) == (2, T, 8)


def test_mla_attention_chunked_matches_jax(monkeypatch):
    """A T above a lowered chunk threshold (both packages' modules) takes
    ``_sdpa_chunked``, over KV blocks of 8 with a ragged last block; it
    matches JAX's chunked path and the port's own full path."""
    jc, tc = mla_cfgs("k3")
    ja, ta = _attn_params(*mla_params())
    t = 37
    jx, tx = _x(jc, "float32", t=t)
    jpos, tpos = _pos(2, t)
    with torch.no_grad():
        full = TL.mla_attention(ta, tx, tc, tpos)
    calls = []
    chunked = TL._sdpa_chunked
    monkeypatch.setattr(TL, "_sdpa_chunked",
                        lambda *a: calls.append(1) or chunked(*a))
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "ATTN_CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "ATTN_KV_BLOCK", 8)
    ref = jax.jit(lambda p, x: JL.mla_attention(p, x, jc, jpos))(ja, jx)
    with torch.no_grad():
        got = TL.mla_attention(ta, tx, tc, tpos)
    assert calls == [1]
    _close(got, ref)
    _close(got, full)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_mla_cache_matches_jax(dtype):
    jc, tc = mla_cfgs("k3")
    jd, td = DTYPES[dtype]
    ref = JL.init_mla_cache(jc, 3, 11, jd)
    got = TL.init_mla_cache(tc, 3, 11, td, device="cpu")
    assert set(got) == set(ref) == {"ckv", "kpe"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert got[k].dtype == td and ref[k].dtype == jd
        assert not got[k].any()
    assert tuple(got["ckv"].shape) == (3, 11, tc.kv_lora_rank)
    assert tuple(got["kpe"].shape) == (3, 11, tc.qk_rope_dim)
    state = init_decode_state(tc, 3, 11, td, device="cpu")
    jstate = JE.init_decode_state(jc, 3, 11, jd)
    for k in ("ckv", "kpe"):
        assert tuple(state["caches"][k].shape) == \
            jstate["caches"][k].shape == (jc.num_layers,) + ref[k].shape
        assert state["caches"][k].dtype == td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_after_prefill_matches_jax(dtype):
    """The layer alone: a prefill's latents padded into a cache, then
    three absorbed decode steps, each writing its row in place."""
    jc, tc = mla_cfgs("k3", dtype)
    ja, ta = _attn_params(*mla_params())
    jx, tx = _x(jc, dtype, t=T + 3)
    jd, td = DTYPES[dtype]
    jpos, tpos = _pos(2, T)
    _, (jc_kv, jk_pe) = JL.mla_attention(ja, jx[:, :T], jc, jpos,
                                         return_cache=True)
    jcache = {"ckv": jnp.pad(jc_kv, ((0, 0), (0, 3), (0, 0))).astype(jd),
              "kpe": jnp.pad(jk_pe, ((0, 0), (0, 3), (0, 0))).astype(jd)}
    with torch.no_grad():
        _, (c_kv, k_pe) = TL.mla_attention(ta, tx[:, :T], tc, tpos,
                                           return_cache=True)
        tcache = {"ckv": torch.nn.functional.pad(c_kv, (0, 0, 0, 3)),
                  "kpe": torch.nn.functional.pad(k_pe, (0, 0, 0, 3))}
    for i in range(3):
        jy, jcache = _jax_run(dtype, lambda p, x, c: JL.mla_decode(
            p, x, jc, c, T + i), ja, jx[:, T + i:T + i + 1], jcache)
        with torch.no_grad():
            ty, out = TL.mla_decode(ta, tx[:, T + i:T + i + 1], tc, tcache,
                                    T + i)
        assert out is tcache and tuple(ty.shape) == (2, 1, jc.d_model)
        _check(dtype)(ty, jy)
    for k in ("ckv", "kpe"):
        _check(dtype)(tcache[k], jcache[k])


def test_absorbed_decode_matches_materialised_prefill():
    """The two MLA code paths of the port against each other: the decode's
    logits at position t (the absorbed product over the latent cache)
    equal the last logits of a prefill of the t + 1 tokens (per-head K/V
    materialised), for t = PROMPT .. PROMPT + STEPS - 1."""
    _, tc = mla_cfgs("k3")
    _, tp = mla_params()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, PROMPT + STEPS)).astype(np.int32))
    _, state = prefill(tp, tc, {"tokens": toks[:, :PROMPT]}, MAX_LEN,
                       torch.float32, kernel_backend="off")
    for t in range(PROMPT, PROMPT + STEPS):
        dec, state = decode_step(tp, tc, state, toks[:, t:t + 1])
        mat, _ = prefill(tp, tc, {"tokens": toks[:, :t + 1]}, MAX_LEN,
                         torch.float32, kernel_backend="off")
        _close(dec, mat, ABSORB_FRAC)


# ---------------------------------------------------------------------------
# the block and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", list(TOPK))
def test_transformer_block_matches_jax(k):
    jc, tc = mla_cfgs(k)
    jp, tp = mla_params(k)
    jb = jax.tree.map(lambda a: a[1], jp["blocks"])
    tb = TLM.layer_params(tp["blocks"], 1)
    jx, tx = _x(jc, "float32")
    jpos, tpos = _pos(2, T)
    jy, jaux = jax.jit(lambda p, x: JB.transformer_block(p, x, jc, jpos))(
        jb, jx)
    with torch.no_grad():
        ty, taux = TB.transformer_block(tb, tx, tc, tpos)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= 1e-6 and float(taux) > 0


def _batch(vocab, b=2, t=T, seed=19):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


def test_loss_and_gradients_match_jax():
    """``lm.loss_fn`` and autograd's gradient of every leaf, the six MLA
    matrices and the latent norm included, against ``jax.grad``."""
    jc, tc = mla_cfgs("k3")
    jp, tp = mla_params()
    batch = _batch(jc.vocab_size)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JLM.loss_fn(p, jc, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves_with_path(tp)
    for _, w in leaves:
        w.requires_grad_()
    lt, _ = TLM.loss_fn(tp, tc, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(lt, [w for _, w in leaves])
    assert float(lt.detach()) == pytest.approx(float(jl), rel=F32_FRAC)
    jgl = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jg)))
    assert set(jgl) == {p for p, _ in leaves}
    for (p, _), g in zip(leaves, grads):
        _close(g, jgl[p])
    for key in MLA_KEYS:
        g = dict(zip([p for p, _ in leaves], grads))["blocks/attn/" + key]
        assert float(g.abs().max()) > 0, key


# ---------------------------------------------------------------------------
# the contiguous engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", list(TOPK))
def test_prefill_and_decode_match_jax(k, dtype):
    """A prefill of PROMPT tokens of two rows, then STEPS decode steps:
    the logits of each and the stacked latent caches of JAX's layout."""
    jc, tc = mla_cfgs(k, dtype)
    jp, tp = mla_params(k)
    jd, td = DTYPES[dtype]
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, PROMPT + STEPS)).astype(np.int32)
    jl, js = _jax_run(dtype, lambda p, t: JE.prefill(
        p, jc, {"tokens": t}, MAX_LEN, jd, kernel_backend="off"),
        jp, jnp.asarray(toks[:, :PROMPT]))
    jls = [jl]
    for i in range(STEPS):
        jl, js = _jax_run(dtype, lambda p, s, t: JE.decode_step(p, jc, s, t),
                          jp, js, jnp.asarray(toks[:, PROMPT + i:
                                                   PROMPT + i + 1]))
        jls.append(jl)
    tl, ts = prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                     MAX_LEN, td, kernel_backend="off")
    tls = [tl]
    for i in range(STEPS):
        tl, ts = decode_step(tp, tc, ts, torch.from_numpy(
            toks[:, PROMPT + i:PROMPT + i + 1]))
        tls.append(tl)
    for g, r in zip(tls, jls):
        _check(dtype)(g, r)
    assert int(ts["pos"]) == int(js["pos"]) == PROMPT + STEPS
    assert set(ts["caches"]) == set(js["caches"]) == {"ckv", "kpe"}
    for key in ("ckv", "kpe"):
        assert ts["caches"][key].dtype == td
        assert tuple(ts["caches"][key].shape) == js["caches"][key].shape
        _check(dtype)(ts["caches"][key], js["caches"][key])


def test_int8_cache_matches_jax():
    """An int8 contiguous cache: the latents and rope keys cast with no
    scale, as JAX casts them (truncated toward zero)."""
    jc, tc = mla_cfgs("k3")
    jp, tp = mla_params()
    toks = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, PROMPT + 2)).astype(np.int32)
    jl, js = JE.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                        MAX_LEN, jnp.int8, kernel_backend="off")
    tl, ts = prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                     MAX_LEN, torch.int8, kernel_backend="off")
    _close(tl, jl)
    jdec = jax.jit(lambda s, t: JE.decode_step(jp, jc, s, t))
    for i in range(2):
        tok = toks[:, PROMPT + i:PROMPT + i + 1]
        jl, js = jdec(js, jnp.asarray(tok))
        tl, ts = decode_step(tp, tc, ts, torch.from_numpy(tok))
        _close(tl, jl, INT8_FRAC)
    for key in ("ckv", "kpe"):
        assert ts["caches"][key].dtype == torch.int8
        _close(ts["caches"][key], js["caches"][key], INT8_FRAC)


@pytest.mark.parametrize("k", list(TOPK))
def test_greedy_generate_tokens_equal_jax(k):
    jc, tc = mla_cfgs(k)
    jp, tp = mla_params(k)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 10)).astype(np.int32)
    want = jax.jit(lambda p, t: JE.greedy_generate(
        p, jc, {"tokens": t}, MAX_LEN, 8, jnp.float32))(jp, jnp.asarray(toks))
    got = greedy_generate(tp, tc, {"tokens": torch.from_numpy(toks)},
                          MAX_LEN, 8, torch.float32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the scheduler's contiguous mode, snapshot / restore
# ---------------------------------------------------------------------------

def _serve(**kw):
    return dict(dict(num_slots=2, eos_id=None, max_len=MAX_LEN,
                     cache_dtype="float32", mode="contiguous"), **kw)


def _port_sched(tp, tc, **kw):
    sc = ServeConfig(**_serve(**kw))
    return BatchScheduler(sc, EngineHooks.for_model(tp, tc, sc))


def _jax_sched(jp, jc, **kw):
    sc = JServe(**_serve(**kw))
    return JSched(sc, JHooks.for_model(jp, jc, sc))


def _prompts(seed, n=4, t=10, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (t,)).astype(np.int32) for _ in range(n)]


def _submit(sched, prompts, cls=Request):
    reqs = [cls(uid=i, prompt=p.copy(), max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    return reqs


def _drain(sched, prompts, cls=Request):
    _submit(sched, prompts, cls)
    return {r.uid: list(r.generated) for r in sched.run_until_drained()}


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return np.asarray(tree)


def _mid_stream(sched, prompts, cls=Request, steps=3):
    reqs = _submit(sched, prompts, cls)
    for _ in range(steps):
        sched.step()
    snap = sched.snapshot()
    assert len(snap["slot_reqs"]) > 0 and len(snap["pending"]) > 0
    return reqs, snap


def _continue(resumed, reqs):
    out = {r.uid: list(r.generated) for r in reqs if r.done}
    out.update({r.uid: list(r.generated)
                for r in resumed.run_until_drained()})
    return out


def test_scheduler_streams_equal_jax_and_restore_continues(tmp_path):
    """Four equal-length prompts on two slots: the port's streams equal
    JAX's scheduler's; a snapshot mid-stream (bf16 latents, widened to
    f32 in the snapshot) through the port's checkpoint layer, restored
    into a fresh scheduler, continues as the uninterrupted run, its
    latents back in bf16 and the snapshot left as it was."""
    jc, tc = mla_cfgs("k3")
    jp, tp = mla_params()
    prompts = _prompts(5, vocab=jc.vocab_size)
    ref = _drain(_jax_sched(jp, jc), prompts, JRequest)
    assert len(ref) == 4 and _drain(_port_sched(tp, tc), prompts) == ref
    bf = _drain(_port_sched(tp, tc, cache_dtype="bfloat16"), prompts)
    reqs, snap = _mid_stream(_port_sched(tp, tc, cache_dtype="bfloat16"),
                             prompts)
    kept = copy.deepcopy(snap)
    assert snap["state"]["caches"]["ckv"].dtype == np.float32
    save_checkpoint(tmp_path, 1, snap)
    loaded, _, _ = restore_checkpoint(tmp_path, _as_numpy(snap))
    sc = ServeConfig(**_serve(cache_dtype="bfloat16"))
    resumed = BatchScheduler.restore(loaded,
                                     hooks=EngineHooks.for_model(tp, tc, sc))
    assert resumed.state["caches"]["ckv"].dtype == torch.bfloat16
    assert resumed.state["caches"]["kpe"].dtype == torch.bfloat16
    assert _continue(resumed, reqs) == bf
    assert jax.tree.map(lambda a: np.asarray(a).tolist(), snap) == \
        jax.tree.map(lambda a: np.asarray(a).tolist(), kept)


def test_jax_mla_snapshot_restores_in_the_port(tmp_path):
    """A JAX contiguous MLA scheduler snapshotted mid-stream, through JAX's
    checkpoint layer, restored by the port, continues as JAX's
    uninterrupted run."""
    jc, tc = mla_cfgs("k2")
    jp, tp = mla_params("k2")
    prompts = _prompts(7, vocab=jc.vocab_size)
    ref = _drain(_jax_sched(jp, jc), prompts, JRequest)
    jreqs, jsnap = _mid_stream(_jax_sched(jp, jc), prompts, JRequest)
    j_save(tmp_path, 1, jsnap)
    loaded, _, _ = restore_checkpoint(tmp_path, _as_numpy(jsnap))
    hooks = EngineHooks.for_model(tp, tc, ServeConfig(**_serve()))
    assert _continue(BatchScheduler.restore(loaded, hooks=hooks),
                     jreqs) == ref


# ---------------------------------------------------------------------------
# the paged refusal and the serve CLI
# ---------------------------------------------------------------------------

def test_paged_mode_refuses_mla_as_jax():
    """MLA keeps the contiguous latent cache: both packages refuse a paged
    pool for it with the same message, the serve CLI's ``--mode paged``
    raises it, and ``--mode auto`` picks contiguous."""
    jc, tc = mla_cfgs("k3")
    assert not TE.paged_supported(tc) and not JE.paged_supported(jc)
    with pytest.raises(ValueError) as je:
        JE.init_paged_state(jc, 4, 8, jnp.float32)
    with pytest.raises(ValueError, match="paged KV unsupported") as te:
        TE.init_paged_state(tc, 4, 8, torch.float32, device="cpu")
    assert str(te.value) == str(je.value)
    argv = ["--device", "cpu", "--reduced", "--arch",
            "deepseek-v2-lite-16b", "--requests", "2", "--max-new", "3"]
    with pytest.raises(ValueError, match="paged KV unsupported"):
        TSERVE.main(argv + ["--mode", "paged"])
    assert TSERVE.main(argv)["mode"] == "contiguous"


def test_serve_cli_profile_writes_a_trace_and_keeps_the_streams(
        tmp_path, monkeypatch, capsys):
    """``--profile 2`` on the reduced deepseek-v2-lite-16b: the trace
    directory is printed and holds a Chrome trace of the ticks, and the
    generated streams equal those of the same run without the flag."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu", "--reduced", "--arch",
            "deepseek-v2-lite-16b", "--requests", "4", "--max-new", "5"]
    plain = TSERVE.main(argv)
    traced = TSERVE.main(argv + ["--profile", "2"])
    assert plain["trace_dir"] is None and plain["mode"] == "contiguous"
    trace = pathlib.Path(traced["trace_dir"])
    assert trace.parent == tmp_path
    assert f"profiler trace (2 tick(s)): {trace}" in capsys.readouterr().out
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)

    def streams(rep):
        return {r.uid: list(r.generated) for r in rep["finished"]}
    assert len(streams(plain)) == 4
    assert streams(traced) == streams(plain)
