"""Port parity of the vlm family (llava's backbone) on the CPU: ``mm_proj``
and the patch embeddings placed before the text (``lm.embed_input``), the
loss over the text positions only, the contiguous engine's prefill with
patch embeddings and its decode, and paged serving of the text (JAX's
paged prefill takes tokens only), against the JAX package.

Config: ``tests/test_models.py::tiny("vlm")`` (2 layers, d 32, 4 heads
and 2 KV heads of 8, swiglu, RoPE, 8 patch embeddings), f32 and a bf16
twin.  Parameters come from ``repro.models.lm.init_params(
jax.random.key(0), cfg)`` through ``params_from_numpy``; tokens and patch
embeddings are numpy arrays from a seed.

Tolerances (as ``tests/test_torch_encdec.py``): f32 against jitted JAX,
|d| <= 1e-5 * max|ref|; bf16 against JAX run op by op, |d|/|ref| <= 1e-2
in L2; the int8 backend's prefill and decode, |d| <= 1e-3 * max|ref| (an
activation at an int8 rounding tie may move one payload step); token
streams exactly equal.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_models import tiny  # noqa: E402
from test_torch_encdec import (_j, _ref_ctx, _t,  # noqa: E402
                               assert_close, DTYPES, F32_FRAC, INT8_FRAC,
                               BF16_REL)
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

from repro.models import lm as JLM  # noqa: E402
from repro.serving import BatchScheduler as JSched  # noqa: E402
from repro.serving import EngineHooks as JHooks  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServe  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.serving import (BatchScheduler, EngineHooks,  # noqa: E402
                                 Request, ServeConfig, decode_step,
                                 paged_supported, prefill)
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path  # noqa: E402

PROMPT, STEPS, MAX_LEN = 10, 4, 24


def vlm_cfgs(dtype="float32", **kw):
    """(JAX config, port config) of the tiny vlm."""
    jc = tiny("vlm", compute_dtype=dtype, **kw)
    return jc, TMC(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def vlm_jparams():
    jc, _ = vlm_cfgs()
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, jp)


def vlm_params():
    jp = vlm_jparams()
    return (jax.tree.map(jnp.asarray, jp),
            TLM.params_from_numpy(jp, device="cpu"))


def vlm_batch(cfg, b=2, t=PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "patch_embeds": rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32)}


def test_params_tree_matches_jax():
    """``mm_proj`` [D, D] beside the dense stack, in JAX's tree."""
    _, tc = vlm_cfgs()
    ref = {k: (v.shape, v.dtype) for k, v in tree_leaves_with_path(
        TLM.params_from_numpy(vlm_jparams(), device="cpu"))}
    got = {k: (v.shape, v.dtype) for k, v in tree_leaves_with_path(
        TLM.init_params(tc, seed=0, device="cpu"))}
    assert got == ref and ref["mm_proj"][0] == (32, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_input_projects_and_places_patches(dtype):
    """x0 = [patch_embeds @ mm_proj ; text embeddings], positions 0..P+T-1
    for both, against JAX's ``embed_input``."""
    jc, tc = vlm_cfgs(dtype)
    jp, tp = vlm_params()
    batch = vlm_batch(tc)
    with _ref_ctx(dtype):
        rx, rpos = JLM.embed_input(jp, jc, _j(batch))
    x, pos = TLM.embed_input(tp, tc, _t(batch))
    P = tc.num_patches
    assert x.shape == (2, P + PROMPT, 32) and x.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    assert_close(x, rx, dtype)
    td = DTYPES[dtype][1]
    want = (torch.from_numpy(batch["patch_embeds"]).to(td)
            @ tp["mm_proj"].to(td))
    torch.testing.assert_close(x[:, :P], want, rtol=0, atol=0)
    torch.testing.assert_close(
        x[:, P:], tp["embed"].to(td)[torch.from_numpy(batch["tokens"])
                                     .long()], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(dtype):
    jc, tc = vlm_cfgs(dtype)
    jp, tp = vlm_params()
    batch = vlm_batch(tc)
    with _ref_ctx(dtype):
        lj, mj = JLM.loss_fn(jp, jc, _j(batch))
    lt, mt = TLM.loss_fn(tp, tc, _t(batch))
    tol = F32_FRAC if dtype == "float32" else BF16_REL
    assert abs(float(lt) - float(lj)) <= tol * abs(float(lj))
    assert float(mt["tokens"]) == float(mj["tokens"]) == 2 * PROMPT


def test_loss_ignores_patches():
    """``tests/test_models.py::test_vlm_loss_ignores_patches`` on the
    port: the hidden states span P + T positions, the loss counts the T
    text labels only and equals the CE of the text rows' logits."""
    _, tc = vlm_cfgs()
    _, tp = vlm_params()
    batch = _t(vlm_batch(tc, t=32))
    loss, m = TLM.loss_fn(tp, tc, batch)
    assert np.isfinite(float(loss))
    x = TLM.forward_hidden(tp, tc, batch)
    assert x.shape[1] == tc.num_patches + 32
    assert float(m["tokens"]) == 2 * 32
    logits = (x[:, tc.num_patches:] @ TLM.head_weight(tp, tc)).to(
        torch.float32)
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, tc.vocab_size),
                                           batch["labels"].reshape(-1).long())
    assert abs(float(ce) - float(loss)) <= 1e-5 * float(loss)


def test_loss_gradients_match_jax():
    """Autograd through ``mm_proj`` and the stack against ``jax.grad``
    (f32), every leaf."""
    jc, tc = vlm_cfgs()
    jp, tp = vlm_params()
    batch = vlm_batch(tc)
    ref = jax.grad(lambda p: JLM.loss_fn(p, jc, _j(batch))[0])(jp)
    leaves = [v.requires_grad_() for _, v in tree_leaves_with_path(tp)]
    loss, _ = TLM.loss_fn(tp, tc, _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    names = [k for k, _ in tree_leaves_with_path(tp)]
    assert "mm_proj" in names
    for k, g, r in zip(names, grads, jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(),
                                                          1e-3), k


@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
def test_prefill_with_patches_then_decode_match_jax(backend):
    """The contiguous engine: a prefill of the patch embeddings and the
    prompt (``pos`` = P + T after it), then STEPS decode steps on JAX's
    argmax tokens under each backend, logits and caches against JAX's."""
    from repro.kernels.ops import kernel_backend_ctx as j_ctx
    from repro_torch.kernels.ops import kernel_backend_ctx as t_ctx

    jc, tc = vlm_cfgs()
    jp, tp = vlm_params()
    batch = vlm_batch(tc, seed=1)
    max_len = tc.num_patches + MAX_LEN
    frac = INT8_FRAC if backend == "int8" else F32_FRAC
    with j_ctx(backend):
        logits, state = JE.prefill(jp, jc, _j(batch), max_len, jnp.float32,
                                   kernel_backend=backend)
        ref, toks = [np.asarray(logits)], []
        for _ in range(STEPS):
            toks.append(np.argmax(ref[-1], -1)[:, None].astype(np.int32))
            logits, state = JE.decode_step(jp, jc, state,
                                           jnp.asarray(toks[-1]))
            ref.append(np.asarray(logits))
    tl, ts = prefill(tp, tc, _t(batch), max_len, torch.float32,
                     kernel_backend=backend)
    assert int(ts["pos"]) == tc.num_patches + PROMPT
    got = [tl]
    with t_ctx(backend, "cpu"):
        for tok in toks:
            tl, ts = decode_step(tp, tc, ts, torch.from_numpy(tok))
            got.append(tl)
    for g, r in zip(got, ref):
        assert_close(g, r, frac=frac)
    assert int(ts["pos"]) == int(state["pos"])
    for k in ("k", "v"):
        assert_close(ts["caches"][k], np.asarray(state["caches"][k]),
                     frac=frac)


def test_decode_matches_forward():
    """Prefill the patches and 16 tokens, decode the next 8: the logits
    equal the full forward's text rows (f32 cache), within
    ``tests/test_serving.py``'s atol/rtol 2e-3."""
    _, tc = vlm_cfgs()
    _, tp = vlm_params()
    batch = _t(vlm_batch(tc, t=24, seed=2))
    P = tc.num_patches
    pre = dict(batch, tokens=batch["tokens"][:, :16])
    logits, state = prefill(tp, tc, pre, P + 24, torch.float32)
    outs = [logits]
    for i in range(7):
        logits, state = decode_step(tp, tc, state,
                                    batch["tokens"][:, 16 + i][:, None])
        outs.append(logits)
    x = TLM.forward_hidden(tp, tc, batch)[:, P:]
    full = (x @ TLM.head_weight(tp, tc)).to(torch.float32)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full[:, 15:23].numpy(), atol=2e-3, rtol=2e-3)


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, size=(8,)).astype(np.int32)
    reqs = []
    for i in range(5):
        tail = rng.integers(0, vocab, size=(2 + 3 * i,)).astype(np.int32)
        p = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
        reqs.append(cls(uid=i, prompt=p, max_new_tokens=5))
    return reqs


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_paged_text_serving_matches_jax(cache):
    """The vlm's paged path (text only, as JAX's): the scheduler's token
    streams, stats and tick log equal JAX's scheduler's, prefix sharing
    and copy-on-write included."""
    jc, tc = vlm_cfgs()
    jp, tp = vlm_params()
    assert paged_supported(tc) and JE.paged_supported(jc)
    kw = dict(num_slots=3, eos_id=None, max_len=40, block_size=4,
              cache_dtype=cache, prefill_chunk=6)
    js = JSched(JServe(**kw), JHooks.for_model(jp, jc, JServe(**kw)))
    ts = BatchScheduler(ServeConfig(**kw),
                        EngineHooks.for_model(tp, tc, ServeConfig(**kw)))
    jreqs = _requests(JRequest, tc.vocab_size)
    treqs = _requests(Request, tc.vocab_size)
    for a, b in zip(jreqs, treqs):
        js.submit(a)
        ts.submit(b)
    js.run_until_drained()
    ts.run_until_drained()
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert ts.stats == js.stats and ts.stats["prefix_hits"] > 0
    assert ts.tick_log == js.tick_log


def test_paged_prefill_chunk_matches_jax():
    """One text prompt prefilled in two chunks into the paged pool: the
    logits and the pool's K/V rows against JAX's ``paged_prefill_chunk``
    (f32)."""
    jc, tc = vlm_cfgs()
    jp, tp = vlm_params()
    toks = np.random.default_rng(4).integers(
        0, tc.vocab_size, (1, 9)).astype(np.int32)
    table = np.arange(1, 4, dtype=np.int32)[None]
    jpool = JE.init_paged_state(jc, 5, 4, jnp.float32)
    tpool = TE.init_paged_state(tc, 5, 4, torch.float32, device="cpu")
    for s, e in ((0, 5), (5, 9)):
        jl, jpool = JE.paged_prefill_chunk(jp, jc, jpool, jnp.asarray(table),
                                           jnp.asarray(toks[:, s:e]), s)
        tl, tpool = TE.paged_prefill_chunk(tp, tc, tpool,
                                           torch.from_numpy(table),
                                           torch.from_numpy(toks[:, s:e]), s)
        assert_close(tl, jl)
    for k in ("k", "v"):
        assert_close(tpool[k], np.asarray(jpool[k]))


def test_serve_cli_llava_paged_text():
    """The serve CLI on the reduced llava: paged by default (text only),
    every request to its last token; contiguous mode is refused, naming
    the patch embeddings the scheduler's prefill hook cannot pass."""
    report = TSERVE.main(["--device", "cpu", "--reduced", "--arch",
                          "llava-next-mistral-7b", "--slots", "2",
                          "--requests", "3", "--prompt-len", "6",
                          "--prompt-len-max", "12", "--max-new", "4",
                          "--max-len", "32", "--block-size", "8"])
    assert report["mode"] == "paged" and report["cfg"].family == "vlm"
    assert len(report["finished"]) == 3 and report["tokens"] == 12
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--device", "cpu", "--reduced", "--arch",
                     "llava-next-mistral-7b", "--mode", "contiguous",
                     "--requests", "1"])
    assert e.value.code == 2
