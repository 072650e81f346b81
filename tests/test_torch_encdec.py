"""Port parity of the encoder-decoder family (whisper's backbone) on the
CPU: ``models/lm.py``'s ``_sinusoid``, ``encode``, parameters and loss,
``models/blocks.py``'s ``_cross_attention``, ``decoder_block``, its cache,
prefill, decode and ``fill_cross_cache``, and the contiguous engine
(prefill, decode, greedy generation, the scheduler's snapshot/restore, the
paged refusal, the serve CLI's refusal) against the JAX package.

Config: ``tests/test_models.py::tiny("encdec")`` (2 encoder and 2 decoder
layers, d 32, 4 heads of 8, d_ff 64, 20 encoder frames, layernorm, gelu,
no RoPE), f32 and a bf16 twin.  Parameters come from
``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; tokens and frames are numpy arrays from a seed.

Tolerances, and why:
  * the sinusoid (f32): XLA's sin, cos and pow round a few values of the
    table otherwise than PyTorch's (~5% of them, by up to 4 ulps of the
    angle's range): |d| <= 2^-17 (observed <= 3.9e-6 at 1500 x 384).
  * f32 against jitted JAX: f32 sums and transcendentals in other orders,
    |d| <= 1e-5 * max|ref| (observed <= 2e-6).
  * bf16 against JAX run op by op (``jax.disable_jit``; jitted JAX fuses
    bf16 chains and moves by 1-2%): |d|/|ref| <= 1e-2 in L2, a few bf16
    steps.
  * the kernel backends' prefill and decode (f32 model, f32 cache) against
    JAX's with the same backend (its Pallas kernels in interpret mode):
    emulate as f32 (|d| <= 1e-5 * max|ref|); int8 re-quantizes every
    activation row to absmax/127 steps, and XLA's tanh in gelu rounds a
    few values an ulp from PyTorch's, which may move a payload by one
    step: |d| <= 1e-3 * max|ref| (observed 3.3e-7 * max|ref|, as
    emulate).
  * token streams, and streams continued after a restore: exactly equal.
"""
import contextlib
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

from repro.models import blocks as JB  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.serving import (BatchScheduler, EngineHooks,  # noqa: E402
                                 Request, ServeConfig, decode_step,
                                 greedy_generate, init_decode_state,
                                 init_paged_state, paged_supported, prefill)
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path  # noqa: E402

F32_FRAC = 1e-5
BF16_REL = 1e-2
INT8_FRAC = 1e-3
SINUSOID_ATOL = 2.0 ** -17
PROMPT, STEPS, MAX_LEN = 12, 4, 20
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def encdec_cfgs(dtype="float32", **kw):
    """(JAX config, port config) of the tiny encoder-decoder."""
    jc = tiny("encdec", compute_dtype=dtype, **kw)
    return jc, TMC(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def encdec_jparams():
    """JAX's initial weights of ``encdec_cfgs()`` as numpy (masters are
    f32 for either compute dtype)."""
    jc, _ = encdec_cfgs()
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, jp)


def encdec_params():
    jp = encdec_jparams()
    return (jax.tree.map(jnp.asarray, jp),
            TLM.params_from_numpy(jp, device="cpu"))


def encdec_batch(cfg, b=2, t=PROMPT, seed=0):
    """Tokens, labels and frames as numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "frames": rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, ref, dtype="float32", frac=F32_FRAC):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if dtype == "float32":
        err = np.abs(got - ref).max()
        assert err <= frac * np.abs(ref).max(), (err, np.abs(ref).max())
    else:
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= BF16_REL, rel


def _ref_ctx(dtype):
    """Jitted JAX for f32, JAX op by op for bf16 (module docstring)."""
    return (jax.disable_jit() if dtype == "bfloat16"
            else contextlib.nullcontext())


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("t,d,offset", [(1500, 384, 0), (1, 384, 37),
                                        (20, 32, 0), (4, 384, 1499)])
def test_sinusoid_matches_jax(t, d, offset):
    ref = np.asarray(JLM._sinusoid(t, d, offset))
    got = TLM._sinusoid(t, d, offset).numpy()
    assert got.dtype == np.float32 and got.shape == (t, d)
    assert np.abs(got - ref).max() <= SINUSOID_ATOL
    # a traced offset (JAX) and a host int (the port): decode's position
    one = TLM._sinusoid(1, d, offset).numpy()
    np.testing.assert_array_equal(one, TLM._sinusoid(offset + 1, d)
                                  .numpy()[offset:offset + 1])


def test_params_tree_matches_jax():
    """The port's initializer builds JAX's tree (keys, shapes, dtypes):
    ``enc_blocks`` and the decoder ``blocks`` stacked on their layer
    axes, ``enc_norm`` beside them."""
    jc, tc = encdec_cfgs()
    ref = {k: (v.shape, v.dtype) for k, v in tree_leaves_with_path(
        TLM.params_from_numpy(encdec_jparams(), device="cpu"))}
    got = {k: (v.shape, v.dtype) for k, v in tree_leaves_with_path(
        TLM.init_params(tc, seed=0, device="cpu"))}
    assert got == ref
    assert ref["enc_blocks/attn/wq"][0] == (2, 32, 4, 8)
    assert ref["blocks/cross_attn/wk"][0] == (2, 32, 4, 8)
    assert "enc_norm/bias" in ref and "blocks/self_norm/bias" in ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    jc, tc = encdec_cfgs(dtype)
    jp, tp = encdec_params()
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    enc = rng.standard_normal((2, 20, 32)).astype(np.float32)
    with _ref_ctx(dtype):
        ref = JB._cross_attention(_layer(jp["blocks"], 1)["cross_attn"],
                                  jnp.asarray(x, jd), jnp.asarray(enc, jd),
                                  jc)
    got = TB._cross_attention(TLM.layer_params(tp["blocks"], 1)
                              ["cross_attn"], torch.from_numpy(x).to(td),
                              torch.from_numpy(enc).to(td), tc)
    assert got.dtype == td
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_block_matches_jax(dtype):
    jc, tc = encdec_cfgs(dtype)
    jp, tp = encdec_params()
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    enc = rng.standard_normal((2, 20, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    with _ref_ctx(dtype):
        ref, raux = JB.decoder_block(_layer(jp["blocks"], 0),
                                     jnp.asarray(x, jd), jc,
                                     jnp.asarray(pos), jnp.asarray(enc, jd))
    got, aux = TB.decoder_block(TLM.layer_params(tp["blocks"], 0),
                                torch.from_numpy(x).to(td), tc,
                                torch.from_numpy(pos.copy()),
                                torch.from_numpy(enc).to(td))
    assert float(aux) == float(raux) == 0.0
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jc, tc = encdec_cfgs(dtype)
    jp, tp = encdec_params()
    frames = encdec_batch(tc)["frames"]
    with _ref_ctx(dtype):
        ref = JLM.encode(jp, jc, jnp.asarray(frames))
    got = TLM.encode(tp, tc, torch.from_numpy(frames))
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(dtype):
    jc, tc = encdec_cfgs(dtype)
    jp, tp = encdec_params()
    batch = encdec_batch(tc)
    with _ref_ctx(dtype):
        lj, mj = JLM.loss_fn(jp, jc, _j(batch))
    lt, mt = TLM.loss_fn(tp, tc, _t(batch))
    tol = F32_FRAC if dtype == "float32" else BF16_REL
    assert abs(float(lt) - float(lj)) <= tol * abs(float(lj))
    assert float(mt["tokens"]) == float(mj["tokens"]) == 2 * PROMPT
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0


def test_loss_gradients_match_jax():
    """Autograd through the port's encoder, cross-attention and decoder
    against ``jax.grad`` (f32): every leaf, ``enc_norm`` and the encoder's
    leaves included, within the f32 rule."""
    jc, tc = encdec_cfgs()
    jp, tp = encdec_params()
    batch = encdec_batch(tc)
    ref = jax.grad(lambda p: JLM.loss_fn(p, jc, _j(batch))[0])(jp)
    pg = {k: v for k, v in tp.items()}
    leaves = [v.requires_grad_() for _, v in tree_leaves_with_path(pg)]
    loss, _ = TLM.loss_fn(pg, tc, _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    names = [k for k, _ in tree_leaves_with_path(pg)]
    for k, g, r in zip(names, grads, jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(),
                                                          1e-3), k


def test_decode_matches_forward():
    """The encdec case of ``tests/test_serving.py::
    test_decode_matches_forward`` on the port: prefill 16 tokens, decode
    the next 8, against the full forward's logits (f32 cache), within
    that test's atol/rtol 2e-3."""
    _, tc = encdec_cfgs()
    _, tp = encdec_params()
    batch = _t(encdec_batch(tc, t=24, seed=3))
    pre = dict(batch, tokens=batch["tokens"][:, :16])
    logits, state = prefill(tp, tc, pre, 24, torch.float32)
    outs = [logits]
    for i in range(7):
        logits, state = decode_step(tp, tc, state,
                                    batch["tokens"][:, 16 + i][:, None])
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    x = TLM.forward_hidden(tp, tc, batch)
    full = (x @ TLM.head_weight(tp, tc)).to(torch.float32)
    np.testing.assert_allclose(dec.numpy(), full[:, 15:23].numpy(),
                               atol=2e-3, rtol=2e-3)


def _serve_jax(jc, jp, batch, backend, cache):
    """JAX's prefill and STEPS decode steps on the argmax tokens: (logits
    list, state after the prefill, final state, tokens fed)."""
    logits, state = JE.prefill(jp, jc, _j(batch), MAX_LEN, cache,
                               kernel_backend=backend)
    first = jax.tree.map(np.asarray, state)
    outs, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        toks.append(np.argmax(outs[-1], -1)[:, None].astype(np.int32))
        logits, state = JE.decode_step(jp, jc, state, jnp.asarray(toks[-1]))
        outs.append(np.asarray(logits))
    return outs, first, jax.tree.map(np.asarray, state), toks


@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
def test_prefill_decode_match_jax(backend):
    """Prefill with frames, then STEPS decode steps fed JAX's tokens, under
    each kernel backend (f32 model and cache): the logits and every cache
    leaf, ``cross_k``/``cross_v`` included, after the prefill and after
    the last step, against JAX's engine; ``pos`` counts the tokens."""
    from repro.kernels.ops import kernel_backend_ctx as j_ctx
    from repro_torch.kernels.ops import kernel_backend_ctx as t_ctx

    jc, tc = encdec_cfgs()
    jp, tp = encdec_params()
    batch = encdec_batch(tc, seed=4)
    frac = INT8_FRAC if backend == "int8" else F32_FRAC
    with j_ctx(backend):
        ref, ref_first, ref_last, toks = _serve_jax(jc, jp, batch, backend,
                                                    jnp.float32)
    logits, state = prefill(tp, tc, _t(batch), MAX_LEN, torch.float32,
                            kernel_backend=backend)
    assert int(state["pos"]) == PROMPT
    got = [logits]
    for path, leaf in tree_leaves_with_path(state["caches"]):
        assert_close(leaf, _at(ref_first["caches"], path), frac=frac)
    with t_ctx(backend, "cpu"):
        for tok in toks:
            logits, state = decode_step(tp, tc, state, torch.from_numpy(tok))
            got.append(logits)
    assert int(state["pos"]) == int(ref_last["pos"]) == PROMPT + STEPS
    for g, r in zip(got, ref):
        assert_close(g, r, frac=frac)
    for path, leaf in tree_leaves_with_path(state["caches"]):
        assert_close(leaf, _at(ref_last["caches"], path), frac=frac)


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_decode_state_matches_jax():
    """``init_decode_state``'s tree: JAX's keys, shapes and dtypes, the
    cross K/V [L, B, encoder_seq, Hkv, hd]."""
    jc, tc = encdec_cfgs()
    ref = JE.init_decode_state(jc, 3, 16, jnp.bfloat16)
    got = init_decode_state(tc, 3, 16, torch.bfloat16, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            tree_leaves_with_path(jax.tree.map(np.asarray, ref["caches"]))}
    have = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree_leaves_with_path(got["caches"])}
    assert have == want
    assert have["cross_k"][0] == (2, 3, 20, 4, 8)


def test_greedy_generate_equals_jax():
    jc, tc = encdec_cfgs()
    jp, tp = encdec_params()
    batch = encdec_batch(tc, seed=5)
    want = JE.greedy_generate(jp, jc, _j(batch), MAX_LEN, 6, jnp.float32)
    got = greedy_generate(tp, tc, _t(batch), MAX_LEN, 6, torch.float32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fill_cross_cache_matches_prefill():
    """``fill_cross_cache`` computes the cross K/V of every decoder layer
    as the prefill seeds them (and as JAX's does)."""
    jc, tc = encdec_cfgs()
    jp, tp = encdec_params()
    frames = encdec_batch(tc)["frames"]
    enc = TLM.encode(tp, tc, torch.from_numpy(frames))
    k, v = TB.fill_cross_cache(tp["blocks"], enc, tc, torch.float32)
    rk, rv = JB.fill_cross_cache(jp["blocks"], JLM.encode(
        jp, jc, jnp.asarray(frames)), jc, jnp.float32)
    assert_close(k, rk)
    assert_close(v, rv)
    _, state = prefill(tp, tc, _t(encdec_batch(tc)), MAX_LEN, torch.float32)
    torch.testing.assert_close(state["caches"]["cross_k"], k, rtol=0,
                               atol=0)
    torch.testing.assert_close(state["caches"]["cross_v"], v, rtol=0,
                               atol=0)


def _frame_hooks(tp, tc, serve, frames_of):
    """The scheduler's contiguous hooks with a prefill that hands the
    engine the request's frames (looked up by its prompt): the
    scheduler's own prefill hook passes tokens only, as JAX's does."""
    base = EngineHooks.for_model(tp, tc, serve)

    def prefill_one(tokens):
        f = frames_of[tuple(tokens[0].tolist())]
        return prefill(tp, tc, {"tokens": tokens,
                                "frames": torch.from_numpy(f[None])},
                       serve.max_len, serve.torch_cache_dtype())
    return dataclasses.replace(base, prefill=prefill_one)


def test_snapshot_restore_streams_equal():
    """Whisper's contiguous batch in the scheduler (frames through the
    prefill hook): a snapshot after 3 decode steps, restored into a fresh
    scheduler, continues every stream as the uninterrupted run; the
    snapshot's state holds the cross K/V in JAX's tree and shapes."""
    jc, tc = encdec_cfgs()
    _, tp = encdec_params()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tc.vocab_size, PROMPT).astype(np.int32)
               for _ in range(3)]
    frames_of = {tuple(p.tolist()): rng.standard_normal(
        (tc.encoder_seq, tc.d_model)).astype(np.float32) for p in prompts}
    serve = ServeConfig(num_slots=3, eos_id=None, max_len=MAX_LEN,
                        mode="contiguous", cache_dtype="float32")

    def start():
        sched = BatchScheduler(serve, _frame_hooks(tp, tc, serve, frames_of))
        reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        return sched, reqs

    sched, reqs = start()
    sched.run_until_drained()
    ref = {r.uid: list(r.generated) for r in reqs}
    for i, p in enumerate(prompts):   # each stream is its request's own
        one = greedy_generate(tp, tc, {
            "tokens": torch.from_numpy(p[None]),
            "frames": torch.from_numpy(frames_of[tuple(p.tolist())][None])},
            MAX_LEN, 6, torch.float32)
        assert ref[i] == one[0].tolist()
    sched, reqs = start()
    while sched.steps_run < 3:
        sched.step()
    snap = sched.snapshot()
    want = JE.init_decode_state(jc, 3, MAX_LEN, jnp.float32)["caches"]
    assert ({k: v.shape for k, v in tree_leaves_with_path(
        jax.tree.map(np.asarray, want))}
        == {k: v.shape for k, v in tree_leaves_with_path(
            snap["state"]["caches"])})
    resumed = BatchScheduler.restore(
        snap, hooks=_frame_hooks(tp, tc, serve, frames_of))
    done = {r.uid: list(r.generated) for r in resumed.run_until_drained()}
    assert done == ref


def test_paged_mode_refused_as_jax():
    """Cross-attention keeps the contiguous path in both packages: the
    paged pool refuses the encdec family with JAX's message."""
    jc, tc = encdec_cfgs()
    assert paged_supported(tc) is JE.paged_supported(jc) is False
    with pytest.raises(ValueError) as ref:
        JE.init_paged_state(jc, 8, 4)
    with pytest.raises(ValueError) as got:
        init_paged_state(tc, 8, 4, device="cpu")
    assert str(got.value) == str(ref.value)
    assert "paged KV unsupported for encdec" in str(got.value)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        TE.paged_decode_step({}, tc, {}, None, None, None)


@pytest.mark.parametrize("mode", ["auto", "contiguous", "paged"])
def test_serve_cli_refuses_encdec(mode, capsys):
    """The scheduler's prefill hook passes only tokens (JAX's CLI fails on
    the missing frames): the port's CLI refuses whisper before a weight is
    drawn, naming that cause."""
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--device", "cpu", "--reduced", "--arch",
                     "whisper-tiny", "--mode", mode, "--requests", "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "passes only the prompt's tokens" in err and "frames" in err
