"""Port parity of the moe family and of sliding-window decode on the CPU:
``models/layers.py``'s routing and per-row capacity dispatch (``moe_route``,
``moe_verbose``, ``moe``, ``moe_capacity``, ``moe_aux_from_stats``), the
moe transformer block, ``lm`` (parameters, the loss and its gradients),
the contiguous engine (prefill and decode, a sliding window's ring), the
scheduler's contiguous mode and the paged engine's moe block, against the
JAX package.

Configs: ``tests/test_models.py::tiny("moe")`` (2 layers, d 32, 4 experts
of 48, top-2, one shared expert, f32), and the reduced mixtral-8x7b twin
(``launch.train._reduce``: 4 layers, d 128, 4 experts of 64, top-2, a
window of 4096); for the ring, tiny("moe") and tiny("dense") with
``swa_window`` 8 over 24 positions.  Parameters come from
``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; inputs are numpy arrays from a seed.  Everything is
f32, and JAX runs jitted, except where a test records JAX's routing
tensors op by op (``jax.disable_jit``, f32 and tiny: the same values).

Tolerances, and why:
  * routing and dispatch (top_e, the sort ``order``, ``slot``, ``keep``)
    and ``frac``: bitwise.  A tie in the router breaks toward the lower
    expert, as ``lax.top_k`` breaks it (the "tie" case forces ties).
  * ``probs_mean``, the renormalised ``top_p`` and the aux: |d| <= 1e-6
    (f32 sums of at most 8 terms in another order).
  * outputs, logits, losses and gradients: f32 sums in other orders,
    |d| <= 1e-5 * max|ref| (observed <= 1e-6); with the int8 decode
    backend (the fused prologue's int8 operands) 2e-2 * max|ref|, as
    ``tests/test_torch_serving_contiguous.py``.
  * token streams: equal.
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

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.launch.train import _reduce as j_reduce  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.serving import BatchScheduler as JSched  # noqa: E402
from repro.serving import EngineHooks as JHooks  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServe  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch.train import _reduce as t_reduce  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.serving import (BatchScheduler, EngineHooks,  # noqa: E402
                                 Request, ServeConfig, decode_step, prefill)
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path  # noqa: E402

F32_FRAC = 1e-5
INT8_FRAC = 2e-2
STAT_TOL = 1e-6
T = 21                       # tokens of a row in the layer checks
CONFIGS = ("tiny", "mixtral")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """(JAX config, port config) of ``name``: "tiny" (tiny("moe")),
    "mixtral" (the reduced mixtral-8x7b) or "dense" (tiny("dense"))."""
    if name == "mixtral":
        jc = j_reduce(j_get_config("mixtral-8x7b"))
        tc = t_reduce(t_get_config("mixtral-8x7b"))
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        jc = dataclasses.replace(jc, **kw)
    else:
        jc = tiny("moe" if name == "tiny" else name, **kw)
    return jc, TMC(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def _jparams(name, **kw):
    jc, _ = _cfgs(name, **kw)
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, jp)


def _params(name, **kw):
    """JAX's weights (as JAX arrays, so that jitted serving steps can
    index the embedding with traced tokens) and the port's copy."""
    jp = _jparams(name, **kw)
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


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

def _tie_router(router):
    """Router columns 1-3 made equal, column 0 their negation: every
    token's top two picks come from a three-way tie (or 0 and a two-way
    tie for the second pick), which ``lax.top_k`` breaks toward the lower
    expert."""
    r = np.array(router, copy=True)
    r[..., 2] = r[..., 1]
    r[..., 3] = r[..., 1]
    r[..., 0] = -r[..., 1]
    return r


CASES = {"tiny": ("tiny", {}), "drop": ("tiny", {"capacity_factor": 0.5}),
         "tie": ("tiny", {}), "mixtral": ("mixtral", {})}


def _case(case):
    """(JAX config, port config, JAX moe params of layer 0, the port's,
    x [3, T, D] numpy)."""
    name, kw = CASES[case]
    jc, tc = _cfgs(name, **kw)
    jp = jax.tree.map(lambda a: a[0], _jparams(name)["blocks"]["moe"])
    if case == "tie":
        jp = dict(jp, router=_tie_router(jp["router"]))
    tp = TLM.params_from_numpy(jp, device="cpu")
    x = np.random.default_rng(5).standard_normal(
        (3, T, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, x


def _jax_routing(monkeypatch, jp, x, jc):
    """JAX's ``moe_verbose`` op by op, recording its routing tensors: the
    raw top-k (``lax.top_k``), the per-row sort (``jnp.argsort``), and
    ``slot`` with its condition ``keep`` (the first integer
    ``jnp.where`` of the row shape).  Returns (out, frac, probs_mean,
    record)."""
    rec = {}
    top_k, argsort, where = jax.lax.top_k, jnp.argsort, jnp.where

    def rec_top_k(a, k):
        out = top_k(a, k)
        rec.setdefault("top", out)
        return out

    def rec_argsort(a, *args, **kw):
        out = argsort(a, *args, **kw)
        rec.setdefault("order", out)
        return out

    def rec_where(c, *args, **kw):
        out = where(c, *args, **kw)
        if (len(args) == 2 and "slot" not in rec and "order" in rec
                and jnp.issubdtype(out.dtype, jnp.integer)
                and out.shape == c.shape):
            rec["keep"], rec["slot"] = c, out
        return out
    monkeypatch.setattr(JL.lax, "top_k", rec_top_k)
    monkeypatch.setattr(JL.jnp, "argsort", rec_argsort)
    monkeypatch.setattr(JL.jnp, "where", rec_where)
    with jax.disable_jit():
        out, frac, pm = JL.moe_verbose(jp, jnp.asarray(x), jc)
    monkeypatch.undo()
    return out, frac, pm, rec


@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_dispatch_match_jax_bitwise(case, monkeypatch):
    jc, tc, jp, tp, x = _case(case)
    _, jfrac, jpm, rec = _jax_routing(monkeypatch, jp, x, jc)
    with torch.no_grad():
        r = TL.moe_route(tp, torch.from_numpy(x), tc)
    j_top_p, j_top_e = rec["top"]
    assert r["C"] == JL.moe_capacity(jc, T)
    np.testing.assert_array_equal(r["top_e"].numpy(), np.asarray(j_top_e))
    for k in ("order", "slot", "keep"):
        np.testing.assert_array_equal(r[k].numpy(), np.asarray(rec[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(r["frac"].numpy(), np.asarray(jfrac))
    j_top_p = np.asarray(j_top_p) / np.asarray(j_top_p).sum(-1,
                                                             keepdims=True)
    np.testing.assert_allclose(r["top_p"].numpy(), j_top_p, rtol=0,
                               atol=STAT_TOL)
    np.testing.assert_allclose(r["probs_mean"].numpy(), np.asarray(jpm),
                               rtol=0, atol=STAT_TOL)
    np.testing.assert_array_equal(r["stok"].numpy(),
                                  np.asarray(rec["order"]) // 2)
    keep = r["keep"].numpy()
    if case in ("drop", "tie"):  # capacity 8 (16) of 42 picks on 4 (2)
        assert not keep.all()    # experts: some dropped
    if case == "tie":            # the K-th and (K+1)-th probabilities tie
        srt = np.sort(r["probs"].numpy(), axis=-1)[..., ::-1]
        assert (srt[..., 1] == srt[..., 2]).mean() > 0.9


def test_top_k_breaks_ties_as_lax_top_k():
    """Many exact ties (values on a grid of 5 levels): the indices equal
    ``lax.top_k``'s, the lower index first among equals."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 5, (64, 8)).astype(np.float32) / 4
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(a), k)
        tv, ti = TL.top_k_lower_first(torch.from_numpy(a), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_jax(case):
    """The layer's output (within f32 tolerance), its statistics and the
    aux; "drop" drops picks past the capacity, "tie" breaks router ties."""
    jc, tc, jp, tp, x = _case(case)
    jout, jfrac, jpm = jax.jit(lambda p, x: JL.moe_verbose(p, x, jc))(
        jp, jnp.asarray(x))
    jaux = JL.moe_aux_from_stats(jfrac, jpm)
    with torch.no_grad():
        out, frac, pm = TL.moe_verbose(tp, torch.from_numpy(x), tc)
        o2, aux = TL.moe(tp, torch.from_numpy(x), tc)
    _close(out, jout)
    assert torch.equal(o2, out)
    # jitted, XLA takes the mean as a product with 1/n: one ulp from the
    # division of op-by-op JAX, which the routing test holds bitwise
    np.testing.assert_allclose(frac.numpy(), np.asarray(jfrac), rtol=0,
                               atol=STAT_TOL)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), rtol=0,
                               atol=STAT_TOL)
    assert abs(float(aux) - float(jaux)) <= STAT_TOL
    assert float(aux) == pytest.approx(float(TL.moe_aux_from_stats(frac,
                                                                   pm)))


@pytest.mark.parametrize("t,cf", [(1, 1.25), (21, 1.25), (21, 0.5),
                                  (128, 1.25), (4096, 1.25)])
def test_capacity_matches_jax(t, cf):
    for name in CONFIGS:
        jc, tc = _cfgs(name, capacity_factor=cf)
        assert TL.moe_capacity(tc, t) == JL.moe_capacity(jc, t)
    full = t_get_config("mixtral-8x7b")
    assert TL.moe_capacity(full, 128) == 40 and TL.moe_capacity(full, 1) == 8


# ---------------------------------------------------------------------------
# the block and the model
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_jax():
    """The port's initializer draws JAX's tree: the same keys and shapes
    (the shared expert of tiny("moe") included), stacked on the layer
    axis."""
    shapes = {}
    for name in CONFIGS:
        jc, tc = _cfgs(name)
        ref = {k: v.shape for k, v in tree_leaves_with_path(_jparams(name))}
        got = {k: tuple(v.shape) for k, v in tree_leaves_with_path(
            TLM.init_params(tc, seed=0, device="cpu"))}
        assert got == ref
        shapes[name] = got
    assert shapes["tiny"]["blocks/moe/shared/w_down"] == (2, 48, 32)
    assert "blocks/moe/shared/w_down" not in shapes["mixtral"]
    assert shapes["mixtral"]["blocks/moe/w_gate"] == (4, 4, 128, 64)
    assert shapes["mixtral"]["blocks/moe/router"] == (4, 128, 4)


@pytest.mark.parametrize("name", CONFIGS)
def test_transformer_block_matches_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    jb = jax.tree.map(lambda a: a[1], jp["blocks"])
    tb = TLM.layer_params(tp["blocks"], 1)
    x = np.random.default_rng(7).standard_normal(
        (2, T, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T))
    jy, jaux = jax.jit(lambda p, x: JB.transformer_block(
        p, x, jc, jnp.asarray(pos)))(jb, jnp.asarray(x))
    with torch.no_grad():
        ty, taux = TB.transformer_block(tb, torch.from_numpy(x), tc,
                                        torch.from_numpy(pos.copy()))
    _close(ty, jy)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert abs(float(taux) - float(jaux)) <= STAT_TOL


def _batch(vocab, b=2, t=T, seed=19):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_jax(name):
    """``lm.loss_fn`` (CE + AUX_COEF * aux) and autograd's gradient of
    every leaf against ``jax.grad``: the router's carries the aux
    through the routing probabilities."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    batch = _batch(jc.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JLM.loss_fn(p, jc, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pg = {k: v for k, v in tp.items()}
    leaves = tree_leaves_with_path(pg)
    for _, w in leaves:
        w.requires_grad_()
    lt, mt = TLM.loss_fn(pg, tc, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(lt, [w for _, w in leaves])
    assert float(lt.detach()) == pytest.approx(float(jl), rel=F32_FRAC)
    aux = float(mt["aux"].detach())
    assert aux == pytest.approx(float(jm["aux"]), abs=STAT_TOL) and aux > 0
    jgl = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jg)))
    assert set(jgl) == {k for k, _ in leaves}
    for (k, _), g in zip(leaves, grads):
        _close(g, jgl[k])
    router = dict(zip([k for k, _ in leaves], grads))["blocks/moe/router"]
    assert float(router.abs().max()) > 0


# ---------------------------------------------------------------------------
# contiguous serving: prefill, decode, the ring of a sliding window
# ---------------------------------------------------------------------------

RING = {"moe": ("tiny", {}), "moe_swa": ("tiny", {"swa_window": 8}),
        "dense_swa": ("dense", {"swa_window": 8})}
PROMPT, STEPS, MAX_LEN = 12, 12, 32


@pytest.mark.parametrize("backend", ["off", "int8"])
@pytest.mark.parametrize("ring", list(RING))
def test_contiguous_prefill_and_decode_match_jax(ring, backend):
    """A prefill of PROMPT tokens of two rows, then STEPS decode steps (24
    positions): with a window of 8 the cache is a ring of 8 slots that
    wraps twice; the decode under ``backend``."""
    name, kw = RING[ring]
    jc, tc = _cfgs(name, **kw)
    jp, tp = _params(name, **kw)
    frac = F32_FRAC if backend == "off" else INT8_FRAC
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, PROMPT + STEPS)).astype(np.int32)
    jl, js = JE.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                        MAX_LEN, jnp.float32, kernel_backend="off")
    tl, ts = prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                     MAX_LEN, torch.float32, kernel_backend="off")
    _close(tl, jl)
    length = MAX_LEN if "swa" not in ring else 8
    assert ts["caches"]["k"].shape == js["caches"]["k"].shape == (
        jc.num_layers, 2, length, jc.num_kv_heads, jc.head_dim)
    jdec = jax.jit(lambda s, t: JE.decode_step(jp, jc, s, t))
    for i in range(STEPS):
        tok = toks[:, PROMPT + i:PROMPT + i + 1]
        with JO.kernel_backend_ctx(backend):
            jl, js = jdec(js, jnp.asarray(tok))
        with TO.kernel_backend_ctx(backend, "cpu"):
            tl, ts = decode_step(tp, tc, ts, torch.from_numpy(tok))
        _close(tl, jl, frac)
    assert int(ts["pos"]) == int(js["pos"]) == PROMPT + STEPS
    _close(ts["caches"]["k"], js["caches"]["k"], frac)


def _serve_cfg(mode, **kw):
    return dict(num_slots=2, eos_id=None, max_len=MAX_LEN,
                cache_dtype="float32", mode=mode, **kw)


def _drain(sched, prompts, cls):
    for i, p in enumerate(prompts):
        sched.submit(cls(uid=i, prompt=p.copy(), max_new_tokens=8))
    return {r.uid: list(r.generated) for r in sched.run_until_drained()}


@pytest.mark.parametrize("ring", ["moe_swa", "dense_swa"])
def test_contiguous_scheduler_streams_match_jax(ring):
    """Four equal-length prompts of 14 tokens on two slots, 8 new each (the
    ring of 8 wraps): the port's streams equal JAX's, and the port's
    per-request greedy generation."""
    name, kw = RING[ring]
    jc, tc = _cfgs(name, **kw)
    jp, tp = _params(name, **kw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jc.vocab_size, (14,)).astype(np.int32)
               for _ in range(4)]
    jsc, tsc = JServe(**_serve_cfg("contiguous")), \
        ServeConfig(**_serve_cfg("contiguous"))
    ref = _drain(JSched(jsc, JHooks.for_model(jp, jc, jsc)), prompts,
                 JRequest)
    got = _drain(BatchScheduler(tsc, EngineHooks.for_model(tp, tc, tsc)),
                 prompts, Request)
    assert len(got) == 4 and got == ref
    one = TE.greedy_generate(tp, tc, {"tokens": torch.from_numpy(
        np.stack(prompts[:2]))}, MAX_LEN, 8, torch.float32)
    assert [got[0], got[1]] == one.tolist()


def test_paged_moe_matches_jax():
    """tiny("moe") (no window, so paged) through the paged engine: three
    prompts in ragged 5-token chunks, then two decode steps, the port's
    logits and pool against JAX's."""
    jc, tc = _cfgs("tiny")
    jp, tp = _params("tiny")
    bs, maxb, lens = 8, 4, (13, 8, 21)
    nb = 1 + len(lens) * maxb
    jpool = JE.init_paged_state(jc, nb, bs, jnp.float32)
    tpool = TE.init_paged_state(tc, nb, bs, torch.float32, device="cpu")
    jchunk = jax.jit(lambda pool, table, toks, start: JE.paged_prefill_chunk(
        jp, jc, pool, table, toks, start))
    rng = np.random.default_rng(1)
    tables = np.zeros((len(lens), maxb), np.int32)
    toks = np.zeros((len(lens), 1), np.int32)
    for i, n in enumerate(lens):
        tables[i] = 1 + i * maxb + np.arange(maxb)
        prompt = rng.integers(0, jc.vocab_size, (1, n)).astype(np.int32)
        for s in range(0, n, 5):
            c = prompt[:, s:s + 5]
            jl, jpool = jchunk(jpool, jnp.asarray(tables[i:i + 1]),
                               jnp.asarray(c), np.int32(s))
            tl, tpool = TE.paged_prefill_chunk(
                tp, tc, tpool, torch.from_numpy(tables[i:i + 1]),
                torch.from_numpy(c), s)
            _close(tl, jl)
        toks[i, 0] = int(np.argmax(np.asarray(jl)[0]))
    seq = np.array(lens, np.int32)
    jdec = jax.jit(lambda pool, t, l, x: JE.paged_decode_step(
        jp, jc, pool, t, l, x, "ref"))
    for _ in range(2):
        jl, jpool = jdec(jpool, jnp.asarray(tables), jnp.asarray(seq),
                         jnp.asarray(toks))
        tl, tpool = TE.paged_decode_step(
            tp, tc, tpool, torch.from_numpy(tables), torch.from_numpy(seq),
            torch.from_numpy(toks), "ref")
        _close(tl, jl)
        toks = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        seq = seq + 1
    _close(tpool["k"], jpool["k"])
    _close(tpool["v"], jpool["v"])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-3-4b"])
def test_paged_refuses_a_sliding_window_as_jax(arch):
    """A window keeps the contiguous ring: both packages refuse a paged
    pool for it, with the same message."""
    jc = j_reduce(j_get_config(arch))
    tc = t_reduce(t_get_config(arch))
    assert not TE.paged_supported(tc) and not JE.paged_supported(jc)
    with pytest.raises(ValueError) as je:
        JE.init_paged_state(jc, 4, 8, jnp.float32)
    with pytest.raises(ValueError, match="paged KV unsupported") as te:
        TE.init_paged_state(tc, 4, 8, torch.float32, device="cpu")
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the combine's order for K > 2, in bf16
# ---------------------------------------------------------------------------

# (K, E) of the combine cases: d 64, expert d_ff 32, no shared expert
COMBINE = {"k2e8": (2, 8), "k3e4": (3, 4), "k4e8": (4, 8), "k6e16": (6, 16)}
# K 6 / E 16: outputs that may differ from jitted JAX by one bf16 step.
# On this seed one does: an expert's bf16 gate product whose f32 sum lies
# within 2e-8 of a bf16 rounding tie (-0.58007814 between -0.578125 and
# -0.58203125) rounds to the other side under PyTorch's and XLA's
# accumulation orders, and one of the seven outputs of that expert row it
# moves survives the combine (ROADMAP, reference facts)
COMBINE_MAX_SHARE = 1e-3


def _combine_case(k, e, dtype):
    jc = tiny("moe", d_model=64, moe_d_ff=32, num_shared_experts=0,
              num_experts=e, experts_per_token=k, compute_dtype=dtype)
    jp = jax.tree.map(np.asarray, JL.init_moe(jax.random.key(0), jc))
    x = np.random.default_rng(0).standard_normal((2, 48, 64)).astype(
        np.float32)
    return (jc, TMC(**dataclasses.asdict(jc)), jp,
            TLM.params_from_numpy(jp, device="cpu"), x)


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("case", list(COMBINE))
def test_combine_order_matches_jax_bf16(case):
    """``moe_verbose`` in bf16 against jitted JAX on JAX's ``init_moe``
    weights: a token's K picks are summed in ascending expert order, the
    order of JAX's scatter-add of the sorted picks, so K 2, 3 and 4 are
    bitwise; K 6 is within one bf16 step on at most COMBINE_MAX_SHARE of
    the outputs (an expert product's rounding tie, not the combine)."""
    k, e = COMBINE[case]
    jc, tc, jp, tp, x = _combine_case(k, e, "bfloat16")
    ref = np.asarray(jax.jit(lambda p, x: JL.moe_verbose(p, x, jc)[0])(
        jp, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = TL.moe_verbose(tp, torch.from_numpy(x).to(torch.bfloat16),
                             tc)[0].float().numpy()
    if k <= 4:
        np.testing.assert_array_equal(got, ref)
        return
    d = np.abs(got - ref)
    assert (d <= _bf16_step(ref)).all(), d.max()
    assert (d > 0).mean() <= COMBINE_MAX_SHARE, int((d > 0).sum())


def test_combine_vjp_matches_jax_k4():
    """The VJP of ``moe_verbose``'s output at K 4 / E 8 (f32) against
    ``jax.vjp``: the input's and every weight's gradient under one random
    cotangent."""
    jc, tc, jp, tp, x = _combine_case(4, 8, "float32")
    ct = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    jout, vjp = jax.vjp(lambda p, x: JL.moe_verbose(p, x, jc)[0], jp,
                        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    pg = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = TL.moe_verbose(pg, xt, tc)[0]
    _close(out, jout)
    keys = sorted(pg)
    grads = torch.autograd.grad(out, [pg[k] for k in keys] + [xt],
                                torch.from_numpy(ct))
    _close(grads[-1], jgx)
    for k, g in zip(keys, grads):
        _close(g, jgp[k])
        assert float(g.abs().max()) > 0, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_backward_equals_the_token_gather_bitwise(dtype):
    """The dispatch reads each token's row K times through
    ``_RepeatRows`` (each copy once), so that its backward sums a token's
    K gradients in a fixed order with no atomics (on CUDA the backward of
    a gather with repeated indices adds with atomics, and the stochastic
    pair of the K 6 deepseek step differed from run to run): at K 6 its
    gradient is bit for bit that of the plain gather of the token's row,
    as the CPU computes it."""
    k = 6
    rng = np.random.default_rng(2)
    b, t, d = 2, 9, 16
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(td)
    top_e = torch.from_numpy(np.stack([np.stack([rng.permutation(16)[:k]
                                                 for _ in range(t)])
                                       for _ in range(b)]))
    order = torch.argsort(top_e.reshape(b, t * k), dim=-1, stable=True)
    g = torch.from_numpy(rng.standard_normal((b, t * k, d)).astype(
        np.float32)).to(td)
    x1 = x.clone().requires_grad_()
    plain = torch.gather(x1, 1, (order // k)[..., None].expand(b, t * k, d))
    rank = torch.argsort(torch.argsort(top_e, dim=-1), dim=-1)
    pick_row = (torch.arange(t)[:, None] * k + rank).reshape(b, t * k)
    x2 = x.clone().requires_grad_()
    mine = torch.gather(TL._RepeatRows.apply(x2, k), 1, torch.gather(
        pick_row, 1, order)[..., None].expand(b, t * k, d))
    assert torch.equal(plain, mine)
    (ga,) = torch.autograd.grad(plain, x1, g)
    (gb,) = torch.autograd.grad(mine, x2, g)
    assert torch.equal(ga, gb)
