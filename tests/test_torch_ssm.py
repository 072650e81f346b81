"""Port parity of the ssm and hybrid models on the CPU: every function of
``models/ssm.py``, the Mamba2 blocks, and ``lm`` (``init_params``,
``forward_hidden``, ``loss_fn``, ``last_token_logits``) for both families,
against the JAX package.

Configs: ``tiny("ssm")`` and ``tiny("hybrid")`` of ``tests/test_models.py``
(d 32, 16 states, heads of 8, chunk 16; the hybrid 2 groups of 2 Mamba
layers with one shared block), f32, and a bf16 twin of each.  Parameters
come from ``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; inputs are numpy arrays from a seed.

Tolerances, and why:
  * f32 compute: the frameworks sum in other orders (cumsum, einsum,
    matmul): |d| <= 1e-5 * max|ref| (observed <= 2.2e-6).
  * bf16 compute, against JAX run op by op (``jax.disable_jit``, as the
    port runs): |d|/|ref| <= 1e-2 in L2 (observed 0 for the ssm stack,
    <= 1e-3 for the hybrid's, whose attention softmax and bf16 matmuls
    round in another order).  Jitted JAX keeps f32 between the fused bf16
    ops of a layer and moves its own result by 1-2% against op-by-op JAX,
    so it is not the reference here.
  * ``silu`` in bf16 and ``_segsum``'s mask: bitwise.
The conv and SSD checks run the JAX functions jitted (one compile a shape;
the chunked SSD is bitwise op-by-op JAX's either way in bf16).
"""
import dataclasses
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
from repro.models import ssm as JS  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_FRAC = 1e-5
BF16_REL = 1e-2
# one sequence length for every sequence-level check (a ragged 2 chunks of
# 16), so that JAX compiles each op at one shape a dtype
T = 21


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family, dtype="float32"):
    jc = tiny(family, compute_dtype=dtype)
    return jc, TMC(**dataclasses.asdict(jc))


_PARAMS = {}


def _params(family):
    """JAX's initial weights of ``tiny(family)`` (f32 masters, the same for
    both compute dtypes) and the port's copy."""
    if family not in _PARAMS:
        jc, _ = _cfgs(family)
        jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0),
                                                        jc)
        _PARAMS[family] = (jp, TLM.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[family]


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, dtype):
    """f32: |d| <= F32_FRAC * max|ref|; bf16: |d|/|ref| <= BF16_REL."""
    g, r = _np32(got), _np32(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    if dtype == "float32":
        err = np.abs(g - r).max()
        assert err <= F32_FRAC * np.abs(r).max(), (err, np.abs(r).max())
    else:
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel <= BF16_REL, rel


def _ref(dtype, fn, *args):
    """The JAX reference ``fn(*args)``: op by op for bf16 (see the module
    docstring), jitted for f32 (one compile, the same values to f32
    reassociation)."""
    if dtype == "bfloat16":
        with jax.disable_jit():
            return fn(*args)
    return jax.jit(fn)(*args)


def _in(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _layer0(family):
    jp, tp = _params(family)
    if family == "hybrid":
        return (jax.tree.map(lambda a: a[0, 1], jp["blocks"]),
                TLM.layer_params(tp["blocks"], (0, 1)))
    return (jax.tree.map(lambda a: a[0], jp["blocks"]),
            TLM.layer_params(tp["blocks"], 0))


# ---------------------------------------------------------------------------
# the elementwise pieces
# ---------------------------------------------------------------------------

def test_silu_is_jax_silu_bitwise_in_bf16():
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    x *= 4
    for jd, td in DTYPES.values():
        ref = _np32(jax.nn.silu(jnp.asarray(x).astype(jd)))
        got = _np32(TL.silu(torch.from_numpy(x).to(td)))
        if td == torch.bfloat16:
            np.testing.assert_array_equal(got, ref)
        else:
            assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_softplus_matches_jax_beyond_torch_threshold():
    """JAX's softplus is logaddexp(x, 0); ``F.softplus`` returns x above
    20.  The port's agrees with JAX to an f32 ulp across the range dt_raw +
    dt_bias reaches and well beyond the threshold."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        np.random.default_rng(1).standard_normal(4000) * 6])
    x = x.astype(np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("q", [1, 5, 16])
def test_segsum_matches_jax(q):
    dA = -np.abs(np.random.default_rng(q).standard_normal(
        (2, 3, q))).astype(np.float32)
    ref = np.asarray(JS._segsum(jnp.asarray(dA)))
    got = TS._segsum(torch.from_numpy(dA)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-6 * max(
        1.0, np.abs(ref[fin]).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [1, 2, 9])
def test_causal_conv_matches_jax(dtype, t):
    rng = np.random.default_rng(t)
    xj, xt = _in(rng, (2, t, 12), dtype)
    wj, wt = _in(rng, (4, 12), dtype, 0.5)
    bj, bt = _in(rng, (12,), dtype, 0.1)
    ref = jax.jit(JS._causal_conv)(xj, wj, bj)
    _close(TS._causal_conv(xt, wt, bt), ref, dtype)


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, t, h, p, n, dtype):
    xj, xt = _in(rng, (b, t, h, p), dtype)
    dt = (np.abs(rng.standard_normal((b, t, h))) * 0.3).astype(np.float32)
    A = -np.arange(1, h + 1, dtype=np.float32)
    Bj, Bt = _in(rng, (b, t, n), dtype)
    Cj, Ct = _in(rng, (b, t, n), dtype)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return ((xj, jnp.asarray(dt), jnp.asarray(A), Bj, Cj, jnp.asarray(h0)),
            (xt, torch.from_numpy(dt), torch.from_numpy(A), Bt, Ct,
             torch.from_numpy(h0)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [32, T, 9], ids=["whole", "ragged", "short"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(dtype, t, with_h0):
    """Chunk 16 at the tiny model's 8 heads of 8 and 16 states: T 32 (two
    whole chunks), 21 (padded with dt = 0), 9 (one chunk shorter than the
    chunk size, q = min(chunk, T))."""
    rng = np.random.default_rng(t + 100 * with_h0)
    j, tt = _ssd_inputs(rng, 2, t, 8, 8, 16, dtype)
    jh0 = j[5] if with_h0 else None
    th0 = tt[5] if with_h0 else None
    yj, hj = jax.jit(JS.ssd_chunked, static_argnums=5)(*j[:5], 16, jh0)
    yt, ht = TS.ssd_chunked(*tt[:5], 16, th0)
    assert yt.dtype == DTYPES[dtype][1] and ht.dtype == torch.float32
    _close(yt, yj, dtype)
    _close(ht, hj, dtype)


def test_ssd_chunked_equals_the_recurrence():
    """The chunked dual form against the step-by-step recurrence h_t =
    exp(dt A) h + dt B x^T, y = C . h, in f32 (a check of the algorithm,
    beside the parity with JAX)."""
    rng = np.random.default_rng(3)
    _, (x, dt, A, Bm, Cm, h0) = _ssd_inputs(rng, 1, 21, 3, 4, 5, "float32")
    y, hT = TS.ssd_chunked(x, dt, A, Bm, Cm, 8, h0)
    h = h0.clone()
    for s in range(21):
        h = (h * torch.exp(dt[:, s] * A)[..., None, None]
             + torch.einsum("bn,bh,bhp->bhnp", Bm[:, s], dt[:, s], x[:, s]))
        ys = torch.einsum("bn,bhnp->bhp", Cm[:, s], h)
        assert torch.allclose(y[:, s], ys, atol=1e-5, rtol=1e-5)
    assert torch.allclose(hT, h, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the Mamba2 layer: init, forward, cache, decode
# ---------------------------------------------------------------------------

def test_init_mamba_matches_jax_tree_and_distributions():
    jc, tc = _cfgs("ssm")
    ref = jax.jit(JS.init_mamba, static_argnums=1)(jax.random.key(0), jc)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    got = TS.init_mamba(gen, tc)
    assert jax.tree.map(lambda a: a.shape, ref) == jax.tree.map(
        lambda a: tuple(a.shape), got, is_leaf=torch.is_tensor)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        got, is_leaf=torch.is_tensor))
    # log(1..H): the two libraries' logs, an f32 ulp apart at most
    np.testing.assert_allclose(got["A_log"].numpy(),
                               np.asarray(ref["A_log"]), rtol=1.2e-7)
    assert torch.equal(got["D_skip"], torch.ones(tc.ssm_heads))
    dt = torch.nn.functional.softplus(got["dt_bias"].double())
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 0.1 * (1 + 1e-5))).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "h0_conv0"])
def test_mamba_forward_matches_jax(dtype, family, carry):
    jc, tc = _cfgs(family, dtype)
    pj, pt = _layer0(family)
    pj, pt = pj["mamba"], pt["mamba"]
    rng = np.random.default_rng(5)
    xj, xt = _in(rng, (2, T, jc.d_model), dtype)
    kw_j, kw_t = {}, {}
    if carry:
        h0 = rng.standard_normal((2, jc.ssm_heads, jc.ssm_state,
                                  jc.ssm_head_dim)).astype(np.float32)
        cj, ct = _in(rng, (2, jc.conv_kernel - 1,
                           jc.d_inner + 2 * jc.ssm_state), dtype)
        kw_j = dict(h0=jnp.asarray(h0), conv0=cj)
        kw_t = dict(h0=torch.from_numpy(h0), conv0=ct)
    oj, (hj, tj) = _ref(dtype, lambda p, x, kw: JS.mamba_forward(
        p, x, jc, **kw), pj, xj, kw_j)
    ot, (ht, tt) = TS.mamba_forward(pt, xt, tc, **kw_t)
    _close(ot, oj, dtype)
    _close(ht, hj, dtype)
    _close(tt, tj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_init_mamba_cache_matches_jax(dtype):
    jc, tc = _cfgs("ssm")
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "int8": jnp.int8}[dtype]
    ref = JS.init_mamba_cache(jc, 3, jd)
    got = TS.init_mamba_cache(tc, 3, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert str(got[k].dtype) == f"torch.{np.dtype(ref[k].dtype).name}"
        assert not got[k].any()
    assert got["h"].dtype == torch.float32


@pytest.mark.parametrize("dtype,cache", [("float32", "float32"),
                                         ("bfloat16", "bfloat16"),
                                         ("float32", "int8")])
def test_mamba_decode_matches_jax(dtype, cache):
    """Four one-token steps from a random state; the port writes the cache
    in place, JAX returns a new one.  An int8 conv cache truncates the
    pre-conv values toward zero in both."""
    jc, tc = _cfgs("ssm", dtype)
    pj, pt = _layer0("ssm")
    pj, pt = pj["mamba"], pt["mamba"]
    rng = np.random.default_rng(11)
    jcd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int8": jnp.int8}[cache]
    h = rng.standard_normal((2, jc.ssm_heads, jc.ssm_state,
                             jc.ssm_head_dim)).astype(np.float32)
    conv = (rng.standard_normal((2, jc.conv_kernel - 1, jc.d_inner
                                 + 2 * jc.ssm_state)) * 3).astype(np.float32)
    jcache = {"h": jnp.asarray(h), "conv": jnp.asarray(conv).astype(jcd)}
    # the port writes its cache in place: give it copies, as JAX may
    # alias the numpy buffers it was handed (and read them asynchronously)
    tcache = {"h": torch.from_numpy(h.copy()),
              "conv": torch.from_numpy(conv.copy()).to(getattr(torch, cache))}
    h_obj = tcache["h"]
    for s in range(4):
        xj, xt = _in(rng, (2, 1, jc.d_model), dtype, 2.0)
        oj, jcache = _ref(dtype, lambda p, x, c: JS.mamba_decode(p, x, jc, c),
                          pj, xj, jcache)
        ot, tcache = TS.mamba_decode(pt, xt, tc, tcache)
        _close(ot, oj, dtype)
        _close(tcache["h"], jcache["h"], dtype)
        assert tcache["conv"].dtype == getattr(torch, cache)
        if cache == "int8":
            np.testing.assert_array_equal(_np32(tcache["conv"]),
                                          _np32(jcache["conv"]))
        else:
            _close(tcache["conv"], jcache["conv"], dtype)
    assert tcache["h"] is h_obj  # written in place


def test_mamba_blocks_match_jax():
    """Pre-norm + residual around the Mamba layer: the full-sequence block,
    its prefill (the decode state: h f32, the conv tail in the cache
    dtype), and a decode step from that state."""
    jc, tc = _cfgs("ssm")
    pj, pt = _layer0("ssm")
    rng = np.random.default_rng(13)
    xj, xt = _in(rng, (2, T, jc.d_model), "float32")
    yj, aj = _ref("float32", lambda p, x: JB.mamba_block(p, x, jc), pj, xj)
    yt, at = TB.mamba_block(pt, xt, tc)
    _close(yt, yj, "float32")
    assert float(at) == float(aj) == 0.0
    yj, cj = _ref("float32", lambda p, x: JB.mamba_block_prefill(
        p, x, jc, cache_dtype=jnp.bfloat16), pj, xj)
    yt, ct = TB.mamba_block_prefill(pt, xt, tc, cache_dtype=torch.bfloat16)
    _close(yt, yj, "float32")
    _close(ct["h"], cj["h"], "float32")
    assert ct["conv"].dtype == torch.bfloat16
    _close(ct["conv"], cj["conv"], "float32")
    x1j, x1t = _in(rng, (2, 1, jc.d_model), "float32")
    oj, cj = _ref("float32", lambda p, x, c: JB.mamba_block_decode(
        p, x, jc, c, T), pj, x1j, cj)
    ot, ct = TB.mamba_block_decode(pt, x1t, tc, ct, T)
    _close(ot, oj, "float32")
    _close(ct["h"], cj["h"], "float32")


# ---------------------------------------------------------------------------
# lm: parameters, stacks, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_init_params_has_jax_layout(family):
    jc, tc = _cfgs(family)
    jp, tp = _params(family)
    shapes = jax.tree.map(lambda a: a.shape, jp)
    ours = TLM.init_params(tc, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), ours,
                        is_leaf=torch.is_tensor) == shapes
    assert jax.tree.map(lambda a: tuple(a.shape), tp,
                        is_leaf=torch.is_tensor) == shapes
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    if family == "hybrid":
        G, K = TLM.hybrid_groups(tc)
        assert (G, K) == JLM.hybrid_groups(jc) == (2, 2)
        assert tuple(ours["blocks"]["mamba"]["w_x"].shape[:2]) == (G, K)
        assert "mlp" in ours["shared_attn"] and "attn" in ours["shared_attn"]
        one = TLM.layer_params(tp["blocks"], (1, 0))
        np.testing.assert_array_equal(
            one["mamba"]["w_z"].numpy(),
            np.asarray(jp["blocks"]["mamba"]["w_z"][1, 0]))
    assert TLM.SHARED_OPERAND_KIND == JLM.SHARED_OPERAND_KIND


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_forward_hidden_and_logits_match_jax(dtype, family):
    jc, tc = _cfgs(family, dtype)
    jp, tp = _params(family)
    toks = np.random.default_rng(17).integers(
        0, jc.vocab_size, (2, T)).astype(np.int32)
    hj, lj = _ref(dtype, lambda p, b: (JLM.forward_hidden(p, jc, b),
                                       JLM.last_token_logits(p, jc, b)),
                  jp, {"tokens": jnp.asarray(toks)})
    tb = {"tokens": torch.from_numpy(toks)}
    ht = TLM.forward_hidden(tp, tc, tb)
    assert ht.dtype == DTYPES[dtype][1]
    _close(ht, hj, dtype)
    _close(TLM.last_token_logits(tp, tc, tb), lj, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_loss_fn_matches_jax(dtype, family):
    """The autodiff path's loss, forward only, with ignored labels."""
    jc, tc = _cfgs(family, dtype)
    jp, tp = _params(family)
    rng = np.random.default_rng(19)
    toks = rng.integers(0, jc.vocab_size, (2, T)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, T)).astype(np.int32)
    labels[0, :3] = -1
    lj, mj = _ref(dtype, lambda p, b: JLM.loss_fn(p, jc, b), jp,
                  {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    with torch.no_grad():
        lt, mt = TLM.loss_fn(tp, tc, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    tol = F32_FRAC if dtype == "float32" else BF16_REL
    assert abs(float(lt) - float(lj)) <= tol * abs(float(lj))
    assert float(mt["tokens"]) == float(mj["tokens"]) == 2 * T - 3
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0


@pytest.mark.parametrize("kw", [dict(family="encdec"), dict(family="vlm")])
def test_other_families_still_raise(kw):
    """encdec and vlm wait for ROADMAP A9e."""
    _, tc = _cfgs("hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP A9e"):
        TLM.init_params(dataclasses.replace(tc, **kw), device="cpu")


def test_mla_params_build():
    """Since ROADMAP A9d an MLA model's parameters build, with JAX's
    tree: MLA's ``attn`` leaves in JAX's shapes."""
    from test_torch_mla import mla_cfgs, mla_jparams

    _, tc = mla_cfgs("k3")
    got = {k: tuple(v.shape) for k, v in tree_leaves_with_path(
        TLM.init_params(tc, seed=0, device="cpu"))}
    assert got == {k: v.shape for k, v in
                   tree_leaves_with_path(mla_jparams("k3"))}
    assert "blocks/attn/w_dkv" in got and "blocks/attn/wk" not in got
