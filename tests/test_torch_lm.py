"""Port parity of the dense model's training half on the CPU: the
kernel-datapath ``dense_unit`` (forward and its backward on ``bp_gstep`` /
``sgd_dw_update``), full-sequence ``attention`` (materialised and chunked
online softmax) and ``loss_fn`` (value and every gradient), against the
JAX package's functions and ``jax.grad``.

Inputs are numpy arrays from a seed; parameters come from
``repro.models.lm.init_params(jax.random.key(0), cfg)`` carried across with
``params_from_numpy``.  The JAX side runs op by op (``jax.disable_jit``),
as the port does, wherever bf16 is involved: under ``jit`` XLA fuses bf16
chains and rescales, and the jitted JAX gradient itself moves by up to
7.5% of its norm against the op-by-op one on the bf16 config (int8
backend).  The f32 model runs jitted (faster; the same values to f32
reassociation).  The JAX kernels run as
its own tests run them on the CPU (interpret mode or their jnp fallback);
the port's wrappers run their plain versions on CPU tensors.

Configs: ``tiny`` is ``tests/test_models.py::tiny("dense")`` (2 layers,
d 32, 4 heads, 2 KV heads, f32); ``qwen_tiny`` is the same with QKV bias,
4 KV heads and bf16 compute (tied embedding and swiglu are the defaults).

Tolerances, and why:
  * the dense unit: on the int8 datapath payloads and int32 sums are exact
    and every rescale is the same IEEE operation, so with the identity
    activation it is bitwise, f32 or bf16; otherwise f32 sums differ in
    order and XLA's exp/tanh differ from PyTorch's by an ulp:
    |d| <= 1e-6 * max|ref| (observed <= 4.3e-7).
  * f32 attention, loss and gradients: sums in different orders:
    |d| <= 1e-5 * max|ref|.
  * bf16 compute: the values are the same bf16 operations in the same
    order; what differs is only where a sum is taken (einsum, the bias
    gradient's reduction over B*T), which moves a bf16 result by an ulp
    (2^-8 relative): loss |d| <= 1e-3 |ref|, gradients within 5% of their
    L2 norm (observed <= 2.6%, int8 <= 1.4%, and only the biases there).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JMC
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TMC
from repro_torch.util.tree import tree_leaves, tree_map
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

TINY = dict(name="t-dense", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
            compute_dtype="float32")
QWEN_TINY = dict(TINY, name="t-qwen", num_kv_heads=4, qkv_bias=True,
                 compute_dtype="bfloat16")
CFGS = {"tiny": TINY, "qwen_tiny": QWEN_TINY}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _f32(t):
    return t.detach().to(torch.float32).numpy()


def _op_by_op(cfg):
    """JAX op by op for bf16 (see the module docstring), jitted for f32."""
    return (jax.disable_jit() if cfg.compute_dtype == "bfloat16"
            else contextlib.nullcontext())


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@functools.lru_cache(maxsize=None)
def _params(name):
    """(JAX cfg, port cfg, JAX params, port params); the port's copy is
    shared, so a test that takes gradients must not mark it."""
    jc, tc = JMC(**CFGS[name]), TMC(**CFGS[name])
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jp = JLM.init_params(jax.random.key(0), jc)
    tp = TLM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# dense_unit: forward and gradients on each backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
@pytest.mark.parametrize("act", ["identity", "silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_unit_value_and_grads(backend, act, dtype):
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 24)) * 0.25).astype(np.float32)
    c = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jf(xx, ww):
        y = JL.dense_unit(xx.astype(jdt), ww, act, backend)
        return jnp.sum(y.astype(jnp.float32) * c), y
    with jax.disable_jit():
        (_, yj), (dxj, dwj) = jax.value_and_grad(jf, argnums=(0, 1),
                                                 has_aux=True)(
            jnp.asarray(x), jnp.asarray(w))
    xt = _t(x).requires_grad_()
    wt = _t(w).requires_grad_()
    yt = TL.dense_unit(xt.to(tdt), wt, act, backend)
    (yt.to(torch.float32) * _t(c)).sum().backward()
    assert yt.dtype == tdt
    got = [_f32(yt), _f32(xt.grad), _f32(wt.grad)]
    ref = [_j32(yj), _j32(dxj), _j32(dwj)]
    exact = backend == "int8" and act == "identity"
    for g, r, what in zip(got, ref, ("y", "dx", "dw")):
        lim = 0.0 if exact else 1e-6 * np.abs(r).max()
        assert np.abs(g - r).max() <= lim, (what, np.abs(g - r).max())


def test_dense_unit_backward_runs_the_kernel_entry_points(monkeypatch):
    """The backward calls dense_bwd_dx and dense_bwd_dw once each (never
    autograd of the plain version), and the forward records no graph."""
    calls = []
    for name in ("dense_fwd", "dense_bwd_dx", "dense_bwd_dw"):
        orig = getattr(TO, name)

        def wrap(*a, _o=orig, _n=name):
            calls.append((_n, torch.is_grad_enabled()))
            out = _o(*a)
            assert out.grad_fn is None
            return out
        monkeypatch.setattr(TO, name, wrap)
    x = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(8, 4, requires_grad=True)
    TL.dense_unit(x, w, "silu", "int8").sum().backward()
    assert calls == [("dense_fwd", False), ("dense_bwd_dx", False),
                     ("dense_bwd_dw", False)]


# ---------------------------------------------------------------------------
# attention: full and chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "qwen_tiny"])
@pytest.mark.parametrize("chunked", [False, True])
def test_attention_value_and_grad(name, chunked, monkeypatch):
    if chunked:  # the online-softmax path at T 20: KV blocks of 8, padded
        for mod in (JL, TL):
            monkeypatch.setattr(mod, "ATTN_CHUNK_THRESHOLD", 16)
            monkeypatch.setattr(mod, "ATTN_KV_BLOCK", 8)
    jc, tc, jp, tp = _params(name)
    rng = _rng(2)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    c = rng.standard_normal((2, 20, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = tree_map(lambda a: a[0], tp["blocks"]["attn"])
    dt = TLM.compute_dtype(tc)

    def jf(xx):
        y = JL.attention(ja, xx.astype(JLM.compute_dtype(jc)), jc,
                         jnp.asarray(pos))
        return jnp.sum(y.astype(jnp.float32) * c), y
    vg = jax.value_and_grad(jf, has_aux=True)
    with _op_by_op(jc):
        (_, yj), gj = (vg if dt == torch.bfloat16 else jax.jit(vg))(
            jnp.asarray(x))
    xt = _t(x).requires_grad_()
    yt = TL.attention(ta, xt.to(dt), tc, _t(pos))
    (yt.to(torch.float32) * _t(c)).sum().backward()
    if dt == torch.float32:
        np.testing.assert_allclose(_f32(yt), _j32(yj), rtol=0,
                                   atol=1e-5 * np.abs(_j32(yj)).max())
        np.testing.assert_allclose(_f32(xt.grad), _j32(gj), rtol=0,
                                   atol=1e-5 * np.abs(_j32(gj)).max())
    else:
        assert _rel_l2(_f32(yt), _j32(yj)) <= 0.01
        assert _rel_l2(_f32(xt.grad), _j32(gj)) <= 0.05


def test_attn_mask_matches():
    for causal, window, off in ((True, None, 0), (False, None, 0),
                                (True, 3, 2)):
        np.testing.assert_array_equal(
            TL._attn_mask(5, 7, causal, window, off).numpy(),
            np.asarray(JL._attn_mask(5, 7, causal, window, off)))


# ---------------------------------------------------------------------------
# loss_fn: value and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,backend", [("tiny", "off"), ("tiny", "int8"),
                                          ("qwen_tiny", "int8")])
def test_loss_fn_value_and_grads(name, backend):
    """The bf16 config on the main path's backend only: op by op, the JAX
    side takes ~15 s a case on the CPU."""
    jc, tc, jp, tp = _params(name)
    rng = _rng(3)
    batch = {"tokens": rng.integers(0, 128, (2, 24)).astype(np.int32),
             "labels": rng.integers(-1, 128, (2, 24)).astype(np.int32)}
    vg = jax.value_and_grad(lambda p: JLM.loss_fn(p, jc, batch),
                            has_aux=True)
    with JO.kernel_backend_ctx(backend), _op_by_op(jc):
        (lj, mj), gj = (vg if name == "qwen_tiny" else jax.jit(vg))(jp)
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    with TO.kernel_backend_ctx(backend, "cpu"):
        lt, mt = TLM.loss_fn(tp, tc, {k: _t(v) for k, v in batch.items()})
    lt.backward()
    assert float(mt["tokens"]) == float(mj["tokens"])
    f32 = name == "tiny"
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-6 if f32 else 1e-3)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(gj),
                            tree_leaves(tp)):
        r, g = np.asarray(r), g.grad.numpy()
        if f32:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=jax.tree_util.keystr(path))
        else:
            assert _rel_l2(g, r) <= 0.05, (jax.tree_util.keystr(path),
                                            _rel_l2(g, r))


def test_last_token_logits_and_eval():
    jc, tc, jp, tp = _params("tiny")
    tok = _rng(4).integers(0, 128, (2, 9)).astype(np.int32)
    want = JLM.last_token_logits(jp, jc, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got = TLM.last_token_logits(tp, tc, {"tokens": _t(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
