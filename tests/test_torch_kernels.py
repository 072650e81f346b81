"""Port parity: the kernels' plain PyTorch versions (what the wrappers run on
CPU tensors) against the JAX package's Pallas kernels in interpret mode.

Tolerances, and why:
  * int8 datapaths (int32 accumulators, one f32 rescale by the same scale):
    bitwise.
  * f32 datapaths: the two frameworks sum products in different orders, so
    values agree to f32 reassociation error: |d| <= 1e-5 * (1 + |ref|) at
    these sizes (K <= 128, values O(1)).
  * after an (I,F) output rounding, a value that sits at a rounding tie in
    one framework may land one grid step 2^-F away in the other (ROADMAP's
    grid-step rule): every difference is at most one step, on at most 2% of
    the elements.
  * int8 payloads quantized after a float norm may likewise sit one step
    apart on a counted few elements (decode_prologue's int8 datapath).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as JC
from repro.kernels import decode_prologue as JDP
from repro.kernels import ops as JO
from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JR
from repro.kernels.fxp_matmul import fxp_matmul as j_fxp_matmul
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.kernels import common as TC
from repro_torch.kernels import decode_prologue as TDP
from repro_torch.kernels import ops as TO
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TR
from repro_torch.kernels.fxp_matmul import fxp_matmul
from repro_torch.models.config import ModelConfig as TModelConfig

RTOL = 1e-5


def _close(t, j):
    t = t.detach().to(torch.float32).numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape
    np.testing.assert_array_less(np.abs(t - j), RTOL * (1.0 + np.abs(j)))


def _grid_close(t, j, step, frac=0.02):
    """Equal, except one grid step on at most ``frac`` of the elements."""
    d = np.abs(t.numpy() - np.asarray(j))
    assert d.max() <= step * (1 + 1e-6), d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# common.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["identity", "relu", "sigmoid", "tanh",
                                 "silu", "gelu"])
def test_act_fn_and_deriv(act):
    z = _rand((64,), 0, 3.0)
    _close(TC.act_fn(torch.from_numpy(z), act), JC.act_fn(jnp.asarray(z), act))
    _close(TC.act_deriv(torch.from_numpy(z), act),
           JC.act_deriv(jnp.asarray(z), act))


@pytest.mark.parametrize("bits", [(4, 10), (2, 12), (3, 4)])
def test_kq_bitwise(bits):
    x = _rand((257,), 1, 4.0)
    step = 2.0 ** -bits[1]
    x[:8] = (np.arange(8) + 0.5).astype(np.float32) * np.float32(step)  # ties
    np.testing.assert_array_equal(TC.kq(torch.from_numpy(x), *bits).numpy(),
                                  np.asarray(JC.kq(jnp.asarray(x), *bits)))


def test_int8_dot_exact_past_int8_range():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, size=(5, 300)).astype(np.int8)
    b = rng.integers(-127, 128, size=(300, 7)).astype(np.int8)
    a[0] = 127
    b[:, 0] = 127                                  # 127^2 * 300 > 2^16
    got = TC.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JC.int8_dot(jnp.asarray(a), jnp.asarray(b))))
    assert int(got[0, 0]) == 127 * 127 * 300


# ---------------------------------------------------------------------------
# fxp_matmul
# ---------------------------------------------------------------------------

_FXP_CASES = [
    # xa_bits, w_bits, out_bits, act
    (None, None, None, "identity"),
    ((4, 10), (2, 12), None, "relu"),
    ((4, 10), (2, 12), (4, 10), "identity"),
    (None, None, (4, 10), "silu"),
    ((3, 4), (2, 5), (4, 10), "gelu"),
    (None, None, None, "tanh"),
]


@pytest.mark.parametrize("xa,wb,ob,act", _FXP_CASES)
def test_fxp_matmul_emulate_vs_jax_kernel(xa, wb, ob, act):
    x, w = _rand((16, 64), 3), _rand((64, 48), 4, 0.2)
    got = fxp_matmul(torch.from_numpy(x), torch.from_numpy(w), xa_bits=xa,
                     w_bits=wb, out_bits=ob, act=act)
    want = j_fxp_matmul(jnp.asarray(x), jnp.asarray(w), xa_bits=xa,
                        w_bits=wb, out_bits=ob, act=act, bm=8, bn=16, bk=32,
                        interpret=True)
    if ob is None:
        _close(got, want)
    else:
        _grid_close(got, want, 2.0 ** -ob[1])


@pytest.mark.parametrize("ob,act", [(None, "identity"), ((4, 10), "identity"),
                                    (None, "relu")])
def test_fxp_matmul_int8_bitwise_vs_jax_kernel(ob, act):
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, size=(16, 64)).astype(np.int8)
    w = rng.integers(-127, 128, size=(64, 48)).astype(np.int8)
    scale = np.float32(3.1e-5)
    got = fxp_matmul(torch.from_numpy(x), torch.from_numpy(w), out_bits=ob,
                     act=act, datapath="int8", scale=float(scale))
    want = j_fxp_matmul(jnp.asarray(x), jnp.asarray(w), out_bits=ob, act=act,
                        bm=8, bn=16, bk=32, datapath="int8",
                        scale=jnp.float32(scale), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fxp_matmul_ragged_vs_ref():
    """M=5, K=37, N=11: no tile divides; the port needs no divisibility."""
    x, w = _rand((5, 37), 6), _rand((37, 11), 7, 0.3)
    for xa, wb, ob, act in _FXP_CASES:
        got = fxp_matmul(torch.from_numpy(x), torch.from_numpy(w), xa_bits=xa,
                         w_bits=wb, out_bits=ob, act=act)
        want = JR.fxp_matmul_ref(jnp.asarray(x), jnp.asarray(w), xa_bits=xa,
                                 w_bits=wb, out_bits=ob, act=act)
        if ob is None:
            _close(got, want)
        else:
            _grid_close(got, want, 2.0 ** -ob[1], frac=0.05)
        ref = TR.fxp_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                xa_bits=xa, w_bits=wb, out_bits=ob, act=act)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
@pytest.mark.parametrize("bits", [((4, 10), (2, 12), None),
                                  ((2, 5), (1, 6), None)])
def test_fxp_matmul_op_vs_jax(datapath, bits):
    xa, wb, ob = bits
    x, w = _rand((8, 64), 8), _rand((64, 32), 9, 0.2)
    got = TO.fxp_matmul_op(torch.from_numpy(x), torch.from_numpy(w),
                           xa_bits=xa, w_bits=wb, out_bits=ob,
                           datapath=datapath)
    want = JO.fxp_matmul_op(jnp.asarray(x), jnp.asarray(w), xa_bits=xa,
                            w_bits=wb, out_bits=ob, datapath=datapath)
    _close(got, want)
    if datapath == "int8":
        # payloads and int32 accumulators are bitwise; XLA fuses the jitted
        # rescale acc * (sx * sw) so that it may round one ulp apart
        ref = TR.fxp_matmul_int8_ref(torch.from_numpy(x), torch.from_numpy(w),
                                     xa_bits=xa, w_bits=wb, out_bits=ob)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
@pytest.mark.parametrize("m", [8, 5])
def test_dense_fwd_vs_jax(backend, m):
    x, w = _rand((m, 128), 10), _rand((128, 64), 11, 0.1)
    want = JO.dense_fwd(jnp.asarray(x), jnp.asarray(w), backend)
    if backend == "off":
        got = torch.from_numpy(x) @ torch.from_numpy(w)
    else:
        got = TO.dense_fwd(torch.from_numpy(x), torch.from_numpy(w), backend)
    if backend == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, must raise, not run the plain path."""
    x = torch.zeros((8, 16), device="meta")
    w = torch.zeros((16, 8), device="meta")
    with pytest.raises(RuntimeError):
        fxp_matmul(x, w)
    with pytest.raises(RuntimeError):
        TPA.paged_attention(torch.zeros((2, 4, 8), device="meta"),
                            {"k": torch.zeros((3, 4, 2, 8), device="meta"),
                             "v": torch.zeros((3, 4, 2, 8), device="meta")},
                            torch.zeros((2, 2), dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32),
                            groups=2, scale=1.0)
    with pytest.raises(RuntimeError):
        TDP.fused_prologue(x, torch.ones(16), w, w, w, None,
                           torch.zeros(8, dtype=torch.int32), use_rope=True,
                           theta=1e4, eps=1e-5, h=1, hkv=1, hd=8)


# ---------------------------------------------------------------------------
# decode_prologue
# ---------------------------------------------------------------------------

def _prologue_setup(hkv, bias, rope, seed=0):
    kw = dict(name="t-prologue", family="dense", num_layers=1, d_model=64,
              num_heads=4, num_kv_heads=hkv, d_ff=64, vocab_size=64,
              compute_dtype="float32", qkv_bias=bias, use_rope=rope,
              rope_theta=1e6)
    rng = np.random.default_rng(seed)
    d, h, hd = 64, 4, 16
    norm = {"scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    attn = {"wq": (0.1 * rng.standard_normal((d, h, hd))).astype(np.float32),
            "wk": (0.1 * rng.standard_normal((d, hkv, hd))).astype(np.float32),
            "wv": (0.1 * rng.standard_normal((d, hkv, hd))).astype(np.float32)}
    if bias:
        attn["bq"] = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
        attn["bk"] = (0.1 * rng.standard_normal((hkv, hd))).astype(np.float32)
        attn["bv"] = (0.1 * rng.standard_normal((hkv, hd))).astype(np.float32)
    x = rng.standard_normal((3, 1, d)).astype(np.float32)
    pos = np.array([0, 5, 300], np.int32)
    return JModelConfig(**kw), TModelConfig(**kw), norm, attn, x, pos


@pytest.mark.parametrize("backend", ["emulate", "int8"])
@pytest.mark.parametrize("hkv,bias,rope", [(4, True, True), (2, False, True),
                                           (2, True, False)])
def test_decode_prologue_vs_jax(backend, hkv, bias, rope):
    jcfg, tcfg, norm, attn, x, pos = _prologue_setup(hkv, bias, rope)
    with JO.kernel_backend_ctx(backend):
        want = JDP.decode_prologue(
            jax.tree.map(jnp.asarray, norm), jax.tree.map(jnp.asarray, attn),
            jnp.asarray(x), jcfg, jnp.asarray(pos))
    tn = {k: torch.from_numpy(v) for k, v in norm.items()}
    ta = {k: torch.from_numpy(v) for k, v in attn.items()}
    with TO.kernel_backend_ctx(backend, "cpu"):
        assert TDP.prologue_active(tcfg, torch.from_numpy(x))
        got = TDP.decode_prologue(tn, ta, torch.from_numpy(x), tcfg,
                                  torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        if backend == "emulate":
            _close(g, w)
        else:
            # one int8 step of the normed row (|x| <= 127 * sx) moves an
            # output by at most sx * sw * max|w_col| * 1; allow 1e-3
            d = np.abs(g.numpy() - np.asarray(w))
            assert d.max() <= 1e-3 * (1 + np.abs(np.asarray(w)).max())
            assert (d > RTOL * (1 + np.abs(np.asarray(w)))).mean() <= 0.05


def test_prologue_gates():
    kw = dict(name="g", family="dense", num_layers=1, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=64)
    assert TDP.prologue_supported(TModelConfig(**kw))
    assert not TDP.prologue_supported(TModelConfig(**kw, norm_kind="layernorm"))
    assert not TDP.prologue_supported(TModelConfig(**kw, head_dim=12))
    x1, x8 = torch.zeros((2, 1, 64)), torch.zeros((2, 8, 64))
    assert not TDP.prologue_active(TModelConfig(**kw), x1)   # backend off
    with TO.kernel_backend_ctx("emulate"):
        assert TDP.prologue_active(TModelConfig(**kw), x1)
        assert not TDP.prologue_active(TModelConfig(**kw), x8)


def test_resolve_backend_auto_by_device():
    assert TO.resolve_backend("auto", "cpu") == "off"
    assert TO.resolve_backend(None, "cuda") == "int8"
    assert TO.resolve_backend("emulate", "cpu") == "emulate"
    with pytest.raises(ValueError):
        TO.resolve_backend("fast", "cpu")


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
@pytest.mark.parametrize("groups", [1, 2])
def test_paged_attention_vs_jax(pool_dtype, groups):
    rng = np.random.default_rng(3)
    n, bs, hkv, hd, b, m = 9, 8, 2, 16, 4, 4
    h = hkv * groups
    kv = rng.standard_normal((2, n, bs, hkv, hd)).astype(np.float32)
    if pool_dtype == "int8":
        amax = np.abs(kv).max(axis=(3, 4))
        scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
        q8 = np.clip(np.round(kv / scale[..., None, None]), -127, 127)
        pool = {"k": q8[0].astype(np.int8), "v": q8[1].astype(np.int8),
                "k_scale": scale[0], "v_scale": scale[1]}
    else:
        pool = {"k": kv[0], "v": kv[1]}
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    tables = rng.integers(1, n, size=(b, m)).astype(np.int32)
    tables[0] = 0                                  # an inactive slot
    lens = np.array([0, 7, 17, m * bs - 1], np.int32)   # 0, block edge, max
    want = JPA.paged_attention(jnp.asarray(q),
                               {k: jnp.asarray(v) for k, v in pool.items()},
                               jnp.asarray(tables), jnp.asarray(lens),
                               groups=groups, scale=hd ** -0.5)
    got = TPA.paged_attention(torch.from_numpy(q),
                              {k: torch.from_numpy(v) for k, v in pool.items()},
                              torch.from_numpy(tables), torch.from_numpy(lens),
                              groups=groups, scale=hd ** -0.5)
    _close(got, want)
