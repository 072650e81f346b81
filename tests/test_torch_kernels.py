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
from repro_torch.kernels import fxp_matmul as TFM
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


@pytest.mark.parametrize("n_sm", [132, 4])
@pytest.mark.parametrize("k", [784, 1000, 2816])
@pytest.mark.parametrize("datapath,xb,wb", [("emulate", 4, 4),
                                            ("emulate", 2, 4),
                                            ("emulate", 2, 2),
                                            ("int8", 1, 1)])
def test_fxp_matmul_plan_splits_cover_k_once(n_sm, k, datapath, xb, wb):
    """Every k lies in exactly one split, in order, no split is empty, and
    the split count is a power of two <= 16 (one thread-block cluster)."""
    for m in (1, 8, 16, 17, 128, 1024):
        for n in (10, 256, 333, 1024, 2816):
            plan = TFM._plan(m, k, n, n_sm, datapath, xb, wb)
            s = plan.splits
            assert 1 <= s <= TFM.MAX_SPLITS and s & (s - 1) == 0
            ranges = TFM._k_ranges(plan, k)
            assert len(ranges) == s and ranges[0][0] == 0
            assert ranges[-1][1] == k
            for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(k, k)]):
                assert lo < hi == nxt and lo % plan.bk == 0
            assert plan.path == ("decode" if m <= TFM.DECODE_ROWS
                                 else "tiled")
            if plan.path == "decode":
                # the largest split's X fits its shared-memory budget
                rows = 8 if m <= 8 else 16
                xrow = rows * (xb + (1 if datapath == "int8" else 4))
                assert max(hi - lo for lo, hi in ranges) * xrow <= TFM.X_SMEM
                assert TFM._x_bytes(m, k, plan.bk, s, datapath,
                                    xb) <= TFM.X_SMEM


@pytest.mark.parametrize("datapath,xb,wb", [("emulate", 4, 4),
                                            ("emulate", 2, 2),
                                            ("int8", 1, 1)])
def test_fxp_matmul_plan_alignment_class(datapath, xb, wb):
    """Rows that are whole 16-byte pieces take 16-byte loads; an unaligned
    N (the LeNet head's 10, 333) or K takes the narrow loads."""
    for n in (10, 333):
        assert not TFM._plan(8, 1024, n, 132, datapath, xb, wb).vw
        assert not TFM._plan(128, 1024, n, 132, datapath, xb, wb).vw
    for n in (256, 1024, 2816):
        assert TFM._plan(8, 1024, n, 132, datapath, xb, wb).vw
    assert TFM._plan(8, 1024, 256, 132, datapath, xb, wb).vx
    assert TFM._plan(5, 1000, 333, 132, datapath, xb,
                     wb).vx == (1000 * xb % 16 == 0)


@pytest.mark.parametrize("datapath,xb,wb", [("emulate", 4, 4),
                                            ("emulate", 2, 4),
                                            ("emulate", 2, 2),
                                            ("int8", 1, 1)])
def test_fxp_matmul_plan_at_the_serving_and_lenet_shapes(datapath, xb, wb):
    bk = TFM.DECODE_BK[wb]
    # qwen1.5-0.5b decode (8 slots) and prefill (chunks of 16): 44 strips
    # of N = 2816 in 4 K splits (176 CTAs), 16 strips of N = 1024 in 8
    for m in (8, 16):
        assert TFM._plan(m, 1024, 2816, 132, datapath, xb, wb) == (
            "decode", 64, bk, 4, True, True)
        assert TFM._plan(m, 2816, 1024, 132, datapath, xb, wb) == (
            "decode", 64, bk, 8, True, True)
    # the unaligned phase-3 row: 6 strips, 8 splits, narrow loads of W
    assert TFM._plan(5, 1000, 333, 132, datapath, xb, wb) == (
        "decode", 64, bk, 8, 1000 * xb % 16 == 0, False)
    # LeNet-5 forward at batch 128 and 1024: 64x64 tiles, a K split while
    # the tiles leave SMs idle, at most 8
    tbk = TFM.TILED_BK[datapath]
    for (m, k, n), s in (((128, 784, 256), 8), ((128, 256, 256), 4),
                         ((128, 256, 10), 4), ((1024, 784, 256), 2),
                         ((1024, 256, 256), 2), ((1024, 256, 10), 4)):
        assert TFM._plan(m, k, n, 132, datapath, xb, wb) == (
            "tiled", 64, tbk, s, True, n != 10), (m, k, n)


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

def _prologue_setup(hkv, bias, rope, seed=0, hd=16):
    kw = dict(name="t-prologue", family="dense", num_layers=1, d_model=64,
              num_heads=4, num_kv_heads=hkv, d_ff=64, vocab_size=64,
              compute_dtype="float32", qkv_bias=bias, use_rope=rope,
              rope_theta=1e6, head_dim=hd)
    rng = np.random.default_rng(seed)
    d, h = 64, 4
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
@pytest.mark.parametrize("hkv,bias,rope,hd,angle_ulp", [
    pytest.param(4, True, True, 16, 0.0, id="4-True-True"),
    pytest.param(2, False, True, 16, 0.0, id="2-False-True"),
    pytest.param(2, True, False, 16, 0.0, id="2-True-False"),
    # two strips a head on the card, GQA groups of 2.  At hd 128 position
    # 300 turns pair 1 by 242 rad, whose f32 ulp is 2^-15: the two
    # libraries' rotations of the same q sit up to about that far apart
    # (1.8e-5 here), so q and k are allowed one such ulp of max|ref|
    pytest.param(2, True, True, 128, 2.0 ** -15, id="2-True-True-hd128"),
    # zamba2-2.7b's head dim 80 (a strip of 32 pairs and one of 8, 4-byte
    # W copies in int8), no bias; the same angle allowance as hd 128
    pytest.param(4, False, True, 80, 2.0 ** -15, id="4-False-True-hd80")])
def test_decode_prologue_vs_jax(backend, hkv, bias, rope, hd, angle_ulp):
    jcfg, tcfg, norm, attn, x, pos = _prologue_setup(hkv, bias, rope, hd=hd)
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
        if backend == "emulate" and angle_ulp:
            j = np.asarray(w)
            np.testing.assert_array_less(
                np.abs(g.numpy() - j),
                RTOL * (1.0 + np.abs(j)) + angle_ulp * np.abs(j).max())
        elif backend == "emulate":
            _close(g, w)
        else:
            # one int8 step of the normed row (|x| <= 127 * sx) moves an
            # output by at most sx * sw * max|w_col| * 1; allow 1e-3
            d = np.abs(g.numpy() - np.asarray(w))
            assert d.max() <= 1e-3 * (1 + np.abs(np.asarray(w)).max())
            assert (d > RTOL * (1 + np.abs(np.asarray(w)))).mean() <= 0.05


# (D, H, Hkv, hd) of the configs the prologue serves: qwen1.5-0.5b,
# yi-34b, h2o-danube3-4b (hd 120), gemma-7b (hd 256) and zamba2-2.7b's
# shared block (hd 80)
PROLOGUE_WIDTHS = {"qwen": (1024, 16, 16, 64), "yi": (7168, 56, 8, 128),
                   "danube": (3840, 32, 8, 120), "gemma": (3072, 16, 16, 256),
                   "zamba2": (2560, 32, 32, 80)}


@pytest.mark.parametrize("width", sorted(PROLOGUE_WIDTHS))
@pytest.mark.parametrize("datapath,xb", [("int8", 2), ("emulate", 2),
                                         ("emulate", 4)])
def test_decode_prologue_plan_covers_each_weight_once(width, datapath, xb):
    """Every (column, k) of the three weights is owned by exactly one
    (strip, split): the strips cover each column of q, k and v once and
    the splits each k once; both columns of a RoPE pair lie in one strip;
    a CTA's shared memory fits Hopper's and the cluster is portable."""
    d, h, hkv, hd = PROLOGUE_WIDTHS[width]
    half = hd // 2
    strips = TDP._strips(h, hkv, hd)
    cover = [np.zeros(nh * hd, np.int64) for nh in (h, hkv, hkv)]
    for kind, head, j0, npairs in strips:
        assert 0 < npairs <= TDP.PAIRS
        cols = head * hd + j0 + np.arange(npairs)
        cover[kind][cols] += 1            # pair j ...
        cover[kind][cols + half] += 1     # ... and j + hd/2, same strip
    assert all((c == 1).all() for c in cover)
    for b in (1, 8, 16, 24):
        plan = TDP._plan(b, d, h, hkv, hd, 132, datapath, xb)
        assert plan.strips == len(strips)
        assert plan.grid == (len(strips), plan.passes, plan.splits)
        assert plan.rows in (8, 16) and plan.passes * plan.rows >= b
        assert plan.passes == -(-b // plan.rows)
        s = plan.splits                   # the cluster's CTAs
        assert 1 <= s <= 8 and s & (s - 1) == 0
        assert plan.smem <= 232448
        assert plan.bk == (128 if datapath == "int8" else 32)
        kcov = np.zeros(d, np.int64)
        for lo, hi in TDP._k_ranges(plan, d):
            assert lo < hi and lo % plan.bk == 0
            kcov[lo:hi] += 1
        assert (kcov == 1).all()


@pytest.mark.parametrize("datapath,xb", [("int8", 2), ("emulate", 2),
                                         ("emulate", 4)])
def test_decode_prologue_plan_fills_the_card(datapath, xb):
    """At qwen1.5-0.5b width the 48 strips split D until the 132 SMs of an
    H100 each have a CTA; at yi-34b width B <= 16 slots read W once."""
    d, h, hkv, hd = PROLOGUE_WIDTHS["qwen"]
    for b in (1, 8, 16):
        plan = TDP._plan(b, d, h, hkv, hd, 132, datapath, xb)
        assert plan.strips == 48 and plan.ctas >= 132
    d, h, hkv, hd = PROLOGUE_WIDTHS["yi"]
    for b in (1, 8, 16):
        plan = TDP._plan(b, d, h, hkv, hd, 132, datapath, xb)
        assert plan.passes == 1 and plan.strips == 144
    assert TDP._plan(24, d, h, hkv, hd, 132, datapath, xb).passes == 2


def test_decode_prologue_plan_forces_and_refuses_splits():
    d, h, hkv, hd = PROLOGUE_WIDTHS["qwen"]
    for s in (1, 2, 4, 8):
        assert TDP._plan(8, d, h, hkv, hd, 132, "int8", 2,
                         splits=s).splits == s
    with pytest.raises(ValueError):
        TDP._plan(8, d, h, hkv, hd, 132, "int8", 2, splits=3)
    with pytest.raises(ValueError):
        TDP._plan(8, 100, h, hkv, hd, 132, "int8", 2, splits=2)  # 1 tile
    with pytest.raises(ValueError):
        TDP._plan(8, d, h, hkv, 15, 132, "int8", 2)              # odd hd


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_decode_prologue_takes_yi_width_off_the_cpu(datapath):
    """A yi-34b-wide prologue on meta tensors gets as far as the device
    check (RuntimeError), not a width limit (ValueError)."""
    m = dict(device="meta")
    d, h, hkv, hd = PROLOGUE_WIDTHS["yi"]
    wdt = torch.int8 if datapath == "int8" else torch.float32
    wq = torch.zeros((d, h * hd), dtype=wdt, **m)
    wkv = torch.zeros((d, hkv * hd), dtype=wdt, **m)
    kw = dict(wscales=torch.ones(3, **m)) if datapath == "int8" else {}
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        TDP.fused_prologue(torch.zeros((8, d), dtype=torch.bfloat16, **m),
                           torch.ones(d, **m), wq, wkv, wkv, None,
                           torch.zeros(8, dtype=torch.int32, **m),
                           use_rope=True, theta=5e6, eps=1e-5, h=h, hkv=hkv,
                           hd=hd, **kw)
    assert TDP._plan(8, d, h, hkv, hd, 132, datapath, 2).passes == 1


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


# ---------------------------------------------------------------------------
# paged_attention: the chunk plan of the CUDA kernel (the kernel runs only
# on the card; chip_smoke.py holds it against its plain version there)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,bs", [(32, 16), (256, 16), (1, 16), (30, 7),
                                  (3, 128), (5, 1)])
def test_paged_attention_chunks_cover_each_position_once(m, bs):
    chunks = TPA._chunks(m, bs)
    positions = [t for start, stop in chunks for t in range(start, stop)]
    assert positions == list(range(m * bs))          # each once, in order
    assert all(0 < stop - start <= TPA.CHUNK for start, stop in chunks)
    assert all(stop - start == TPA.CHUNK for start, stop in chunks[:-1])
    # the kernel refuses any other count: S = ceil(M*bs / CHUNK)
    assert len(chunks) == -(-m * bs // TPA.CHUNK)


def test_paged_attention_scratch_shapes():
    # yi-34b's widths at 8 slots of 256 blocks of 16
    shapes = TPA._scratch_shapes(8, 56, 128, 256, 16)
    assert shapes == {"probs": (8, 56, 4096), "stats": (8, 56, 64, 2),
                      "part": (8, 56, 64, 128)}
    # the phase-3 decode shape of qwen1.5-0.5b
    shapes = TPA._scratch_shapes(8, 16, 64, 32, 16)
    assert shapes["stats"] == (8, 16, 8, 2) and shapes["part"] == (
        8, 16, 8, 64)


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the parameters would go to the card")
    from repro_torch.models import lm as TLM
    cfg = TModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                       num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                       vocab_size=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLM.init_params(cfg)
    params = TLM.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_params_from_numpy_and_paged_pool_default_to_the_card():
    """The two helpers that carry weights across and make the KV pool run
    on the card unless told otherwise: without CUDA both defaults raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the tensors would go to the card")
    from repro_torch.models import lm as TLM
    from repro_torch.serving import engine as TE
    cfg = TModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                       num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                       vocab_size=64)
    tree = {"embed": np.zeros((4, 8), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLM.params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.init_paged_state(cfg, 3, 4)
    assert TLM.params_from_numpy(tree, device="cpu")["embed"].device.type \
        == "cpu"
    assert TE.init_paged_state(cfg, 3, 4, device="cpu")["k"].device.type \
        == "cpu"


def test_paged_attention_counters_are_kept_per_stream(monkeypatch):
    """Two streams never share tickets: each (device, stream) has its own
    zeroed counters, reused across calls and grown (zeroed) on demand."""
    monkeypatch.setattr(TPA, "_COUNTERS", {})
    dev = torch.device("cpu")
    a = TPA._counters(dev, 1, 64)
    assert TPA._counters(dev, 1, 64) is a
    b = TPA._counters(dev, 2, 64)
    assert b is not a and b.data_ptr() != a.data_ptr()
    assert a.dtype == torch.int32 and int(a.abs().sum()) == 0
    big = TPA._counters(dev, 1, 4096)
    assert big.numel() >= 4096 and int(big.abs().sum()) == 0
    assert TPA._counters(dev, 2, 64) is b
