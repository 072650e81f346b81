"""Port parity: the int8 quantizers of ``repro_torch.quant.int8``, the
serving KV quantizer ``quant_kv_rows`` and the (I,F) fixed-point
quantizers and bit schedules of ``repro_torch.quant.fixed_point`` against
the JAX package, bit for bit.

Inputs are numpy arrays from a seeded generator, handed to both frameworks.
The rounding is half-to-even on both sides, so payloads match exactly,
including at exact .5 ties (constructed below on the quantization grid).
Every fixed-point comparison is bitwise (tolerance 0): the grid steps are
exact powers of two, so ``x / step`` and ``k * step`` are exact and only
the rounding decides, which both frameworks do half to even.  The
stochastic quantizers take JAX's own uniform draw as their noise ``u``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import fixed_point as JF
from repro.quant import int8 as JQ
from repro.serving import engine as JE
from repro_torch.quant import fixed_point as TF
from repro_torch.quant import int8 as TQ
from repro_torch.serving import engine as TE


def _x(seed=0, shape=(33, 47), scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ties(step: float, n=64, seed=1):
    """Values exactly halfway between grid points k*step, both signs."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-40, 40, size=n).astype(np.float32)
    return ((k + 0.5) * np.float32(step)).astype(np.float32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bits", [(2, 5), (1, 6), (3, 4), (4, 10), (2, 12),
                                  (0, 7)])
def test_int8_spec_matches(bits):
    t, j = TQ.int8_spec(*bits), JQ.int8_spec(*bits)
    assert (t.scale, t.qmin, t.qmax, t.shift, t.exact) == \
        (j.scale, j.qmin, j.qmax, j.shift, j.exact)
    assert TQ.transport_bits(bits) == JQ.transport_bits(bits)


@pytest.mark.parametrize("bits", [(2, 5), (3, 4), (4, 10), (2, 12)])
def test_quantize_int8_fxp_bitwise_with_ties(bits):
    spec = JQ.int8_spec(*bits)
    x = np.concatenate([_x().ravel(), _ties(spec.scale)])
    qt, st = TQ.quantize_int8_fxp(torch.from_numpy(x), *bits)
    qj, sj = JQ.quantize_int8_fxp(jnp.asarray(x), *bits)
    _eq(qt, qj)
    assert float(st) == float(sj)


def test_quantize_int8_absmax_bitwise_with_ties():
    x = _x(2)
    s = float(JQ.absmax_scale(jnp.asarray(x)))
    x = np.concatenate([x.ravel(), _ties(s, seed=3)])
    x = x[np.abs(x) <= np.abs(x).max()]   # ties stay inside the absmax
    qt, st = TQ.quantize_int8_absmax(torch.from_numpy(x))
    qj, sj = JQ.quantize_int8_absmax(jnp.asarray(x))
    _eq(qt, qj)
    _eq(st, sj)
    # round half to even: at least one tie went down to the even integer
    scaled = np.asarray(x / np.float32(sj), np.float32)
    tie = np.abs(scaled - np.trunc(scaled)) == 0.5
    assert tie.any()
    assert np.all(qt.numpy()[tie] % 2 == 0)


@pytest.mark.parametrize("bits", [None, (2, 5), (4, 10)])
def test_quantize_int8_auto_and_dequantize(bits):
    x = _x(4)
    qt, st = TQ.quantize_int8_auto(torch.from_numpy(x), bits)
    qj, sj = JQ.quantize_int8_auto(jnp.asarray(x), bits)
    _eq(qt, qj)
    _eq(st, sj)
    _eq(TQ.dequantize_int8(qt, st), JQ.dequantize_int8(qj, sj))


def test_absmax_scale_zero_safe():
    z = np.zeros((4, 4), np.float32)
    assert float(TQ.absmax_scale(torch.from_numpy(z))) == 1.0
    _eq(TQ.absmax_scale(torch.from_numpy(_x(5))),
        JQ.absmax_scale(jnp.asarray(_x(5))))


def test_pow2_int_exact():
    for b in range(0, 31):
        assert float(TQ._pow2_int(b)) == 2.0 ** b


@pytest.mark.parametrize("heads,hd", [(2, 8), (4, 16)])
def test_quant_kv_rows_bitwise(heads, hd):
    """Per-token absmax over the head AND head_dim axes, ties included."""
    x = _x(6, (9, heads, hd))
    # plant exact ties: row 0's scale is absmax/127; put k+0.5 steps in it
    s = np.float32(max(np.abs(x[0]).max(), 1e-8)) / np.float32(127.0)
    x[0, 0, :4] = (np.array([0.5, -2.5, 3.5, 10.5], np.float32) * s)
    qt, st = TE.quant_kv_rows(torch.from_numpy(x))
    qj, sj = JE.quant_kv_rows(jnp.asarray(x))
    _eq(qt, qj)
    _eq(st, sj)
    zero = np.zeros((2, heads, hd), np.float32)
    qt, st = TE.quant_kv_rows(torch.from_numpy(zero))
    qj, sj = JE.quant_kv_rows(jnp.asarray(zero))
    _eq(qt, qj)
    _eq(st, sj)


# ---------------------------------------------------------------------------
# quant.fixed_point: (I,F) quantizers, STE, stochastic rounding, schedules
# ---------------------------------------------------------------------------

FXP_BITS = [(2, 12), (4, 10), (1, 4), (0, 7), (3, 10), (6, 2)]


def _fxp_x(bits, seed=7, dtype=np.float32):
    """Values spanning the format's range and past it, plus exact ties."""
    step = 2.0 ** -bits[1]
    top = (2.0 ** (bits[0] + bits[1]) - 1) * step
    x = np.concatenate([_x(seed, (300,), 1.5 * top / 3).ravel(),
                        _ties(step, seed=seed + 1),
                        np.array([top, -top - step, 2 * top, -2 * top])])
    return x.astype(dtype)


@pytest.mark.parametrize("bits", FXP_BITS)
def test_fixed_point_quantize_bitwise(bits):
    x = _fxp_x(bits)
    _eq(TF.quantize(torch.from_numpy(x), *bits),
        JF.quantize(jnp.asarray(x), *bits))
    # runtime (tensor) bits give the same grid
    _eq(TF.quantize(torch.from_numpy(x), torch.tensor(bits[0]),
                    torch.tensor(bits[1])),
        JF.quantize(jnp.asarray(x), jnp.int32(bits[0]), jnp.int32(bits[1])))
    assert float(TF.fxp_max(*bits)) == float(JF.fxp_max(*bits))
    assert float(TF.fxp_resolution(bits[1])) == float(
        JF.fxp_resolution(bits[1]))


@pytest.mark.parametrize("bits", [(2, 12), (4, 10)])
def test_fixed_point_quantize_bf16_bitwise(bits):
    """bf16 inputs stay bf16 through the grid, as in the JAX package."""
    x = _fxp_x(bits)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    got = TF.quantize(xt, *bits)
    assert got.dtype == torch.bfloat16
    _eq(got.float(), JF.quantize(xj, *bits).astype(jnp.float32))


@pytest.mark.parametrize("bits", FXP_BITS)
def test_quantize_ste_value_and_mask(bits):
    x = _fxp_x(bits, seed=11)
    c = _x(12, x.shape)
    xt = torch.from_numpy(x).requires_grad_()
    yt = TF.quantize_ste(xt, *bits)
    (yt * torch.from_numpy(c)).sum().backward()
    yj, gj = jax.value_and_grad(
        lambda v: jnp.sum(JF.quantize_ste(v, jnp.int32(bits[0]),
                                          jnp.int32(bits[1])) * c))(
        jnp.asarray(x))
    _eq(yt.detach(), JF.quantize(jnp.asarray(x), *bits))
    _eq(xt.grad, gj)
    # the mask zeroes exactly the saturated values
    top = float(TF.fxp_max(*bits))
    assert bool((xt.grad[torch.from_numpy(np.abs(x) > top)] == 0).all())


@pytest.mark.parametrize("bits", [(2, 12), (1, 4), (3, 6)])
def test_quantize_stochastic_with_jax_draw(bits):
    x = _fxp_x(bits, seed=21)
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    i, f = jnp.int32(bits[0]), jnp.int32(bits[1])
    c = _x(22, x.shape)
    yj, gj = jax.value_and_grad(
        lambda v: jnp.sum(JF.quantize_stochastic(v, i, f, key) * c))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yt = TF.quantize_stochastic(xt, *bits, torch.from_numpy(u))
    (yt * torch.from_numpy(c)).sum().backward()
    _eq(yt.detach(), JF._stochastic_value(jnp.asarray(x), i, f, key))
    _eq(xt.grad, gj)


def test_stochastic_round_batched_with_jax_rows():
    """Row b's noise is JAX's fold_in(key, offset + b) draw; a slice of the
    rows with the slice of u reproduces the full batch."""
    bits, off = (2, 5), 3
    x = _x(31, (8, 6), 2.0)
    key = jax.random.key(9)
    u = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, off + b), (6,), dtype=jnp.float32))
        for b in range(8)])
    want = JF.stochastic_round_batched(jnp.asarray(x), jnp.int32(2),
                                       jnp.int32(5), key, off)
    got = TF.stochastic_round_batched(torch.from_numpy(x), *bits,
                                      torch.from_numpy(u))
    _eq(got, want)
    _eq(TF.stochastic_round_batched(torch.from_numpy(x[3:]), *bits,
                                    torch.from_numpy(u[3:])), want[3:])


def _sched_eq(t, j, per_layer=True):
    for k in ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f", "enabled"):
        _eq(getattr(t, k), getattr(j, k))
    if per_layer:
        assert t.num_layers == j.num_layers


@pytest.mark.parametrize("n", [1, 2, 5, 24])
@pytest.mark.parametrize("ramp,enabled", [(True, True), (False, False)])
def test_bit_schedules_match(n, ramp, enabled):
    kw = dict(weight=(1, 9), act=(3, 8), grad=(2, 11), ramp=ramp,
              enabled=enabled)
    _sched_eq(TF.make_bit_schedule(n, **kw), JF.make_bit_schedule(n, **kw))
    fmts = [(i % 3, 8 + i % 5) for i in range(n)]
    _sched_eq(TF.schedule_from_formats(fmts, enabled=enabled),
              JF.schedule_from_formats(fmts, enabled=enabled))
    for ds in ("mnist", "cifar10", "svhn"):
        _sched_eq(TF.paper_schedule(ds, n), JF.paper_schedule(ds, n))
    t, j = TF.make_bit_schedule(n, **kw), JF.make_bit_schedule(n, **kw)
    _sched_eq(t.layer(n - 1), j.layer(n - 1), per_layer=False)


@pytest.mark.parametrize("enabled", [0.0, 1.0])
def test_maybe_quantize_blend(enabled):
    x = _fxp_x((2, 6), seed=41)
    xt = torch.from_numpy(x).requires_grad_()
    yt = TF.maybe_quantize(xt, 2, 6, torch.tensor(enabled))
    yt.sum().backward()
    gj = jax.grad(lambda v: jnp.sum(JF.maybe_quantize(
        v, jnp.int32(2), jnp.int32(6), jnp.float32(enabled))))(
        jnp.asarray(x))
    _eq(yt.detach(), JF.maybe_quantize(jnp.asarray(x), jnp.int32(2),
                                       jnp.int32(6), jnp.float32(enabled)))
    _eq(xt.grad, gj)


def test_qformat_matches():
    for bits in FXP_BITS:
        t, j = TF.QFormat(*bits), JF.QFormat(*bits)
        assert (repr(t), t.bitwidth, t.resolution, t.max_value) == \
            (repr(j), j.bitwidth, j.resolution, j.max_value)


def test_fixed_point_pow2_exact():
    for b in range(0, 31):
        assert float(TF._pow2_int(b)) == 2.0 ** b
