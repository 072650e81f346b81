"""Port parity: the int8 quantizers of ``repro_torch.quant.int8`` and the
serving KV quantizer ``quant_kv_rows`` against the JAX package, bit for bit.

Inputs are numpy arrays from a seeded generator, handed to both frameworks.
The rounding is half-to-even on both sides, so payloads match exactly,
including at exact .5 ties (constructed below on the quantization grid).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import int8 as JQ
from repro.serving import engine as JE
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
