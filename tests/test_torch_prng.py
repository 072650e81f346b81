"""Port parity: ``repro_torch.util.prng`` (threefry2x32 in torch int64 ops)
against ``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable`` True),
and the keyed stochastic quantizers of ``repro_torch.quant.fixed_point``
against the JAX package's.

Tolerance: none.  Keys, bits and uniforms are integer ops (the uniform a
bit pattern viewed as f32), so every comparison is bitwise, over a
hypothesis grid of seeds, fold data, offsets and shapes.  The quantizers
round on an exact power-of-two grid with the same noise, so their values
and STE gradients are bitwise too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.quant import fixed_point as JF
from repro_torch.quant import fixed_point as TF
from repro_torch.util import prng
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

SEEDS = st.one_of(st.sampled_from([0, 1, 2 ** 31 - 1, 2 ** 32 - 1]),
                  st.integers(0, 2 ** 32 - 1))
DATA = st.integers(0, 2 ** 32 - 1)
SHAPES = st.lists(st.integers(1, 9), min_size=0, max_size=3).map(tuple)


def _jkey(seed, folds=()):
    k = jax.random.key(seed)
    for d in folds:
        k = jax.random.fold_in(k, d)
    return k


def _tkey(seed, folds=()):
    k = prng.key(seed)
    for d in folds:
        k = prng.fold_in(k, d)
    return k


def _data(jk) -> np.ndarray:
    return np.asarray(jax.random.key_data(jk)).astype(np.int64)


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert t.shape == j.shape
    assert t.numpy().astype(j.dtype).tobytes() == j.tobytes()


@settings(max_examples=60, deadline=None)
@given(SEEDS, st.lists(DATA, max_size=3))
def test_key_and_fold_in_match_jax(seed, folds):
    assert prng.key(seed).tolist() == _data(jax.random.key(seed)).tolist()
    assert _tkey(seed, folds).tolist() == _data(_jkey(seed, folds)).tolist()


@settings(max_examples=40, deadline=None)
@given(SEEDS, st.lists(DATA, max_size=2), SHAPES)
def test_bits_and_uniform_match_jax(seed, folds, shape):
    jk, tk = _jkey(seed, folds), _tkey(seed, folds)
    _same(prng.random_bits(tk, shape),
          np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    _same(prng.uniform(tk, shape), jax.random.uniform(jk, shape, jnp.float32))


def test_uniform_matches_jax_on_the_recorded_shape():
    """The recipe's own check: fold_in(fold_in(fold_in(key(1), 7), 3), 5)
    over (4, 129, 33), 17028 draws."""
    shape = (4, 129, 33)
    want = jax.random.uniform(_jkey(1, (7, 3, 5)), shape, jnp.float32)
    got = prng.uniform(_tkey(1, (7, 3, 5)), shape)
    _same(got, want)
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@settings(max_examples=30, deadline=None)
@given(SEEDS, st.integers(0, 1000), st.integers(1, 6), SHAPES)
def test_uniform_rows_match_jax_per_row_folds(seed, offset, rows, shape):
    jk, tk = _jkey(seed, (offset % 7,)), _tkey(seed, (offset % 7,))
    want = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jk, offset + b), shape, jnp.float32))
        for b in range(rows)])
    _same(prng.uniform_rows(tk, (rows, *shape), offset), want)


def test_jax_key_data_is_a_port_key():
    """A JAX key's raw uint32 data is a port key; the full uint32 range of
    fold data folds as JAX's does."""
    jk = _jkey(9, (4,))
    tk = prng.as_key(np.asarray(jax.random.key_data(jk)))
    assert tk.dtype == torch.int64 and tk.tolist() == _data(jk).tolist()
    for v in (0, 1, 2 ** 31, 2 ** 32 - 1):
        assert prng.fold_in(tk, v).tolist() == _data(
            jax.random.fold_in(jk, v)).tolist()
    with pytest.raises(ValueError, match="two words"):
        prng.as_key(torch.zeros(3, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the keyed quantizers
# ---------------------------------------------------------------------------

def _x(seed, shape, bits):
    """Values on and between the (I,F) grid, some saturating."""
    rng = np.random.default_rng(seed)
    top = float(TF.fxp_max(*bits))
    return (rng.uniform(-1.3, 1.3, shape) * top).astype(np.float32)


@pytest.mark.parametrize("bits", [(2, 12), (1, 4), (3, 6)])
@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_keyed_quantize_stochastic_matches_jax(bits, seed):
    x = _x(21 + bits[1], (5, 17, 9), bits)
    c = np.random.default_rng(22).standard_normal(x.shape).astype(np.float32)
    i, f = jnp.int32(bits[0]), jnp.int32(bits[1])
    jk = _jkey(seed, (3,))
    yj, gj = jax.value_and_grad(
        lambda v: jnp.sum(JF.quantize_stochastic(v, i, f, jk) * c))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yt = TF.quantize_stochastic(xt, *bits, _tkey(seed, (3,)))
    (yt * torch.from_numpy(c)).sum().backward()
    _same(yt.detach(), JF.quantize_stochastic(jnp.asarray(x), i, f, jk))
    _same(xt.grad, gj)
    # a JAX key's raw data draws the same noise
    _same(TF.quantize_stochastic(torch.from_numpy(x), *bits,
                                 np.asarray(jax.random.key_data(jk))),
          JF.quantize_stochastic(jnp.asarray(x), i, f, jk))


@pytest.mark.parametrize("offset", [0, 3])
def test_keyed_stochastic_round_batched_matches_jax(offset):
    bits = (2, 5)
    x = _x(31, (8, 6, 7), bits)
    jk = _jkey(4, (2,))
    want = JF.stochastic_round_batched(jnp.asarray(x), jnp.int32(2),
                                       jnp.int32(5), jk, offset)
    got = TF.stochastic_round_batched(torch.from_numpy(x), *bits,
                                      _tkey(4, (2,)), offset)
    _same(got, want)
    # rows [3:] with their global offset reproduce the full batch's draws
    _same(TF.stochastic_round_batched(torch.from_numpy(x[3:]), *bits,
                                      _tkey(4, (2,)), offset + 3), want[3:])


def test_keyed_rounding_refuses_non_f32():
    """JAX draws the noise in x's dtype; the port draws f32 only."""
    x = torch.zeros(4, 4, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="f32 noise"):
        TF.quantize_stochastic(x, 2, 12, prng.key(0))
    with pytest.raises(TypeError, match="f32 noise"):
        TF.stochastic_round_batched(x, 2, 12, prng.key(0))
