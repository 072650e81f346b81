"""Port parity of the LeNet-5 training slice against the JAX package, on CPU.

The same numpy inputs go through the JAX function and its port: the six
training oracles of ``kernels/ref.py``; the plain versions that the kernel
wrappers (``bp_gstep``, ``sgd_dw_update``, ``bp_fused_unit``) run on CPU
tensors, against the Pallas kernels in interpret mode; the ``*_op`` entry
points and ``dense_bwd_dx``/``dense_bwd_dw``; the synthetic data; and the
LeNet train step (input 64, hidden 32, 5 layers, 10 classes, as
``tests/test_kernel_backend.py``) from JAX's parameters carried across by
``params_from_numpy``.

Tolerances, and why:
  * int8 datapaths, called op by op: the payloads, the int32 sums and every
    f32 rescale, product and difference are the same IEEE operations in the
    same order, so the results are bitwise equal.  Two exceptions, both
    XLA's (ROADMAP C): the jitted JAX ``*_op`` may round a fused rescale one
    ulp away, so there the port is held bitwise to its own oracle and at
    f32 tolerance to JAX; and the Pallas kernels in interpret mode contract
    the update ``W - lr*dW`` into one fused multiply-add, which the
    reference and the port round twice, so W_new is held to one rounding
    of lr*dW there: |d| <= 2^-23 * (|W| + |W_new|).
  * f32 datapaths: the frameworks sum products in different orders, so
    values agree to f32 reassociation error, |d| <= 1e-5 * (1 + |ref|) at
    these sizes (contractions <= 256 terms, values O(1)).
  * after an (I,F) rounding, a value that sits at a rounding tie in one
    framework may land one grid step 2^-F away in the other (ROADMAP's
    grid-step rule): every difference is at most one step, on at most 2%
    of the elements; the update W - lr*dW then moves by lr * |x| * 2^-F on
    the weights that such a G element touches.
  * the LeNet step: stated beside each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lenet5 import LeNetConfig as JLeNetConfig
from repro.core import lenet as JL
from repro.data.pipeline import SyntheticClassificationDataset as JData
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.bp_fused_unit import bp_fused_unit as j_fused
from repro.kernels.bp_gstep import bp_gstep as j_gstep
from repro.kernels.sgd_dw_update import sgd_dw_update as j_dw
from repro_torch.configs.lenet5 import CONFIG, LeNetConfig
from repro_torch.core import lenet as TL
from repro_torch.data import SyntheticClassificationDataset as TData
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import bp_fused_unit as TFU
from repro_torch.kernels import bp_gstep as TGS
from repro_torch.kernels import sgd_dw_update as TSW
from repro_torch.kernels.bp_fused_unit import bp_fused_unit
from repro_torch.kernels.bp_gstep import bp_gstep
from repro_torch.kernels.sgd_dw_update import sgd_dw_update

RTOL = 1e-5
LR = 0.05


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(t, j, tol=RTOL):
    t = t.detach().to(torch.float32).numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape
    np.testing.assert_array_less(np.abs(t - j), tol * (1.0 + np.abs(j)))


def _grid_close(t, j, step, frac=0.02):
    """Within f32 tolerance, except one grid step on <= ``frac`` of the
    elements."""
    d = np.abs(t.numpy() - np.asarray(j))
    lim = RTOL * (1.0 + np.abs(np.asarray(j)))
    assert d.max() <= step * (1 + 1e-6) + lim.max(), d.max()
    assert (d > lim).mean() <= frac, (d > lim).mean()


def _bitwise(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _one_rounding(t, j, w):
    """W - lr*dW rounded twice against one FMA: one rounding of lr*dW."""
    j = np.asarray(j)
    lim = 2.0 ** -23 * (np.abs(w) + np.abs(j)) + 1e-30
    np.testing.assert_array_less(np.abs(t.numpy() - j), lim)


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _payload(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# the six oracles of kernels/ref.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g_bits,act,with_z", [
    ((2, 12), "relu", True), (None, "relu", True), ((1, 12), "tanh", True),
    (None, "identity", False), ((2, 5), "identity", False)])
def test_bp_gstep_ref_vs_jax(g_bits, act, with_z):
    g, w = _rand((16, 10), 0, 0.1), _rand((24, 10), 1, 0.3)
    z = _rand((16, 24), 2) if with_z else None
    got = TR.bp_gstep_ref(_t(g), _t(w), None if z is None else _t(z),
                          g_bits=g_bits, act=act)
    want = JR.bp_gstep_ref(_j(g), _j(w), _j(z), g_bits=g_bits, act=act)
    if g_bits is None:
        _close(got, want)
    else:
        _grid_close(got, want, 2.0 ** -g_bits[1])


@pytest.mark.parametrize("with_w,w_bits", [(True, None), (True, (2, 12)),
                                           (False, None), (False, (4, 10))])
def test_sgd_dw_update_ref_vs_jax(with_w, w_bits):
    x, g = _rand((16, 24), 3), _rand((16, 10), 4, 0.1)
    w = _rand((24, 10), 5, 0.3) if with_w else None
    got = TR.sgd_dw_update_ref(_t(x), _t(g), None if w is None else _t(w),
                               LR, w_bits=w_bits)
    want = JR.sgd_dw_update_ref(_j(x), _j(g), _j(w), LR, w_bits=w_bits)
    if w_bits is None:
        _close(got, want)
    else:
        _grid_close(got, want, 2.0 ** -w_bits[1])


@pytest.mark.parametrize("bits", [((2, 12), (2, 12), None),
                                  (None, None, None),
                                  ((1, 12), (2, 5), (2, 12))])
def test_bp_fused_unit_ref_vs_jax(bits):
    g_bits, w_bits, w_out_bits = bits
    g, w = _rand((16, 24), 6, 0.1), _rand((32, 24), 7, 0.3)
    x, z = np.maximum(_rand((16, 32), 8), 0), _rand((16, 32), 9)
    kw = dict(g_bits=g_bits, w_bits=w_bits, w_out_bits=w_out_bits,
              act="relu")
    got = TR.bp_fused_unit_ref(_t(g), _t(w), _t(x), _t(z), LR, **kw)
    want = JR.bp_fused_unit_ref(_j(g), _j(w), _j(x), _j(z), LR, **kw)
    for t_, j_, b in zip(got, want, (g_bits, w_out_bits)):
        if b is None:
            _close(t_, j_)
        else:
            _grid_close(t_, j_, 2.0 ** -b[1])


_INT8_BITS = [((2, 12), (2, 12)), ((2, 5), (1, 6)), (None, (3, 4))]


@pytest.mark.parametrize("g_in_bits,w_bits", _INT8_BITS)
@pytest.mark.parametrize("with_z", [True, False])
def test_bp_gstep_int8_ref_bitwise(g_in_bits, w_bits, with_z):
    g, w = _rand((16, 10), 10, 0.1), _rand((24, 10), 11, 0.3)
    z = _rand((16, 24), 12) if with_z else None
    kw = dict(g_in_bits=g_in_bits, w_bits=w_bits,
              g_bits=(2, 12) if with_z else None,
              act="relu" if with_z else "identity")
    got = TR.bp_gstep_int8_ref(_t(g), _t(w), None if z is None else _t(z),
                               **kw)
    _bitwise(got, JR.bp_gstep_int8_ref(_j(g), _j(w), _j(z), **kw))


@pytest.mark.parametrize("xa_bits,g_in_bits", _INT8_BITS)
@pytest.mark.parametrize("with_w", [True, False])
def test_sgd_dw_update_int8_ref_bitwise(xa_bits, g_in_bits, with_w):
    x, g = np.maximum(_rand((16, 24), 13), 0), _rand((16, 10), 14, 0.1)
    w = _rand((24, 10), 15, 0.3) if with_w else None
    kw = dict(xa_bits=xa_bits, g_in_bits=g_in_bits, w_bits=None)
    got = TR.sgd_dw_update_int8_ref(_t(x), _t(g),
                                    None if w is None else _t(w), LR, **kw)
    _bitwise(got, JR.sgd_dw_update_int8_ref(_j(x), _j(g), _j(w), LR, **kw))


@pytest.mark.parametrize("w_bits", [(2, 12), (2, 5), None])
def test_bp_fused_unit_int8_ref_bitwise(w_bits):
    g, w = _rand((16, 24), 16, 0.1), _rand((32, 24), 17, 0.3)
    x, z = np.maximum(_rand((16, 32), 18), 0), _rand((16, 32), 19)
    kw = dict(g_in_bits=(2, 12), xa_bits=(4, 10), g_bits=(2, 12),
              w_bits=w_bits, w_out_bits=None, act="relu")
    got = TR.bp_fused_unit_int8_ref(_t(g), _t(w), _t(x), _t(z), LR, **kw)
    want = JR.bp_fused_unit_int8_ref(_j(g), _j(w), _j(x), _j(z), LR, **kw)
    for t_, j_ in zip(got, want):
        _bitwise(t_, j_)


# ---------------------------------------------------------------------------
# the wrappers' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dout", [10, 32, 256])
@pytest.mark.parametrize("form", ["relu", "z=None"])
@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_bp_gstep_vs_jax_kernel(dout, form, datapath):
    """Dout 10 is the LeNet head (the CUDA kernel's short path); 256 is
    deeper than one tile of its tiled path and two of the JAX kernel's
    128-deep blocks."""
    t, din = 16, 24
    z = _rand((t, din), 20) if form == "relu" else None
    kw = (dict(g_bits=(1, 12), act="relu") if form == "relu"
          else dict(g_bits=None, act="identity"))
    if datapath == "int8":
        g, w, scale = _payload((t, dout), 21), _payload((din, dout), 22), \
            np.float32(2.3e-5)
        got = bp_gstep(_t(g), _t(w), None if z is None else _t(z),
                       datapath="int8", scale=float(scale), **kw)
        want = j_gstep(_j(g), _j(w), _j(z), datapath="int8",
                       scale=jnp.float32(scale), interpret=True, **kw)
        _bitwise(got, want)
        return
    g, w = _rand((t, dout), 23, 0.1), _rand((din, dout), 24, 0.3)
    got = bp_gstep(_t(g), _t(w), None if z is None else _t(z), **kw)
    want = j_gstep(_j(g), _j(w), _j(z), interpret=True, **kw)
    if form == "relu":
        _grid_close(got, want, 2.0 ** -12)
    else:
        _close(got, want)


@pytest.mark.parametrize("dout", [10, 32])
@pytest.mark.parametrize("w_bits,with_w", [(None, True), ((2, 12), True),
                                           (None, False)])
@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_sgd_dw_update_vs_jax_kernel(dout, w_bits, with_w, datapath):
    t, din = 16, 24
    w = _rand((din, dout), 25, 0.3) if with_w else None
    tw = None if w is None else _t(w)
    if datapath == "int8":
        x, g, scale = _payload((t, din), 26), _payload((t, dout), 27), \
            np.float32(1.7e-5)
        got = sgd_dw_update(_t(x), _t(g), tw, LR, w_bits=w_bits,
                            datapath="int8", scale=float(scale))
        want = j_dw(_j(x), _j(g), _j(w), LR, w_bits=w_bits, datapath="int8",
                    scale=jnp.float32(scale), interpret=True)
        if with_w and w_bits is None:
            _one_rounding(got, want, w)
        else:
            _bitwise(got, want)
        return
    x, g = np.maximum(_rand((t, din), 28), 0), _rand((t, dout), 29, 0.1)
    got = sgd_dw_update(_t(x), _t(g), tw, LR, w_bits=w_bits)
    want = j_dw(_j(x), _j(g), _j(w), LR, w_bits=w_bits, interpret=True)
    if w_bits is None:
        _close(got, want)
    else:
        _grid_close(got, want, 2.0 ** -w_bits[1])


@pytest.mark.parametrize("dout", [10, 24, 1030])
@pytest.mark.parametrize("datapath,w_bits", [
    ("emulate", (2, 12)), ("emulate", None),
    ("int8", (2, 12)), ("int8", (2, 5)), ("int8", None)])
def test_bp_fused_unit_vs_jax_kernel(dout, datapath, w_bits):
    """int8 covers W on its exact (I,F) grid (2, 5) and the whole-tensor
    absmax ((2, 12) does not embed in 8 bits; None); Dout 1030 is ragged
    and wider than the first CUDA port took."""
    t, din = 16, 32
    w = _rand((din, dout), 30, 0.3)
    z = _rand((t, din), 31)
    kw = dict(g_bits=(2, 12), w_bits=w_bits, w_out_bits=None, act="relu")
    if datapath == "int8":
        g, x = _payload((t, dout), 32), _payload((t, din), 33)
        gs, xs = np.float32(1.1e-4), np.float32(0.02)
        got = bp_fused_unit(_t(g), _t(w), _t(x), _t(z), LR, datapath="int8",
                            g_scale=float(gs), x_scale=float(xs), **kw)
        want = j_fused(_j(g), _j(w), _j(x), _j(z), LR, datapath="int8",
                       g_scale=jnp.float32(gs), x_scale=jnp.float32(xs),
                       interpret=True, **kw)
        _bitwise(got[0], want[0])
        _one_rounding(got[1], want[1], w)
        return
    g, x = _rand((t, dout), 34, 0.1), np.maximum(_rand((t, din), 35), 0)
    got = bp_fused_unit(_t(g), _t(w), _t(x), _t(z), LR, **kw)
    want = j_fused(_j(g), _j(w), _j(x), _j(z), LR, interpret=True, **kw)
    _grid_close(got[0], want[0], 2.0 ** -12)
    _close(got[1], want[1])


def test_training_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    meta tensors, which no kernel takes, must raise, not run the plain
    path."""
    m = dict(device="meta")
    g, w, xz = (torch.zeros((8, 4), **m), torch.zeros((16, 4), **m),
                torch.zeros((8, 16), **m))
    with pytest.raises(RuntimeError):
        bp_gstep(g, w, xz)
    with pytest.raises(RuntimeError):
        sgd_dw_update(xz, g, w, LR)
    with pytest.raises(RuntimeError):
        bp_fused_unit(g, w, xz, xz, LR)


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_bp_fused_unit_takes_a_wide_dout_off_the_cpu(datapath):
    """No Dout is too wide: a 2816-wide frame on meta tensors gets as far
    as the device check (RuntimeError), where the first CUDA port refused
    Dout > 1024 with a ValueError before it."""
    m = dict(device="meta")
    dt = torch.int8 if datapath == "int8" else torch.float32
    g, w = torch.zeros((8, 2816), dtype=dt, **m), torch.zeros((16, 2816), **m)
    x, z = torch.zeros((8, 16), dtype=dt, **m), torch.zeros((8, 16), **m)
    kw = dict(datapath="int8", g_scale=1.0, x_scale=1.0) \
        if datapath == "int8" else {}
    with pytest.raises(RuntimeError, match="CUDA device"):
        bp_fused_unit(g, w, x, z, LR, **kw)


def test_wrappers_check_their_operands():
    g, w, z = torch.zeros((8, 4)), torch.zeros((16, 4)), torch.zeros((8, 16))
    with pytest.raises(ValueError):
        bp_gstep(g, w, None, act="relu")              # f' needs Z
    with pytest.raises(TypeError):
        bp_gstep(g, w, z, datapath="int8", scale=1.0)  # f32, not payloads
    with pytest.raises(ValueError):
        sgd_dw_update(z, g, torch.zeros((16, 5)), LR)  # W shape
    with pytest.raises(ValueError):
        bp_fused_unit(g.to(torch.int8), w, z.to(torch.int8), z, LR,
                      datapath="int8", g_scale=1.0)    # no x_scale


# ---------------------------------------------------------------------------
# ops: the *_op entry points and the dense unit's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_training_ops_vs_jax(datapath):
    t, din, dout = 16, 32, 24
    g, w = _rand((t, dout), 36, 0.1), _rand((din, dout), 37, 0.3)
    x, z = np.maximum(_rand((t, din), 38), 0), _rand((t, din), 39)
    bits = dict(g_in_bits=(2, 12), w_bits=(2, 5))
    got = TO.bp_gstep_op(_t(g), _t(w), _t(z), datapath=datapath, **bits)
    want = JO.bp_gstep_op(_j(g), _j(w), _j(z), datapath=datapath, **bits)
    _grid_close(got, want, 2.0 ** -12)
    got_dw = TO.sgd_dw_update_op(_t(x), _t(g), _t(w), LR, datapath=datapath)
    want_dw = JO.sgd_dw_update_op(_j(x), _j(g), _j(w), LR, datapath=datapath)
    _close(got_dw, want_dw)
    got_f = TO.bp_fused_unit_op(_t(g), _t(w), _t(x), _t(z), LR,
                                datapath=datapath, g_in_bits=(2, 12))
    want_f = JO.bp_fused_unit_op(_j(g), _j(w), _j(x), _j(z), LR,
                                 datapath=datapath, g_in_bits=(2, 12))
    _grid_close(got_f[0], want_f[0], 2.0 ** -12)
    _close(got_f[1], want_f[1])
    if datapath == "int8":
        # bitwise to the port's own oracles (XLA may fuse JAX's rescale)
        _bitwise(got, TR.bp_gstep_int8_ref(_t(g), _t(w), _t(z), **bits))
        _bitwise(got_dw, TR.sgd_dw_update_int8_ref(_t(x), _t(g), _t(w), LR))
        for a, b in zip(got_f, TR.bp_fused_unit_int8_ref(
                _t(g), _t(w), _t(x), _t(z), LR, g_in_bits=(2, 12))):
            _bitwise(a, b)


@pytest.mark.parametrize("backend", ["emulate", "int8"])
@pytest.mark.parametrize("n", [10, 32])
def test_dense_bwd_vs_jax(backend, n):
    m, k = 16, 24
    dz, w, x2 = _rand((m, n), 40, 0.1), _rand((k, n), 41, 0.3), \
        _rand((m, k), 42)
    dx = TO.dense_bwd_dx(_t(dz), _t(w), backend)
    dw = TO.dense_bwd_dw(_t(x2), _t(dz), backend)
    want_dx = JO.dense_bwd_dx(_j(dz), _j(w), backend)
    want_dw = JO.dense_bwd_dw(_j(x2), _j(dz), backend)
    assert tuple(dx.shape) == (m, k) and tuple(dw.shape) == (k, n)
    if backend == "int8":
        _bitwise(dx, want_dx)
        _bitwise(dw, want_dw)
    else:
        _close(dx, want_dx)
        _close(dw, want_dw)


# ---------------------------------------------------------------------------
# data, config, parameters
# ---------------------------------------------------------------------------

def test_synthetic_classification_matches_jax_data():
    kw = dict(input_dim=64, num_classes=10, n_train=256, n_test=64, seed=3,
              noise=3.5)
    a, b = TData(**kw), JData(**kw)
    for part in ("train", "test"):
        for u, v in zip(getattr(a, part), getattr(b, part)):
            np.testing.assert_array_equal(u, v)
    for (xa, ya), (xb, yb) in zip(a.train_batches(32, 3, seed=5),
                                  b.train_batches(32, 3, seed=5)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_lenet_config_and_params_match_jax_layout():
    assert CONFIG == LeNetConfig(input_dim=784, hidden=256, num_layers=5,
                                 num_classes=10)
    assert CONFIG.__dict__ == JLeNetConfig().__dict__
    tp = TL.init_lenet_params(CONFIG, seed=0, device="cpu")
    jp = JL.init_lenet_params(jax.random.key(0), JLeNetConfig())
    for k in ("w_in", "hidden", "w_out"):
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
        assert tp[k].dtype == torch.float32
    # N(0, 1/fan_in), like the JAX initializer
    assert abs(float(tp["w_in"].std()) * 784 ** 0.5 - 1) < 0.02
    assert abs(float(tp["hidden"].std()) * 256 ** 0.5 - 1) < 0.02
    assert abs(float(tp["w_out"].std()) * 256 ** 0.5 - 1) < 0.1


def test_lenet_bits_match_jax():
    pts = [(2, 12), (2, 12), (2, 12), (1, 12), (3, 10)]
    assert TL.lenet_bits_table(pts).__dict__ == \
        JL.lenet_bits_table(pts).__dict__
    assert TL.lenet_bits(5).__dict__ == JL.lenet_bits(5).__dict__
    assert TL.lenet_bits_off(5).__dict__ == JL.lenet_bits_off(5).__dict__


# ---------------------------------------------------------------------------
# the LeNet train step
# ---------------------------------------------------------------------------

SMALL = dict(input_dim=64, hidden=32, num_layers=5, num_classes=10)
# (loss relative, params max |d|) per backend, JAX step against the port's:
#  * off / emulate: f32 sums in another order, plus one 2^-12 grid step on
#    a few G or activation elements (moving a weight by lr*|x|*2^-12 <=
#    1e-4 at lr 0.1): 1e-5 and 2e-4.
#  * int8: the payloads, int32 sums and rescales are the same operations,
#    but an f32 value an ulp apart (softmax, XLA's fused rescale) may round
#    to another int8 payload, one step of max|.|/127, and the step then
#    runs down the G chain: 1e-4 and 2e-3.
STEP_TOL = {"off": (1e-5, 2e-4), "emulate": (1e-5, 2e-4),
            "int8": (1e-4, 2e-3)}
# after five steps: off/emulate as after one (observed 1e-7 and 3e-8); on
# int8 each payload moved by a step changes the next forward's payloads,
# so the differences compound (observed 3.5e-4 and 1.2e-3 with bits on)
FIVE_STEP_TOL = {"emulate": (1e-5, 2e-4), "int8": (2e-3, 1e-2)}


def _lenet_setup():
    params = JL.init_lenet_params(jax.random.key(0), JLeNetConfig(**SMALL))
    x = np.array(jax.random.normal(jax.random.key(1), (64, 64)))
    y = np.array(jax.random.randint(jax.random.key(2), (64,), 0, 10))
    return jax.tree.map(np.asarray, params), x, y


def _max_diff(tp, jp):
    return max(float(np.abs(tp[k].numpy() - np.asarray(jp[k])).max())
               for k in jp)


@pytest.mark.parametrize("bits_on", [False, True])
@pytest.mark.parametrize("backend", ["off", "emulate", "int8"])
def test_lenet_step_vs_jax(backend, bits_on):
    params, x, y = _lenet_setup()
    jbits = JL.lenet_bits(5) if bits_on else JL.lenet_bits_off(5)
    tbits = TL.lenet_bits(5) if bits_on else TL.lenet_bits_off(5)
    jstep = jax.jit(JL.make_lenet_train_step(JLeNetConfig(**SMALL), jbits,
                                             backend))
    tstep = TL.make_lenet_train_step(LeNetConfig(**SMALL), tbits, backend,
                                     device="cpu")
    jp, jm = jstep(jax.tree.map(jnp.asarray, params),
                   (jnp.asarray(x), jnp.asarray(y)), 0.1)
    tp, tm = tstep(TL.params_from_numpy(params, device="cpu"), (x, y), 0.1)
    loss_tol, param_tol = STEP_TOL[backend]
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=loss_tol)
    assert float(tm["acc"]) == float(jm["acc"])
    assert _max_diff(tp, jp) < param_tol


@pytest.mark.parametrize("backend", ["emulate", "int8"])
def test_lenet_five_steps_descend_with_jax(backend):
    """Five steps on one batch: both descend at every step, and the port
    stays within ``FIVE_STEP_TOL`` of JAX."""
    params, x, y = _lenet_setup()
    jstep = jax.jit(JL.make_lenet_train_step(JLeNetConfig(**SMALL),
                                             JL.lenet_bits(5), backend))
    tstep = TL.make_lenet_train_step(LeNetConfig(**SMALL), TL.lenet_bits(5),
                                     backend, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    tp = TL.params_from_numpy(params, device="cpu")
    jl, tl = [], []
    for _ in range(5):
        jp, jm = jstep(jp, (jnp.asarray(x), jnp.asarray(y)), 0.1)
        tp, tm = tstep(tp, (x, y), 0.1)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert all(np.diff(tl) < 0) and all(np.diff(jl) < 0), (tl, jl)
    loss_tol, param_tol = FIVE_STEP_TOL[backend]
    np.testing.assert_allclose(tl, jl, rtol=loss_tol)
    assert _max_diff(tp, jp) < param_tol


def test_lenet_step_metrics_stay_tensors():
    params, x, y = _lenet_setup()
    step = TL.make_lenet_train_step(LeNetConfig(**SMALL), TL.lenet_bits(5),
                                    "auto", device="cpu")
    p, m = step(TL.params_from_numpy(params, device="cpu"), (x, y),
                torch.tensor(0.1))
    assert isinstance(m["loss"], torch.Tensor) and m["loss"].dim() == 0
    assert set(p) == {"w_in", "hidden", "w_out"}
    assert tuple(p["hidden"].shape) == (3, 32, 32)


def test_lenet_step_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the step would run on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.make_lenet_train_step(CONFIG, TL.lenet_bits(5), "int8",
                                 device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.make_lenet_train_step(CONFIG)             # the card by default


def test_lenet_update_sensitivity_to_sum_order(monkeypatch):
    """Why the card-vs-CPU parity of the full-width train step allows 0.15
    (``chip_smoke.py::TRAIN_PARITY_TOL``): the G chain is a few 2^-12 grid
    steps large, so an ulp of difference that moves one value across a
    rounding boundary moves it a whole step, and the next frame carries the
    step into a row of boundaries.  Reversing the order of every sum of the
    plain emulate step, on the CPU alone, moves the updates by 4.6% (w_in)
    and 2.1% (hidden) on the full-width network; the int8 chain's exact
    integer sums do not move."""
    data = TData(784, 10, n_train=8192, n_test=2048, noise=3.5, seed=0)
    x, y = next(data.train_batches(128, 1, seed=0))
    bits = TL.lenet_bits_table([(2, 12), (2, 12), (2, 12), (1, 12), (3, 10)])
    matmul = torch.Tensor.__matmul__

    def reversed_sums(a, b):
        k = torch.arange(a.shape[-1] - 1, -1, -1)
        return matmul(a[..., k], b[k])

    for backend in ("emulate", "int8"):
        p0 = TL.init_lenet_params(CONFIG, seed=0, device="cpu")
        step = TL.make_lenet_train_step(CONFIG, bits, backend, device="cpu")
        ref, ref_m = step(p0, (x, y), LR)
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "__matmul__", reversed_sums)
            got, got_m = step(p0, (x, y), LR)
        rel = {k: float((got[k] - ref[k]).norm() / (ref[k] - p0[k]).norm())
               for k in ref}
        assert max(rel.values()) < 0.15, (backend, rel)
        if backend == "int8":
            assert max(rel.values()) == 0.0, rel
        assert float(got_m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                     rel=1e-4)


# ---------------------------------------------------------------------------
# sgd_dw_update: the token split of the CUDA kernel (the kernel runs only on
# the card; chip_smoke.py holds it against its plain version there)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
@pytest.mark.parametrize("t,din,dout", [(128, 784, 256), (1024, 784, 256),
                                        (128, 256, 10), (1024, 256, 10),
                                        (2048, 1024, 2816), (100, 50, 10),
                                        (3, 16, 16), (4100, 64, 48),
                                        (0, 8, 8)])
@pytest.mark.parametrize("n_sm", [132, 8])
def test_sgd_dw_splits_cover_each_token_once(datapath, t, din, dout, n_sm):
    kind, per, s = TSW._plan(t, din, dout, n_sm, datapath)
    bk = TSW.BK[datapath]
    nk = -(-t // bk)
    runs = [range(k * per * bk, min((k + 1) * per * bk, t)) for k in range(s)]
    # each token once, in order
    assert [i for r in runs for i in r] == list(range(t))
    if t == 0:
        assert s == 1
        return
    assert 1 <= s <= nk
    assert all(len(r) > 0 for r in runs)                    # no empty split
    # the kernel's own check of the plan (csrc/sgd_dw_update.cu, plan_ok):
    # the splits of a tile form one cluster, at most MAX_SPLITS CTAs
    assert per >= 1 and (s - 1) * per < nk <= s * per
    assert s <= TSW.MAX_SPLITS == 16
    # a split is at least MIN_SPLIT_TOKENS long unless it is the only one
    assert s == 1 or per * bk >= TSW.MIN_SPLIT_TOKENS[datapath]
    # at most CTAS_PER_SM CTAs an SM, unless one split already has more
    tiles = TSW._tiles(kind, din, dout)
    assert s * tiles <= max(tiles, TSW.CTAS_PER_SM[kind] * n_sm)
    assert (kind == "int8") == (datapath == "int8")


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_sgd_dw_plan_at_the_lenet_and_mlp_shapes(datapath):
    f32 = datapath == "emulate"
    # LeNet at batch 128 (the train step): emulate splits 64x64 tiles in 4,
    # int8 runs one CTA a tile over both token tiles
    for din, dout in ((784, 256), (256, 10)):
        assert TSW._plan(128, din, dout, 132, datapath) == (
            ("f32x4", 2, 4) if f32 else ("int8", 2, 1))
    # at batch 1024 both split, up to CTAS_PER_SM CTAs an SM, in clusters
    # of a power of two
    assert TSW._plan(1024, 784, 256, 132, datapath) == (
        ("f32x4", 8, 8) if f32 else ("int8", 4, 4))
    assert TSW._plan(1024, 256, 10, 132, datapath) == (
        ("f32x4", 4, 16) if f32 else ("int8", 2, 8))
    # the qwen MLP shape fills the card with whole tiles
    assert TSW._plan(2048, 1024, 2816, 132, datapath) == (
        ("f32x8" if f32 else "int8"), 128 if f32 else 32, 1)


def test_lenet_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the defaults would run on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.init_lenet_params(CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.make_lenet_train_step(CONFIG, TL.lenet_bits(5))
    assert TL.init_lenet_params(CONFIG, device="cpu")["w_in"].device.type \
        == "cpu"


def test_lenet_default_backend_on_the_cpu_is_off():
    """``auto`` (the default) resolves to the plain oracles on the CPU."""
    params, x, y = _lenet_setup()
    cfg, bits = LeNetConfig(**SMALL), TL.lenet_bits(5)
    p0 = TL.params_from_numpy(params, device="cpu")
    got, got_m = TL.make_lenet_train_step(cfg, bits, device="cpu")(
        p0, (x, y), 0.1)
    ref, ref_m = TL.make_lenet_train_step(cfg, bits, "off", device="cpu")(
        p0, (x, y), 0.1)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(got_m["loss"], ref_m["loss"])


# ---------------------------------------------------------------------------
# bp_fused_unit: the tiles, clusters and Dout chunks of the CUDA kernel (the
# kernel runs only on the card; chip_smoke.py holds it against its plain
# version there, for every tile height and cluster size)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
@pytest.mark.parametrize("din", [256, 784])
@pytest.mark.parametrize("dout", [10, 256, 1025, 2816, 8192])
@pytest.mark.parametrize("t", [128, 1024, 2048])
def test_bp_fused_unit_plan_tiles_w_once(datapath, din, dout, t):
    plan = TFU._plan(t, din, dout, 132, datapath)
    gx, gy = plan.grid
    # every (Din, Dout) element is owned by exactly one CTA: the Din tiles
    # and the Dout slices each cover their axis once (a CTA past Dout pads
    # the last cluster and owns nothing)
    rows, cols = np.zeros(din, np.int64), np.zeros(dout, np.int64)
    for y in range(gy):
        rows[y * TFU.TI:(y + 1) * TFU.TI] += 1
    for xs in range(gx):
        cols[xs * TFU.TO:(xs + 1) * TFU.TO] += 1
    assert (rows == 1).all() and (cols == 1).all()
    slices = -(-dout // TFU.TO)
    assert gy == -(-din // TFU.TI) and 0 <= gx - slices < plan.cluster
    # the launch may ask for it: portable clusters that tile the grid, and
    # shared memory within Hopper's 227 KB a CTA
    assert plan.cluster in (1, 2, 4, 8) and gx % plan.cluster == 0
    assert plan.smem <= TFU.SMEM_MAX == 232448
    # the chunks' sums: a second pass over [chunks, T, Din] only when the
    # Dout slices need more than one cluster
    assert plan.chunks == -(-slices // plan.cluster)
    assert plan.scratch == (plan.chunks * t * din if plan.chunks > 1 else 0)


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_bp_fused_unit_plan_fills_the_card_at_the_lenet_frame(datapath):
    """The LeNet hidden frame (T 128, 256 x 256) puts at least 64 CTAs on
    the H100's 132 SMs (the first port put 16) in one launch: 8 Dout
    slices summed in one cluster for each 16-row Din tile."""
    plan = TFU._plan(128, 256, 256, 132, datapath)
    assert plan.ctas >= 64 and plan.chunks == 1
    assert (plan.cluster, plan.grid) == (8, (8, 16))
    # a long token loop sums the slices through the scratch instead
    assert TFU._plan(1024, 256, 256, 132, datapath).cluster == 1
    # every power-of-two cluster can be forced; no other size
    for c in (1, 2, 4, 8):
        plan = TFU._plan(128, 256, 256, 132, datapath, cluster=c)
        assert (plan.grid, plan.chunks) == ((8, 16), 8 // c)
    with pytest.raises(ValueError):
        TFU._plan(128, 256, 256, 132, datapath, cluster=3)


# ---------------------------------------------------------------------------
# bp_gstep: the paths and tiles of the CUDA kernel (the kernel runs only on
# the card; chip_smoke.py holds it against its plain version there, on both
# paths and at every row count of the short one)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_bp_gstep_plan_at_the_lenet_and_qwen_shapes(datapath):
    # the LeNet head (Dout 10): the short path, with the most rows a CTA
    # whose CTAs still number a third of the H100's 132 SMs
    assert TGS._plan(128, 256, 10, 132, datapath) == (
        "short", 8, 64, (16, 4), 1, False)
    assert TGS._plan(1024, 256, 10, 132, datapath) == (
        "short", 16, 64, (64, 4), 1, False)
    # the dense engine's dx at qwen1.5-0.5b's MLP (T 2048): 128x128 tiles
    # that fill the card unsplit, 16-byte copies of G and W
    assert TGS._plan(2048, 1024, 2816, 132, datapath) == (
        "tiled", 128, 128, (16, 8), 1, True)
    assert TGS._plan(2048, 2816, 1024, 132, datapath) == (
        "tiled", 128, 128, (16, 22), 1, True)
    # a LeNet hidden layer's dx (T 128, 256 x 256) has 2 tiles: Dout split
    # over a cluster of 8 (f32: 8 tiles of 32) or 4 (int8: 4 tiles of 64);
    # at T 1024 (16 tiles) in 4, and the 2816-wide frame (22 tiles) in 4
    assert TGS._plan(128, 256, 256, 132, datapath).splits == (
        8 if datapath == "emulate" else 4)
    assert TGS._plan(1024, 256, 256, 132, datapath).splits == 4
    assert TGS._plan(128, 2816, 2816, 132, datapath).splits == 4
    # with few SMs the most rows a CTA already fill them; a short T the
    # fewest
    assert TGS._plan(128, 256, 10, 8, datapath).rows == 16
    assert TGS._plan(4, 64, 10, 132, datapath).rows == 4


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
@pytest.mark.parametrize("t,din,dout", [(1, 50, 1), (33, 130, 10),
                                        (1000, 1000, 15), (4100, 130, 40),
                                        (33, 1000, 70), (4100, 50, 16),
                                        (1000, 130, 80), (1, 1000, 1000),
                                        (2048, 2816, 1024), (3, 16, 16)])
def test_bp_gstep_plan_tiles_cover_each_output_once(datapath, t, din, dout):
    """Every output [t, din] lies in exactly one CTA's tile, for the plan's
    own row count and each one the short path can be forced to."""
    plan = TGS._plan(t, din, dout, 132, datapath)
    assert plan.path == ("short" if dout < TGS.SHORT_DOUT else "tiled")
    plans = [plan]
    if plan.path == "short":
        plans += [TGS._plan(t, din, dout, 132, datapath, rows=r)
                  for r in TGS.SHORT_ROWS]
    for p in plans:
        gx, gy = p.grid
        assert p.splits == 1 or p.path == "tiled"
        rows, cols = np.zeros(t, np.int64), np.zeros(din, np.int64)
        for x in range(gx):
            rows[x * p.rows:(x + 1) * p.rows] += 1
        for y in range(gy):
            cols[y * p.cols:(y + 1) * p.cols] += 1
        assert (rows == 1).all() and (cols == 1).all()
        # no CTA lies wholly past the edge
        assert (gx - 1) * p.rows < t and (gy - 1) * p.cols < din
        assert gy <= TGS.MAX_GRID_Y
        if p.path == "tiled":
            assert (p.rows, p.cols) == (TGS.TILE_T, TGS.TILE_DIN)
        else:
            assert p.rows in TGS.SHORT_ROWS and p.cols == TGS.SHORT_COLS


@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_bp_gstep_plan_alignment_class(datapath):
    """16-byte copies of G and W where Dout elements make whole 16-byte
    pieces; the class follows the shape, never the data (the launch adds
    the check of the bases)."""
    esz = 1 if datapath == "int8" else 4
    for dout in (1, 10, 15, 16, 40, 70, 80, 1000, 1024, 2816):
        plan = TGS._plan(64, 256, dout, 132, datapath)
        assert plan.vec == (dout * esz % 16 == 0), dout


def test_bp_gstep_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        TGS._plan(128, 256, 10, 132, "emulate", rows=3)     # short rows
    for bad in (3, 16, 0):                                  # splits
        with pytest.raises(ValueError):
            TGS._plan(128, 256, 256, 132, "emulate", splits=bad)
    with pytest.raises(ValueError):                          # > Dout tiles
        TGS._plan(128, 256, 256, 132, "int8", splits=8)
    with pytest.raises(ValueError):
        TGS._plan(128, 256, 256, 132, "emulate", rows=4)    # tiled rows
    with pytest.raises(ValueError):
        TGS._plan(128, 256, 10, 132, "bf16")
    with pytest.raises(ValueError):                          # grid's y
        TGS._plan(4, 64 * 65536, 10, 132, "int8")
    assert TGS._plan(4, 64 * 65535, 10, 132, "int8").grid[1] == 65535


@pytest.mark.parametrize("n_sm", [132, 8])
@pytest.mark.parametrize("datapath", ["emulate", "int8"])
def test_bp_gstep_splits_cover_dout_once(n_sm, datapath):
    """Every Dout index lies in exactly one split, in order, no split is
    empty, and the split count is a power of two <= 8 (one portable
    cluster) that keeps the CTAs within the SMs where it splits."""
    for t in (1, 128, 1024, 2048):
        for din in (50, 256, 1024, 2816):
            for dout in (16, 40, 80, 256, 1000, 2816):
                plan = TGS._plan(t, din, dout, n_sm, datapath)
                s, tiles = plan.splits, plan.grid[0] * plan.grid[1]
                assert 1 <= s <= TGS.MAX_SPLITS and s & (s - 1) == 0
                assert s == 1 or 3 * tiles * s <= 2 * n_sm
                forced = [TGS._plan(t, din, dout, n_sm, datapath, splits=f)
                          for f in (1, 2, 4, 8)
                          if f <= -(-dout // TGS.TILE_K[datapath])]
                for p in [plan] + forced:
                    ranges = TGS._k_ranges(p, dout, datapath)
                    assert len(ranges) == p.splits
                    assert ranges[0][0] == 0 and ranges[-1][1] == dout
                    for (lo, hi), (nxt, _) in zip(ranges,
                                                  ranges[1:] + [(dout, 0)]):
                        assert lo < hi == nxt
                        assert lo % TGS.TILE_K[datapath] == 0
