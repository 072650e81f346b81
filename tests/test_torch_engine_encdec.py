"""The TaxoNN layer engine on the encdec and vlm families, on the CPU:
the port's taxonn step against its own autodiff step and against JAX's
engine (jitted: backends off and emulate, and the vlm's int8; the
encdec's int8 step, round to nearest and stochastic, against JAX run op
by op is in ``tests/test_torch_engine_encdec_jax.py``), the encoder's
output quantized
once and handed to every decoder unit unquantized, ``enc_norm``'s
gradient, ``util.prng.normal`` against ``jax.random.normal``, the train
driver's modality inputs, the driver's kill-and-resume on the reduced
whisper, bitwise, and the kernels' entry points a layer that
``chip_smoke.py``'s whisper and llava phases count as launches.

Configs: ``tests/test_models.py::tiny("encdec")`` and ``tiny("vlm")``
(f32; see ``tests/test_torch_encdec.py`` and ``tests/test_torch_vlm.py``),
JAX's weights through ``params_from_numpy``, batches of 2 x 16 tokens with
20 frames or 8 patch embeddings from a numpy seed.

Tolerances, and why:
  * taxonn against autodiff with quantization off: the G-chain is the
    chain rule, every gradient at the step-start weights, sums in other
    orders: ``tests/test_engine.py``'s |d| <= 2e-5 + 2e-4|ref|, loss rel
    1e-5, grad_norm rel 1e-3.
  * the port's step against jitted JAX's, quantization on (momentum or
    SGD, ``QuantPolicy(grad_scale=64)``, ``default_bits``, lr 0.05):
    ``tests/test_torch_engine.py``'s f32 rule, |d| <= 2e-6 + 1e-5|ref|, or
    one more lr*2^-12 on at most 1% of the elements; loss rel 1e-6,
    grad_norm rel 1e-5.
  * ``prng.normal`` against ``jax.random.normal`` (f32): the uniform is
    JAX's bit for bit; PyTorch's log1p and sqrt in Giles' erfinv round a
    few values otherwise than XLA's (~5% of the draws): |d| <= 2^-21 *
    max(1, |ref|) (observed 7.2e-7 at |ref| ~ 5, 2.4e-7 below 1); two
    draws of the port bitwise equal.
  * the driver's kill-and-resume: the crc32s of the last checkpoint and
    every logged loss equal the uninterrupted run's.
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
from test_torch_engine import GRID  # noqa: E402
from test_torch_engine_jax import _grid_close  # noqa: E402
from test_torch_encdec import encdec_cfgs, encdec_jparams  # noqa: E402
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)
from test_torch_vlm import vlm_cfgs, vlm_jparams  # noqa: E402

from repro.core import QuantPolicy as JQP  # noqa: E402
from repro.core import make_train_step as j_make  # noqa: E402
from repro.core.steps import default_bits as j_bits  # noqa: E402
from repro.core.steps import init_train_state as j_init  # noqa: E402
from repro.optim import Hyper as JHyper  # noqa: E402
from repro.optim import OptimizerConfig as JOCfg  # noqa: E402
from repro_torch.core import steps as TS  # noqa: E402
from repro_torch.core import taxonn as TX  # noqa: E402
from repro_torch.core import (QuantPolicy, StepOptions,  # noqa: E402
                              default_bits, init_train_state,
                              make_train_step)
from repro_torch.launch.train import modality_inputs  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.optim import Hyper, OptimizerConfig  # noqa: E402
from repro_torch.quant import fixed_point as TFP  # noqa: E402
from repro_torch.util import prng  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path  # noqa: E402

LR = 0.05
NORMAL_ATOL = 2.0 ** -21
CFGS = {"encdec": (encdec_cfgs, encdec_jparams),
        "vlm": (vlm_cfgs, vlm_jparams)}


def _cfgs(family):
    return CFGS[family][0]()


def _jparams(family):
    return CFGS[family][1]()


def _tparams(family):
    return TLM.params_from_numpy(_jparams(family), device="cpu")


def _batch(family, seed=0, b=2, t=16):
    _, tc = _cfgs(family)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, tc.vocab_size, (b, t)).astype(np.int32),
           "labels": rng.integers(0, tc.vocab_size, (b, t)).astype(np.int32)}
    if family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, tc.encoder_seq, tc.d_model)).astype(np.float32)
    else:
        out["patch_embeds"] = rng.standard_normal(
            (b, tc.num_patches, tc.d_model)).astype(np.float32)
    return out


def _leaves(tree):
    return tree_leaves_with_path(tree)


@functools.lru_cache(maxsize=None)
def jax_step(family, backend, optimizer="momentum", stochastic=False,
             jit=True):
    """JAX's new params (numpy leaves) and metrics after one quantized step
    of ``family``'s tiny model (jitted, or op by op with ``jit=False``)."""
    jc, _ = _cfgs(family)
    jp = jax.tree.map(jnp.asarray, _jparams(family))
    ocfg = JOCfg(kind=optimizer)
    step = j_make(jc, JQP(grad_scale=64.0, kernel_backend=backend,
                          stochastic=stochastic), ocfg)
    args = (jp, j_init(jp, ocfg),
            {k: jnp.asarray(v) for k, v in _batch(family).items()},
            JHyper(lr=jnp.float32(LR), step=jnp.int32(0)), j_bits(jc),
            *([jax.random.key_data(jax.random.key(7))] if stochastic
              else []))
    if jit:
        new, _, m = jax.jit(step)(*args)
    else:
        with jax.disable_jit():
            new, _, m = step(*args)
    return ([np.asarray(x) for x in jax.tree.leaves(new)],
            {k: float(v) for k, v in m.items()})


def port_step(family, backend, optimizer="momentum", stochastic=False):
    """The port's new params and metrics after the same step."""
    _, tc = _cfgs(family)
    p0 = _tparams(family)
    ocfg = OptimizerConfig(kind=optimizer)
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0,
                                           stochastic=stochastic), ocfg,
                           StepOptions(kernel_backend=backend), device="cpu")
    key = np.asarray(jax.random.key_data(jax.random.key(7)))
    new, _, m = step(p0, init_train_state(p0, ocfg), _batch(family),
                     Hyper(lr=LR, step=0), default_bits(tc),
                     key if stochastic else None)
    return new, m, p0


@pytest.mark.parametrize("family", ["encdec", "vlm"])
@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_taxonn_matches_autodiff_quantization_off(family, optimizer):
    """With quantization off the engine's split SGD is the chain rule: the
    same update as the port's autodiff step, encoder, ``enc_norm`` and
    ``mm_proj`` included."""
    _, tc = _cfgs(family)
    p0 = _tparams(family)
    ocfg = OptimizerConfig(kind=optimizer)
    out = {}
    for engine in ("taxonn", "autodiff"):
        step = make_train_step(tc, QuantPolicy.off(), ocfg,
                               StepOptions(engine=engine), device="cpu")
        out[engine] = step(p0, init_train_state(p0, ocfg), _batch(family),
                           Hyper(lr=LR, step=0), default_bits(tc))
    (new, _, m), (ref, _, rm) = out["taxonn"], out["autodiff"]
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-3)
    names = set()
    for (k, g), (_, r), (_, w) in zip(_leaves(new), _leaves(ref),
                                      _leaves(p0)):
        names.add(k)
        assert not torch.equal(r, w), k           # every leaf trained
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5,
                                   rtol=2e-4, err_msg=k)
    assert ({"enc_norm/scale", "enc_blocks/attn/wq"} <= names
            if family == "encdec" else "mm_proj" in names)


@pytest.mark.parametrize("family,backend,optimizer", [
    ("encdec", "off", "sgd"), ("encdec", "off", "momentum"),
    ("encdec", "emulate", "momentum"),
    ("vlm", "off", "sgd"), ("vlm", "off", "momentum"),
    ("vlm", "emulate", "momentum"), ("vlm", "int8", "momentum")])
def test_taxonn_step_matches_jax(family, backend, optimizer):
    """``make_train_step`` against JAX's (the encdec and vlm cases of
    ``tests/test_engine.py::test_engine_matches_autodiff_sgd``'s step),
    quantization on, jitted JAX: every leaf within the f32 rule."""
    ref, ref_m = jax_step(family, backend, optimizer)
    new, m, _ = port_step(family, backend, optimizer)
    assert float(m["loss"]) == pytest.approx(ref_m["loss"], rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(ref_m["grad_norm"],
                                                  rel=1e-5)
    assert float(m["tokens"]) == ref_m["tokens"] == 32
    leaves = _leaves(new)
    assert len(leaves) == len(ref)
    for (k, g), r in zip(leaves, ref):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
            k, np.abs(g - r).max())


def test_default_bits_has_the_encoder_stack():
    jc, tc = _cfgs("encdec")
    got, ref = default_bits(tc), j_bits(jc)
    assert set(got) == set(ref) == {"blocks", "enc_blocks"}
    for k in ref:
        for f in ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f"):
            np.testing.assert_array_equal(getattr(got[k], f).numpy(),
                                          np.asarray(getattr(ref[k], f)))
    assert set(default_bits(_cfgs("vlm")[1])) == {"blocks"}


def test_enc_out_quantized_once(monkeypatch):
    """The encoder's output is quantized once, in the last encoder unit's
    activation format, before the decoder stack: no decoder unit quantizes
    it again (``_quantize_shared`` never sees it), every decoder unit
    (forward and re-linearisation) receives the same tensor, and that
    tensor lies on the (a_i, a_f) grid of ``bits["enc_blocks"]``'s last
    unit."""
    _, tc = _cfgs("encdec")
    seen, calls = [], []
    real_body = TS._make_body

    def recording_body(cfg, positions):
        body = real_body(cfg, positions)

        def wrapped(p, x, b_l, *shared):
            seen.append(shared[0])
            return body(p, x, b_l, *shared)
        return wrapped
    monkeypatch.setattr(TS, "_make_body", recording_body)
    real_q = TX._quantize_shared

    def counting(shared, *a):
        calls.extend(shared)          # the encoder's stack shares nothing
        return real_q(shared, *a)
    monkeypatch.setattr(TX, "_quantize_shared", counting)
    p0 = _tparams("encdec")
    ocfg = OptimizerConfig(kind="sgd")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0), ocfg,
                           device="cpu")
    bits = default_bits(tc)
    step(p0, init_train_state(p0, ocfg), _batch("encdec"),
         Hyper(lr=LR, step=0), bits)
    assert not calls
    assert len(seen) == 2 * tc.num_layers
    # the same storage (the backward hands a detached view to autograd)
    assert all(s.data_ptr() == seen[0].data_ptr() for s in seen)
    a_i = int(bits["enc_blocks"].a_i[-1])
    a_f = int(bits["enc_blocks"].a_f[-1])
    enc = seen[0].detach()
    torch.testing.assert_close(
        enc, TFP.quantize_ste(enc, a_i, a_f), rtol=0, atol=0)
    # not the raw output: quantization moved it
    raw = TLM.encode(p0, tc, torch.from_numpy(_batch("encdec")["frames"]))
    assert not torch.equal(enc, raw)


def test_enc_norm_gradient():
    """``enc_norm`` is a boundary leaf whose gradient comes only through
    the decoder's dS: with quantization off it equals autograd's, with
    quantization on JAX's (jitted, off backend), and it moves."""
    new, _, p0 = port_step("encdec", "off")
    ref, _ = jax_step("encdec", "off")
    names = [k for k, _ in _leaves(new)]
    for k in ("enc_norm/bias", "enc_norm/scale"):
        g = dict(_leaves(new))[k]
        r = ref[names.index(k)]
        assert not torch.equal(g, dict(_leaves(p0))[k]), k
        assert _grid_close(g.numpy(), r, 2e-6, 1e-5, LR * GRID), k


@pytest.mark.parametrize("seed,fold,shape", [
    (2, 3, (4, 1500, 384)), (3, 0, (2, 576, 64)), (2, 7, (1000,)),
    (0, 2 ** 32 - 1, (5, 7))])
def test_prng_normal_matches_jax(seed, fold, shape):
    key = prng.fold_in(prng.key(seed), fold)
    got = prng.normal(key, shape)
    ref = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed), fold), shape, jnp.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    g = got.numpy()
    assert np.all(np.abs(g - ref) <= NORMAL_ATOL * np.maximum(1.0,
                                                              np.abs(ref)))
    assert torch.equal(got.view(torch.int32),
                       prng.normal(key, shape).view(torch.int32))
    assert np.isfinite(g).all()


def test_erf_inv_edges():
    """Giles' erfinv as XLA computes it at the edges: +-inf at +-1, 0 at
    0, and against ``jax.lax.erf_inv`` on a grid of [-1, 1]."""
    x = np.concatenate([np.linspace(-1, 1, 2001, dtype=np.float32),
                        np.float32([np.nextafter(np.float32(-1), 0),
                                    np.nextafter(np.float32(1), 0)])])
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert got[0] == -np.inf and got[2000] == np.inf and got[1000] == 0
    fin = np.isfinite(ref)
    assert np.all(np.abs(got[fin] - ref[fin])
                  <= NORMAL_ATOL * np.maximum(1.0, np.abs(ref[fin])))


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_driver_modality_inputs_match_jax(family):
    """The JAX driver draws frames from ``fold_in(key(2), step)`` and patch
    embeddings from ``fold_in(key(3), step)``; the port's driver and sweep
    draw the same (``launch.train.modality_inputs``)."""
    _, tc = _cfgs(family)
    got = modality_inputs(tc, 3, 5, "cpu")
    name, seed, width = (("frames", 2, tc.encoder_seq) if family == "encdec"
                         else ("patch_embeds", 3, tc.num_patches))
    assert set(got) == {name}
    ref = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed), 5),
        (3, width, tc.d_model), jnp.float32))
    assert got[name].shape == (3, width, tc.d_model)
    assert np.all(np.abs(got[name].numpy() - ref)
                  <= NORMAL_ATOL * np.maximum(1.0, np.abs(ref)))
    assert modality_inputs(dataclasses.replace(tc, family="dense"), 3, 5,
                           "cpu") == {}


def test_driver_kill_resumes_bitwise_whisper(tmp_path):
    """The reduced whisper through the driver (int8, stochastic rounding):
    killed at a seeded step, resumed from its checkpoint, the last
    checkpoint's crc32s (encoder, decoder, enc_norm and their momentum)
    and every logged loss equal the uninterrupted run's; the frames are
    drawn a step, so the resumed run replays them."""
    from test_torch_train_drills import _kill_and_resume

    _kill_and_resume(tmp_path, "int8", "--stochastic", "--arch",
                     "whisper-tiny")


def _count_entry_points(monkeypatch):
    """Count the calls of each kernel's entry point (the plain versions on
    the CPU; on the card each call is one launch)."""
    from repro_torch.kernels import decode_prologue as TDP
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import paged_attention as TPA

    calls = {}
    for mod, name in ((TO, "dense_fwd"), (TO, "dense_bwd_dx"),
                      (TO, "dense_bwd_dw"), (TDP, "fused_prologue"),
                      (TPA, "paged_attention")):
        orig = getattr(mod, name)
        calls[name] = 0

        def wrap(*a, _o=orig, _n=name, **kw):
            calls[_n] += 1
            return _o(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    return calls


def _launches(counts):
    """chip_smoke's launch dict in entry-point names."""
    return {"dense_fwd": counts["fxp_matmul"],
            "dense_bwd_dx": counts["bp_gstep"],
            "dense_bwd_dw": counts["sgd_dw_update"],
            "fused_prologue": counts["decode_prologue"],
            "paged_attention": counts["paged_attention"]}


def _per_layer(counts, layers):
    assert all(v % layers == 0 for v in counts.values()), counts
    return {k: v // layers for k, v in counts.items()}


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_launches_match_chip_smoke(monkeypatch, family):
    """The launches ``chip_smoke.py``'s whisper and llava phases hold the
    card to, a layer at a time: an int8 prefill, a decode step (contiguous;
    the vlm's paged step and prefill chunk too) and a train step of the
    tiny model call each kernel's entry point as often a layer as the
    full-width counts say (whisper: 6 units an encoder and a decoder layer
    in the prefill, 5 a decoder layer in a decode step, no prologue; llava:
    7 a layer in the prefill, 3 and the prologue a decode step, the paged
    attention too in paged mode, none in a paged prefill chunk)."""
    import pathlib

    from repro_torch.kernels import ops as TO
    from repro_torch.serving import engine as TE

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as CS

    _, tc = _cfgs(family)
    p = _tparams(family)
    batch = {k: torch.from_numpy(v) for k, v in _batch(family).items()}
    calls = _count_entry_points(monkeypatch)

    def take():
        out = dict(calls)
        for k in calls:
            calls[k] = 0
        return out
    extra = tc.num_patches if family == "vlm" else 0
    _, state = TE.prefill(p, tc, batch, 16 + extra + 2, torch.bfloat16,
                          kernel_backend="int8")
    pre = take()
    with TO.kernel_backend_ctx("int8", "cpu"):
        TE.decode_step(p, tc, state, batch["tokens"][:, :1])
    dec = take()
    ocfg = OptimizerConfig(kind="sgd")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0), ocfg,
                           StepOptions(kernel_backend="int8"), device="cpu")
    step(p, init_train_state(p, ocfg), _batch(family), Hyper(lr=LR, step=0),
         default_bits(tc))
    train = take()
    if family == "encdec":
        from repro_torch.configs import get_config

        card = get_config(CS.WHISPER_ARCH)
        layers = tc.num_layers + tc.num_encoder_layers
        full = card.num_layers + card.num_encoder_layers
        assert _per_layer(pre, layers) == _per_layer(
            _launches(CS.WHISPER_PREFILL_LAUNCHES), full)
        assert _per_layer(dec, tc.num_layers) == _per_layer(
            _launches(CS.WHISPER_DECODE_LAUNCHES), card.num_layers)
        assert _per_layer(train, layers) == _per_layer(
            _launches(CS.WHISPER_TRAIN_LAUNCHES), full)
        return
    assert _per_layer(pre, tc.num_layers) == _per_layer(
        _launches(CS.LLAVA_PREFILL_LAUNCHES), CS.LLAVA_SERVE_LAYERS)
    assert _per_layer(dec, tc.num_layers) == _per_layer(
        _launches(CS.LLAVA_DECODE_LAUNCHES), CS.LLAVA_SERVE_LAYERS)
    assert _per_layer(train, tc.num_layers) == _per_layer(
        _launches(CS.LLAVA_TRAIN_LAUNCHES), CS.LLAVA_TRAIN_LAYERS)
    # the paged text path: a prefill chunk unfused under no backend, a
    # decode step with the prologue and the paged attention kernel
    pool = TE.init_paged_state(tc, 9, 4, torch.int8, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    TE.paged_prefill_chunk(p, tc, pool, table, batch["tokens"][:1, :8], 0)
    assert take() == {k: 0 for k in calls}
    with TO.kernel_backend_ctx("int8", "cpu"):
        TE.paged_decode_step(p, tc, pool, table, torch.tensor([8]),
                             batch["tokens"][:1, 8:9], "kernel")
    assert _per_layer(take(), tc.num_layers) == _per_layer(
        _launches(CS.LLAVA_PAGED_DECODE_LAUNCHES), CS.LLAVA_SERVE_LAYERS)
