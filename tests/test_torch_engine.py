"""Port parity of the TaxoNN layer engine (``repro_torch.core.taxonn`` +
``core.steps``) on the CPU, against the port's own autodiff step and the
JAX package's engine (``repro.core``).

Configs (as ``tests/test_torch_lm.py``): ``tiny`` is
``tests/test_models.py::tiny("dense")`` (2 layers, d 32, 4 heads, 2 KV
heads, vocab 128, f32); ``qwen_tiny`` adds QKV bias, 4 KV heads and bf16
compute (tied embedding, swiglu).  Parameters come from
``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; batches are numpy arrays from a seed.  The port's
kernel wrappers run their plain versions on CPU tensors.

Tolerances, and why:
  * taxonn against autodiff with quantization off (``QuantPolicy.off()``):
    the G-chain is the chain rule, so both take every gradient at the
    step-start weights; they differ in summation order only.  The
    tolerances of ``tests/test_engine.py``: |d| <= 2e-5 + 2e-4|ref|
    (momentum8: 5e-4 + 5e-3|ref|, its int8 buffers round at ties), loss
    rel 1e-5, grad_norm rel 1e-3.
  * the port's taxonn step against JAX's with quantization on
    (``tests/test_torch_engine_jax.py``, apart so that each file stays
    well under a minute on the CPU: one step,
    momentum, ``QuantPolicy(grad_scale=64)``, ``default_bits``):
    - f32 (``tiny``, JAX jitted): f32 sums in other orders,
      |d| <= 2e-6 + 1e-5|ref| (observed <= 4e-7), with the grid-step rule:
      a G element at an (I,F) rounding tie may land one 2^-12 step away,
      which moves the update of the weights it touches by at most
      lr*|x|*2^-12 / grad_scale, so up to 1% of the elements may miss by
      one more lr*2^-12 (strict mode, ``quantize_updates``: the update
      itself is rounded onto the 2^-12 grid, so one more 2^-12); loss rel
      1e-6, grad_norm rel 1e-5.
    - bf16 (``qwen_tiny``, int8, JAX op by op: under jit XLA fuses bf16
      chains and the jitted JAX gradient itself moves up to 7.5% against
      the op-by-op one): every weight matrix to f32 ulps (observed
      bitwise); the QKV biases within 5% of their update's L2 norm
      (observed <= 1.4%: the bias gradient is a bf16 sum over B*T rows,
      reduced in another order); loss rel 1e-6, grad_norm rel 1e-3.
  * the card-vs-CPU tolerance of ``chip_smoke.py``'s ``train_lm`` phase is
    justified here on the CPU (see the test's docstring).
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMDataset as JLMData
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JMC
from repro_torch.core import steps as TS
from repro_torch.core import taxonn as TX
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              init_train_state, make_eval_step,
                              make_train_step)
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels import ops as TO
from repro_torch.models import blocks as TB
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.quant import make_bit_schedule
from repro_torch.util.tree import tree_leaves, tree_map
from repro_torch.util.tree import tree_leaves_with_path as _leaves

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its tolerance constants)

TINY = dict(name="t-dense", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
            compute_dtype="float32")
QWEN_TINY = dict(TINY, name="t-qwen", num_kv_heads=4, qkv_bias=True,
                 compute_dtype="bfloat16")
CFGS = {"tiny": TINY, "qwen_tiny": QWEN_TINY}
GRID = 2.0 ** -12


@functools.lru_cache(maxsize=None)
def _setup(name):
    jc, tc = JMC(**CFGS[name]), ModelConfig(**CFGS[name])
    jp = JLM.init_params(jax.random.key(0), jc)
    return jc, tc, jp, jax.tree.map(np.asarray, jp)


def _tparams(name):
    return TLM.params_from_numpy(_setup(name)[3], device="cpu")


def _batch(seed=0, b=2, t=32, v=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, v, (b, t)).astype(np.int32),
            "labels": rng.integers(0, v, (b, t)).astype(np.int32)}


def _run(step, params, ocfg, batch, bits, steps=1, lr=0.05):
    state = init_train_state(params, ocfg)
    for s in range(steps):
        params, state, m = step(params, state, batch, Hyper(lr=lr, step=s),
                                bits)
    return params, state, m


# ---------------------------------------------------------------------------
# taxonn == autodiff with quantization off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "int8"])
def test_engine_matches_autodiff_sgd(backend):
    _, tc, _, _ = _setup("tiny")
    p0, ocfg = _tparams("tiny"), OptimizerConfig()
    bits = default_bits(tc, enabled=False)
    runs = {}
    for engine in ("taxonn", "autodiff"):
        step = make_train_step(tc, QuantPolicy.off(), ocfg,
                               StepOptions(engine=engine,
                                           kernel_backend=backend),
                               device="cpu")
        runs[engine] = _run(step, p0, ocfg, _batch(), bits)
    (pt, _, mt), (pa, _, ma) = runs["taxonn"], runs["autodiff"]
    for (k, a), (_, b) in zip(_leaves(pt), _leaves(pa)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4, err_msg=k)
    assert float(mt["loss"]) == pytest.approx(float(ma["loss"]), rel=1e-5)
    assert float(mt["grad_norm"]) == pytest.approx(float(ma["grad_norm"]),
                                                   rel=1e-3)


@pytest.mark.parametrize("kind", ["momentum", "adam", "momentum8"])
def test_engine_matches_autodiff_stateful_opt(kind):
    _, tc, _, _ = _setup("tiny")
    tol = (dict(atol=5e-4, rtol=5e-3) if kind == "momentum8"
           else dict(atol=2e-5, rtol=2e-4))
    p0, ocfg = _tparams("tiny"), OptimizerConfig(kind=kind)
    bits = default_bits(tc, enabled=False)
    out = {}
    for engine in ("taxonn", "autodiff"):
        step = make_train_step(tc, QuantPolicy.off(), ocfg,
                               StepOptions(engine=engine), device="cpu")
        out[engine] = _run(step, p0, ocfg, _batch(), bits, steps=3, lr=0.01)
    for (k, a), (_, b) in zip(_leaves(out["taxonn"][0]),
                              _leaves(out["autodiff"][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=k, **tol)
    for (k, a), (_, b) in zip(_leaves(out["taxonn"][1]),
                              _leaves(out["autodiff"][1])):
        if a.dtype == torch.int8:
            assert (a.int() - b.int()).abs().max() <= 1, k
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=k,
                                       **tol)


# ---------------------------------------------------------------------------
# the engine's own properties (mirrors tests/test_engine.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "int8"])
def test_quantized_step_runs_and_descends(backend):
    """Quantization on at paper bitwidths: a learnable copy task (labels =
    tokens) keeps training."""
    tc = ModelConfig(**dict(TINY, num_layers=3))
    params = TLM.init_params(tc, seed=0, device="cpu")
    tok = np.random.default_rng(1).integers(0, 128, (4, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    ocfg = OptimizerConfig(kind="sgd")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0), ocfg,
                           StepOptions(kernel_backend=backend), device="cpu")
    state, bits, losses = init_train_state(params, ocfg), default_bits(tc), []
    for s in range(30):
        params, state, m = step(params, state, batch, Hyper(0.5, s), bits)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses


def test_bits_are_runtime_data():
    """One step object serves every (I,F) schedule and the enabled toggle;
    coarser bits change the result, the same bits repeat it exactly."""
    _, tc, _, _ = _setup("tiny")
    p0, ocfg = _tparams("tiny"), OptimizerConfig()
    step = make_train_step(tc, QuantPolicy(), ocfg, device="cpu")
    n = tc.num_layers
    scheds = [{"blocks": make_bit_schedule(n, weight=(2, 12))},
              {"blocks": make_bit_schedule(n, weight=(1, 4))},
              {"blocks": make_bit_schedule(n, enabled=False)},
              {"blocks": make_bit_schedule(n, weight=(2, 12))}]
    out = [tree_leaves(_run(step, p0, ocfg, _batch(), b)[0])
           for b in scheds]
    assert not torch.allclose(out[0][0], out[1][0])
    assert not torch.allclose(out[0][0], out[2][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0], out[3]))
    # disabled bits: the plain step (quantization off) on the same data
    plain = make_train_step(tc, QuantPolicy.off(), ocfg, device="cpu")
    ref = tree_leaves(_run(plain, p0, ocfg, _batch(), scheds[2])[0])
    assert all(torch.allclose(a, b, atol=1e-6) for a, b in zip(out[2], ref))


def test_gradient_lifetime_is_per_layer(monkeypatch):
    """The paper's memory claim, checked by the order of calls: the forward
    runs every layer without autograd; then, layer by layer in reverse,
    the body is re-run under autograd and that layer's update is applied,
    one leaf at a time, before the next (lower) layer's body starts; the
    boundary updates come last.  No update ever sees a stacked [L, ...]
    gradient, nor more than one leaf of one layer."""
    tc = ModelConfig(**dict(TINY, num_layers=4))
    params = TLM.init_params(tc, seed=0, device="cpu")
    ptr = {int(params["blocks"]["mlp_norm"]["scale"][i].data_ptr()): i
           for i in range(tc.num_layers)}
    events = []
    body, upd = TB.transformer_block, TX.apply_update

    def spy_body(p, x, cfg, positions, causal=True):
        events.append(("body", ptr[p["mlp_norm"]["scale"].data_ptr()],
                       torch.is_grad_enabled()))
        return body(p, x, cfg, positions, causal)

    def spy_update(p, g, s, hyper, cfg):
        shapes = [tuple(t.shape) for t in tree_leaves(g)]
        events.append(("update", shapes))
        return upd(p, g, s, hyper, cfg)
    monkeypatch.setattr(TB, "transformer_block", spy_body)
    monkeypatch.setattr(TX, "apply_update", spy_update)
    ocfg = OptimizerConfig()
    step = make_train_step(tc, QuantPolicy.off(), ocfg, device="cpu")
    step(params, init_train_state(params, ocfg), _batch(), Hyper(0.1, 0),
         default_bits(tc, enabled=False))
    n = tc.num_layers
    assert events[:n] == [("body", i, False) for i in range(n)]
    stacked = {tuple(t.shape) for t in tree_leaves(params["blocks"])}
    leaves = len(tree_leaves(TLM.layer_params(params["blocks"], 0)))
    per_layer = 1 + leaves            # the body, then one update a leaf
    for j, i in enumerate(reversed(range(n))):
        kind, layer, grad_on = events[n + per_layer * j]
        assert (kind, layer, grad_on) == ("body", i, True)
        for kind, shapes in events[n + per_layer * j + 1:
                                   n + per_layer * (j + 1)]:
            assert (kind == "update" and len(shapes) == 1
                    and not set(shapes) & stacked)
    # the boundary updates go through steps
    assert len(events) == n + n * per_layer


def test_kernel_entry_points_per_layer(monkeypatch):
    """Each layer runs 7 dense units (q, k, v, o, gate, up, down): 14
    forward matmuls (the forward and the re-linearisation), 7 dx and 7 dW
    a step -- the counts chip_smoke.py's train_lm phase holds the card's
    kernel launches to (TRAIN_LM_LAUNCHES)."""
    _, tc, _, _ = _setup("qwen_tiny")
    calls = {"dense_fwd": 0, "dense_bwd_dx": 0, "dense_bwd_dw": 0}
    for name in calls:
        orig = getattr(TO, name)

        def wrap(*a, _o=orig, _n=name):
            calls[_n] += 1
            return _o(*a)
        monkeypatch.setattr(TO, name, wrap)
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0), ocfg,
                           StepOptions(kernel_backend="int8"), device="cpu")
    _run(step, _tparams("qwen_tiny"), ocfg, _batch(), default_bits(tc))
    per_layer = {"dense_fwd": CS.TRAIN_LM_LAUNCHES["fxp_matmul"],
                 "dense_bwd_dx": CS.TRAIN_LM_LAUNCHES["bp_gstep"],
                 "dense_bwd_dw": CS.TRAIN_LM_LAUNCHES["sgd_dw_update"]}
    assert calls == {k: v // 24 * tc.num_layers for k, v in per_layer.items()}


def test_engine_unit_rows_match_the_train_lm_shapes(monkeypatch):
    """chip_smoke.py's check_engine_units compares the three training
    kernels at T = TRAIN_LM_BATCH x TRAIN_LM_SEQ through ENGINE_UNITS, with
    bf16 x, f32 dz and each unit's W dtype: the (K, N) and dtypes that
    full-width qwen1.5-0.5b's step hands kops (here one layer, a small
    vocabulary)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(CS.LM_ARCH), num_layers=1,
                              vocab_size=256)
    seen = {"dense_fwd": set(), "dense_bwd_dx": set(), "dense_bwd_dw": set()}
    for name in seen:
        orig = getattr(TO, name)

        def wrap(a, b, backend, _o=orig, _n=name):
            seen[_n].add((a.dtype, b.dtype) + tuple(
                b.shape if _n != "dense_bwd_dw" else (a.shape[1],
                                                      b.shape[1])))
            return _o(a, b, backend)
        monkeypatch.setattr(TO, name, wrap)
    ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
    step = make_train_step(cfg, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE),
                           ocfg, StepOptions(kernel_backend="int8"),
                           device="cpu")
    _run(step, TLM.init_params(cfg, seed=0, device="cpu"), ocfg,
         SyntheticLMDataset(256, 8, 2, seed=0).batch_at(0), default_bits(cfg),
         lr=CS.TRAIN_LM_LR)
    bf16, f32 = torch.bfloat16, torch.float32
    units = [(getattr(torch, wdt), k, n) for _, k, n, wdt in CS.ENGINE_UNITS]
    assert seen["dense_fwd"] == {(bf16, w, k, n) for w, k, n in units}
    assert seen["dense_bwd_dx"] == {(f32, w, k, n) for w, k, n in units}
    assert seen["dense_bwd_dw"] == {(bf16, f32, k, n) for _, k, n in units}


def test_update_sensitivity_justifies_card_tolerance():
    """Why chip_smoke.py's train_lm phase holds the card's one-step update
    to TRAIN_LM_PARITY_TOL (relative L2 of each parameter's update) and the
    loss to TRAIN_LM_LOSS_TOL against the CPU.  On a 2-layer qwen-shaped
    net (d 256, 4 heads of 64, d_ff 704, vocab 2048, bf16, the train_lm
    step's policy, optimizer and lr), on the CPU alone:
      * reversing the order of every ``@`` sum moves the updates by at most
        1.2% (emulate) and 0 (int8: exact integer sums);
      * one f32 ulp added to every master weight moves them by up to 6.2%
        (int8: an activation at an int8 rounding tie flips its payload, and
        every later absmax quantization carries it) and 1.4% (emulate),
        and the loss by 3.2e-4 of itself;
      * the same step with the two layers swapped moves them by > 100%.
    The card differs from the CPU by such ulps (its own sum orders and
    transcendentals), so each backend's limit (int8 0.15, emulate 0.05)
    lies over twice its own largest spread and far below a wrong layer
    order or index (> 1.0)."""
    loss_tol = CS.TRAIN_LM_LOSS_TOL
    assert CS.TRAIN_LM_PARITY_TOL == {"emulate": 0.05, "int8": 0.15}
    cfg = ModelConfig(name="sens", family="dense", num_layers=2, d_model=256,
                      num_heads=4, num_kv_heads=4, d_ff=704, vocab_size=2048,
                      qkv_bias=True, rope_theta=1e6)
    p0 = TLM.init_params(cfg, seed=0, device="cpu")
    batch = SyntheticLMDataset(2048, 64, 2, seed=0).batch_at(0)
    ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
    matmul = torch.Tensor.__matmul__

    def reversed_sums(a, b):
        k = torch.arange(a.shape[-1] - 1, -1, -1)
        return matmul(a[..., k], b[k])

    def rel(new, p_start, ref, ref_start):
        return max(float(((n - s) - (r - rs)).norm() / (r - rs).norm())
                   for (_, n), (_, s), (_, r), (_, rs) in zip(
                       _leaves(new), _leaves(p_start), _leaves(ref),
                       _leaves(ref_start)))

    for backend in ("emulate", "int8"):
        tol = CS.TRAIN_LM_PARITY_TOL[backend]
        step = make_train_step(cfg, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE), ocfg,
                               StepOptions(kernel_backend=backend),
                               device="cpu")

        def one(p):
            return _run(step, p, ocfg, batch, default_bits(cfg),
                        lr=CS.TRAIN_LM_LR)
        ref, _, ref_m = one(p0)
        torch.Tensor.__matmul__ = reversed_sums
        try:
            got, _, got_m = one(p0)
        finally:
            torch.Tensor.__matmul__ = matmul
        spread = rel(got, p0, ref, p0)
        assert spread < tol / 2, (backend, spread)
        if backend == "int8":
            assert spread <= 1e-5, spread
        p1 = tree_map(lambda t: torch.nextafter(t, torch.full_like(
            t, float("inf"))), p0)
        got, _, got_m = one(p1)
        spread = rel(got, p1, ref, p0)
        assert spread < tol / 2, (backend, spread)
        assert abs(float(got_m["loss"]) / float(ref_m["loss"]) - 1) \
            < loss_tol / 4
        swapped = dict(p0, blocks=tree_map(lambda t: t.flip(0), p0["blocks"]))
        got, _, _ = one(swapped)
        got = dict(got, blocks=tree_map(lambda t: t.flip(0), got["blocks"]))
        assert rel(got, p0, ref, p0) > 1.0


# ---------------------------------------------------------------------------
# options, data and the eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy_kw", [
    dict(dw_psum_axes=("data",)), dict(compress_dw=True),
    dict(overlap="on"), dict(dw_transport="ring"),
    dict(bit_anneal="0:16")])
def test_unported_policy_options_raise(policy_kw):
    """The JAX policy's multi-device options are not fields of the port's
    policy yet: asking for one fails at once.  Its anneal is ported
    (``search.anneal``): ``bit_anneal`` is accepted, and the step built from
    the policy applies the ramp to its bits."""
    if "bit_anneal" in policy_kw:
        pol = QuantPolicy(**policy_kw)
        assert pol.bit_anneal == "0:16"
        _, tc, _, _ = _setup("tiny")
        p0, ocfg = _tparams("tiny"), OptimizerConfig(kind="sgd")
        step = make_train_step(tc, pol, ocfg, device="cpu")
        plain = make_train_step(tc, QuantPolicy(), ocfg, device="cpu")
        assert step.bit_anneal.spec == "0:16"
        bits = default_bits(tc)
        got = _run(step, p0, ocfg, _batch(), bits)[0]
        want = _run(plain, p0, ocfg, _batch(),
                    step.bit_anneal.apply_tree(bits, 0))[0]
        unannealed = _run(plain, p0, ocfg, _batch(), bits)[0]
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))
        assert not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got), tree_leaves(unannealed)))
        return
    with pytest.raises(TypeError, match="unexpected keyword"):
        QuantPolicy(**policy_kw)


def test_unported_step_options_raise():
    _, tc, _, _ = _setup("tiny")
    for kw in (dict(pipeline_schedule="gpipe"),
               dict(overlap="on"), dict(transport="ring")):
        with pytest.raises(TypeError, match="unexpected keyword"):
            StepOptions(**kw)
    # the anneal is ported (search.anneal): accepted, normalised, exposed
    opts = StepOptions(bit_anneal="0:16")
    assert opts.bit_anneal.spec == "0:16"
    assert make_train_step(tc, options=opts,
                           device="cpu").bit_anneal is opts.bit_anneal
    with pytest.raises(ValueError):
        StepOptions(engine="sgd")
    with pytest.raises(NotImplementedError, match="ROADMAP A9e"):
        make_train_step(dataclasses.replace(tc, family="encdec"),
                        device="cpu")
    # MLA is ported (ROADMAP A9d): its parameters and a step build
    mla = dataclasses.replace(tc, use_mla=True, kv_lora_rank=16,
                              qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8)
    assert "w_uk" in TLM.init_params(mla, device="cpu")["blocks"]["attn"]
    assert make_train_step(mla, device="cpu").backend == "off"
    step = make_train_step(tc, options=StepOptions(engine="autodiff"),
                           device="cpu")
    assert step.backend == "off" and step.device.type == "cpu"


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 2)])
def test_synthetic_lm_dataset_matches(seed, shards):
    for shard in range(shards):
        t = SyntheticLMDataset(151936, 16, 8, seed=seed, shard_id=shard,
                               num_shards=shards)
        j = JLMData(151936, 16, 8, seed=seed, shard_id=shard,
                    num_shards=shards)
        for s in (0, 1, 7):
            a, b = t.batch_at(s), j.batch_at(s)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


def test_eval_step_matches_loss_fn():
    _, tc, _, _ = _setup("tiny")
    p, batch = _tparams("tiny"), _batch()
    m = make_eval_step(tc)(p, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    loss, _ = TLM.loss_fn(p, tc, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert float(m["loss"]) == float(loss)
    assert TS.num_scan_units(tc) == tc.num_layers
