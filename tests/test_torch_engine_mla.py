"""Port parity of the TaxoNN layer engine on MLA (deepseek-v2-lite's latent
attention, with its top-k moe) on the CPU: the taxonn step against the
port's own autodiff step, the quantized leaves of an MLA layer and one
quantized step against the JAX package's engine, the three kernel
backends giving the same bits, no kernel on the path, the train driver
on the reduced deepseek-v2-lite-16b, and the limits and controls of
``chip_smoke.py``'s mla phase.

Configs: ``tests/test_torch_mla.py::mla_cfgs`` (``tiny("moe",
use_mla=True, ...)``: 2 layers, d 32, 4 heads, latent rank 16, 4 experts
of 48 and one shared, top-2 or top-3, f32), and for the card's limits a
one-layer net of deepseek-v2-lite's shape (64 experts, top-6, 2 shared, 16
heads of nope 32 / rope 16 / v 32) at d 128 (latent rank 64) or d 256
(rank 128).  Parameters of the tiny configs come from
``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; batches are numpy arrays from a seed.

Tolerances, and why:
  * taxonn against autodiff with quantization off: the G-chain is the
    chain rule, the aux seeded in each layer's VJP; they differ in
    summation order only: |d| <= 2e-5 + 2e-4|ref|, loss rel 1e-5,
    grad_norm rel 1e-3 (``tests/test_engine.py``'s).
  * quantized leaves, and the backends against each other: bitwise (the
    same round-half-even on the same grid; no dense unit on this path).
  * one quantized momentum step against JAX's engine, jitted (no kernel
    runs, so XLA's int8 rescale does not enter): f32 sums in other orders,
    |d| <= 2e-6 + 1e-5|ref|, or one more lr*2^-12 on at most 1% of the
    elements (``tests/test_torch_engine.py``'s f32 rule); loss, aux and
    total rel 1e-6, grad_norm rel 1e-5.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_engine import GRID, ROOT  # noqa: E402
from test_torch_engine_jax import _grid_close  # noqa: E402
from test_torch_mla import (MLA_KEYS, _one_thread,  # noqa: E402,F401
                            mla_cfgs, mla_jparams)
from test_torch_train_driver import parse_losses, run_driver  # noqa: E402

from repro.core import QuantPolicy as JQP  # noqa: E402
from repro.core import make_train_step as j_make  # noqa: E402
from repro.core.steps import default_bits as j_bits  # noqa: E402
from repro.core.steps import init_train_state as j_init  # noqa: E402
from repro.core.taxonn import quantize_weight_tree as j_qtree  # noqa: E402
from repro.optim import Hyper as JHyper  # noqa: E402
from repro.optim import OptimizerConfig as JOCfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (QuantPolicy, StepOptions,  # noqa: E402
                              default_bits, init_train_state,
                              make_train_step)
from repro_torch.core.taxonn import quantize_weight_tree  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import decode_prologue as TDP  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import paged_attention as TPA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.optim import Hyper, OptimizerConfig  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path as _leaves  # noqa
from repro_torch.util.tree import tree_map  # noqa: E402

sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the mla phase's constants)

LR = 0.05
# the names through which the port reaches each of the six kernels
KERNEL_CALLS = ((TO, "fxp_matmul"), (TO, "bp_gstep"), (TO, "sgd_dw_update"),
                (TO, "bp_fused_unit"), (TDP, "fused_prologue"),
                (TPA, "paged_attention"))


def _tparams(k="k3"):
    return TLM.params_from_numpy(mla_jparams(k), device="cpu")


def _batch(seed=0, b=2, t=24, v=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, v, (b, t)).astype(np.int32),
            "labels": rng.integers(0, v, (b, t)).astype(np.int32)}


def _step(tc, policy, ocfg, backend, engine="taxonn"):
    return make_train_step(tc, policy, ocfg,
                           StepOptions(engine=engine, kernel_backend=backend),
                           device="cpu")


# ---------------------------------------------------------------------------
# taxonn == autodiff with quantization off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "int8"])
def test_engine_matches_autodiff(backend):
    """One SGD step: every leaf, the six MLA matrices, the latent norm,
    the router and the experts, within summation order of autograd's."""
    _, tc = mla_cfgs("k3")
    ocfg = OptimizerConfig()
    bits = default_bits(tc, enabled=False)
    out = {}
    for engine in ("taxonn", "autodiff"):
        p = _tparams()
        out[engine] = _step(tc, QuantPolicy.off(), ocfg, backend, engine)(
            p, init_train_state(p, ocfg), _batch(), Hyper(lr=LR, step=0),
            bits)
    (pt, _, mt), (pa, _, ma) = out["taxonn"], out["autodiff"]
    for (k, a), (kr, b) in zip(_leaves(pt), _leaves(pa)):
        assert k == kr
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4, err_msg=k)
    p0 = _tparams()["blocks"]["attn"]
    for key in ("wq", "w_dkv", "w_kpe", "w_uk", "w_uv", "wo"):
        assert float((pt["blocks"]["attn"][key] - p0[key]).abs().max()) > 0
    assert float(mt["loss"]) == pytest.approx(float(ma["loss"]), rel=1e-5)
    assert float(mt["aux"]) == pytest.approx(float(ma["aux"]), rel=1e-5)
    assert float(mt["grad_norm"]) == pytest.approx(float(ma["grad_norm"]),
                                                   rel=1e-3)


def test_quantized_leaves_match_jax():
    """``quantize_weight_tree`` on an MLA layer's slice quantizes every
    leaf with ndim >= 2, as JAX's does: the six MLA matrices, the router,
    the expert stacks and the shared expert; the latent norm's scale and
    the block norms stay f32.  The same leaves change, to the same
    values."""
    jc, tc = mla_cfgs("k3")
    jp, tp = mla_jparams(), _tparams()
    jb, tb = j_bits(jc)["blocks"], default_bits(tc)["blocks"]
    j_slice = jax.tree.map(lambda a: a[1], jp["blocks"])
    t_slice = tree_map(lambda a: a[1], tp["blocks"])
    jq = j_qtree(j_slice, jb.w_i[1], jb.w_f[1], jb.enabled, True)
    tq = quantize_weight_tree(t_slice, tb.w_i[1], tb.w_f[1], tb.enabled,
                              True)
    changed = {k for (k, q), (_, w) in zip(_leaves(tq), _leaves(t_slice))
               if not torch.equal(q, w)}
    j_changed = {k for (k, q), (_, w) in zip(_leaves(jq), _leaves(j_slice))
                 if not np.array_equal(np.asarray(q), w)}
    assert changed == j_changed
    mla = {"attn/" + k for k in MLA_KEYS if k != "ckv_norm/scale"}
    assert mla | {"moe/router", "moe/w_gate", "moe/shared/w_up"} <= changed
    assert "attn/ckv_norm/scale" not in changed
    assert not any(k.endswith("norm/scale") for k in changed)
    for (k, q), (_, r) in zip(_leaves(tq), _leaves(jq)):
        assert np.array_equal(q.numpy(), np.asarray(r)), k


@pytest.mark.parametrize("k", ["k2", "k3"])
def test_taxonn_step_matches_jax_quantized(k):
    """One quantized momentum step (``QuantPolicy(grad_scale=64)``,
    default bits) on both engines from JAX's weights: every new leaf
    within the f32 rule; the loss, the aux, the total and the gradient
    norm."""
    jc, tc = mla_cfgs(k)
    jp = jax.tree.map(jnp.asarray, mla_jparams(k))
    batch = _batch()
    jocfg = JOCfg(kind="momentum")
    jstep = jax.jit(j_make(jc, JQP(grad_scale=64.0, kernel_backend="off"),
                           jocfg))
    ref, _, rm = jstep(jp, j_init(jp, jocfg),
                       {key: jnp.asarray(v) for key, v in batch.items()},
                       JHyper(lr=jnp.float32(LR), step=jnp.int32(0)),
                       j_bits(jc))
    ocfg = OptimizerConfig(kind="momentum")
    p0 = _tparams(k)
    new, _, m = _step(tc, QuantPolicy(grad_scale=64.0), ocfg, "off")(
        p0, init_train_state(p0, ocfg), batch, Hyper(lr=LR, step=0),
        default_bits(tc))
    for key, rel in (("loss", 1e-6), ("aux", 1e-6), ("loss_total", 1e-6),
                     ("grad_norm", 1e-5)):
        assert float(m[key]) == pytest.approx(float(rm[key]), rel=rel), key
    ref = [np.asarray(x) for x in jax.tree.leaves(ref)]
    leaves = _leaves(new)
    assert len(leaves) == len(ref)
    for (key, g), r in zip(leaves, ref):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
        assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
            key, np.abs(g - r).max())


# ---------------------------------------------------------------------------
# the backends, and the kernels a step and a serve launch
# ---------------------------------------------------------------------------

def _count_kernel_calls(monkeypatch, calls):
    for mod, name in KERNEL_CALLS:
        orig = getattr(mod, name)

        def wrap(*a, _o=orig, _n=name, **kw):
            calls[_n] += 1
            return _o(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)


def test_backends_compute_the_same_bits_and_call_no_kernel(monkeypatch):
    """An MLA moe model (bf16 compute) runs none of the six kernels: a
    quantized train step under off, emulate and int8 gives the same new
    leaves and loss bit for bit, and so do a prefill and two decode
    steps' logits, with no kernel wrapper called (the fused prologue
    excludes MLA; the MLA, router and expert products are plain)."""
    _, tc = mla_cfgs("k3", "bfloat16")
    calls = dict.fromkeys([n for _, n in KERNEL_CALLS], 0)
    _count_kernel_calls(monkeypatch, calls)
    ocfg = OptimizerConfig(kind="momentum")
    toks = torch.from_numpy(_batch()["tokens"][:, :12])
    runs = {}
    for backend in ("off", "emulate", "int8"):
        p = _tparams()
        new, _, m = _step(tc, QuantPolicy(grad_scale=64.0), ocfg, backend)(
            p, init_train_state(p, ocfg), _batch(), Hyper(lr=LR, step=0),
            default_bits(tc))
        logits, state = TE.prefill(p, tc, {"tokens": toks}, 16,
                                   torch.bfloat16, kernel_backend=backend)
        outs = [logits]
        with TO.kernel_backend_ctx(backend, "cpu"):
            for i in range(2):
                logits, state = TE.decode_step(p, tc, state,
                                               toks[:, i:i + 1])
                outs.append(logits)
        runs[backend] = (_leaves(new), float(m["loss"]), outs)
    assert calls == dict.fromkeys(calls, 0)
    (a, la, oa) = runs["off"]
    for backend in ("emulate", "int8"):
        b, lb, ob = runs[backend]
        assert la == lb, backend
        for (k, x), (_, y) in zip(a, b):
            assert torch.equal(x, y), (backend, k)
        for x, y in zip(oa, ob):
            assert torch.equal(x, y), backend


# ---------------------------------------------------------------------------
# chip_smoke.py's mla phase: its configs, limits and controls
# ---------------------------------------------------------------------------

def test_mla_chip_configs_are_deepseek_cut_in_depth():
    """The mla phase runs deepseek-v2-lite-16b at its published widths, cut
    only in depth, and expects no launch of any of the six kernels."""
    full = get_config(CS.MLA_ARCH)
    for layers in (CS.MLA_SERVE_LAYERS, CS.MLA_TRAIN_LAYERS, 1):
        cut = CS._mla_cfg(full, layers)
        assert dataclasses.replace(cut, num_layers=27) == full
    assert CS.MLA_SERVE_LAYERS == full.num_layers == 27
    assert (full.d_model, full.num_heads, full.kv_lora_rank,
            full.qk_nope_dim, full.qk_rope_dim, full.v_head_dim,
            full.num_experts, full.moe_d_ff, full.experts_per_token,
            full.num_shared_experts, full.vocab_size, full.use_mla) == (
        2048, 16, 512, 128, 64, 128, 64, 1408, 6, 2, 102400, True)
    assert CS.MLA_LAUNCHES == dict.fromkeys(CS.SOURCES, 0)
    per_layer, rest = CS._layer_bytes(full)
    assert 27 * per_layer + rest == 4 * full.param_count()
    assert round(full.param_count() / 1e9, 2) == 16.00
    assert round(per_layer / 4e9, 3) == 0.585


def _narrow(d=128, r=64, vocab=1024):
    """A one-layer net of deepseek-v2-lite's shape (64 experts of 64,
    top-6, 2 shared; 16 heads of nope 32, rope 16, v 32) at d ``d`` and
    latent rank ``r``."""
    return dataclasses.replace(get_config(CS.MLA_ARCH), num_layers=1,
                               d_model=d, kv_lora_rank=r, qk_nope_dim=32,
                               qk_rope_dim=16, v_head_dim=32, moe_d_ff=64,
                               vocab_size=vocab)


def test_update_sensitivity_justifies_mla_card_tolerance():
    """Why the mla phase holds the card's one-layer step to
    MLA_TRAIN_PARITY_TOL (the whole update), MLA_TRAIN_LEAF_TOL (each leaf
    but the router) and MLA_ROUTER_TOL (the router).  On ``_narrow()``,
    the phase's batch, policy, optimizer and lr, int8, on the CPU alone,
    one f32 ulp added to every master moves the whole update by 0.0045,
    the largest other leaf by 0.0085 and the router by 0.0031: each under
    half of its limit; the dropped-latent control moves them by 0.81,
    1.00 and 1.04, beyond each."""
    cfg = _narrow()
    p0 = TLM.init_params(cfg, seed=0, device="cpu")
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.tensor(float("inf"))), p0)
    batch = SyntheticLMDataset(cfg.vocab_size, CS.MLA_TRAIN_PARITY_SEQ,
                               CS.MLA_TRAIN_PARITY_BATCH, seed=0).batch_at(0)
    ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
    step = _step(cfg, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE), ocfg,
                 CS.MLA_BACKEND)

    def run(p):
        return step(p, init_train_state(p, ocfg), batch,
                    Hyper(lr=CS.TRAIN_LM_LR, step=0), default_bits(cfg))[0]

    ref = run(p0)

    def readings(new):
        whole, rel = CS._update_rel(ref, new, p0)
        router = rel.pop(CS.MOE_ROUTER_LEAF)
        return whole, max(rel.values()), router
    tols = (CS.MLA_TRAIN_PARITY_TOL[CS.MLA_BACKEND],
            CS.MLA_TRAIN_LEAF_TOL[CS.MLA_BACKEND],
            CS.MLA_ROUTER_TOL[CS.MLA_BACKEND])
    for v, tol in zip(readings(run(nudged)), tols):
        assert 2 * v <= tol, (v, tol)
    undo = CS._dropped_latent(torch, TL)
    try:
        bad = run(p0)
    finally:
        undo()
    for v, tol in zip(readings(bad), tols):
        assert v > tol, (v, tol)


def test_route_replay_reproduces_the_step_and_sees_the_control():
    """The train parity's replay (``chip_smoke._route_replayer``): one
    step on ``_narrow()`` (the phase's batch, policy, optimizer and lr,
    int8) with its own recorded picks replayed gives the same bits, with
    another step's picks it does not, and the dropped-latent control
    moves the whole update beyond MLA_REPLAYED_TOL."""
    cfg = _narrow()
    p0 = TLM.init_params(cfg, seed=0, device="cpu")
    ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
    step = _step(cfg, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE), ocfg,
                 CS.MLA_BACKEND)

    def run(b=0):
        batch = SyntheticLMDataset(cfg.vocab_size, CS.MLA_TRAIN_PARITY_SEQ,
                                   CS.MLA_TRAIN_PARITY_BATCH,
                                   seed=0).batch_at(b)
        return step(p0, init_train_state(p0, ocfg), batch,
                    Hyper(lr=CS.TRAIN_LM_LR, step=0), default_bits(cfg))[0]

    def replayed(picks):
        undo = CS._route_replayer(torch, TL, picks)
        try:
            return run()
        finally:
            undo()
    seen, undo = CS._route_recorder(TL)
    try:
        ref = run()
        n = len(seen)
        run(1)
    finally:
        undo()
    own, other = seen[:n], seen[n:]
    assert n >= 1 and len(other) == n
    assert any(not torch.equal(a, b) for a, b in zip(own, other))
    for (k, a), (_, b) in zip(_leaves(ref), _leaves(replayed(own))):
        assert torch.equal(a, b), k
    assert CS._update_rel(ref, replayed(other), p0)[0] > 0
    undo = CS._dropped_latent(torch, TL)
    try:
        bad = replayed(own)
    finally:
        undo()
    assert CS._update_rel(ref, bad, p0)[0] > CS.MLA_REPLAYED_TOL


def test_router_ulp_nudge_is_one_ulp_and_the_controls_exceed_the_limit():
    """The serve parity's one-ulp nudge (``chip_smoke._router_ulp_nudged``)
    moves every router weight's bf16 value by exactly one in the last
    place, up and down, and leaves every other leaf as it was.  On
    ``_narrow(256, 128, 4096)`` (bf16, int8 backend, the phase's rows,
    prompt and steps) the nudged run stays within MLA_PARITY_TOL, and the
    card's two controls, the dropped latent and the un-absorbed query,
    move the logits beyond it."""
    cfg = _narrow(256, 128, 4096)
    p0 = TLM.init_params(cfg, seed=3, device="cpu")
    nudged = CS._router_ulp_nudged(torch, p0)
    r0 = p0["blocks"]["moe"]["router"].to(torch.bfloat16)
    r1 = nudged["blocks"]["moe"]["router"]
    assert r1.dtype == torch.float32
    assert torch.equal(r1, r1.to(torch.bfloat16).float())
    step = (r1.to(torch.bfloat16).view(torch.int16).int()
            - r0.view(torch.int16).int())
    assert set(step.unique().tolist()) == {-1, 1}
    for k, v in _leaves(p0):
        if k != CS.MOE_ROUTER_LEAF:
            assert dict(_leaves(nudged))[k] is v, k
    toks = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (CS.MLA_PARITY_SLOTS, CS.MLA_PARITY_PROMPT)
    ).astype(np.int32)

    def side(p, feed=None):
        return CS._moe_parity_side(torch, p, cfg, toks, CS.MLA_BACKEND,
                                   "cpu", feed, CS.MLA_PARITY_STEPS)
    ref = side(p0)
    rel = CS._logit_rel(side(nudged, ref[1])[0], ref[0])
    assert 0 < rel <= CS.MLA_PARITY_TOL, rel
    for install in (CS._dropped_latent_decode, CS._unabsorbed_query):
        undo = install(torch, TL)
        try:
            bad = side(p0, ref[1])
        finally:
            undo()
        assert CS._logit_rel(bad[0], ref[0]) > CS.MLA_PARITY_TOL, install


def test_absorbed_check_holds_the_algebra_and_sees_the_control():
    """``chip_smoke._absorbed_vs_materialised`` on ``_narrow()`` on the
    CPU: in f32 the absorbed decode's logits lie within MLA_ABSORB_TOL of
    the materialised prefill's, and the un-absorbed control beyond it."""
    cfg = _narrow()
    p0 = TLM.init_params(cfg, seed=2, device="cpu")
    toks = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (CS.MLA_PARITY_SLOTS, CS.MLA_PARITY_PROMPT)
    ).astype(np.int32)
    vals, bad = CS._absorbed_vs_materialised(torch, "cpu", p0, cfg, toks,
                                             "float32")
    assert len(vals) == CS.MLA_PARITY_STEPS
    assert max(vals) <= CS.MLA_ABSORB_TOL / 10, vals
    assert bad > CS.MLA_ABSORB_TOL, bad


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_driver_descends_on_reduced_deepseek():
    """The engine trains the reduced deepseek-v2-lite-16b twin (MLA)
    through the driver, quantized."""
    out = run_driver("--arch", "deepseek-v2-lite-16b", "--steps", "60",
                     "--lr", "3e-2", "--quantize", "--log-every", "10")
    assert "deepseek-v2-lite-16b (moe) on cpu" in out.stdout
    losses = parse_losses(out.stdout)
    assert len(losses) >= 3
    assert losses[-1] < losses[0] * 0.95, out.stdout[-2000:]
