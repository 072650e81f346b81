"""Port parity of the TaxoNN layer engine on the moe family on the CPU: the
taxonn step against the port's own autodiff step, the quantized leaves of
a moe layer against the JAX package's, the load-balance aux's gradient,
the kernels a step and a serve launch, and the train driver on the
reduced mixtral-8x7b; the step against JAX's engine is in
``tests/test_torch_engine_moe_jax.py``.

Configs: ``tests/test_models.py::tiny("moe")`` (2 layers, d 32, 4 experts
of 48, top-2, one shared expert, f32) and, through the driver, the reduced
mixtral-8x7b twin (4 layers, d 128, 4 experts of 64).  Parameters come
from ``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; batches are numpy arrays from a seed.  The port's
kernel wrappers run their plain versions on CPU tensors.

Tolerances, and why:
  * taxonn against autodiff with quantization off: the G-chain is the
    chain rule, the aux seeded with ``AUX_COEF`` in each layer's VJP as
    autograd seeds it through the loss; they differ in summation order
    only.  ``tests/test_engine.py``'s: |d| <= 2e-5 + 2e-4|ref|, loss rel
    1e-5, grad_norm rel 1e-3.
  * quantized leaves: bitwise (the same round-half-even on the same
    grid).
"""
import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_models import tiny  # noqa: E402
from test_torch_engine import ROOT  # noqa: E402
from test_torch_train_driver import parse_losses, run_driver  # noqa: E402

from repro.core.steps import default_bits as j_bits  # noqa: E402
from repro.core.taxonn import quantize_weight_tree as j_qtree  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (QuantPolicy, StepOptions,  # noqa: E402
                              default_bits, init_train_state,
                              make_train_step)
from repro_torch.core import steps as TS  # noqa: E402
from repro_torch.core.taxonn import quantize_weight_tree  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import Hyper, OptimizerConfig  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path as _leaves  # noqa
from repro_torch.util.tree import tree_map  # noqa: E402

sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its launch constants)

LR = 0.05
ENTRY_POINTS = ("dense_fwd", "dense_bwd_dx", "dense_bwd_dw")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jc = tiny("moe", **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def _jparams():
    jc, _ = _cfgs()
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, jp)


def _tparams():
    return TLM.params_from_numpy(_jparams(), device="cpu")


def _batch(seed=0, b=2, t=32, v=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, v, (b, t)).astype(np.int32),
            "labels": rng.integers(0, v, (b, t)).astype(np.int32)}


def _both_engines(backend, ocfg, steps=1, lr=LR):
    _, tc = _cfgs()
    bits = default_bits(tc, enabled=False)
    out = {}
    for engine in ("taxonn", "autodiff"):
        step = make_train_step(tc, QuantPolicy.off(), ocfg,
                               StepOptions(engine=engine,
                                           kernel_backend=backend),
                               device="cpu")
        params, state = _tparams(), init_train_state(_tparams(), ocfg)
        for s in range(steps):
            params, state, m = step(params, state, _batch(),
                                    Hyper(lr=lr, step=s), bits)
        out[engine] = params, m
    return out["taxonn"], out["autodiff"]


def _assert_params_close(got, ref, atol, rtol):
    for (k, a), (kr, b) in zip(_leaves(got), _leaves(ref)):
        assert k == kr
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# taxonn == autodiff with quantization off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "int8"])
def test_engine_matches_autodiff_sgd(backend):
    """One SGD step: every leaf, the router and the experts included,
    within summation order of autograd's, and the same aux."""
    (pt, mt), (pa, ma) = _both_engines(backend, OptimizerConfig())
    assert set(pt) == set(pa) == set(_tparams())
    _assert_params_close(pt, pa, 2e-5, 2e-4)
    assert float(mt["loss"]) == pytest.approx(float(ma["loss"]), rel=1e-5)
    assert float(mt["aux"]) == pytest.approx(float(ma["aux"]), rel=1e-5)
    assert float(mt["grad_norm"]) == pytest.approx(float(ma["grad_norm"]),
                                                   rel=1e-3)


def test_engine_matches_autodiff_momentum():
    (pt, _), (pa, _) = _both_engines("off", OptimizerConfig(kind="momentum"),
                                     steps=3, lr=0.01)
    moved = pt["blocks"]["moe"]["router"] - _tparams()["blocks"]["moe"][
        "router"]
    assert float(moved.abs().max()) > 0
    _assert_params_close(pt, pa, 2e-5, 2e-4)


def test_aux_gradient_reaches_the_router(monkeypatch):
    """The engine seeds each layer's aux with AUX_COEF * grad_scale: with
    the coefficient set to 0 the router's update changes (the aux reaches
    it through the routing probabilities), and the aux itself does not."""
    _, tc = _cfgs()
    ocfg = OptimizerConfig()

    def run():
        step = make_train_step(tc, QuantPolicy.off(), ocfg,
                               StepOptions(kernel_backend="off"),
                               device="cpu")
        p = _tparams()
        return step(p, init_train_state(p, ocfg), _batch(),
                    Hyper(lr=LR, step=0), default_bits(tc, enabled=False))
    with_aux, _, m = run()
    monkeypatch.setattr(TS, "AUX_COEF", 0.0)
    without, _, m0 = run()
    p0 = _tparams()["blocks"]["moe"]["router"]
    d_aux = (with_aux["blocks"]["moe"]["router"] - p0).norm()
    d_ce = (without["blocks"]["moe"]["router"] - p0).norm()
    diff = (with_aux["blocks"]["moe"]["router"]
            - without["blocks"]["moe"]["router"]).norm()
    assert float(diff) > 1e-3 * float(d_ce) and float(d_aux) != float(d_ce)
    assert float(m["aux"]) == float(m0["aux"]) > 0


def test_stochastic_int8_step_is_repeatable():
    """The int8 step with stochastic rounding, twice from the same params
    and key: every new leaf bitwise equal (the dispatch writes no slot
    twice but the trash row, and a token's K picks are summed in a fixed
    order, by expert)."""
    _, tc = _cfgs()
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0, stochastic=True),
                           ocfg, StepOptions(kernel_backend="int8"),
                           device="cpu")
    key = np.asarray(jax.random.key_data(jax.random.key(7)))
    runs = []
    for _ in range(2):
        p = _tparams()
        new, _, m = step(p, init_train_state(p, ocfg), _batch(),
                         Hyper(lr=LR, step=0), default_bits(tc), key)
        runs.append((_leaves(new), float(m["loss"])))
    (a, la), (b, lb) = runs
    assert la == lb
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# the quantized leaves of a moe layer
# ---------------------------------------------------------------------------

def test_quantized_leaves_match_jax():
    """quantize_weight_tree quantizes every leaf of a layer's slice with
    ndim >= 2: the router [D, E], the expert stacks [E, D, F] and
    [E, F, D], the shared expert and the attention; the norm scales stay
    f32.  The port changes the same leaves as JAX, to the same values."""
    jc, tc = _cfgs()
    jp, tp = _jparams(), _tparams()
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
    assert {"moe/router", "moe/w_gate", "moe/w_up", "moe/w_down",
            "moe/shared/w_gate", "attn/wq"} <= changed
    assert not any(k.endswith("norm/scale") for k in changed)
    for (k, q), (_, r) in zip(_leaves(tq), _leaves(jq)):
        assert np.array_equal(q.numpy(), np.asarray(r)), k


# ---------------------------------------------------------------------------
# the kernels a step and a serve launch
# ---------------------------------------------------------------------------

def _count_entry_points(monkeypatch, calls, shapes=None):
    from repro_torch.kernels import decode_prologue as TDP

    for mod, name in [(TO, n) for n in ENTRY_POINTS] + [
            (TDP, "fused_prologue")]:
        orig = getattr(mod, name)

        def wrap(*a, _o=orig, _n=name, **kw):
            calls[_n] += 1
            if shapes is not None and _n == "dense_fwd":
                shapes.add((a[0].dtype, a[1].dtype) + tuple(a[1].shape))
            return _o(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)


def test_kernel_entry_points_per_layer(monkeypatch):
    """The moe layer runs its attention projections (q, k, v, o) on the
    dense unit and its router and experts as plain products, as JAX does:
    an int8 train step launches 8 fxp_matmul (the forward and the
    re-linearisation), 4 bp_gstep and 4 sgd_dw_update a layer; a prefill
    4 fxp_matmul a layer; a decode step one decode_prologue a layer and no
    dense unit (the tail's o-projection is a product) -- chip_smoke.py's
    MOE_TRAIN_LAUNCHES, MOE_PREFILL_LAUNCHES and MOE_DECODE_LAUNCHES over
    their layer counts."""
    _, tc = _cfgs(compute_dtype="bfloat16")
    n = tc.num_layers
    calls = dict.fromkeys(ENTRY_POINTS + ("fused_prologue",), 0)
    shapes = set()
    _count_entry_points(monkeypatch, calls, shapes)
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0), ocfg,
                           StepOptions(kernel_backend="int8"), device="cpu")
    p = _tparams()
    step(p, init_train_state(p, ocfg), _batch(), Hyper(lr=LR, step=0),
         default_bits(tc))
    per = {k: v // CS.MOE_TRAIN_LAYERS
           for k, v in CS.MOE_TRAIN_LAUNCHES.items()}
    assert per["fxp_matmul"] == 8 and per["bp_gstep"] == 4
    assert calls == {"dense_fwd": per["fxp_matmul"] * n,
                     "dense_bwd_dx": per["bp_gstep"] * n,
                     "dense_bwd_dw": per["sgd_dw_update"] * n,
                     "fused_prologue": 0}
    d, hd = tc.d_model, tc.num_heads * tc.head_dim
    assert {s[2:] for s in shapes} == {(d, hd), (hd, d)}
    calls.update(dict.fromkeys(calls, 0))
    toks = torch.from_numpy(_batch()["tokens"][:, :12])
    _, state = TE.prefill(p, tc, {"tokens": toks}, 16, torch.bfloat16,
                          kernel_backend="int8")
    per = {k: v // CS.MOE_SERVE_LAYERS
           for k, v in CS.MOE_PREFILL_LAUNCHES.items()}
    assert calls == {"dense_fwd": per["fxp_matmul"] * n, "dense_bwd_dx": 0,
                     "dense_bwd_dw": 0, "fused_prologue": 0}
    calls.update(dict.fromkeys(calls, 0))
    with TO.kernel_backend_ctx("int8", "cpu"):
        TE.decode_step(p, tc, state, toks[:, :1])
    per = {k: v // CS.MOE_SERVE_LAYERS
           for k, v in CS.MOE_DECODE_LAUNCHES.items()}
    assert per["fxp_matmul"] == 0
    assert calls == {"dense_fwd": 0, "dense_bwd_dx": 0, "dense_bwd_dw": 0,
                     "fused_prologue": per["decode_prologue"] * n}


def test_moe_chip_configs_are_mixtral_cut_in_depth():
    """chip_smoke.py's moe phase runs mixtral-8x7b at its published widths,
    cut only in depth (and, for the serve parity, in its window so that
    the ring wraps)."""
    full = get_config(CS.MOE_ARCH)
    for layers in (CS.MOE_SERVE_LAYERS, CS.MOE_TRAIN_LAYERS, 1):
        cut = CS._moe_cfg(full, layers)
        assert dataclasses.replace(cut, num_layers=32) == full
    cut = CS._moe_cfg(full, 1, window=CS.MOE_PARITY_WINDOW)
    assert cut.swa_window == CS.MOE_PARITY_WINDOW < CS.MOE_PARITY_PROMPT
    assert (full.d_model, full.num_experts, full.experts_per_token,
            full.moe_d_ff, full.num_heads, full.num_kv_heads,
            full.vocab_size) == (4096, 8, 2, 14336, 32, 8, 32000)


def test_update_sensitivity_justifies_moe_card_tolerance():
    """Why chip_smoke.py's moe phase holds the card's one-layer mixtral step
    to MOE_TRAIN_PARITY_TOL (the whole update), MOE_TRAIN_LEAF_TOL (each
    leaf but the router) and MOE_ROUTER_TOL (the router).  On a one-layer
    net of mixtral's shape (8 experts, top-2, 4 query heads a KV head; d
    128, heads of 32, expert d_ff 256, vocab 1024), the phase's batch, the
    policy, optimizer and lr of train_lm, int8, on the CPU alone, one f32
    ulp added to every master moves the whole update by 0.0094, the
    largest other leaf by 0.013 and the router by 0.0028: each under half
    of its limit; the dropped-K control (the last quarter of K where K is
    d_model) moves them by 1.36, 1.43 and 1.69, beyond each."""
    from repro_torch.data import SyntheticLMDataset

    cfg = dataclasses.replace(get_config(CS.MOE_ARCH), num_layers=1,
                              d_model=128, num_heads=4, num_kv_heads=1,
                              head_dim=32, moe_d_ff=256, vocab_size=1024)
    p0 = TLM.init_params(cfg, seed=0, device="cpu")
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.tensor(float("inf"))), p0)
    batch = SyntheticLMDataset(cfg.vocab_size, CS.MOE_TRAIN_PARITY_SEQ,
                               CS.MOE_TRAIN_PARITY_BATCH, seed=0).batch_at(0)
    ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
    step = make_train_step(cfg, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE),
                           ocfg, StepOptions(kernel_backend="int8"),
                           device="cpu")

    def run(p):
        return step(p, init_train_state(p, ocfg), batch,
                    Hyper(lr=CS.TRAIN_LM_LR, step=0), default_bits(cfg))[0]

    ref = run(p0)

    def readings(new):
        whole, rel = CS._update_rel(ref, new, p0)
        router = rel.pop(CS.MOE_ROUTER_LEAF)
        return whole, max(rel.values()), router
    tols = (CS.MOE_TRAIN_PARITY_TOL["int8"], CS.MOE_TRAIN_LEAF_TOL["int8"],
            CS.MOE_ROUTER_TOL["int8"])
    for v, tol in zip(readings(run(nudged)), tols):
        assert 2 * v <= tol, (v, tol)
    undo = CS._dropped_k(TO, cfg.d_model,
                         cfg.d_model // CS.MOE_FAULT_SPLITS)
    try:
        bad = run(p0)
    finally:
        undo()
    for v, tol in zip(readings(bad), tols):
        assert v > tol, (v, tol)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_driver_descends_on_reduced_mixtral():
    """The engine trains the reduced mixtral-8x7b twin through the driver,
    quantized, as ``tests/test_train_driver.py`` trains the dense twin."""
    out = run_driver("--arch", "mixtral-8x7b", "--steps", "100", "--lr",
                     "3e-2", "--quantize", "--log-every", "10")
    assert "(moe) on cpu" in out.stdout
    losses = parse_losses(out.stdout)
    assert len(losses) >= 3
    assert losses[-1] < losses[0] * 0.9, out.stdout[-2000:]
