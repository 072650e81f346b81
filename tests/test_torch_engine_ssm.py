"""Port parity of the TaxoNN layer engine on the ssm and hybrid families
(``core/taxonn.py``'s shared operand, ``core/steps.py``'s Mamba2 and group
bodies) on the CPU, against the port's own autodiff step and the JAX
package's quantizer; the engine against JAX's engine is in
``tests/test_torch_engine_ssm_jax.py``.

Configs: ``tests/test_models.py::tiny("ssm")`` (2 Mamba2 layers, d 32,
f32) and ``tiny("hybrid")`` (4 Mamba2 layers in 2 groups of 2, each group
after one application of the weight-tied shared block).  Parameters come
from ``repro.models.lm.init_params(jax.random.key(0), cfg)`` through
``params_from_numpy``; batches are numpy arrays from a seed.  The port's
kernel wrappers run their plain versions on CPU tensors.

Tolerances, and why:
  * taxonn against autodiff with quantization off: the G-chain is the
    chain rule, so both take every gradient at the step-start weights (the
    shared block's too: its gradient is summed over the groups and applied
    once); they differ in summation order only.  The tolerances of
    ``tests/test_engine.py``: |d| <= 2e-5 + 2e-4|ref|, loss rel 1e-5,
    grad_norm rel 1e-3.
  * quantized leaves: JAX's and the port's ``quantize_weight_tree`` on one
    unit's slice, bitwise (the same round-half-even on the same grid).
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

from repro.core.steps import default_bits as j_bits  # noqa: E402
from repro.core.taxonn import quantize_weight_tree as j_qtree  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (QuantPolicy, StepOptions,  # noqa: E402
                              default_bits, init_train_state,
                              make_train_step)
from repro_torch.core.taxonn import quantize_weight_tree  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import Hyper, OptimizerConfig  # noqa: E402
from repro_torch.util.tree import tree_leaves_with_path as _leaves  # noqa
from repro_torch.util.tree import tree_map  # noqa: E402

sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its launch constants)

FAMILIES = ["ssm", "hybrid"]
ENTRY_POINTS = ("dense_fwd", "dense_bwd_dx", "dense_bwd_dw")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family, **kw):
    jc = tiny(family, **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def _jparams(family, dtype="float32"):
    jc, _ = _cfgs(family, compute_dtype=dtype)
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, jp)


def _tparams(family, dtype="float32"):
    return TLM.params_from_numpy(_jparams(family, dtype), device="cpu")


def _batch(seed=0, b=2, t=32, v=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, v, (b, t)).astype(np.int32),
            "labels": rng.integers(0, v, (b, t)).astype(np.int32)}


def _run(step, params, ocfg, bits, steps=1, lr=0.05):
    state = init_train_state(params, ocfg)
    for s in range(steps):
        params, state, m = step(params, state, _batch(), Hyper(lr=lr, step=s),
                                bits)
    return params, m


def _both_engines(family, backend, ocfg, steps=1, lr=0.05):
    _, tc = _cfgs(family)
    bits = default_bits(tc, enabled=False)
    out = {}
    for engine in ("taxonn", "autodiff"):
        step = make_train_step(tc, QuantPolicy.off(), ocfg,
                               StepOptions(engine=engine,
                                           kernel_backend=backend),
                               device="cpu")
        out[engine] = _run(step, _tparams(family), ocfg, bits, steps, lr)
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
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_autodiff_sgd(family, backend):
    (pt, mt), (pa, ma) = _both_engines(family, backend, OptimizerConfig())
    assert set(pt) == set(pa) == set(_tparams(family))
    _assert_params_close(pt, pa, 2e-5, 2e-4)
    assert float(mt["loss"]) == pytest.approx(float(ma["loss"]), rel=1e-5)
    assert float(mt["grad_norm"]) == pytest.approx(float(ma["grad_norm"]),
                                                   rel=1e-3)


def test_engine_matches_autodiff_momentum_hybrid():
    """Three momentum steps: the shared block keeps its own optimizer
    state, updated once a step from the gradient of all its
    applications."""
    (pt, _), (pa, _) = _both_engines("hybrid", "off",
                                     OptimizerConfig(kind="momentum"),
                                     steps=3, lr=0.01)
    p0 = _tparams("hybrid")
    moved = (pt["shared_attn"]["mlp"]["w_down"]
             - p0["shared_attn"]["mlp"]["w_down"])
    assert float(moved.abs().max()) > 0
    _assert_params_close(pt, pa, 2e-5, 2e-4)


# ---------------------------------------------------------------------------
# the quantized leaves of a unit: JAX's group-level rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,n_changed", [("ssm", 9), ("hybrid", 11)])
def test_quantized_leaves_match_jax(family, n_changed):
    """quantize_weight_tree quantizes every leaf of the unit's slice with
    ndim >= 2.  An ssm unit is one layer, so its vectors (A_log, dt_bias,
    D_skip, conv_b_*, the norms) stay f32; a hybrid unit is a group, whose
    [K, ...] slice makes them 2-D, and A_log and dt_bias change under the
    group's weight format (D_skip, the conv biases and the norms sit on
    the grid already).  The port changes the same leaves as JAX, to the
    same values."""
    jc, tc = _cfgs(family)
    jp, tp = _jparams(family), _tparams(family)
    jb, tb = j_bits(jc)["blocks"], default_bits(tc)["blocks"]
    j_slice = jax.tree.map(lambda a: a[0], jp["blocks"])
    t_slice = tree_map(lambda a: a[0], tp["blocks"])
    jq = j_qtree(j_slice, jb.w_i[0], jb.w_f[0], jb.enabled, True)
    tq = quantize_weight_tree(t_slice, tb.w_i[0], tb.w_f[0], tb.enabled,
                              True)
    changed = {k for (k, q), (_, w) in zip(_leaves(tq), _leaves(t_slice))
               if not torch.equal(q, w)}
    j_changed = {k for (k, q), (_, w) in zip(_leaves(jq), _leaves(j_slice))
                 if not np.array_equal(np.asarray(q), w)}
    assert changed == j_changed and len(changed) == n_changed
    assert (("mamba/A_log" in changed) == (family == "hybrid")
            and ("mamba/dt_bias" in changed) == (family == "hybrid"))
    for (k, q), (_, r) in zip(_leaves(tq), _leaves(jq)):
        assert np.array_equal(q.numpy(), np.asarray(r)), k


# ---------------------------------------------------------------------------
# the kernels a step launches
# ---------------------------------------------------------------------------

def _count_entry_points(monkeypatch, calls=None, shapes=None):
    for name in ENTRY_POINTS:
        orig = getattr(TO, name)

        def wrap(a, b, backend, _o=orig, _n=name):
            if calls is not None:
                calls[_n] += 1
            if shapes is not None:
                shapes[_n].add((a.dtype, b.dtype) + tuple(
                    b.shape if _n != "dense_bwd_dw" else (a.shape[1],
                                                          b.shape[1])))
            return _o(a, b, backend)
        monkeypatch.setattr(TO, name, wrap)


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_entry_points_per_unit(family, monkeypatch):
    """The hybrid's int8 step runs the shared block's 7 dense units in each
    of its G groups: 2*G*7 forward matmuls (the forward and the
    re-linearisation), G*7 dx and G*7 dW -- chip_smoke.py's
    HYBRID_TRAIN_LAUNCHES over its 9 groups; the ssm step none (the
    Mamba2 products are plain PyTorch, as JAX computes them)."""
    _, tc = _cfgs(family)
    calls = dict.fromkeys(ENTRY_POINTS, 0)
    _count_entry_points(monkeypatch, calls=calls)
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0), ocfg,
                           StepOptions(kernel_backend="int8"), device="cpu")
    _run(step, _tparams(family), ocfg, default_bits(tc))
    g = TLM.hybrid_groups(tc)[0] if family == "hybrid" else 0
    groups = TLM.hybrid_groups(get_config(CS.HYBRID_ARCH))[0]
    per_group = {k: v // groups for k, v in CS.HYBRID_TRAIN_LAUNCHES.items()}
    assert per_group["fxp_matmul"] == 2 * 7 and groups == 9
    assert calls == {"dense_fwd": per_group["fxp_matmul"] * g,
                     "dense_bwd_dx": per_group["bp_gstep"] * g,
                     "dense_bwd_dw": per_group["sgd_dw_update"] * g}


def _train_units(cfg):
    """The (W dtype, K, N) of the shared block's dense units: q, k, v (f32
    masters), o (cast to the compute dtype, as JAX's masked wo), gate, up
    and down."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    f32, cdt = torch.float32, TLM.compute_dtype(cfg)
    return {(f32, d, hq), (f32, d, hkv), (cdt, hq, d), (f32, d, f),
            (f32, f, d)}


def test_zamba2_engine_rows_are_the_train_shapes(monkeypatch):
    """chip_smoke.py's ZAMBA2_ENGINE_UNITS, the shapes at which phase 3
    holds the three training kernels to their plain versions, are those
    train_ssm's zamba2-2.7b step hands the dense unit: the tiny bf16
    hybrid's int8 step calls dense_fwd, dense_bwd_dx and dense_bwd_dw at
    exactly ``_train_units`` (bf16 x, f32 dz), and ZAMBA2_ENGINE_UNITS is
    ``_train_units`` of zamba2-2.7b."""
    _, tc = _cfgs("hybrid", compute_dtype="bfloat16")
    shapes = {name: set() for name in ENTRY_POINTS}
    _count_entry_points(monkeypatch, shapes=shapes)
    ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
    step = make_train_step(tc, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE),
                           ocfg, StepOptions(kernel_backend="int8"),
                           device="cpu")
    _run(step, _tparams("hybrid", "bfloat16"), ocfg, default_bits(tc),
         lr=CS.TRAIN_LM_LR)
    bf16, f32 = torch.bfloat16, torch.float32
    units = _train_units(tc)
    assert shapes["dense_fwd"] == {(bf16, w, k, n) for w, k, n in units}
    assert shapes["dense_bwd_dx"] == {(f32, w, k, n) for w, k, n in units}
    assert shapes["dense_bwd_dw"] == {(bf16, f32, k, n)
                                      for _, k, n in units}
    zamba2 = get_config(CS.HYBRID_ARCH)
    assert TLM.compute_dtype(zamba2) == bf16
    assert {(getattr(torch, w), k, n)
            for _, k, n, w in CS.ZAMBA2_ENGINE_UNITS} == _train_units(zamba2)


def test_update_sensitivity_justifies_ssm_card_tolerance():
    """Why chip_smoke.py's train_ssm holds the card's one-step update to
    three limits: SSM_TRAIN_PARITY_TOL on the whole update,
    SSM_TRAIN_LEAF_TOL on each leaf but the Mamba2 vectors A_log and
    dt_bias, and SSM_TRAIN_VECTOR_TOL on those two.  On a one-group hybrid
    of zamba2's shape and a 2-layer ssm of mamba2's (d 128, d_ff 1024,
    vocab 1024, bf16, 2 x 64 tokens, train_lm's policy, optimizer and lr),
    on the CPU alone, one f32 ulp added to every master weight moves:
      * the whole update by 0.040 (int8) and 0.022 (emulate) on the
        hybrid and 0.0023 on the ssm, and every other leaf by at most
        0.055, 0.026 and 0.025: each under half of its limit;
      * the updates of A_log and dt_bias by up to 0.53 of themselves
        (dt_bias), within their limit but beyond every other one: their
        gradients sum over every position and head;
    while the dropped-K controls (the last quarter of the down projection's
    K, or its last tile of 128) move the whole update by 1.17 and 0.91,
    some other leaf by 1.29-1.45 and the vectors by 1.94-2.60."""
    from repro_torch.data import SyntheticLMDataset

    shapes = dict(d_model=128, vocab_size=1024)
    cases = [(dataclasses.replace(get_config(CS.HYBRID_ARCH), num_layers=6,
                                  num_heads=4, num_kv_heads=4, head_dim=32,
                                  d_ff=1024, **shapes), ("int8", "emulate")),
             (dataclasses.replace(get_config(CS.SSM_ARCH), num_layers=2,
                                  **shapes), ("int8",))]
    vectors = []
    for cfg, backends in cases:
        p0 = TLM.init_params(cfg, seed=0, device="cpu")
        nudged = tree_map(lambda x: torch.nextafter(
            x, torch.tensor(float("inf"))), p0)
        batch = SyntheticLMDataset(cfg.vocab_size, CS.SSM_TRAIN_PARITY_SEQ,
                                   CS.SSM_TRAIN_PARITY_BATCH,
                                   seed=0).batch_at(0)
        for backend in backends:
            ocfg = OptimizerConfig(kind=CS.TRAIN_LM_OPTIMIZER)
            step = make_train_step(
                cfg, QuantPolicy(grad_scale=CS.TRAIN_LM_GRAD_SCALE), ocfg,
                StepOptions(kernel_backend=backend), device="cpu")

            def run(p):
                return step(p, init_train_state(p, ocfg), batch,
                            Hyper(lr=CS.TRAIN_LM_LR, step=0),
                            default_bits(cfg))[0]
            ref = run(p0)
            (whole, _), (leaf, _), (vec, _) = CS._update_readings(
                ref, run(nudged), p0)[0]
            tol = CS.SSM_TRAIN_PARITY_TOL[backend]
            leaf_tol = CS.SSM_TRAIN_LEAF_TOL[backend]
            assert 2 * whole <= tol, (cfg.name, backend, whole, tol)
            assert 2 * leaf <= leaf_tol, (cfg.name, backend, leaf, leaf_tol)
            assert vec <= CS.SSM_TRAIN_VECTOR_TOL, (cfg.name, backend, vec)
            vectors.append(vec)
            if cfg.family != "hybrid":
                continue
            seen = []
            for cut in (cfg.d_ff // 4, 128):
                undo = CS._dropped_k(TO, cfg.d_ff, cut)
                try:
                    bad = run(p0)
                finally:
                    undo()
                reads = CS._update_readings(ref, bad, p0)[0]
                assert reads[0][0] > 0.5, (backend, cut, reads)
                assert reads[1][0] > leaf_tol, (backend, cut, reads)
                seen.append(reads[2][0])
            assert max(seen) > CS.SSM_TRAIN_VECTOR_TOL, (backend, seen)
    assert max(vectors) > max(CS.SSM_TRAIN_PARITY_TOL.values())
    assert max(vectors) > max(CS.SSM_TRAIN_LEAF_TOL.values())
