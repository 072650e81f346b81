"""The engine's stage-sharded pipeline path (``StepOptions.pipeline_*``,
``core.steps._pipeline_stack_forward``, ``grad_tap``,
``grad_tap_stochastic``) against the port's engine step and the JAX
package's pipeline step, on one rank.

JAX's conformance contract (``tests/test_pipeline_conformance.py``), held
on the port itself: for every family and each of JAX's five quantization
legs (S = M = 4, lr 2e-3, ``kernel_backend="off"``), the pipeline step's
loss is bitwise the engine step's, every updated parameter within 2e-6 and
the grad norm within JAX's bound; gpipe, 1f1b and interleaved (v = 2) are
bitwise each other (one execution order serves every schedule).  On this
host every CPU product of these cells gives the same bits for a microbatch
of rows as for the full batch, so no loss needs a looser rule.

Against JAX's jitted pipeline step (one JAX subprocess for every
reference): dense under all five legs, the other five families with
quantization off and on: the params within the per-family engine parity
tests' rule (``test_torch_engine_jax._grid_close(.., 2e-6, 1e-5, LR *
GRID)``), the loss within 1e-5 relative and the grad norm within JAX's
own pipeline-against-engine bound (``LOSS_REL``: at these cells the port's
engine step is as far from JAX's engine step).  Also: the step metrics
(JAX's ``test_train_step_threads_pipeline_metrics`` values), the build-time
errors with JAX's texts, ``pipeline_exec_capabilities`` equal to JAX's,
and the grad taps' cotangents bitwise JAX's, the stochastic one at a
microbatch offset equal to the full batch's rows.
"""
import concurrent.futures
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantPolicy as JQP
from repro.core.steps import pipeline_exec_capabilities as j_caps
from repro.core.taxonn import grad_tap as j_tap
from repro.core.taxonn import grad_tap_stochastic as j_tap_stoch
from repro.models import lm as JLM
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              grad_tap, grad_tap_stochastic,
                              init_train_state, make_train_step,
                              pipeline_exec_capabilities)
from repro_torch.dist import get_schedule
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.util.tree import tree_leaves
from test_models import make_batch, tiny
from test_torch_collectives import run_jax
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)
from test_torch_engine import GRID
from test_torch_engine_jax import _grid_close

FAMILIES = ("dense", "ssm", "vlm", "hybrid", "encdec", "moe")
SCHEDULES = (("gpipe", None), ("1f1b", None), ("interleaved", 2))
# leg name -> (QuantPolicy kwargs, needs rng): JAX's QUANT_LEGS
QUANT_LEGS = {
    "off": (dict(quantize_weights=False, quantize_acts=False,
                 quantize_grads=False), False),
    "on": (dict(grad_scale=16.0), False),
    "stochastic": (dict(grad_scale=16.0, stochastic=True), True),
    "quant_updates": (dict(grad_scale=16.0, quantize_updates=True), False),
    "compress_dw": (dict(grad_scale=16.0, compress_dw=True), False),
}
S_PIPE, M_PIPE = 4, 4
LR = 2e-3
PARAM_TOL = 2e-6
# against jitted JAX at these cells (S = M = 4, b 8 x t 16, grad_scale 16):
# the port's ENGINE step already sits up to 3.3e-6 relative from JAX's
# engine step in the loss and 6.0e-5 in the grad norm where the G-chain is
# quantized (vlm and encdec "on"; f32 reassociation moves (I,F) ties), and
# JAX's pipeline step sits up to 7.1e-7 and 1.6e-4 from JAX's own engine
# step on this host.  So the loss is held to 1e-5 relative and the grad
# norm to JAX's conformance bound between its pipeline and its engine,
# max(1e-3, 1e-3 * |g|); the params keep the engine tests' rule.
LOSS_REL = 1e-5
# the JAX references: dense under every leg, the other families off and on
JAX_CELLS = tuple([("dense", leg) for leg in sorted(QUANT_LEGS)]
                  + [(f, leg) for f in FAMILIES[1:] for leg in ("off", "on")])


def _cfg(family):
    """JAX's tiny per-family config with exactly S_PIPE engine units."""
    if family == "hybrid":
        return tiny("hybrid", num_layers=2 * S_PIPE, attn_every=2)
    return tiny(family, num_layers=S_PIPE)


@functools.lru_cache(maxsize=None)
def _inputs(family):
    """The port's config, JAX's initial params (numpy) and a batch."""
    jc = _cfg(family)
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(0), jc))
    batch = {k: np.array(v) for k, v in make_batch(jc, b=8, t=16).items()}
    return ModelConfig(**dataclasses.asdict(jc)), jp, batch


def _step(family, leg, sched=None):
    """One port step from JAX's params: the engine's, or the pipeline's
    under ``sched`` ((name, num_virtual))."""
    tc, jp, batch = _inputs(family)
    kw, needs_rng = QUANT_LEGS[leg]
    pol = QuantPolicy(**kw, kernel_backend="off")
    ocfg = OptimizerConfig(kind="sgd")
    opts = StepOptions()
    if sched is not None:
        opts = StepOptions(pipeline_schedule=get_schedule(*sched),
                           pipeline_stages=S_PIPE, num_microbatches=M_PIPE)
    p0 = TLM.params_from_numpy(jp, device="cpu")
    rng = (np.asarray(jax.random.key_data(jax.random.key(3)))
           if needs_rng else None)
    step = make_train_step(tc, pol, ocfg, opts, device="cpu")
    return step(p0, init_train_state(p0, ocfg), batch, Hyper(lr=LR, step=0),
                default_bits(tc, enabled=pol.quantize_weights), rng)


@functools.lru_cache(maxsize=None)
def _pipe_1f1b(family, leg):
    return _step(family, leg, ("1f1b", None))


def _bitwise(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("leg", sorted(QUANT_LEGS))
@pytest.mark.parametrize("family", FAMILIES)
def test_pipeline_step_conforms_to_the_engine_step(family, leg):
    ref_p, _, ref_m = _step(family, leg)
    runs = [_pipe_1f1b(family, leg) if s == ("1f1b", None)
            else _step(family, leg, s) for s in SCHEDULES]
    for (name, _), (p, s, m) in zip(SCHEDULES, runs):
        assert _bitwise(m["loss"], ref_m["loss"]), (family, leg, name)
        worst = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(p), tree_leaves(ref_p)))
        assert worst < PARAM_TOL, (family, leg, name, worst)
        gn, ref_gn = float(m["grad_norm"]), float(ref_m["grad_norm"])
        assert abs(gn - ref_gn) <= max(1e-3, 1e-3 * ref_gn)
    # one execution order: the schedules are bitwise each other
    p0, s0, m0 = runs[0]
    for p, s, m in runs[1:]:
        assert all(_bitwise(a, b) for a, b in zip(
            tree_leaves((p, s, m["loss"], m["grad_norm"])),
            tree_leaves((p0, s0, m0["loss"], m0["grad_norm"]))))


# ---------------------------------------------------------------------------
# against JAX's jitted pipeline step
# ---------------------------------------------------------------------------

JAX_CODE = """
import jax, jax.numpy as jnp, numpy as np
from repro.core import QuantPolicy, StepOptions, make_train_step
from repro.core.steps import default_bits, init_train_state
from repro.models import lm
from repro.optim import Hyper, OptimizerConfig
from test_models import make_batch, tiny
out = {}
for fam, leg in CELLS:
    cfg = _cfg(fam)
    kw, needs_rng = QUANT_LEGS[leg]
    pol = QuantPolicy(**kw, kernel_backend="off")
    params = lm.init_params(jax.random.key(0), cfg)
    ocfg = OptimizerConfig(kind="sgd")
    step = jax.jit(make_train_step(cfg, pol, ocfg, StepOptions(
        pipeline_schedule="1f1b", pipeline_stages=S_PIPE,
        num_microbatches=M_PIPE)))
    p, _, m = step(params, init_train_state(params, ocfg),
                   make_batch(cfg, b=8, t=16),
                   Hyper(lr=jnp.float32(LR), step=jnp.int32(0)),
                   default_bits(cfg, enabled=pol.quantize_weights),
                   jax.random.key(3) if needs_rng else None)
    tag = f"{fam}_{leg}_"
    out[tag + "loss"] = np.asarray(m["loss"])
    out[tag + "gnorm"] = np.asarray(m["grad_norm"])
    for k in ("pipe_bubble", "pipe_ticks", "pipe_peak_mb"):
        out[tag + k] = np.asarray(m[k])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{tag}p{i}"] = np.asarray(x)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_run(tmp_path_factory):
    """JAX's pipeline steps in one subprocess, started with the module's
    first test so that it runs beside the port's steps."""
    head = (f"CELLS = {JAX_CELLS!r}\nQUANT_LEGS = {QUANT_LEGS!r}\n"
            f"S_PIPE, M_PIPE, LR = {S_PIPE}, {M_PIPE}, {LR!r}\n"
            "from test_models import tiny\n" + inspect.getsource(_cfg))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_jax, head + JAX_CODE,
                        tmp_path_factory.mktemp("pipeline_jax"), 1)


@pytest.fixture(scope="module")
def jax_refs(_jax_run):
    return _jax_run.result()


@pytest.mark.parametrize("family,leg", JAX_CELLS)
def test_pipeline_step_matches_jax(jax_refs, family, leg):
    p, _, m = _pipe_1f1b(family, leg)
    tag = f"{family}_{leg}_"
    assert float(m["loss"]) == pytest.approx(float(jax_refs[tag + "loss"]),
                                             rel=LOSS_REL)
    ref_gn = float(jax_refs[tag + "gnorm"])
    assert abs(float(m["grad_norm"]) - ref_gn) <= max(1e-3, 1e-3 * ref_gn)
    for k in ("pipe_bubble", "pipe_ticks", "pipe_peak_mb"):
        assert float(m[k]) == float(jax_refs[tag + k]), k
    leaves = tree_leaves(p)
    assert len(leaves) == sum(k.startswith(tag + "p")
                              and k[len(tag) + 1:].isdigit() for k in jax_refs)
    for i, g in enumerate(leaves):
        r = jax_refs[f"{tag}p{i}"]
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, i
        assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
            family, leg, i, np.abs(g - r).max())


# ---------------------------------------------------------------------------
# metrics, build-time errors, capabilities
# ---------------------------------------------------------------------------

def test_train_step_threads_pipeline_metrics():
    """JAX's values: 1f1b at S 4, M 8 is 3/15 idle over 15 ticks, 7
    microbatches in flight at the peak; both engines report them."""
    jc = tiny("dense", num_layers=4)
    tc = ModelConfig(**dataclasses.asdict(jc))
    p0 = TLM.init_params(tc, device="cpu")
    batch = {k: np.array(v) for k, v in make_batch(jc, b=8, t=32).items()}
    ocfg = OptimizerConfig()
    for engine in ("taxonn", "autodiff"):
        step = make_train_step(tc, QuantPolicy.off(), ocfg, StepOptions(
            engine=engine, pipeline_schedule="1f1b", pipeline_stages=4,
            num_microbatches=8), device="cpu")
        assert step.pipeline_schedule.name == "1f1b"
        _, _, m = step(p0, init_train_state(p0, ocfg), batch,
                       Hyper(lr=0.01, step=0), default_bits(tc, False))
        assert float(m["pipe_bubble"]) == pytest.approx(3 / 15)
        assert int(m["pipe_ticks"]) == 8 + 2 * 4 - 1
        assert int(m["pipe_peak_mb"]) == 7
        assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="divis"):
        make_train_step(tc, QuantPolicy.off(), ocfg, StepOptions(
            pipeline_schedule=get_schedule("interleaved", num_virtual=2),
            pipeline_stages=5, num_microbatches=8), device="cpu")
    # the batch must divide into the microbatches (JAX's text)
    step = make_train_step(tc, QuantPolicy.off(), ocfg, StepOptions(
        pipeline_schedule="gpipe", pipeline_stages=2, num_microbatches=3),
        device="cpu")
    with pytest.raises(ValueError, match="global batch 8 does not divide "
                                         "into num_microbatches=3"):
        step(p0, init_train_state(p0, ocfg), batch, Hyper(lr=0.01, step=0),
             default_bits(tc, False))
    # no schedule: no pipeline metrics and no schedule on the step
    step = make_train_step(tc, QuantPolicy.off(), ocfg, device="cpu")
    assert step.pipeline_schedule is None


def test_pipeline_execution_build_time_validation():
    """JAX's ``test_pipeline_execution_build_time_validation``: a layer
    count the stages do not divide fails when the step is built; every
    family and feature builds."""
    ocfg = OptimizerConfig()

    def build(jc, pol):
        return make_train_step(ModelConfig(**dataclasses.asdict(jc)), pol,
                               ocfg, StepOptions(pipeline_schedule="gpipe",
                                                 pipeline_stages=2,
                                                 num_microbatches=4),
                               device="cpu")

    with pytest.raises(ValueError, match="num_layers=3 does not divide into "
                                         "pipeline_stages=2 equal stages"):
        build(tiny("dense", num_layers=3), QuantPolicy.off())
    for jc, pol in (
            (tiny("hybrid"), QuantPolicy.off()),
            (tiny("dense", num_layers=4), QuantPolicy(compress_dw=True)),
            (tiny("dense", num_layers=4), QuantPolicy(overlap="on")),
            (tiny("encdec", num_layers=4), QuantPolicy(stochastic=True)),
            (tiny("moe", num_layers=4), QuantPolicy(quantize_updates=True))):
        assert build(jc, pol).pipeline_schedule is not None


@pytest.mark.parametrize("leg", sorted(QUANT_LEGS))
def test_capabilities_equal_jax(leg):
    kw, _ = QUANT_LEGS[leg]
    for family in FAMILIES + ("unobtainium",):
        jc = _cfg(family if family != "unobtainium" else "dense")
        tc = ModelConfig(**dataclasses.asdict(jc))
        if family == "unobtainium":
            object.__setattr__(jc, "family", family)
            object.__setattr__(tc, "family", family)
        for ov in ("off", "on"):
            assert pipeline_exec_capabilities(
                tc, QuantPolicy(**kw, overlap=ov)) == j_caps(
                    jc, JQP(**kw, overlap=ov)), (family, ov)


# ---------------------------------------------------------------------------
# the grad taps
# ---------------------------------------------------------------------------

def _tap_pair(x, ct, enabled, kd=None, offset=0):
    """(port cotangent, JAX cotangent) of the tap at ``x`` under ``ct``."""
    jx, jct = jnp.asarray(x), jnp.asarray(ct)
    bits = (jnp.int32(2), jnp.int32(12), jnp.float32(enabled))
    if kd is None:
        _, vjp = jax.vjp(lambda a: j_tap(a, *bits), jx)
    else:
        _, vjp = jax.vjp(lambda a: j_tap_stoch(
            a, *bits, jnp.asarray(kd), jnp.int32(offset)), jx)
    tx = torch.from_numpy(x).requires_grad_()
    tb = (torch.tensor(2, dtype=torch.int32),
          torch.tensor(12, dtype=torch.int32), torch.tensor(enabled))
    y = (grad_tap(tx, *tb) if kd is None
         else grad_tap_stochastic(tx, *tb, kd, offset))
    assert torch.equal(y.detach(), tx.detach())
    g, = torch.autograd.grad(y, tx, torch.from_numpy(ct))
    return g.numpy(), np.asarray(vjp(jct)[0])


@pytest.mark.parametrize("enabled", [1.0, 0.0])
def test_grad_taps_match_jax(enabled):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 5, 7)).astype(np.float32)
    ct = (rng.standard_normal((8, 5, 7)) * 0.01).astype(np.float32)
    kd = np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.key(5), 3)))
    got, want = _tap_pair(x, ct, enabled)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    full, want = _tap_pair(x, ct, enabled, kd, 0)
    np.testing.assert_array_equal(full.view(np.uint32),
                                  want.view(np.uint32))
    # a microbatch of rows 4..5 at its global offset draws the full batch's
    # rows' noise
    part, want = _tap_pair(x[4:6], ct[4:6], enabled, kd, 4)
    np.testing.assert_array_equal(part.view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(part, full[4:6])
    if enabled:
        assert not np.array_equal(full, got)       # the noise moved G
