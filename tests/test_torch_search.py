"""Port parity of the bitwidth search (``repro_torch.search``) against the
JAX package's (``repro.search``) on the CPU: plans and serve plans (JSON
both ways), anneal schedules, the greedy selection, the LeNet and LM
probes and sweeps, the export checks, and the annealed engine step.

Tolerances, and why:
  * the LeNet probe (f32, ``relu(x @ w)`` bodies through the engine's
    stack): one JAX step and one port step agree to f32 ulps, but the
    trajectories part at the first ReLU or (I,F) rounding tie that a
    reassociated sum moves across (a G element one 2^-F step apart), and
    from there the probe losses drift like the port's own under one ulp
    on every weight.  So the per-schedule losses after 8 steps are held
    to 1e-6 of themselves with quantization off and 2e-3 with it on; a
    whole sweep (QUICK_SWEEP, 40 steps a probe) must choose the same
    plan, its losses within 10% of JAX's.
  * the LM sweep (2-layer f32 dense config, ``make_train_step``): the
    same plan, every loss within 1e-6 of jitted JAX's (f32: jit and op by
    op agree to ulps; one probe is also held to op-by-op JAX).
  * the LM sweep on the tiny hybrid (``tests/test_models.py::
    tiny("hybrid")``, its 2 groups the 2 units): the same plan, the
    baseline and final losses within 1e-6 of jitted JAX's, and each probe
    loss within 2e-3 of it, the LeNet probes' quantized rule: the probes
    run at (1,3), where one f32 ulp on every weight moves the port's own
    probe losses by up to 7e-3 of themselves (observed against JAX:
    1.6e-5).
  * the export checks and the anneal: bitwise.
  * the card tolerances of ``chip_smoke.py``'s ``search`` phase are
    justified here on the CPU (``test_probe_spread_justifies_card_
    tolerances``).
"""
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import steps as JST
from repro.core.taxonn import QuantPolicy as JQP
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JMC
from repro.optim import Hyper as JHyper
from repro.optim import OptimizerConfig as JOCfg
from repro.quant import schedule_from_formats as j_sched
from repro.search import anneal as JA
from repro.search import export as JE
from repro.search import plan as JP
from repro.search import sensitivity as JS
from repro.serving import engine as JENG
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              init_train_state, make_train_step)
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.quant.fixed_point import schedule_from_formats as t_sched
from repro_torch.search import anneal as TA
from repro_torch.search import export as TE
from repro_torch.search import plan as TP
from repro_torch.search import sensitivity as TS
from repro_torch.serving import engine as TENG
from repro_torch.util import prng
from repro_torch.util.tree import tree_leaves

from test_models import tiny
from test_torch_engine_jax import _grid_close

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the search phase's tolerances)

TINY = dict(name="t-dense", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
            compute_dtype="float32")
QUICK = dict(num_groups=2, probe_steps=40, target=0.15,
             grid=((1, 3), (1, 5), (2, 6), (2, 10)))
EXPORT_FORMATS = [(2, 5), (1, 6), (2, 12), (4, 10)]
GRID = 2.0 ** -12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs files on parallel
    workers, where torch's default of a thread a core oversubscribes the
    CPU and these small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _jax_mlp_weights(seed=0):
    w = JS._init_mlp(jax.random.key(seed), 784, 256, 10, 3)
    return {k: np.asarray(v) for k, v in w.items()}


# ---------------------------------------------------------------------------
# plan: groups and JSON
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 24])
@pytest.mark.parametrize("g", [-1, 0, 1, 2, 3, 4, 30])
def test_layer_groups_match_jax(n, g):
    assert TP.layer_groups(n, g) == JP.layer_groups(n, g)


def test_layer_groups_refuse_no_layers():
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="num_layers must be positive"):
            mod.layer_groups(0, 1)


def _plan_kwargs():
    return dict(num_layers=5, baseline_loss=0.1234567891, final_loss=0.2,
                target=0.08, seed=3, grid=((1, 3), (2, 6), (2, 12)),
                probe_steps=24, probes=9)


def _plans():
    """The same plan built by each package."""
    out = []
    for mod in (JP, TP):
        groups = (mod.GroupChoice(0, (0, 1), 1, 3, 0.15, True),
                  mod.GroupChoice(1, (2, 3, 4), 2, 12, 0.3333333333, False))
        out.append(mod.BitPlan(groups=groups, **_plan_kwargs()))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bitplan_json_crosses_packages(writer, tmp_path):
    jplan, tplan = _plans()
    path = str(tmp_path / "d" / "plan.json")
    src, dst = (jplan, TP.BitPlan) if writer == "jax" else (tplan, JP.BitPlan)
    src.save(path)
    other = tmp_path / "other.json"
    (jplan if writer == "port" else tplan).save(str(other))
    assert pathlib.Path(path).read_bytes() == other.read_bytes()
    loaded = dst.load(path)
    assert loaded.to_json() == src.to_json()
    assert loaded.formats() == src.formats()
    assert loaded.describe() == src.describe()
    assert loaded.met_target == src.met_target
    jb, tb = jplan.to_bit_schedule(), tplan.to_bit_schedule(enabled=True)
    for f in ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f", "enabled"):
        np.testing.assert_array_equal(_np(getattr(jb, f)),
                                      getattr(tb, f).numpy(), err_msg=f)
    assert float(tplan.to_bit_schedule(enabled=False).enabled) == 0.0


def test_bitplan_refuses_what_jax_refuses():
    kw = dict(_plan_kwargs(), num_layers=4)
    for mod in (JP, TP):
        with pytest.raises(ValueError, match="do not partition"):
            mod.BitPlan(groups=(mod.GroupChoice(0, (0, 2), 1, 3, 0.1, True),),
                        **kw)
        with pytest.raises(ValueError, match="unknown BitPlan schema 2"):
            mod.BitPlan.from_json({"schema": 2})
    jp, tp = (m.plan_from_formats(EXPORT_FORMATS, baseline_loss=0.5,
                                  final_loss=0.6, target=0.2, seed=4,
                                  probe_steps=7) for m in (JP, TP))
    assert jp.to_json() == tp.to_json()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_plan_json_crosses_packages(writer, tmp_path):
    jsp = JE.to_serve_plan(JP.plan_from_formats(EXPORT_FORMATS))
    tsp = TE.to_serve_plan(TP.plan_from_formats(EXPORT_FORMATS))
    assert jsp.to_json() == tsp.to_json()
    path = str(tmp_path / "serve.json")
    if writer == "jax":
        JE.save_serve_plan(jsp, path)
        loaded = TE.load_serve_plan(path)
    else:
        TE.save_serve_plan(tsp, path)
        loaded = JE.load_serve_plan(path)
    assert loaded.to_json() == jsp.to_json()
    assert [lq.exact for lq in loaded.layers] == [True, True, False, False]
    assert [lq.eff_f_bits for lq in loaded.layers] == [5, 6, 5, 3]


def test_to_serve_plan_of_the_export_plan():
    sp = TE.to_serve_plan(TP.plan_from_formats(EXPORT_FORMATS))
    by_layer = {l.layer: l for l in sp.layers}
    assert by_layer[0].mode == "fxp" and by_layer[0].exact
    assert by_layer[1].mode == "fxp" and by_layer[1].exact
    assert by_layer[2].mode == "absmax" and by_layer[2].shift == 7
    assert by_layer[2].eff_f_bits == 5
    assert sp.serve_config_kwargs() == {"cache_dtype": torch.int8}
    for export, plan in ((TE, TP), (JE, JP)):
        with pytest.raises(ValueError, match="I > 7") as e:
            export.to_serve_plan(plan.plan_from_formats([(8, 4)]))
        assert "layer 0 format (8,4)" in str(e.value)


# ---------------------------------------------------------------------------
# anneal
# ---------------------------------------------------------------------------

BAD_SPECS = ["", "   ", "5:12", "0:12,0:10", "0:xyz", "0:12,100:-3", "0:99",
             "abc", "0:1:2", "-1:3,0:4", "0:12,5:10,3:8", ",,,", "x:3",
             123, None]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=[repr(s) for s in BAD_SPECS])
def test_anneal_parse_errors_match_jax(spec):
    errs = []
    for mod in (JA, TA):
        with pytest.raises(Exception) as e:
            mod.AnnealSchedule.parse(spec)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] is ValueError


@pytest.mark.parametrize("spec", ["0:off, 100:16,400:12", "0:16", "0:off",
                                  "0:14,3:12,7:10", "0:0,2:off,4:24"])
def test_anneal_parse_matches_jax(spec):
    j, t = JA.AnnealSchedule.parse(spec), TA.AnnealSchedule.parse(spec)
    assert t.milestones == j.milestones
    assert (t.spec, t.final_step, t.describe()) == (j.spec, j.final_step,
                                                    j.describe())
    assert TA.AnnealSchedule.parse(t) is t
    assert TA.AnnealSchedule.parse(t.spec) == t
    for s in range(-2, 500, 7):
        assert t.f_floor_at(s) == j.f_floor_at(s)


@pytest.mark.parametrize("spec", ["0:off,3:16,7:12", "0:14,2:off,5:10",
                                  "0:24", "0:off"])
@pytest.mark.parametrize("step_kind", ["int", "tensor"])
def test_anneal_apply_matches_jax(spec, step_kind):
    formats = [(2, 6), (2, 8), (2, 14), (1, 20)]
    j, t = JA.AnnealSchedule.parse(spec), TA.AnnealSchedule.parse(spec)
    jb, tb = j_sched(formats), t_sched(formats)
    tb0 = {f: getattr(tb, f).clone() for f in ("w_f", "a_f", "g_f")}
    for step in range(0, 11):
        ts = step if step_kind == "int" else torch.tensor(step,
                                                          dtype=torch.int32)
        jr = j.apply_tree({"blocks": jb}, jnp.int32(step))["blocks"]
        tr = t.apply_tree({"blocks": tb}, ts)["blocks"]
        assert isinstance(t.apply(tb, ts), type(tb))
        for f in ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f", "enabled"):
            got, want = getattr(tr, f), _np(getattr(jr, f))
            assert got.dtype == (torch.float32 if f == "enabled"
                                 else torch.int32), f
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    for f, v in tb0.items():  # the schedule itself is left as it was
        assert torch.equal(getattr(tb, f), v)


# ---------------------------------------------------------------------------
# select_plan with a table-driven fake probe
# ---------------------------------------------------------------------------

PENALTY = {(1, 3): 0.5, (1, 5): 0.05, (2, 6): 0.03, (2, 8): 0.02,
           (2, 10): 0.0, (2, 12): 0.0, (4, 16): 0.0}


def _fake_probe(schedule):
    """loss = 1 off, else 1 + the sum of each layer's format penalty (the
    same function of the schedule's numbers in either package)."""
    if float(_np(schedule.enabled)) == 0.0:
        return 1.0
    w_i, w_f = _np(schedule.w_i).tolist(), _np(schedule.w_f).tolist()
    return 1.0 + sum(PENALTY[(i, f)] for i, f in zip(w_i, w_f))


@pytest.mark.parametrize("case", [
    dict(num_groups=0, target=0.2),                 # one group a layer
    dict(num_groups=0, target=0.08),                # escalates
    dict(num_groups=2, target=0.04, max_escalations=1),
    dict(num_groups=3, target=0.001),               # nothing meets: widest
    dict(num_groups=1, target=0.3, grid=((2, 6), (1, 3), (1, 5))),
])
def test_select_plan_matches_jax_with_a_fake_probe(case):
    logs = {}
    plans = {}
    for name, mod in (("jax", JS), ("port", TS)):
        logs[name] = []
        plans[name] = mod.select_plan(_fake_probe, 3, mod.SweepConfig(**case),
                                      log=logs[name].append)
    assert plans["port"].to_json() == plans["jax"].to_json()
    assert json.dumps(plans["port"].to_json(), sort_keys=True) == \
        json.dumps(plans["jax"].to_json(), sort_keys=True)
    assert logs["port"] == logs["jax"]
    if case["target"] == 0.08:
        assert sum("escalate" in s for s in logs["port"]) == 4


# ---------------------------------------------------------------------------
# the LeNet probe and sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,enabled,rel", [
    ((2, 12), False, 1e-6), ((1, 3), True, 2e-3), ((2, 6), True, 2e-3),
    ((2, 12), True, 2e-3)])
def test_lenet_probe_losses_match_jax(fmt, enabled, rel):
    """8 probe steps (tail: steps 6-7) from JAX's ``_init_mlp`` weights."""
    sweep = dict(QUICK, probe_steps=8)
    jprobe, n = JS.make_lenet_probe(JS.SweepConfig(**sweep))
    tprobe, tn = TS.make_lenet_probe(TS.SweepConfig(**sweep), device="cpu",
                                     params0=_jax_mlp_weights())
    assert tn == n == 3
    want = jprobe(j_sched([fmt] * n, enabled=enabled))
    got = tprobe(t_sched([fmt] * n, enabled=enabled))
    assert got == pytest.approx(want, rel=rel)


def test_quick_sweep_plan_matches_jax():
    jplan = JS.run_sweep(JS.SweepConfig(**QUICK))
    tplan = TS.run_sweep(TS.SweepConfig(**QUICK), device="cpu",
                         params0=_jax_mlp_weights())
    assert tplan.formats() == jplan.formats()
    assert tplan.probes == jplan.probes
    assert tplan.met_target and jplan.met_target
    j, t = jplan.to_json(), tplan.to_json()
    for k in ("baseline_loss", "final_loss"):
        assert t[k] == pytest.approx(j[k], rel=0.1), k
    for gj, gt in zip(j["groups"], t["groups"]):
        assert gt["probe_loss"] == pytest.approx(gj["probe_loss"], rel=0.1)
        assert {k: v for k, v in gt.items() if k != "probe_loss"} == \
            {k: v for k, v in gj.items() if k != "probe_loss"}
    # the searched plan exports with parity, in the port as in JAX
    assert TE.assert_parity(tplan, device="cpu")["ok"]


def test_lenet_probe_leaves_params0_unchanged():
    p0 = TS._init_mlp(0, 784, 256, 10, 3)
    keep = {k: v.clone() for k, v in p0.items()}
    probe, n = TS.make_lenet_probe(TS.SweepConfig(probe_steps=3),
                                   device="cpu", params0=p0)
    first = probe(t_sched([(2, 6)] * n))
    for k, v in p0.items():
        assert torch.equal(v, keep[k]), k
    assert probe(t_sched([(2, 6)] * n)) == first
    # the default weights are these, drawn on the CPU from the seed
    probe_d, _ = TS.make_lenet_probe(TS.SweepConfig(probe_steps=3),
                                     device="cpu")
    assert probe_d(t_sched([(2, 6)] * n)) == first


# ---------------------------------------------------------------------------
# the LM sweep
# ---------------------------------------------------------------------------

LM_SWEEP = dict(num_groups=2, probe_steps=4, batch=2, target=0.05,
                grid=((1, 3), (2, 6), (2, 12)))


def _lm_setup():
    jc, tc = JMC(**TINY), ModelConfig(**TINY)
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(0), jc))
    return jc, tc, jp


def test_lm_sweep_plan_matches_jax():
    jc, tc, jp = _lm_setup()
    jlog, tlog = [], []
    jplan = JS.run_sweep_lm(jc, None, JS.SweepConfig(**LM_SWEEP), seq_len=16,
                            log=jlog.append)
    tplan = TS.run_sweep_lm(tc, None, TS.SweepConfig(**LM_SWEEP), seq_len=16,
                            log=tlog.append, device="cpu", params0=jp)
    j, t = jplan.to_json(), tplan.to_json()
    assert tplan.formats() == jplan.formats() and t["probes"] == j["probes"]
    assert len(tlog) == len(jlog)
    for k in ("baseline_loss", "final_loss"):
        assert t[k] == pytest.approx(j[k], rel=1e-6), k
    for gj, gt in zip(j["groups"], t["groups"]):
        assert gt["probe_loss"] == pytest.approx(gj["probe_loss"], rel=1e-6)


def test_lm_sweep_plan_matches_jax_hybrid():
    """run_sweep_lm sizes its groups from num_scan_units, so on the hybrid
    it sweeps the engine's units, the groups (the shared block takes each
    group's format)."""
    jc = tiny("hybrid")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(0), jc))
    jplan = JS.run_sweep_lm(jc, None, JS.SweepConfig(**LM_SWEEP), seq_len=16)
    tplan = TS.run_sweep_lm(tc, None, TS.SweepConfig(**LM_SWEEP), seq_len=16,
                            device="cpu", params0=jp)
    j, t = jplan.to_json(), tplan.to_json()
    assert t["num_layers"] == TLM.hybrid_groups(tc)[0] == 2
    assert tplan.formats() == jplan.formats() and t["probes"] == j["probes"]
    for k in ("baseline_loss", "final_loss"):
        assert t[k] == pytest.approx(j[k], rel=1e-6), k
    for gj, gt in zip(j["groups"], t["groups"]):
        assert gt["probe_loss"] == pytest.approx(gj["probe_loss"], rel=2e-3)


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_lm_sweep_refuses_other_families(family, monkeypatch):
    """The JAX sweep draws encoder frames or patch embeddings for encdec
    and vlm; since ROADMAP A9e the port's engine trains both, and its
    probes draw the same inputs (``launch.train.modality_inputs``, JAX's
    normals within 2^-21 relative): a 2-step probe at a mixed schedule on
    JAX's weights reads JAX's probe loss within the sweep's rel 2e-3.  A
    family outside the JAX package's six is still refused."""
    jc = tiny(family)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(0), jc))
    jprobe = _jax_lm_probe(monkeypatch, jc)
    tprobe, n = TS.make_lm_probe(tc, None, TS.SweepConfig(
        **dict(LM_SWEEP, probe_steps=2)), seq_len=16, device="cpu",
        params0=jp)
    assert n == 2
    fmts = [(2, 6), (1, 3)]
    assert tprobe(t_sched(fmts)) == pytest.approx(jprobe(j_sched(fmts)),
                                                  rel=2e-3)
    with pytest.raises(ValueError, match="unknown model family"):
        TS.run_sweep_lm(dataclasses.replace(tc, family="retnet"), None,
                        TS.SweepConfig(**LM_SWEEP), seq_len=16,
                        device="cpu")


def _jax_lm_probe(monkeypatch, cfg):
    """The probe that the JAX package's ``run_sweep_lm`` builds (its
    ``select_plan`` patched to hand the probe back instead of sweeping)."""
    got = []
    monkeypatch.setattr(JS, "select_plan",
                        lambda probe, n, sweep, log=None: got.append(probe))
    JS.run_sweep_lm(cfg, None, JS.SweepConfig(**dict(LM_SWEEP,
                                                     probe_steps=2)),
                    seq_len=16)
    monkeypatch.undo()
    return got[0]


def test_lm_probe_matches_op_by_op_jax(monkeypatch):
    """A 2-step probe of the sweep's step at a mixed schedule against JAX
    run op by op (``jax.disable_jit``); the probe leaves params0 as it
    was."""
    jc, tc, jp = _lm_setup()
    tp = TLM.params_from_numpy(jp, device="cpu")
    keep = [x.clone() for x in tree_leaves(tp)]
    jprobe = _jax_lm_probe(monkeypatch, jc)
    tprobe, n = TS.make_lm_probe(tc, None, TS.SweepConfig(
        **dict(LM_SWEEP, probe_steps=2)), seq_len=16, device="cpu",
        params0=tp)
    assert n == 2
    fmts = [(2, 6), (1, 3)]
    with jax.disable_jit():
        want = jprobe(j_sched(fmts))
    assert tprobe(t_sched(fmts)) == pytest.approx(want, rel=1e-6)
    for a, b in zip(keep, tree_leaves(tp)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_grid_embedding_inputs_bitwise():
    """check_grid_embedding's inputs: JAX's uniform draws bit for bit
    (XLA contracts ``u * span + minval`` into one FMA)."""
    for seed, idx, i_b in ((0, 0, 0), (0, 3, 2), (7, 1, 4), (2 ** 32 - 1,
                                                            5, 7)):
        lo, hi = -1.5 * 2.0 ** i_b, 1.5 * 2.0 ** i_b
        jk = jax.random.fold_in(jax.random.key(seed), idx)
        want = np.asarray(jax.random.uniform(jk, (512,), jnp.float32, lo, hi))
        got = TE._uniform(prng.fold_in(prng.key(seed), idx), (512,), lo, hi,
                          "cpu")
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_check_grid_embedding_matches_jax():
    jplan = JP.plan_from_formats(EXPORT_FORMATS + [(1, 3), (3, 4), (7, 0)])
    tplan = TP.plan_from_formats(EXPORT_FORMATS + [(1, 3), (3, 4), (7, 0)])
    want = JE.check_grid_embedding(jplan, jax.random.key(5))
    got = TE.check_grid_embedding(tplan, prng.key(5), device="cpu")
    assert got == want and got["ok"]


def test_kv_reference_bitwise():
    x = np.array(3.0 * jax.random.normal(jax.random.key(4), (32, 4, 16)))
    x[3] = 0.0   # an all-zero row takes the 1e-8 floor
    xt = torch.from_numpy(x)
    q, s = TE.kv_reference(xt)
    for rq, rs in (JE.kv_reference(jnp.asarray(x)),
                   JENG.quant_kv_rows(jnp.asarray(x)), TENG.quant_kv_rows(xt)):
        np.testing.assert_array_equal(q.numpy(), _np(rq))
        np.testing.assert_array_equal(s.numpy(), _np(rs))
    assert q.dtype == torch.int8
    res = TE.check_kv_parity(prng.key(1), device="cpu")
    assert res == {"kv_payload_max_diff": 0, "kv_scale_max_diff": 0.0,
                   "ok": True}


def test_export_prologue_weights_bitwise():
    ks = jax.random.split(jax.random.key(2), 3)
    attn = {"wq": jax.random.normal(ks[0], (64, 4, 16)) * 0.1,
            "wk": jax.random.normal(ks[1], (64, 2, 16)) * 0.1,
            "wv": jax.random.normal(ks[2], (64, 2, 16)) * 0.1}
    want = JE.export_prologue_weights(attn)
    got = TE.export_prologue_weights(
        {k: torch.from_numpy(np.array(v)) for k, v in attn.items()})
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_array_equal(got[3].numpy(), _np(want[3]).reshape(-1))


@pytest.mark.parametrize("formats", [EXPORT_FORMATS, [(1, 3), (2, 6)]])
def test_verify_train_serve_parity(formats):
    res = TE.verify_train_serve_parity(TP.plan_from_formats(formats),
                                       device="cpu")
    want = JE.verify_train_serve_parity(JP.plan_from_formats(formats))
    assert res == want
    assert res["ok"] and res["prologue_max_diff"] == 0.0
    assert res["grid_msb_max_diff"] == res["grid_exact_max_diff"] == 0.0
    assert TE.assert_parity(TP.plan_from_formats(formats),
                            device="cpu") == res


def test_serve_layer_quant_matches_jax():
    x = np.array(jax.random.uniform(jax.random.key(9), (257,), jnp.float32,
                                    -5.0, 5.0))
    for lq_j, lq_t in zip(JE.to_serve_plan(JP.plan_from_formats(
            EXPORT_FORMATS)).layers, TE.to_serve_plan(TP.plan_from_formats(
                EXPORT_FORMATS)).layers):
        (jq, js), (tq, ts) = (JE.serve_layer_quant(jnp.asarray(x), lq_j),
                              TE.serve_layer_quant(torch.from_numpy(x), lq_t))
        np.testing.assert_array_equal(tq.numpy(), _np(jq))
        assert float(ts) == float(js)


# ---------------------------------------------------------------------------
# the annealed engine step
# ---------------------------------------------------------------------------

ANNEAL_SPEC = "0:off,2:14,5:10"


def _anneal_setup():
    jc, tc, jp = _lm_setup()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, 128, (2, 16)).astype(np.int32)}
    return jc, tc, jp, batch


def test_step_options_normalise_the_anneal():
    opts = StepOptions(bit_anneal="0:16,10:12")
    assert isinstance(opts.bit_anneal, TA.AnnealSchedule)
    assert opts.bit_anneal.spec == "0:16,10:12"
    assert StepOptions(bit_anneal=opts.bit_anneal).bit_anneal is \
        opts.bit_anneal
    with pytest.raises(ValueError, match="bit_anneal must be"):
        StepOptions(bit_anneal=123)
    with pytest.raises(ValueError, match="first anneal milestone"):
        StepOptions(bit_anneal="3:12")
    _, tc, _ = _lm_setup()
    pol = QuantPolicy(bit_anneal="0:16,10:12")
    step = make_train_step(tc, pol, device="cpu")
    assert step.bit_anneal.spec == "0:16,10:12"
    # the options come first, then the policy
    step = make_train_step(tc, pol, options=StepOptions(bit_anneal="0:8"),
                           device="cpu")
    assert step.bit_anneal.spec == "0:8"
    assert make_train_step(tc, device="cpu").bit_anneal is None
    auto = make_train_step(tc, pol, options=StepOptions(engine="autodiff"),
                           device="cpu")
    assert auto.bit_anneal.spec == "0:16,10:12"


@pytest.mark.parametrize("step_kind", ["int", "tensor"])
def test_anneal_step_matches_manual_bits_bitwise(step_kind):
    """A step built with bit_anneal == the same step fed manually annealed
    bits, at every milestone (``test_bit_search.py``'s test, in the
    port), and == JAX's annealed step within the engine's f32 tolerance
    (``test_torch_engine_jax.py``)."""
    jc, tc, jp, batch = _anneal_setup()
    policy = QuantPolicy(grad_scale=8.0)
    ocfg = OptimizerConfig(kind="sgd")
    annealed = make_train_step(tc, policy, ocfg,
                               StepOptions(bit_anneal=ANNEAL_SPEC),
                               device="cpu")
    manual = make_train_step(tc, policy, ocfg, StepOptions(), device="cpu")
    jstep = jax.jit(JST.make_train_step(
        jc, JQP(grad_scale=8.0), JOCfg(kind="sgd"),
        JST.StepOptions(bit_anneal=ANNEAL_SPEC)))
    assert annealed.bit_anneal.spec == ANNEAL_SPEC
    sched = TA.AnnealSchedule.parse(ANNEAL_SPEC)
    bits = default_bits(tc, enabled=True)
    params = TLM.params_from_numpy(jp, device="cpu")
    opt = init_train_state(params, ocfg)
    jopt = JST.init_train_state(jp, JOCfg(kind="sgd"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for step in (0, 1, 2, 4, 5, 9):
        s = step if step_kind == "int" else torch.tensor(step)
        pa, oa, ma = annealed(params, opt, batch, Hyper(lr=0.05, step=s),
                              bits)
        pm, om, mm = manual(params, opt, batch, Hyper(lr=0.05, step=step),
                            sched.apply_tree(bits, step))
        for a, m in zip(tree_leaves((pa, oa)), tree_leaves((pm, om))):
            assert torch.equal(a, m)
        assert torch.equal(ma["loss"], mm["loss"])
        jn, _, jm = jstep(jp, jopt, jbatch,
                          JHyper(lr=jnp.float32(0.05), step=jnp.int32(step)),
                          JST.default_bits(jc))
        assert float(ma["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-6)
        for a, r in zip(tree_leaves(pa), jax.tree.leaves(jn)):
            assert _grid_close(a.numpy(), np.asarray(r), 2e-6, 1e-5,
                               0.05 * GRID), step
    # the anneal acts: with quantization off at step 0 the step equals the
    # step fed disabled bits, and differs from the unannealed one
    p_off, _, _ = manual(params, opt, batch, Hyper(lr=0.05, step=0),
                         default_bits(tc, enabled=False))
    p_on, _, _ = manual(params, opt, batch, Hyper(lr=0.05, step=0), bits)
    pa, _, _ = annealed(params, opt, batch, Hyper(lr=0.05, step=0), bits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa),
                                                 tree_leaves(p_off)))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(pa),
                                                     tree_leaves(p_on)))


# ---------------------------------------------------------------------------
# the card tolerances of chip_smoke.py's search phase
# ---------------------------------------------------------------------------

def _reversed_sums(matmul):
    def mm(a, b):
        k = torch.arange(a.shape[-1] - 1, -1, -1)
        return matmul(a[..., k], b[k])
    return mm


def test_probe_spread_justifies_card_tolerances(monkeypatch):
    """Why the search phase holds the card's LeNet sweep to
    SEARCH_LENET_LOSS_TOL (absolute) against the CPU.  On the CPU alone,
    one f32 ulp on every initial weight together with every ``@`` summed
    in reverse order moves the default LeNet sweep's gated losses (the
    baseline, each group's chosen (1,5)/(1,5)/(2,6) probe and the final
    plan's) by under 2e-3, and the probe that decides its escalation
    ((1,5) in every group, 0.011 above the threshold) by 0.0111 (one
    thread a test): the limit 0.025 is over twice both, and a decision
    nearer the threshold than it is printed, not gated.  (The phase's
    2-layer LM sweep against the CPU, and its limit, went to pay for the
    moe phase; ``test_lm_sweep_plan_matches_jax`` holds the LM sweep to JAX on
    the CPU.)"""
    assert CS.SEARCH_LENET_LOSS_TOL == 0.025
    sweep = TS.SweepConfig()
    lenet = [[(4, 16)] * 3, [(1, 5), (4, 16), (4, 16)],
             [(4, 16), (1, 5), (4, 16)], [(4, 16), (4, 16), (2, 6)],
             [(1, 5), (1, 5), (2, 6)], [(1, 5)] * 3]
    p0 = TS._init_mlp(0, 784, 256, 10, 3)
    p1 = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
          for k, v in p0.items()}

    def losses(params):
        probe, _ = TS.make_lenet_probe(sweep, device="cpu", params0=params)
        return [probe(t_sched(f, enabled=i > 0)) for i, f in enumerate(lenet)]
    ref = losses(p0)
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        _reversed_sums(torch.Tensor.__matmul__))
    got = losses(p1)
    monkeypatch.undo()
    spread = [abs(a - b) for a, b in zip(got, ref)]
    assert max(spread[:5]) < 2e-3, spread
    assert max(spread) < CS.SEARCH_LENET_LOSS_TOL / 2, spread
    assert ref[5] > ref[0] + sweep.target > ref[4], ref
