"""The bitwidth search through the port's resume payload and train driver
on the CPU, mirroring ``tests/test_bit_search.py``'s anneal drills: the
resume guard (also over a payload the JAX package wrote), an annealed
stochastic run checkpointed mid-ramp and continued bitwise, the driver's
``--bit-search`` (plans the JAX package reads, the parity line) and an
annealed driver killed and resumed bitwise.
"""
import re
import warnings

import numpy as np
import pytest
import torch

from repro.core.steps import capture_resume_extra as j_capture
from repro.models.config import ModelConfig as JMC
from repro.search import export as JE
from repro.search.plan import BitPlan as JBitPlan
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              init_train_state, make_train_step)
from repro_torch.core.steps import apply_resume_extra, capture_resume_extra
from repro_torch.ft import FAULT_EXIT_CODE
from repro_torch.launch import train
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.search import export as TE
from repro_torch.search.plan import BitPlan
from repro_torch.util import prng
from repro_torch.util.tree import tree_leaves

from test_torch_search import TINY, _lm_setup, _one_thread  # noqa: F401
from test_torch_train_driver import run_driver, step_losses


def test_anneal_resume_guard():
    cfg = ModelConfig(**TINY)
    extra = capture_resume_extra(cfg, 5, anneal="0:14,3:12")
    assert extra["bit_anneal"] == "0:14,3:12"
    # same spec (or the same schedule spelled otherwise): fine
    assert apply_resume_extra(extra, cfg, 5, anneal="0:14,3:12") == 5
    assert apply_resume_extra(extra, cfg, 5, anneal=" 0:14, 3:12") == 5
    # different ramp: refuse (the bit schedule would jump mid-run)
    with pytest.raises(ValueError, match="annealed under"):
        apply_resume_extra(extra, cfg, 5, anneal="0:16,3:12")
    # dropping the anneal at resume: loud warning, not silent drift
    with pytest.warns(RuntimeWarning, match="bit-anneal mismatch"):
        apply_resume_extra(extra, cfg, 5)
    # adding one to a plain checkpoint: the same warning
    plain = capture_resume_extra(cfg, 5)
    assert "bit_anneal" not in plain
    with pytest.warns(RuntimeWarning, match="bit-anneal mismatch"):
        apply_resume_extra(plain, cfg, 5, anneal="0:14")
    # plain checkpoints resumed plainly stay silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert apply_resume_extra(plain, cfg, 5) == 5


def test_jax_written_anneal_payload_is_accepted_under_its_spec():
    """A payload the JAX package's ``capture_resume_extra`` wrote with an
    anneal: the port resumes it silently under the same spec, refuses it
    under another, and writes the same ``bit_anneal`` entry itself."""
    cfg = ModelConfig(**TINY)
    jextra = j_capture(JMC(**TINY), 7, anneal="0:off,2:16, 6:12")
    assert jextra["bit_anneal"] == "0:off,2:16,6:12"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert apply_resume_extra(jextra, cfg, 7,
                                  anneal="0:off,2:16,6:12") == 7
    with pytest.raises(ValueError, match="annealed under '0:off,2:16,6:12'"):
        apply_resume_extra(jextra, cfg, 7, anneal="0:off,2:16,6:10")
    mine = capture_resume_extra(cfg, 7, anneal="0:off,2:16, 6:12")
    assert mine["bit_anneal"] == jextra["bit_anneal"]
    assert {k: mine[k] for k in ("resume_schema", "arch", "data_step")} == \
        {k: jextra[k] for k in ("resume_schema", "arch", "data_step")}


def _train(step_fn, params, opt, batches, bits, *, start=0, rng_base=None):
    for i, batch in enumerate(batches[start:], start=start):
        rng = prng.fold_in(rng_base, i) if rng_base is not None else None
        params, opt, _ = step_fn(params, opt, batch,
                                 Hyper(lr=0.05, step=i), bits, rng)
    return params, opt


def test_anneal_resume_bitwise_mid_ramp(tmp_path):
    """Checkpoint in the middle of the F-bit ramp through the port's
    ``ckpt/``, restart, and the continuation is bitwise identical to the
    uninterrupted run: the annealed bits are a function of the (restored)
    step, and so is the stochastic rounding's noise."""
    spec = "0:14,3:12,7:10"
    _, cfg, jp = _lm_setup()
    policy = QuantPolicy(grad_scale=8.0, stochastic=True)
    ocfg = OptimizerConfig(kind="sgd")
    step_fn = make_train_step(cfg, policy, ocfg,
                              StepOptions(bit_anneal=spec), device="cpu")
    bits = default_bits(cfg, enabled=True)
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, 128, (2, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(10)]
    rng_base = prng.key(7)
    params0 = TLM.params_from_numpy(jp, device="cpu")
    opt0 = init_train_state(params0, ocfg)

    # uninterrupted: 10 steps straight through the 3 -> 7 milestones
    p_full, o_full = _train(step_fn, params0, opt0, batches, bits,
                            rng_base=rng_base)

    # interrupted: stop at step 5 (mid-ramp), checkpoint, restore, continue
    p_half, o_half = _train(step_fn, params0, opt0, batches[:5], bits,
                            rng_base=rng_base)
    ckpt_dir = str(tmp_path / "ckpt")
    extra = capture_resume_extra(cfg, 5, anneal=spec)
    assert extra["bit_anneal"] == spec
    save_checkpoint(ckpt_dir, 5, (p_half, o_half), extra=extra)
    template = (TLM.params_from_numpy(jp, device="cpu"),
                init_train_state(params0, ocfg))
    (p_res, o_res), ckpt_step, extra_r = restore_checkpoint(ckpt_dir,
                                                            template)
    start = apply_resume_extra(extra_r, cfg, ckpt_step, anneal=spec)
    assert start == 5
    p_resumed, o_resumed = _train(step_fn, p_res, o_res, batches, bits,
                                  start=start, rng_base=rng_base)

    for a, b in zip(tree_leaves((p_full, o_full)),
                    tree_leaves((p_resumed, o_resumed))):
        assert torch.equal(a, b)
    # the ramp acted: the unannealed run ends elsewhere
    plain = make_train_step(cfg, policy, ocfg, device="cpu")
    p_plain, _ = _train(plain, params0, opt0, batches, bits,
                        rng_base=rng_base)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(p_plain),
                                                     tree_leaves(p_full)))


def test_driver_bit_search_writes_plans_jax_reads(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    losses = train.main(["--device", "cpu", "--reduced", "--quantize",
                         "--bit-search", "2", "--bit-probe-steps", "2",
                         "--steps", "2", "--seq-len", "32", "--ckpt-dir",
                         ck, "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    m = re.search(r"\[train\] bit-search \((\d+) probes, [\d.]+s\): (.*)", out)
    assert m, out
    assert "[bit-search] baseline loss" in out
    assert "[train] train<->serve int8 parity: OK" in out
    plan, jplan = BitPlan.load(f"{ck}/bit_plan.json"), JBitPlan.load(
        f"{ck}/bit_plan.json")
    assert jplan.to_json() == plan.to_json()
    assert plan.probes == int(m.group(1)) and plan.describe() == m.group(2)
    assert plan.num_layers == 4 and len(plan.groups) == 2
    assert plan.probe_steps == 2 and plan.target == 0.1
    sp = TE.load_serve_plan(f"{ck}/bit_plan_serve.json")
    jsp = JE.load_serve_plan(f"{ck}/bit_plan_serve.json")
    assert jsp.to_json() == sp.to_json() == TE.to_serve_plan(plan).to_json()
    # the JAX package's checks pass on the plan the port searched
    assert JE.verify_train_serve_parity(jplan)["ok"]


def test_driver_bit_search_defaults_match_jax():
    args = train._parser().parse_args(["--bit-search", "3"])
    assert (args.bit_search, args.bit_target, args.bit_probe_steps,
            args.bit_anneal) == (3, 0.1, 24, None)
    assert train._parser().parse_args([]).bit_search == 0
    cfg = get_config("qwen1.5-0.5b")
    assert train._reduce(cfg).num_layers == 4


def test_annealed_driver_kill_resumes_bitwise(tmp_path):
    """The driver with --bit-anneal (ramping across the kill and the
    resume) and --stochastic, killed at step 6 after its step-5
    checkpoint landed, resumes to the uninterrupted run's losses and checkpoint;
    a resume under another spec is refused before it takes a step."""
    common = ("--steps", "9", "--ckpt-every", "4", "--quantize",
              "--stochastic", "--lr", "3e-2", "--log-every", "1",
              "--kernel-backend", "int8", "--bit-anneal", "0:16,3:14,6:12")
    ref_ck, ck = tmp_path / "ref", tmp_path / "ck"
    ref = run_driver(*common, "--ckpt-dir", str(ref_ck))
    assert len(step_losses(ref.stdout)) == 9
    # step 5's batch is held back a second, so the step-5 checkpoint has
    # landed when the kill comes
    run_driver(*common, "--ckpt-dir", str(ck), "--fault-plan",
               "stall@5:1.0;crash@6", expect_code=FAULT_EXIT_CODE)
    assert not (ck / "step_00000009").exists()
    refused = run_driver(*common[:-1], "0:16,3:12", "--ckpt-dir", str(ck),
                         "--resume", expect_code=1)
    assert "annealed under '0:16,3:14,6:12'" in refused.stderr
    assert not step_losses(refused.stdout)
    resumed = run_driver(*common, "--ckpt-dir", str(ck), "--resume")
    assert "resumed from step 5" in resumed.stdout
    ref_l, res_l = step_losses(ref.stdout), step_losses(resumed.stdout)
    assert sorted(res_l) == list(range(5, 9))
    assert all(res_l[s] == ref_l[s] for s in res_l)
    cfg = train._reduce(get_config("qwen1.5-0.5b"))
    p = TLM.init_params(cfg, device="cpu")
    template = (p, init_train_state(p, OptimizerConfig(kind="momentum")))
    (a, _, ea), (b, _, eb) = (restore_checkpoint(d, template)
                              for d in (ref_ck, ck))
    assert ea["bit_anneal"] == eb["bit_anneal"] == "0:16,3:14,6:12"
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
