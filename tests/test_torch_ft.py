"""Port of fault injection (``repro_torch.ft``), the straggler-tolerant
loader (``repro_torch.data``) and the resume payload
(``repro_torch.core.steps``), mirroring ``tests/test_fault_injection.py``
and the data tests of ``tests/test_fault_tolerance.py``; the plan and the
bit flip are also held to the JAX package's on the same specs and seeds.
"""
import shutil
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro.ft import FaultPlan as JFaultPlan
from repro.ft import flip_one_bit as j_flip
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.steps import (RESUME_SCHEMA, apply_resume_extra,
                                    capture_resume_extra)
from repro_torch.data import (DataProducerError, StragglerTolerantLoader,
                              SyntheticLMDataset)
from repro_torch.ft import (ENV_KNOB, FAULT_EXIT_CODE, FaultEvent, FaultPlan,
                            flip_one_bit)


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def test_fault_plan_parse_and_describe():
    p = FaultPlan.parse("crash@12;io@8x2;fsync@9;rename@9;stall@5:0.25;"
                        "flip@10;seed=7")
    assert p.seed == 7
    assert p.crash_step() == 12
    assert p.flip_steps() == [10]
    kinds = sorted(e.kind for e in p.events)
    assert kinds == ["crash", "flip", "fsync", "io", "rename", "stall"]
    assert "io@8x2" in p.describe()
    assert FaultEvent("stall", 5, 1, 0.25) in p.events


def test_fault_plan_seeded_random_crash_step_is_deterministic():
    a = FaultPlan.parse("crash@rand:8-20;seed=5").crash_step()
    b = FaultPlan.parse("crash@rand:8-20;seed=5").crash_step()
    c = FaultPlan.parse("crash@rand:8-20;seed=6").crash_step()
    assert a == b and 8 <= a < 20
    assert any(FaultPlan.parse(f"crash@rand:8-20;seed={s}").crash_step() != a
               for s in range(10))
    assert 8 <= c < 20


@pytest.mark.parametrize("spec", [
    "crash@12;io@8x2;fsync@9;rename@9;stall@5:0.25;flip@10;seed=7",
    "crash@rand:6-11;seed=5", "crash@rand:8-20;seed=3;flip@rand:1-9"])
def test_fault_plan_matches_the_jax_package(spec):
    """The same spec resolves to the same events in both packages, for
    every seed (the drills of either driver kill at the same step)."""
    for seed in range(12):
        s = f"{spec};seed={seed}"
        mine, ref = FaultPlan.parse(s), JFaultPlan.parse(s)
        assert [tuple(vars(e).values()) for e in mine.events] == [
            tuple(vars(e).values()) for e in ref.events]
        assert mine.describe() == ref.describe()


@pytest.mark.parametrize("bad", ["crash12", "io@x", "boom@3",
                                 "crash@rand:9-9"])
def test_fault_plan_bad_specs_rejected(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_fault_plan_env_and_flag(monkeypatch):
    monkeypatch.setenv(ENV_KNOB, "crash@3")
    assert FaultPlan.from_env(None).crash_step() == 3
    assert FaultPlan.from_env("crash@9").crash_step() == 9  # flag wins
    monkeypatch.delenv(ENV_KNOB)
    assert FaultPlan.from_env(None) is None


def test_ckpt_fault_budget_is_transient():
    p = FaultPlan.parse("io@4x2")
    with pytest.raises(OSError):
        p.ckpt_fault("io", 4)
    with pytest.raises(OSError):
        p.ckpt_fault("io", 4)
    p.ckpt_fault("io", 4)       # budget exhausted: no-op
    p.ckpt_fault("io", 5)       # other steps never fire
    p.ckpt_fault("fsync", 4)    # other kinds never fire
    assert p.fired == [("io", 4), ("io", 4)]


def test_wrap_fetch_stalls_only_the_planned_step():
    p = FaultPlan.parse("stall@2:0.2")
    fetch = p.wrap_fetch(lambda s: {"x": np.full((2,), s)})
    t0 = time.monotonic()
    fetch(1)
    fast = time.monotonic() - t0
    t0 = time.monotonic()
    out = fetch(2)
    slow = time.monotonic() - t0
    assert slow >= 0.2 > fast
    assert out["x"][0] == 2
    assert ("stall", 2) in p.fired


def test_flip_one_bit_matches_the_jax_package(tmp_path):
    """The same seed flips the same bit of the same file."""
    save_checkpoint(tmp_path / "a", 3, tree())
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for seed in (0, 1, 7):
        assert flip_one_bit(tmp_path / "a", 3, seed=seed) == j_flip(
            tmp_path / "b", 3, seed=seed)
    for f in sorted((tmp_path / "a" / "step_00000003").iterdir()):
        assert f.read_bytes() == (tmp_path / "b" / "step_00000003"
                                  / f.name).read_bytes(), f.name
    assert flip_one_bit(tmp_path / "a", 4) is None


def test_corrupt_checkpoint_only_at_planned_steps(tmp_path):
    save_checkpoint(tmp_path, 3, tree())
    plan = FaultPlan.parse("flip@5;seed=2")
    assert plan.corrupt_checkpoint(tmp_path, 3) is None
    save_checkpoint(tmp_path, 5, tree())
    assert plan.corrupt_checkpoint(tmp_path, 5) is not None


def test_fault_exit_code_is_distinct():
    assert FAULT_EXIT_CODE == 41 and FAULT_EXIT_CODE not in (0, 1, 2)


# ---------------------------------------------------------------------------
# Data: deterministic, sharded; the loader (test_fault_tolerance.py)
# ---------------------------------------------------------------------------

def test_data_pipeline_deterministic_and_sharded():
    ds_a = SyntheticLMDataset(100, 16, 8, seed=1, shard_id=0, num_shards=2)
    ds_b = SyntheticLMDataset(100, 16, 8, seed=1, shard_id=0, num_shards=2)
    ds_c = SyntheticLMDataset(100, 16, 8, seed=1, shard_id=1, num_shards=2)
    b1, b2, b3 = ds_a.batch_at(5), ds_b.batch_at(5), ds_c.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_straggler_loader_substitutes_on_deadline():
    def slow_fetch(step):
        if step == 2:
            time.sleep(1.0)  # straggling host
        return {"x": np.full((2,), step)}

    loader = StragglerTolerantLoader(slow_fetch, deadline_s=0.25, prefetch=1)
    try:
        assert loader.get(0)["x"][0] == 0
        assert loader.get(1)["x"][0] == 1
        t0 = time.time()
        got = loader.get(2)  # producer stalled: substitute within deadline
        assert time.time() - t0 < 0.9
        assert loader.skips >= 1 and got["x"][0] == 1
    finally:
        loader.close()


def test_loader_propagates_producer_exception():
    def fetch(step):
        if step == 2:
            raise RuntimeError("disk on fire")
        return {"x": np.full((2,), step)}

    loader = StragglerTolerantLoader(fetch, deadline_s=2.0, prefetch=1)
    try:
        assert loader.get(0)["x"][0] == 0
        assert loader.get(1)["x"][0] == 1
        with pytest.raises(DataProducerError, match="disk on fire"):
            loader.get(2)
        # latched: every later get re-raises instead of serving stale data
        with pytest.raises(DataProducerError):
            loader.get(3)
    finally:
        loader.close()


def test_loader_discards_late_batch_for_skipped_step():
    gate = threading.Event()

    def fetch(step):
        if step == 2:
            gate.wait(5.0)  # straggler, released mid-test
        return {"x": np.full((2,), step)}

    loader = StragglerTolerantLoader(fetch, deadline_s=0.25, prefetch=1)
    try:
        assert loader.get(0)["x"][0] == 0
        assert loader.get(1)["x"][0] == 1
        sub = loader.get(2)           # deadline hit: substitute last batch
        assert sub["x"][0] == 1 and loader.skips == 1
        gate.set()                    # the late batch for step 2 now lands
        got = loader.get(3)           # ... and must be DISCARDED, not served
        assert got["x"][0] == 3
        assert loader.stale_drops >= 1
    finally:
        loader.close()


def test_loader_start_step_resumes_stream():
    loader = StragglerTolerantLoader(
        lambda s: {"x": np.full((2,), s)}, deadline_s=5.0, start_step=10)
    try:
        assert loader.get(10)["x"][0] == 10
        assert loader.get(11)["x"][0] == 11
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# The resume payload (without the transport cache)
# ---------------------------------------------------------------------------

def test_capture_and_apply_resume_extra(tmp_path, capsys):
    cfg = get_config("qwen1.5-0.5b")
    loader = StragglerTolerantLoader(lambda s: {"x": np.zeros(2)},
                                     deadline_s=2.0)
    loader.get(0)
    extra = capture_resume_extra(cfg, 7, loader=loader,
                                 user_extra={"loss": 1.5})
    loader.close()
    assert extra["resume_schema"] == RESUME_SCHEMA
    assert extra["arch"] == cfg.name and extra["data_step"] == 7
    assert extra["loss"] == 1.5 and extra["loader"]["served"] == 1
    assert extra["transport_cache"] == {} and extra["tune_cache"] == {}

    # it round-trips the checkpoint manifest
    save_checkpoint(tmp_path, 7, tree(), extra=extra)
    _, _, extra2 = restore_checkpoint(tmp_path, tree())
    assert extra2 == extra
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert apply_resume_extra(extra2, cfg, 7) == 7
    assert capsys.readouterr().out == ""  # empty caches: nothing to say

    with pytest.raises(ValueError, match="refusing to resume"):
        apply_resume_extra({"arch": cfg.name}, get_config("gemma-7b"), 7)
    # pre-schema checkpoints fall back to the checkpoint step
    assert apply_resume_extra({}, cfg, 9) == 9
    assert apply_resume_extra(None, cfg, 4) == 4


def test_apply_resume_extra_of_a_jax_payload(capsys):
    """A JAX-written payload's caches are named in one line and not
    installed; its bit-anneal spec gets the JAX package's warning."""
    cfg = get_config("qwen1.5-0.5b")
    extra = {"arch": cfg.name, "data_step": 12,
             "transport_cache": {"compressed=False,bytes=8192,g=4":
                                 {"transport": "ring"}},
             "tune_cache": {"a": {}, "b": {}}}
    assert apply_resume_extra(extra, cfg, 12) == 12
    out = capsys.readouterr().out.splitlines()
    assert out == ["[train] checkpoint carries 1 transport-cache and 2 "
                   "tune-cache decision(s); the port has no tuner and does "
                   "not install them"]
    with pytest.warns(RuntimeWarning, match="bit-anneal mismatch"):
        assert apply_resume_extra({"bit_anneal": "0:16,100:12"}, cfg, 3) == 3
