"""The port's kernel tune cache (``repro_torch.kernels.ops``), mirroring
``tests/test_tune_cache.py`` case by case, plus what the port adds.

A decision is the launch a kernel's own ``_plan`` picks for the card's SM
count (the K or token split, the cluster size, the chunk count), keyed by
the kernel, the shape, the datapath and the element sizes but not the SM
count.  Covered: decision stability through the cache (on a fresh cache
every decision is exactly ``_plan``'s, at any shape), snapshot/load with
``restored:`` provenance, the no-clobber rule, malformed entries, the dump
and ``REPRO_TUNE_CACHE``, priming (the train shapes are exactly what each
family's engine step hands the three training kernels, the serve shapes
what a paged decode hands the prologue, paged attention and the MLP),
replay through the checkpoint's resume ``extra`` and the paged serve
snapshot; the JAX package's and the port's payloads load into each other
without error, each skipping the other's kinds; a restored entry derived
for another SM count wins over a fresh ``_plan``.  Everything here is
exact (decisions are integers and names): no tolerance.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              init_train_state, make_train_step)
from repro_torch.core.steps import apply_resume_extra, capture_resume_extra
from repro_torch.kernels import bp_fused_unit as FU
from repro_torch.kernels import bp_gstep as GS
from repro_torch.kernels import common as KC
from repro_torch.kernels import decode_prologue as DP
from repro_torch.kernels import fxp_matmul as FM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import sgd_dw_update as SD
from repro_torch.kernels.ops import (clear_tune_cache, dump_tune_cache,
                                     load_tune_cache, prime_tune_cache,
                                     serve_tune_shapes, train_tune_shapes,
                                     tune_blocks, tune_cache_snapshot,
                                     tune_fused, tune_paged, tune_prologue)
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from test_models import tiny

N_SM = 132


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_tune_cache()
    JO.clear_tune_cache()
    yield
    clear_tune_cache()
    JO.clear_tune_cache()


def _tcfg(family="dense", **kw):
    return ModelConfig(**dataclasses.asdict(tiny(family, **kw)))


# ---------------------------------------------------------------------------
# Decisions are cached and stable
# ---------------------------------------------------------------------------

def test_decision_is_cached_and_stable():
    first = tune_blocks(32, 16, 48, n_sm=N_SM)
    assert first == FM._plan(32, 48, 16, N_SM, "emulate", 4, 4)
    snap = tune_cache_snapshot()
    assert len(snap) == 1
    (key, entry), = snap.items()
    assert key == "kind=fxp_matmul,m=32,n=16,k=48,dp=emulate,xb=4,wb=4"
    assert entry["source"] == "computed" and entry["sm"] == N_SM
    for _ in range(3):
        assert tune_blocks(32, 16, 48, n_sm=N_SM) == first
    assert len(tune_cache_snapshot()) == 1
    assert KC.tune_cache_stats() == {"hits": 3, "misses": 1, "entries": 1}


def test_every_shape_gets_a_cached_decision():
    """The JAX tuners cache a None for a shape that cannot tile (a prime
    dim, a misaligned head dim) and fall back to jnp; the port's kernels
    mask ragged edges, so those shapes get a launch, cached like any."""
    assert tune_blocks(7, 16, 48, n_sm=N_SM) == FM._plan(7, 48, 16, N_SM)
    assert tune_prologue(30, 4, 2, 30, n_sm=N_SM) == DP._plan(
        1, 30, 4, 2, 30, N_SM, "emulate", 2)
    snap = tune_cache_snapshot()
    assert len(snap) == 2
    assert all(e["decision"] is not None for e in snap.values())


# the fresh-cache decision of each kernel at odd, decode, LeNet and qwen
# shapes, against the kernel's own _plan, at two SM counts
PLAN_SHAPES = [(7, 13, 5), (8, 1024, 2816), (16, 896, 4864), (128, 784, 256),
               (1024, 896, 1024), (1024, 4864, 896), (5, 2816, 10)]


@pytest.mark.parametrize("n_sm", [114, 132])
def test_fresh_cache_decisions_are_plan_exactly(n_sm):
    for m, k, n in PLAN_SHAPES:
        for dp, xb, wb in (("int8", 1, 1), ("emulate", 2, 4),
                           ("emulate", 4, 2), ("emulate", 4, 4)):
            assert FM.tuned_plan(m, k, n, n_sm, dp, xb, wb) == FM._plan(
                m, k, n, n_sm, dp, xb, wb)
        for dp in ("int8", "emulate"):
            assert GS.tuned_plan(m, k, n, n_sm, dp) == GS._plan(
                m, k, n, n_sm, dp)
            assert SD.tuned_plan(m, k, n, n_sm, dp) == SD._plan(
                m, k, n, n_sm, dp)
            assert FU.tuned_plan(m, k, n, n_sm, dp) == FU._plan(
                m, k, n, n_sm, dp)
    for b in (1, 8, 9, 32):
        for dp, xb in (("int8", 2), ("emulate", 2), ("emulate", 4)):
            assert DP.tuned_plan(b, 1024, 16, 16, 64, n_sm, dp, xb) == \
                DP._plan(b, 1024, 16, 16, 64, n_sm, dp, xb)
    assert PA.tuned_chunks(17, 16, 32, 2, 64, 8, 1, n_sm) == len(
        PA._chunks(32, 16))
    # the public tuners resolve through the same entries
    assert tune_blocks(1024, 896, 4864, 1, kernel="bp_gstep",
                       n_sm=n_sm) == GS._plan(1024, 896, 4864, n_sm, "int8")
    assert tune_blocks(896, 4864, 1024, 1, kernel="sgd_dw_update",
                       n_sm=n_sm) == SD._plan(1024, 896, 4864, n_sm, "int8")
    assert tune_fused(128, 256, 256, 1, n_sm=n_sm) == FU._plan(
        128, 256, 256, n_sm, "int8")
    assert tune_paged(17, 16, 32, 2, 64, 8, 1, n_sm=n_sm) == 32 * 16 // 64


# ---------------------------------------------------------------------------
# Snapshot / load: provenance, no-clobber, overwrite
# ---------------------------------------------------------------------------

def test_snapshot_load_roundtrip_with_restored_provenance():
    want = tune_blocks(32, 16, 48, n_sm=N_SM)
    pro = tune_prologue(64, 4, 2, 16, n_sm=N_SM)
    snap = tune_cache_snapshot()
    clear_tune_cache()
    assert tune_cache_snapshot() == {}
    assert load_tune_cache(json.loads(json.dumps(snap))) == len(snap)
    # restored decisions replay identically and carry provenance
    assert tune_blocks(32, 16, 48, n_sm=N_SM) == want
    assert tune_prologue(64, 4, 2, 16, n_sm=N_SM) == pro
    after = tune_cache_snapshot()
    assert after.keys() == snap.keys()
    assert all(e["source"] == "restored:computed" and e["sm"] == N_SM
               for e in after.values())


def test_load_does_not_clobber_unless_overwrite():
    tune_blocks(32, 16, 48, n_sm=N_SM)
    (key, entry), = tune_cache_snapshot().items()
    fake = {key: dict(entry, decision=["tiled", 64, 16, 2, True, True])}
    assert load_tune_cache(fake) == 0              # existing entry wins
    assert tune_blocks(32, 16, 48, n_sm=N_SM).splits == 1
    assert load_tune_cache(fake, overwrite=True) == 1
    assert tune_blocks(32, 16, 48, n_sm=N_SM).splits == 2


def test_malformed_entries_are_skipped():
    good = {"kind=fxp_matmul,m=32,n=16,k=48,dp=emulate,xb=4,wb=4":
            {"decision": ["tiled", 64, 16, 1, True, True],
             "source": "computed", "sm": N_SM}}
    bad = {"not-a-key": {"decision": 1, "source": "x"},
           "kind=unknown,z=1": {"decision": 1, "source": "x"},
           "kind=fxp_matmul,m=oops,n=16,k=48,dp=emulate,xb=4,wb=4":
           {"decision": ["tiled", 64, 16, 1, True, True]},
           "kind=fxp_matmul,m=32,n=16,k=49,dp=f16,xb=4,wb=4":
           {"decision": ["tiled", 64, 16, 1, True, True]},
           "kind=fxp_matmul,m=32,n=16,k=50,dp=emulate,xb=4,wb=4":
           {"decision": [8]},
           "kind=paged_attention,n=1,bs=8,m=4,hkv=2,hd=16,g=2,item=4":
           {"decision": [1]},
           "kind=bp_gstep,m=8,n=8,k=8,dp=int8": {"source": "x"},
           # the JAX package's kinds are skipped too
           "kind=blocks,m=32,n=16,k=48,item=4,acc=4,db=True":
           {"decision": [32, 16, 48], "source": "computed"}}
    assert load_tune_cache({**bad, **good}) == 1
    assert KC.foreign_tune_entries({**bad, **good}) == 1
    assert tune_blocks(32, 16, 48, n_sm=N_SM) == FM.Plan(
        "tiled", 64, 16, 1, True, True)


# ---------------------------------------------------------------------------
# Dump / REPRO_TUNE_CACHE preload
# ---------------------------------------------------------------------------

def test_dump_and_env_preload(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    # a dump whose decision DIFFERS from what _plan derives, so that a
    # cache hit is observable
    tune_blocks(32, 16, 48, n_sm=N_SM)
    snap = tune_cache_snapshot()
    (key, _), = snap.items()
    dump_tune_cache(str(path))
    on_disk = json.loads(path.read_text())
    assert on_disk == snap
    on_disk[key]["decision"][3] = 4
    path.write_text(json.dumps(on_disk))

    clear_tune_cache()
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
    monkeypatch.setattr(KC, "_TUNE_ENV_LOADED", False)
    assert tune_blocks(32, 16, 48, n_sm=N_SM).splits == 4  # not derived
    (key2, entry), = tune_cache_snapshot().items()
    assert key2 == key and entry["source"] == "restored:computed"


# ---------------------------------------------------------------------------
# Driver priming
# ---------------------------------------------------------------------------

def test_prime_train_and_serve_shapes():
    cfg = _tcfg()
    primed = prime_tune_cache(train_tune_shapes(cfg, 8, 64), n_sm=N_SM)
    assert primed and all(k.startswith("kind=") for k in primed)
    assert {k.split(",")[0] for k in primed} == {
        "kind=fxp_matmul", "kind=bp_gstep", "kind=sgd_dw_update"}
    primed_s = prime_tune_cache(serve_tune_shapes(
        cfg, num_blocks=17, block_size=8, max_blocks_per_seq=4),
        n_sm=N_SM)
    assert any(k.startswith("kind=paged_attention") for k in primed_s)
    assert any(k.startswith("kind=decode_prologue") for k in primed_s)
    # priming again is pure cache hits: snapshot unchanged
    before = tune_cache_snapshot()
    misses = KC.tune_cache_stats()["misses"]
    prime_tune_cache(train_tune_shapes(cfg, 8, 64), n_sm=66)
    assert tune_cache_snapshot() == before
    assert KC.tune_cache_stats()["misses"] == misses


def _recorders(monkeypatch, seen):
    """Wrap the three training kernels as ``kernels.ops`` calls them; each
    call adds the cache key that its launch would look up."""
    def rec(kind, key_of, orig):
        def f(*a, **kw):
            seen.setdefault(kind, set()).add(
                key_of(*a[:2], kw.get("datapath", "emulate")))
            return orig(*a, **kw)
        return f
    monkeypatch.setattr(TO, "fxp_matmul", rec(
        "fxp_matmul", lambda x, w, dp: (x.shape[0], w.shape[1], x.shape[1],
                                        dp, x.element_size(),
                                        w.element_size()), TO.fxp_matmul))
    monkeypatch.setattr(TO, "bp_gstep", rec(
        "bp_gstep", lambda g, w, dp: (g.shape[0], w.shape[0], g.shape[1],
                                      dp), TO.bp_gstep))
    monkeypatch.setattr(TO, "sgd_dw_update", rec(
        "sgd_dw_update", lambda x, g, dp: (x.shape[1], g.shape[1],
                                           x.shape[0], dp),
        TO.sgd_dw_update))


@pytest.mark.parametrize("family,dtype", [
    ("dense", "bfloat16"), ("moe", "float32"), ("ssm", "float32"),
    ("hybrid", "float32"), ("encdec", "float32"), ("vlm", "bfloat16")])
def test_train_shapes_are_what_the_engine_launches(family, dtype,
                                                    monkeypatch):
    """One engine step of each family under both datapaths hands the
    training kernels exactly the keys ``train_tune_shapes`` primes."""
    torch.set_num_threads(1)
    cfg = _tcfg(family, compute_dtype=dtype)
    b, t = 2, 8
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)),
             "labels": rng.integers(0, cfg.vocab_size, (b, t))}
    if family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    seen = {}
    _recorders(monkeypatch, seen)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    ocfg = OptimizerConfig(kind="sgd")
    for backend in ("int8", "emulate"):
        step = make_train_step(cfg, QuantPolicy(grad_scale=64.0), ocfg,
                               StepOptions(kernel_backend=backend),
                               device="cpu")
        step(params, init_train_state(params, ocfg), batch,
             Hyper(lr=0.01, step=0), default_bits(cfg))
    want = {k: set(v) for k, v in train_tune_shapes(cfg, b, t).items()
            if v}
    assert seen == want


def test_serve_shapes_are_what_a_paged_decode_launches(monkeypatch):
    """A paged decode under both datapaths hands the prologue, paged
    attention and the MLP's fxp_matmul exactly the keys
    ``serve_tune_shapes`` primes (its prefill runs no kernel)."""
    from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                     ServeConfig)
    torch.set_num_threads(1)
    cfg = _tcfg("dense", compute_dtype="bfloat16", num_kv_heads=4)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    seen = {}
    _recorders(monkeypatch, seen)
    orig_pro, orig_pa = DP.fused_prologue, PA.paged_attention

    def pro(x2, nscale, wq2, wk2, wv2, biases, positions, *, wscales=None,
            **kw):
        seen.setdefault("decode_prologue", set()).add(
            (x2.shape[0], x2.shape[1], kw["h"], kw["hkv"], kw["hd"],
             "emulate" if wscales is None else "int8", x2.element_size()))
        return orig_pro(x2, nscale, wq2, wk2, wv2, biases, positions,
                        wscales=wscales, **kw)

    def pa(q, pool_l, tables, lens, *, groups, scale):
        n, bs, hkv, hd = pool_l["k"].shape
        seen.setdefault("paged_attention", set()).add(
            (n, bs, tables.shape[1], hkv, hd, groups,
             pool_l["k"].element_size()))
        return orig_pa(q, pool_l, tables, lens, groups=groups, scale=scale)
    monkeypatch.setattr(DP, "fused_prologue", pro)
    monkeypatch.setattr(PA, "paged_attention", pa)
    rng = np.random.default_rng(3)
    for backend in ("int8", "emulate"):
        sc = ServeConfig(num_slots=2, eos_id=None, max_len=32, mode="paged",
                         block_size=8, cache_dtype="bfloat16",
                         kernel_backend=backend, attn_impl="kernel")
        s = BatchScheduler(sc, EngineHooks.for_model(params, cfg, sc))
        s.submit(Request(uid=0, prompt=rng.integers(
            0, cfg.vocab_size, size=(9,)).astype(np.int32),
            max_new_tokens=3))
        s.run_until_drained()
    want = serve_tune_shapes(
        cfg, num_blocks=sc.resolved_num_blocks, block_size=sc.block_size,
        max_blocks_per_seq=sc.max_blocks_per_seq, cache_itemsize=2,
        num_slots=sc.num_slots)
    assert seen == {k: set(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# Replay through checkpoint resume extra and the serve snapshot
# ---------------------------------------------------------------------------

def test_checkpoint_extra_replays_tune_decisions(capsys):
    cfg = _tcfg()
    want = tune_blocks(32, 16, 48, n_sm=N_SM)
    extra = capture_resume_extra(cfg, 5)
    assert extra["tune_cache"]
    clear_tune_cache()
    assert apply_resume_extra(extra, cfg, 5) == 5
    assert "restored 1 tune-cache decision(s)" in capsys.readouterr().out
    assert tune_blocks(32, 16, 48, n_sm=N_SM) == want
    snap = tune_cache_snapshot()
    assert all(e["source"] == "restored:computed" for e in snap.values())


def test_serve_snapshot_replays_tune_decisions():
    """The serve driver primes the cache for a paged serve; the snapshot
    carries it as the JAX format's JSON bytes and a restore installs it."""
    from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                     ServeConfig)
    torch.set_num_threads(1)
    cfg = _tcfg()
    params = TLM.init_params(cfg, seed=0, device="cpu")
    sc = ServeConfig(num_slots=2, eos_id=None, max_len=32, mode="paged",
                     block_size=8, cache_dtype="float32",
                     kernel_backend="emulate")
    prime_tune_cache(serve_tune_shapes(
        cfg, num_blocks=sc.resolved_num_blocks, block_size=sc.block_size,
        max_blocks_per_seq=sc.max_blocks_per_seq, num_slots=sc.num_slots),
        n_sm=N_SM)
    hooks = EngineHooks.for_model(params, cfg, sc)
    s = BatchScheduler(sc, hooks)
    rng = np.random.default_rng(3)
    s.submit(Request(uid=0,
                     prompt=rng.integers(0, cfg.vocab_size,
                                         size=(9,)).astype(np.int32),
                     max_new_tokens=4))
    for _ in range(3):
        s.step()
    snap = s.snapshot()
    assert np.asarray(snap["tune_cache"]).size    # decisions rode along
    primed = tune_cache_snapshot()
    assert primed and json.loads(bytes(snap["tune_cache"])) == primed

    clear_tune_cache()
    restored = BatchScheduler.restore(snap, hooks=hooks)
    assert restored.config.kernel_backend == "emulate"
    after = tune_cache_snapshot()
    assert after.keys() == primed.keys()
    assert all(e["source"].startswith("restored:") for e in after.values())
    # the decisions themselves replay bit-for-bit
    assert {k: e["decision"] for k, e in after.items()} \
        == {k: e["decision"] for k, e in primed.items()}


# ---------------------------------------------------------------------------
# Across the packages, and across cards
# ---------------------------------------------------------------------------

def test_payloads_cross_load_between_the_packages(capsys):
    """The JAX package's payload (its train and serve kinds) installs
    nothing in the port and is counted; the port's installs nothing in
    the JAX package; neither raises.  Through the resume payloads too."""
    from repro.core.steps import apply_resume_extra as j_apply
    from repro.core.steps import capture_resume_extra as j_capture
    jcfg = tiny()
    JO.prime_tune_cache(JO.train_tune_shapes(jcfg, 8, 64))
    JO.prime_tune_cache(JO.serve_tune_shapes(
        jcfg, num_blocks=17, block_size=8, max_blocks_per_seq=4))
    jsnap = JO.tune_cache_snapshot()
    prime_tune_cache(train_tune_shapes(_tcfg(), 8, 64), n_sm=N_SM)
    tsnap = tune_cache_snapshot()
    assert jsnap and tsnap and not jsnap.keys() & tsnap.keys()

    assert load_tune_cache(jsnap) == 0
    assert KC.foreign_tune_entries(jsnap) == len(jsnap)
    assert tune_cache_snapshot() == tsnap
    assert JO.load_tune_cache(tsnap) == 0
    assert JO.tune_cache_snapshot() == jsnap

    j_extra = j_capture(jcfg, 3)
    t_extra = capture_resume_extra(_tcfg(), 3)
    clear_tune_cache()
    JO.clear_tune_cache()
    assert apply_resume_extra(j_extra, _tcfg(), 3) == 3
    assert j_apply(t_extra, jcfg, 3) == 3
    assert tune_cache_snapshot() == {} and JO.tune_cache_snapshot() == {}
    out = capsys.readouterr().out
    assert (f"restored 0 tune-cache decision(s) from checkpoint; skipped "
            f"{len(jsnap)} of the JAX package's") in out
    assert apply_resume_extra(t_extra, _tcfg(), 3) == 3
    assert tune_cache_snapshot().keys() == tsnap.keys()


def test_a_restored_entry_for_another_sm_count_wins():
    """Decisions derived for half an H100's SMs, restored, are what a
    launch on the full card resolves to: the split counts replay."""
    shapes = {"fxp_matmul": [(8, 2816, 1024, "int8", 1, 1)],
              "bp_gstep": [(1024, 896, 4864, "emulate")],
              "sgd_dw_update": [(896, 896, 1024, "emulate")]}
    half = prime_tune_cache(shapes, n_sm=66)
    snap = tune_cache_snapshot()
    assert all(e["sm"] == 66 for e in snap.values())
    clear_tune_cache()
    fresh = prime_tune_cache(shapes, n_sm=N_SM)
    assert fresh != half                   # the split counts differ
    clear_tune_cache()
    assert load_tune_cache(snap) == len(snap)
    assert FM.tuned_plan(8, 1024, 2816, N_SM, "int8", 1, 1) == FM._plan(
        8, 1024, 2816, 66, "int8", 1, 1)
    assert FM._plan(8, 1024, 2816, 66, "int8", 1, 1).splits != FM._plan(
        8, 1024, 2816, N_SM, "int8", 1, 1).splits
    assert GS.tuned_plan(1024, 896, 4864, N_SM, "emulate") == GS._plan(
        1024, 896, 4864, 66, "emulate")
    assert SD.tuned_plan(1024, 896, 896, N_SM, "emulate") == SD._plan(
        1024, 896, 896, 66, "emulate")
    assert prime_tune_cache(shapes, n_sm=N_SM) == half


def test_a_paged_chunk_count_the_kernel_cannot_take_is_refused():
    load_tune_cache({"kind=paged_attention,n=17,bs=16,m=32,hkv=2,hd=64,"
                     "g=8,item=1": {"decision": 3, "source": "computed"}})
    with pytest.raises(ValueError, match="the kernel takes 8"):
        tune_paged(17, 16, 32, 2, 64, 8, 1, n_sm=N_SM)
