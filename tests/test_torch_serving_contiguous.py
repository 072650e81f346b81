"""Port parity of contiguous serving and scheduler snapshot/restore: the
contiguous cache's layers (``fill_ring``, the one-token decode), the
engine's ``prefill`` / ``decode_step`` / ``greedy_generate``, the
scheduler's contiguous mode and legacy constructor, ``snapshot`` /
``restore`` in both modes through either package's checkpoint layer, and
the serve CLI's ``--mode``, against the JAX package on the CPU.

Model, parameters and prompts as ``tests/test_torch_serving.py`` (the
reduced qwen1.5-0.5b twin with 2 KV heads, f32 compute, JAX's initializer
through ``params_from_numpy``, numpy prompts from a seed).

Tolerances, and why:
  * logits, f32 compute and f32 KV: |d| <= 1e-4 * max|ref| (the
    frameworks sum in other orders; observed <= 1e-6).
  * the int8 decode backend (the fused prologue's and the MLP's int8
    operands) or an int8 KV cache (JAX's unscaled cast, mirrored): a value
    at a rounding or truncation edge may land one int8 step away in the
    other framework; |d| <= 2e-2 * max|ref| (observed <= 1e-6).
  * token streams and continued streams after a restore: exactly equal.
    Contiguous mode's one decode position is defined only for
    equal-length prompts admitted together, so every contiguous stream
    here uses equal-length prompts (as ``tests/test_paging.py`` does).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore
from repro.ckpt import save_checkpoint as j_save
from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.serving import BatchScheduler as JSched
from repro.serving import EngineHooks as JHooks
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving import engine as JE
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops as TO
from repro_torch.launch import serve as TSERVE
from repro_torch.models import layers as TL
from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                 ServeConfig, decode_step, greedy_generate,
                                 init_decode_state, prefill)

from test_torch_serving import _cfgs, _close, _params

CACHES = {"float32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


def _setup():
    jc, tc = _cfgs(2)
    jp, tp = _params(jc)
    return jc, tc, jp, tp


def _prompts(seed, n, length, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(length,)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("t,length", [(5, 8), (8, 8), (13, 8)])
def test_fill_ring_matches_jax(t, length):
    k = np.random.default_rng(t).standard_normal((2, t, 3, 4)).astype(
        np.float32)
    got = TL.fill_ring(torch.from_numpy(k), length)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.fill_ring(k, length)))


@pytest.mark.parametrize("backend,cache", [("off", "float32"),
                                           ("int8", "float32"),
                                           ("off", "int8")])
def test_prefill_and_decode_match_jax(backend, cache):
    """Prefill 16 tokens of two rows, then 6 decode steps, the decode under
    ``backend`` (the fused prologue and the MLP's dense unit)."""
    jc, tc, jp, tp = _setup()
    jd, td = CACHES[cache]
    frac = 1e-4 if (backend, cache) == ("off", "float32") else 2e-2
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 24)).astype(np.int32)
    jl, js = JE.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :16])}, 32,
                        jd, kernel_backend=backend)
    tl, ts = prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :16])}, 32,
                     td, kernel_backend=backend)
    _close(tl, jl, frac)
    assert ts["caches"]["k"].shape == js["caches"]["k"].shape
    assert ts["caches"]["k"].dtype == td and int(ts["pos"]) == 16
    for i in range(6):
        tok = toks[:, 16 + i:17 + i]
        with JO.kernel_backend_ctx(backend):
            jl, js = JE.decode_step(jp, jc, js, jnp.asarray(tok))
        with TO.kernel_backend_ctx(backend, "cpu"):
            tl, ts = decode_step(tp, tc, ts, torch.from_numpy(tok))
        _close(tl, jl, frac)
    assert int(ts["pos"]) == int(js["pos"]) == 22
    _close(ts["caches"]["v"], js["caches"]["v"], frac)


def test_greedy_generate_tokens_equal_jax():
    jc, tc, jp, tp = _setup()
    toks = np.stack(_prompts(1, 2, 10, jc.vocab_size))
    want = JE.greedy_generate(jp, jc, {"tokens": jnp.asarray(toks)}, 24, 8,
                              jnp.float32)
    got = greedy_generate(tp, tc, {"tokens": torch.from_numpy(toks)}, 24, 8,
                          torch.float32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_caches_raise():
    """The encdec and vlm caches wait for ROADMAP A9e; since A9d an MLA
    model's contiguous state holds the latent cache in JAX's shapes."""
    jc, tc, _, _ = _setup()
    for kw in (dict(family="encdec"), dict(family="vlm")):
        with pytest.raises(NotImplementedError, match="ROADMAP A9e"):
            init_decode_state(dataclasses.replace(tc, **kw), 2, 16,
                              device="cpu")
    mla = dict(use_mla=True, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
               v_head_dim=8)
    got = init_decode_state(dataclasses.replace(tc, **mla), 2, 16,
                            device="cpu")["caches"]
    ref = JE.init_decode_state(dataclasses.replace(jc, **mla), 2, 16,
                               jnp.bfloat16)["caches"]
    assert set(got) == set(ref) == {"ckv", "kpe"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape


# ---------------------------------------------------------------------------
# the scheduler's contiguous mode
# ---------------------------------------------------------------------------

def _serve(mode, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("eos_id", None)
    kw.setdefault("max_len", 32)
    kw.setdefault("cache_dtype", "float32")
    if mode == "paged":
        kw.setdefault("block_size", 8)
        kw.setdefault("prefill_chunk", 5)
    return kw


def _port_sched(tp, tc, mode, **kw):
    sc = ServeConfig(mode=mode, **_serve(mode, **kw))
    return BatchScheduler(sc, EngineHooks.for_model(tp, tc, sc))


def _jax_sched(jp, jc, mode, **kw):
    sc = JServe(mode=mode, **_serve(mode, **kw))
    return JSched(sc, JHooks.for_model(jp, jc, sc))


def _submit(sched, prompts, cls=Request, max_new=8):
    reqs = [cls(uid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    return reqs


def _drain(sched, prompts, cls=Request):
    _submit(sched, prompts, cls)
    return {r.uid: list(r.generated) for r in sched.run_until_drained()}


def test_contiguous_streams_match_jax_and_the_paged_streams():
    """Four equal-length prompts on two slots: the port's contiguous
    streams equal JAX's, and the port's paged (chunked prefill) streams
    equal its contiguous ones (as ``tests/test_paging.py:180``)."""
    jc, tc, jp, tp = _setup()
    prompts = _prompts(2, 4, 12, jc.vocab_size)
    ref = _drain(_jax_sched(jp, jc, "contiguous"), prompts, JRequest)
    got = _drain(_port_sched(tp, tc, "contiguous"), prompts)
    paged = _port_sched(tp, tc, "paged")
    assert len(got) == 4 and got == ref
    assert _drain(paged, prompts) == got
    assert paged.stats["prefill_tokens"] == 4 * 12


def test_legacy_constructor_and_eos_sentinel_warn():
    jc, tc, jp, tp = _setup()
    prompts = _prompts(3, 2, 6, jc.vocab_size)
    state = init_decode_state(tc, 2, 32, torch.float32, device="cpu")

    def prefill_one(tokens):
        return prefill(tp, tc, {"tokens": tokens}, 32, torch.float32)

    def decode_fn(state, toks):
        return decode_step(tp, tc, state, toks)

    def merge_fn(state, slot_state, i):
        for k, dst in state["caches"].items():
            dst[:, i] = slot_state["caches"][k][:, 0]
        return {"caches": state["caches"], "pos": slot_state["pos"]}

    with pytest.warns(DeprecationWarning) as rec:
        legacy = BatchScheduler(2, prefill_one, decode_fn, merge_fn, state)
    assert len(rec) == 2  # the constructor and the eos_id=-1 sentinel
    assert legacy.eos_id is None and legacy.config.mode == "contiguous"
    assert legacy.prefill_fn is prefill_one and legacy.merge_fn is merge_fn
    assert _drain(legacy, prompts) == _drain(
        _port_sched(tp, tc, "contiguous"), prompts)
    with pytest.warns(DeprecationWarning, match="eos_id=-1"):
        assert ServeConfig(num_slots=1, eos_id=-1).eos_id is None
    with pytest.raises(TypeError, match="ServeConfig, EngineHooks"):
        BatchScheduler(ServeConfig(num_slots=1, eos_id=None), None)


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------

def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return np.asarray(tree)


def _mid_stream(sched, prompts, steps, cls=Request):
    """Submit, run ``steps`` ticks, snapshot; returns (requests, snap)."""
    reqs = _submit(sched, prompts, cls)
    for _ in range(steps):
        sched.step()
    snap = sched.snapshot()
    assert len(snap["slot_reqs"]) > 0 and len(snap["pending"]) > 0
    assert any(not d["done"] for d in snap["slot_reqs"])
    return reqs, snap


def _continue(resumed, reqs):
    """Streams of the requests that finished before the snapshot and of
    the resumed scheduler's run to the end."""
    out = {r.uid: list(r.generated) for r in reqs if r.done}
    out.update({r.uid: list(r.generated)
                for r in resumed.run_until_drained()})
    return out


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_snapshot_restore_continues_identically(tmp_path, mode):
    """Snapshot mid-stream, through the port's checkpoint layer, restore
    into a fresh scheduler: the continued streams equal the uninterrupted
    run's, and continuing does not write through into the snapshot."""
    jc, tc, jp, tp = _setup()
    prompts = _prompts(4, 4, 11, jc.vocab_size)
    ref = _drain(_port_sched(tp, tc, mode), prompts)
    assert len(ref) == 4

    reqs, snap = _mid_stream(_port_sched(tp, tc, mode), prompts, 4)
    kept = copy.deepcopy(snap)
    save_checkpoint(tmp_path, 1, snap)
    loaded, _, _ = restore_checkpoint(tmp_path, _as_numpy(snap))
    hooks = EngineHooks.for_model(tp, tc, ServeConfig(
        mode=mode, **_serve(mode)))
    resumed = BatchScheduler.restore(loaded, hooks=hooks)
    assert _continue(resumed, reqs) == ref
    _same_tree(snap, kept)
    # the in-memory snapshot restores too, and stays unchanged
    again = BatchScheduler.restore(snap, hooks=hooks)
    again.run_until_drained()
    _same_tree(snap, kept)
    if mode == "paged":
        assert bytes(snap["tune_cache"]) == b"{}"
        assert all(isinstance(v, int) for v in snap["serve"].values())


def test_bf16_cache_snapshot_restores_bf16():
    """numpy has no bfloat16: the snapshot holds the bf16 cache widened to
    f32, exactly, and the restore casts it back into the hooks' dtype."""
    jc, tc, jp, tp = _setup()
    prompts = _prompts(5, 4, 9, jc.vocab_size)
    ref = _drain(_port_sched(tp, tc, "contiguous", cache_dtype="bfloat16"),
                 prompts)
    sched = _port_sched(tp, tc, "contiguous", cache_dtype="bfloat16")
    reqs, snap = _mid_stream(sched, prompts, 3)
    assert snap["state"]["caches"]["k"].dtype == np.float32
    np.testing.assert_array_equal(
        snap["state"]["caches"]["k"],
        sched.state["caches"]["k"].to(torch.float32).numpy())
    hooks = EngineHooks.for_model(tp, tc, ServeConfig(
        mode="contiguous", **_serve("contiguous", cache_dtype="bfloat16")))
    resumed = BatchScheduler.restore(snap, hooks=hooks)
    assert resumed.state["caches"]["k"].dtype == torch.bfloat16
    assert _continue(resumed, reqs) == ref


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_snapshots_cross_between_the_packages(tmp_path, mode):
    """A JAX snapshot restored by the port, and a port snapshot restored by
    JAX, each through the other's checkpoint layer, continue the stream
    identically."""
    jc, tc, jp, tp = _setup()
    prompts = _prompts(6, 4, 10, jc.vocab_size)
    ref = _drain(_jax_sched(jp, jc, mode), prompts, JRequest)

    jreqs, jsnap = _mid_stream(_jax_sched(jp, jc, mode), prompts, 4,
                               JRequest)
    j_save(tmp_path / "jax", 1, jsnap)
    loaded, _, _ = restore_checkpoint(tmp_path / "jax", _as_numpy(jsnap))
    hooks = EngineHooks.for_model(tp, tc, ServeConfig(
        mode=mode, **_serve(mode)))
    assert _continue(BatchScheduler.restore(loaded, hooks=hooks),
                     jreqs) == ref

    treqs, tsnap = _mid_stream(_port_sched(tp, tc, mode), prompts, 4)
    save_checkpoint(tmp_path / "port", 1, tsnap)
    template = jax.tree.map(np.asarray, tsnap)
    loaded, _, _ = j_restore(tmp_path / "port", template)
    jhooks = JHooks.for_model(jp, jc, JServe(mode=mode, **_serve(mode)))
    if mode == "contiguous":
        resumed = JSched.restore(loaded, jhooks.prefill, jhooks.decode,
                                 jhooks.merge)
    else:
        resumed = JSched.restore(loaded, hooks=jhooks)
    assert _continue(resumed, treqs) == ref


# ---------------------------------------------------------------------------
# the serve CLI's --mode
# ---------------------------------------------------------------------------

def test_serve_mode_contiguous_on_cpu():
    common = ["--device", "cpu", "--reduced", "--requests", "4",
              "--slots", "2", "--prompt-len", "10", "--max-new", "5",
              "--max-len", "32", "--kernel-backend", "int8"]
    con = TSERVE.main(common + ["--mode", "contiguous"])
    pag = TSERVE.main(common + ["--mode", "paged"])
    auto = TSERVE.main(common)
    assert con["mode"] == "contiguous" and auto["mode"] == "paged"
    assert len(con["finished"]) == 4 and con["tokens"] == 4 * 5
    streams = {m: {r.uid: r.generated for r in rep["finished"]}
               for m, rep in (("c", con), ("p", pag), ("a", auto))}
    assert streams["c"] == streams["p"] == streams["a"]


@pytest.mark.parametrize("extra", [["--prompt-len-max", "20"],
                                   ["--eos-id", "3"]])
def test_serve_contiguous_refuses_unequal_prompts(extra, capsys):
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--device", "cpu", "--reduced", "--mode", "contiguous",
                     *extra])
    assert e.value.code == 2
    assert "one position" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b"])
def test_serve_reduced_window_and_moe(arch):
    """The reduced twins of a dense model with a sliding window and of the
    moe family serve through the CLI: ``--mode auto`` is contiguous (a
    window keeps its ring), every request finishes, and the streams equal
    the port's greedy generation of each prompt on the served weights;
    ``--mode paged`` raises, as JAX's does."""
    cfg = t_get_config(arch)
    assert cfg.swa_window == 4096 and cfg.family == (
        "moe" if arch == "mixtral-8x7b" else "dense")
    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--slots", "2",
            "--requests", "4", "--prompt-len", "10", "--max-new", "5"]
    rep = TSERVE.main(argv)
    assert rep["mode"] == "contiguous" and rep["tokens"] == 4 * 5
    got = {r.uid: r.generated for r in rep["finished"]}
    prompts = TSERVE.make_prompts(np.random.default_rng(0), 4,
                                  rep["cfg"].vocab_size, 10, 10, 0)
    want = greedy_generate(rep["params"], rep["cfg"], {
        "tokens": torch.from_numpy(np.stack(prompts))}, 64, 5,
        torch.float32)
    assert [got[i] for i in range(4)] == want.tolist()
    with pytest.raises(ValueError, match="paged KV unsupported"):
        TSERVE.main(argv + ["--mode", "paged"])


def test_kernel_entry_points_per_layer(monkeypatch):
    """The launches chip_smoke.py holds the card's contiguous serve to
    (CONT_PREFILL_LAUNCHES, CONT_DECODE_LAUNCHES, for 24 layers): a prefill
    under "int8" runs 7 dense units a layer (q, k, v, o, gate, up, down); a
    decode step under "int8" runs the fused prologue once and the MLP's 3
    units a layer, and never the paged-attention kernel."""
    import sys

    from test_torch_engine import ROOT
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import decode_prologue as TDP
    from repro_torch.kernels import paged_attention as TPA

    _, tc, _, tp = _setup()
    calls = {"dense_fwd": 0, "fused_prologue": 0, "paged_attention": 0}
    for mod, name in ((TO, "dense_fwd"), (TDP, "fused_prologue"),
                      (TPA, "paged_attention")):
        orig = getattr(mod, name)

        def wrap(*a, _o=orig, _n=name, **kw):
            calls[_n] += 1
            return _o(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    toks = torch.from_numpy(np.stack(_prompts(7, 2, 12, tc.vocab_size)))
    _, state = prefill(tp, tc, {"tokens": toks}, 32, torch.bfloat16,
                       kernel_backend="int8")
    per_layer = {k: v // 24 for k, v in CS.CONT_PREFILL_LAUNCHES.items()}
    assert calls == {"dense_fwd": per_layer["fxp_matmul"] * tc.num_layers,
                     "fused_prologue": 0, "paged_attention": 0}
    calls.update(dense_fwd=0)
    with TO.kernel_backend_ctx("int8", "cpu"):
        decode_step(tp, tc, state, toks[:, :1])
    per_layer = {k: v // 24 for k, v in CS.CONT_DECODE_LAUNCHES.items()}
    assert calls == {
        "dense_fwd": per_layer["fxp_matmul"] * tc.num_layers,
        "fused_prologue": per_layer["decode_prologue"] * tc.num_layers,
        "paged_attention": 0}
