"""Port parity of ssm and hybrid serving on the CPU: the engine's contiguous
``prefill`` / ``decode_step`` / ``greedy_generate`` for both families, the
scheduler's contiguous mode (``merge`` on each leaf's batch axis),
``snapshot`` / ``restore``, the serve CLI and the family guards, against
the JAX package.

Configs, parameters and prompts as ``tests/test_torch_ssm.py``:
``tiny("ssm")`` and ``tiny("hybrid")`` (f32, and a bf16 twin), JAX's
initial weights through ``params_from_numpy``, numpy prompts from a seed.

Tolerances, and why:
  * decode logits against the port's own full forward, backend off, f32
    cache: |d| <= 2e-3 + 2e-3 |ref| (``tests/test_serving.py::
    test_decode_matches_forward``'s; the chunked SSD and the one-token
    recurrence sum in other orders).
  * logits against JAX, f32 compute and cache: |d| <= 1e-4 * max|ref|
    (the contiguous suite's; observed <= 1e-6).
  * the int8 backend (the shared block's fused prologue and dense units)
    or an int8 cache (JAX's unscaled cast, mirrored): a value at a
    rounding or truncation edge may land one int8 step away in the other
    framework: |d| <= 2e-2 * max|ref| (the contiguous suite's).
  * bf16 compute and cache, against JAX run op by op: |d|/|ref| <= 1e-2
    in L2 (``tests/test_torch_ssm.py``'s).
  * token streams, and streams continued after a restore: exactly equal.
    Contiguous mode's one decode position is defined only for
    equal-length prompts admitted together, so every stream here uses
    equal-length prompts.
"""
import copy
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_models import tiny  # noqa: E402
from test_torch_engine import ROOT  # noqa: E402

from repro.ckpt import save_checkpoint as j_save  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.serving import BatchScheduler as JSched  # noqa: E402
from repro.serving import EngineHooks as JHooks  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServe  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.ckpt import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (default_bits, init_train_state,  # noqa: E402
                              make_train_step)
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.optim import Hyper, OptimizerConfig  # noqa: E402
from repro_torch.serving import (BatchScheduler, EngineHooks,  # noqa: E402
                                 Request, ServeConfig, decode_step,
                                 greedy_generate, init_decode_state, prefill)
from repro_torch.serving import engine as TE  # noqa: E402

FAMILIES = ["ssm", "hybrid"]
CACHES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
T_CTX, T_TOTAL, MAX_LEN = 16, 24, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs files on parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family, dtype="float32"):
    jc = tiny(family, compute_dtype=dtype)
    return jc, TMC(**dataclasses.asdict(jc))


_PARAMS = {}


def _params(family):
    if family not in _PARAMS:
        jc, _ = _cfgs(family)
        jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.key(0),
                                                        jc)
        _PARAMS[family] = (jp, TLM.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[family]


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, frac):
    g, r = _np32(got), _np32(ref)
    assert g.shape == r.shape and np.isfinite(g).all()
    err = np.abs(g - r).max()
    assert err <= frac * np.abs(r).max(), (err, np.abs(r).max())


def _rel_close(got, ref, tol):
    g, r = _np32(got), _np32(ref)
    assert g.shape == r.shape and np.isfinite(g).all()
    rel = np.linalg.norm(g - r) / np.linalg.norm(r)
    assert rel <= tol, rel


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _prompts(seed, n, length, vocab):
    return list(_tokens(seed, n, length, vocab))


# ---------------------------------------------------------------------------
# the engine: prefill + decode
# ---------------------------------------------------------------------------

def _port_decode_logits(tp, tc, toks, cache, backend):
    """Prefill T_CTX tokens, then decode the rest one at a time under
    ``backend``: the logits after each of tokens T_CTX-1 .. T_TOTAL-2."""
    td = CACHES[cache][1]
    logits, state = prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :T_CTX])}, MAX_LEN, td, kernel_backend=backend)
    out = [logits]
    for i in range(T_TOTAL - T_CTX - 1):
        with TO.kernel_backend_ctx(backend, "cpu"):
            logits, state = decode_step(tp, tc, state, torch.from_numpy(
                toks[:, T_CTX + i:T_CTX + i + 1]))
        out.append(logits)
    return torch.stack(out, dim=1), state


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_matches_forward(family):
    """The port's prefill + one-token decode against its own full forward
    (``tests/test_serving.py::test_decode_matches_forward``)."""
    _, tc = _cfgs(family)
    _, tp = _params(family)
    toks = _tokens(0, 2, T_TOTAL, tc.vocab_size)
    dec, state = _port_decode_logits(tp, tc, toks, "float32", "off")
    x = TLM.forward_hidden(tp, tc, {"tokens": torch.from_numpy(toks)})
    full = (x @ TLM.head_weight(tp, tc)).to(torch.float32)
    ref = full[:, T_CTX - 1:T_TOTAL - 1]
    np.testing.assert_allclose(dec.numpy(), ref.detach().numpy(),
                               atol=2e-3, rtol=2e-3)
    assert int(state["pos"]) == T_TOTAL - 1


def _jax_decode_logits(jp, jc, toks, cache, backend, op_by_op):
    jd = CACHES[cache][0]

    def run():
        logits, state = JE.prefill(jp, jc, {"tokens": jnp.asarray(
            toks[:, :T_CTX])}, MAX_LEN, jd, kernel_backend=backend)
        out = [logits]
        step = (JE.decode_step if op_by_op else
                jax.jit(lambda s, t: JE.decode_step(jp, jc, s, t)))
        for i in range(T_TOTAL - T_CTX - 1):
            tok = jnp.asarray(toks[:, T_CTX + i:T_CTX + i + 1])
            with JO.kernel_backend_ctx(backend):
                if op_by_op:
                    logits, state = step(jp, jc, state, tok)
                else:
                    logits, state = step(state, tok)
            out.append(logits)
        return jnp.stack(out, axis=1), state

    if op_by_op:
        with jax.disable_jit():
            return run()
    return run()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("backend,cache", [("off", "float32"),
                                           ("int8", "float32"),
                                           ("off", "int8")])
def test_prefill_and_decode_match_jax(family, backend, cache):
    """Prefill 16 tokens of two rows, then 7 decode steps under
    ``backend``, against JAX's prefill and decode: logits, ``pos`` and
    every cache leaf (keys, shapes, dtypes, values)."""
    jc, tc = _cfgs(family)
    jp, tp = _params(family)
    frac = 1e-4 if (backend, cache) == ("off", "float32") else 2e-2
    toks = _tokens(1, 2, T_TOTAL, jc.vocab_size)
    got, ts = _port_decode_logits(tp, tc, toks, cache, backend)
    ref, js = _jax_decode_logits(jp, jc, toks, cache, backend, False)
    _close(got, ref, frac)
    assert int(ts["pos"]) == int(js["pos"]) == T_TOTAL - 1
    jl = jax.tree_util.tree_leaves_with_path(js["caches"])
    assert len(jl) == (4 if family == "hybrid" else 2)
    for path, leaf in jl:
        t = ts["caches"]
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype) == f"torch.{np.dtype(leaf.dtype).name}"
        if leaf.dtype == jnp.int8:
            # a truncation edge may move an element by one
            assert np.abs(_np32(t) - _np32(leaf)).max() <= 1
        else:
            _close(t, leaf, frac)


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_and_decode_bf16_match_jax_op_by_op(family):
    jc, tc = _cfgs(family, "bfloat16")
    jp, tp = _params(family)
    toks = _tokens(2, 2, T_TOTAL, jc.vocab_size)
    got, ts = _port_decode_logits(tp, tc, toks, "bfloat16", "off")
    ref, js = _jax_decode_logits(jp, jc, toks, "bfloat16", "off", True)
    _rel_close(got, ref, 1e-2)
    leaf = ts["caches"]["mamba"] if family == "hybrid" else ts["caches"]
    assert leaf["h"].dtype == torch.float32
    assert leaf["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_generate_tokens_equal_jax(family):
    jc, tc = _cfgs(family)
    jp, tp = _params(family)
    toks = _tokens(3, 2, 10, jc.vocab_size)
    want = jax.jit(lambda p, t: JE.greedy_generate(
        p, jc, {"tokens": t}, MAX_LEN, 8, jnp.float32))(jp, jnp.asarray(toks))
    got = greedy_generate(tp, tc, {"tokens": torch.from_numpy(toks)},
                          MAX_LEN, 8, torch.float32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_state_layout_matches_jax_and_ssm_state_is_context_free(
        family):
    """Keys, shapes and dtypes of the zeroed state equal JAX's; the Mamba
    state's size does not depend on max_len (``tests/test_serving.py::
    test_long_context_state_is_constant_size_for_ssm``)."""
    jc, tc = _cfgs(family)
    for cache in ("bfloat16", "int8"):
        jd, td = CACHES[cache]
        ref = JE.init_decode_state(jc, 3, MAX_LEN, jd)
        got = init_decode_state(tc, 3, MAX_LEN, td, device="cpu")
        assert jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype).name),
                            ref["caches"]) == jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype)[6:]), got["caches"],
            is_leaf=torch.is_tensor)
        assert int(got["pos"]) == 0

    def mamba_numel(max_len):
        st = init_decode_state(tc, 1, max_len, device="cpu")["caches"]
        st = st["mamba"] if family == "hybrid" else st
        return sum(t.numel() for t in st.values())
    assert mamba_numel(8) == mamba_numel(65536)
    if family == "ssm":
        small = init_decode_state(tc, 1, 8, device="cpu")
        big = init_decode_state(tc, 1, 65536, device="cpu")
        assert sum(t.numel() for t in small["caches"].values()) == sum(
            t.numel() for t in big["caches"].values())


def test_merge_slot_writes_each_leafs_batch_axis():
    """A one-row hybrid prefill merged into slot 1 of 3: every attention
    leaf [G, B, ...] and every Mamba leaf [G, K, B, ...] of slot 1 equals
    the prefill's, at every group and layer, and slots 0 and 2 stay zero
    (JAX's ``dst[:, i]`` would write Mamba layer 1 of every slot)."""
    _, tc = _cfgs("hybrid")
    _, tp = _params("hybrid")
    state = init_decode_state(tc, 3, MAX_LEN, torch.float32, device="cpu")
    _, one = prefill(tp, tc, {"tokens": torch.from_numpy(
        _tokens(4, 1, 9, tc.vocab_size))}, MAX_LEN, torch.float32)
    TE.merge_slot(tc, state["caches"], one["caches"], 1)
    for group, axis in (("attn", 1), ("mamba", 2)):
        for k, t in state["caches"][group].items():
            src = one["caches"][group][k]
            assert torch.equal(t.select(axis, 1), src.select(axis, 0)), k
            assert bool(src.select(axis, 0).any()), k
            assert not t.select(axis, 0).any() and not t.select(
                axis, 2).any(), k


# ---------------------------------------------------------------------------
# the scheduler's contiguous mode, snapshot / restore
# ---------------------------------------------------------------------------

def _serve(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("eos_id", None)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("cache_dtype", "float32")
    return kw


def _port_sched(tp, tc, **kw):
    sc = ServeConfig(mode="contiguous", **_serve(**kw))
    return BatchScheduler(sc, EngineHooks.for_model(tp, tc, sc))


def _submit(sched, prompts, cls=Request, max_new=6):
    reqs = [cls(uid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    return reqs


def _drain(sched, prompts, cls=Request):
    _submit(sched, prompts, cls)
    return {r.uid: list(r.generated) for r in sched.run_until_drained()}


@pytest.mark.parametrize("family", FAMILIES)
def test_scheduler_streams_equal_greedy_generate(family):
    """Four equal-length prompts on two slots (two admitted, then two
    more into the slots the first freed): each stream equals the port's
    and JAX's greedy generation of that prompt alone.  For the hybrid
    family this is what the JAX scheduler's ``merge`` gets wrong."""
    jc, tc = _cfgs(family)
    jp, tp = _params(family)
    prompts = _prompts(5, 4, 10, jc.vocab_size)
    got = _drain(_port_sched(tp, tc), prompts)
    assert sorted(got) == [0, 1, 2, 3]
    jgen = jax.jit(lambda p, t: JE.greedy_generate(
        p, jc, {"tokens": t}, MAX_LEN, 6, jnp.float32))
    for uid, p in enumerate(prompts):
        mine = greedy_generate(tp, tc, {"tokens": torch.from_numpy(
            p[None])}, MAX_LEN, 6, torch.float32)[0].tolist()
        ref = np.asarray(jgen(jp, jnp.asarray(p[None])))[0].tolist()
        assert got[uid] == mine == ref, uid


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return np.asarray(tree)


def _mid_stream(sched, prompts, steps, cls=Request):
    reqs = _submit(sched, prompts, cls)
    for _ in range(steps):
        sched.step()
    snap = sched.snapshot()
    assert len(snap["slot_reqs"]) > 0 and len(snap["pending"]) > 0
    return reqs, snap


def _continue(resumed, reqs):
    out = {r.uid: list(r.generated) for r in reqs if r.done}
    out.update({r.uid: list(r.generated)
                for r in resumed.run_until_drained()})
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_snapshot_restore_continues_identically(tmp_path, family):
    """Snapshot mid-stream (bf16 cache, widened to f32 in the snapshot),
    through the port's checkpoint layer, restored into a fresh scheduler:
    the streams equal the uninterrupted run's, the nested state comes back
    in the hooks' dtypes, and the snapshot is left as it was."""
    jc, tc = _cfgs(family)
    _, tp = _params(family)
    prompts = _prompts(6, 4, 11, jc.vocab_size)
    ref = _drain(_port_sched(tp, tc, cache_dtype="bfloat16"), prompts)
    assert len(ref) == 4
    reqs, snap = _mid_stream(_port_sched(tp, tc, cache_dtype="bfloat16"),
                             prompts, 3)
    kept = copy.deepcopy(snap)
    save_checkpoint(tmp_path, 1, snap)
    loaded, _, _ = restore_checkpoint(tmp_path, _as_numpy(snap))
    hooks = EngineHooks.for_model(tp, tc, ServeConfig(
        mode="contiguous", **_serve(cache_dtype="bfloat16")))
    resumed = BatchScheduler.restore(loaded, hooks=hooks)
    caches = resumed.state["caches"]
    mamba = caches["mamba"] if family == "hybrid" else caches
    assert mamba["h"].dtype == torch.float32
    assert mamba["conv"].dtype == torch.bfloat16
    assert _continue(resumed, reqs) == ref
    assert jax.tree.map(lambda a: np.asarray(a).tolist(), snap) == \
        jax.tree.map(lambda a: np.asarray(a).tolist(), kept)


def test_jax_ssm_snapshot_restores_in_the_port(tmp_path):
    """A JAX contiguous ssm scheduler snapshotted mid-stream (its merge is
    right for the [L, B, ...] leaves), through JAX's checkpoint layer,
    restored by the port, continues as JAX's uninterrupted run."""
    jc, tc = _cfgs("ssm")
    jp, tp = _params("ssm")
    prompts = _prompts(7, 4, 10, jc.vocab_size)
    jserve = JServe(mode="contiguous", **_serve())
    ref = _drain(JSched(jserve, JHooks.for_model(jp, jc, jserve)), prompts,
                 JRequest)
    jreqs, jsnap = _mid_stream(JSched(jserve, JHooks.for_model(jp, jc,
                                                               jserve)),
                               prompts, 3, JRequest)
    j_save(tmp_path, 1, jsnap)
    loaded, _, _ = restore_checkpoint(tmp_path, _as_numpy(jsnap))
    hooks = EngineHooks.for_model(tp, tc, ServeConfig(mode="contiguous",
                                                      **_serve()))
    assert _continue(BatchScheduler.restore(loaded, hooks=hooks),
                     jreqs) == ref


# ---------------------------------------------------------------------------
# entry points, guards and the launches chip_smoke.py holds the card to
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-370m"])
def test_serve_cli_runs_contiguous(arch):
    rep = TSERVE.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--requests", "3", "--slots", "2", "--prompt-len",
                       "10", "--max-new", "4", "--max-len", "16",
                       "--kernel-backend", "int8"])
    assert rep["mode"] == "contiguous" and rep["requests"] == 3
    assert len(rep["finished"]) == 3 and rep["tokens"] == 3 * 4


@pytest.mark.parametrize("extra", [["--prompt-len-max", "20"],
                                   ["--eos-id", "3"]])
def test_serve_cli_auto_contiguous_refuses_unequal_prompts(extra, capsys):
    """``--mode auto`` resolves to contiguous for these families, so it
    refuses what ``--mode contiguous`` refuses."""
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--device", "cpu", "--reduced", "--arch",
                     "zamba2-2.7b", *extra])
    assert e.value.code == 2
    assert "one position" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-370m"])
def test_serve_cli_paged_mode_raises(arch):
    with pytest.raises(ValueError, match="paged KV unsupported"):
        TSERVE.main(["--device", "cpu", "--reduced", "--arch", arch,
                     "--mode", "paged", "--requests", "1"])


@pytest.mark.parametrize("kw,item", [(dict(family="encdec"), "A9e"),
                                     (dict(family="vlm"), "A9e")])
def test_training_engine_still_raises(kw, item):
    """The engine trains ssm and hybrid (tests/test_torch_engine_ssm.py),
    moe (tests/test_torch_engine_moe.py), MLA
    (``test_training_engine_builds_mla``) and, since ROADMAP ``item``, the
    encdec and vlm families (tests/test_torch_engine_encdec.py): their
    step builds; a family outside the JAX package's six still raises."""
    _, tc = _cfgs("hybrid")
    cfg = dataclasses.replace(tc, **kw)
    assert make_train_step(cfg, device="cpu").backend == "off"
    with pytest.raises(ValueError, match="unknown model family"):
        make_train_step(dataclasses.replace(tc, family="retnet"),
                        device="cpu")


def test_training_engine_builds_mla():
    """Since ROADMAP A9d the engine builds a step that trains the tiny MLA
    moe model (its parity: tests/test_torch_engine_mla.py): a finite loss,
    an aux, and an updated ``w_uk``."""
    from test_torch_mla import mla_cfgs, mla_jparams

    _, tc = mla_cfgs("k3")
    p = TLM.params_from_numpy(mla_jparams("k3"), device="cpu")
    step = make_train_step(tc, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 8)).astype(np.int32)
    new, _, m = step(p, init_train_state(p, OptimizerConfig()),
                     {"tokens": toks, "labels": toks},
                     Hyper(lr=0.05, step=0), default_bits(tc))
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    assert not torch.equal(new["blocks"]["attn"]["w_uk"],
                           p["blocks"]["attn"]["w_uk"])


@pytest.mark.parametrize("kw", [dict(family="encdec"), dict(family="vlm")])
def test_other_caches_still_raise(kw):
    """Since ROADMAP A9e the encdec and vlm caches build (the encdec's
    decoder ring and cross K/V, the vlm's KV ring); the paged pool still
    refuses the encdec's cross-attention, as JAX's does, and a family
    outside the six raises."""
    jc, tc = _cfgs("hybrid")
    cfg = dataclasses.replace(tc, **kw)
    caches = init_decode_state(cfg, 2, 16, device="cpu")["caches"]
    want = {"self", "cross_k", "cross_v"} if kw["family"] == "encdec" \
        else {"k", "v"}
    assert set(caches) == want
    if kw["family"] == "encdec":
        with pytest.raises(ValueError, match="paged KV unsupported"):
            TE.init_paged_state(cfg, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown model family"):
        init_decode_state(dataclasses.replace(tc, family="retnet"), 2, 16,
                          device="cpu")


def test_mla_cache_builds():
    """Since ROADMAP A9d an MLA model's decode state holds the latent
    cache, {"ckv", "kpe"} in JAX's shapes, in the dtype asked for."""
    from test_torch_mla import mla_cfgs

    jc, tc = mla_cfgs("k3")
    got = init_decode_state(tc, 2, 16, torch.bfloat16,
                            device="cpu")["caches"]
    ref = JE.init_decode_state(jc, 2, 16, jnp.bfloat16)["caches"]
    assert set(got) == set(ref) == {"ckv", "kpe"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert got[k].dtype == torch.bfloat16
    assert tuple(got["ckv"].shape) == (tc.num_layers, 2, 16,
                                       tc.kv_lora_rank)


def _count_entry_points(monkeypatch):
    from repro_torch.kernels import decode_prologue as TDP
    from repro_torch.kernels import paged_attention as TPA

    calls = {"dense_fwd": 0, "fused_prologue": 0, "paged_attention": 0}
    for mod, name in ((TO, "dense_fwd"), (TDP, "fused_prologue"),
                      (TPA, "paged_attention")):
        orig = getattr(mod, name)

        def wrap(*a, _o=orig, _n=name, **kw):
            calls[_n] += 1
            return _o(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    return calls


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_entry_points_per_application(monkeypatch, family):
    """The launches chip_smoke.py's serve_ssm phase holds the card to
    (HYBRID_*_LAUNCHES at zamba2's 9 applications of the shared block;
    SSM_LAUNCHES): an int8 hybrid prefill runs 7 dense units an
    application (q, k, v, o, gate, up, down), an int8 decode step the
    fused prologue and the MLP's 3; the Mamba layers run none, so pure
    ssm serving launches nothing."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    _, tc = _cfgs(family)
    _, tp = _params(family)
    calls = _count_entry_points(monkeypatch)
    toks = torch.from_numpy(_tokens(8, 2, 12, tc.vocab_size))
    _, state = prefill(tp, tc, {"tokens": toks}, MAX_LEN, torch.bfloat16,
                       kernel_backend="int8")
    pre = dict(calls)
    calls.update(dense_fwd=0)
    with TO.kernel_backend_ctx("int8", "cpu"):
        decode_step(tp, tc, state, toks[:, :1])
    if family == "ssm":
        assert CS.SSM_LAUNCHES == {k: 0 for k in CS.SOURCES}
        assert pre == calls == {"dense_fwd": 0, "fused_prologue": 0,
                                "paged_attention": 0}
        return
    g_card = TLM.hybrid_groups(get_config(CS.HYBRID_ARCH))[0]
    g_tiny = TLM.hybrid_groups(tc)[0]

    def per_app(counts):
        assert all(v % g_card == 0 for v in counts.values())
        return {k: v // g_card for k, v in counts.items()}
    p, d = per_app(CS.HYBRID_PREFILL_LAUNCHES), per_app(
        CS.HYBRID_DECODE_LAUNCHES)
    assert (g_card, p["fxp_matmul"], d["fxp_matmul"],
            d["decode_prologue"]) == (9, 7, 3, 1)
    assert pre == {"dense_fwd": p["fxp_matmul"] * g_tiny,
                   "fused_prologue": 0, "paged_attention": 0}
    assert calls == {"dense_fwd": d["fxp_matmul"] * g_tiny,
                     "fused_prologue": d["decode_prologue"] * g_tiny,
                     "paged_attention": 0}


def _unit_shapes(cfg, m_pre, m_dec):
    """The (M, K, N) of one shared-block application's dense units: a
    prefill's q, k, v, o, gate, up and down, a decode step's gate, up and
    down."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    pre = [(m_pre, d, hq), (m_pre, d, hkv), (m_pre, d, hkv), (m_pre, hq, d),
           (m_pre, d, f), (m_pre, d, f), (m_pre, f, d)]
    return pre, [(m_dec, d, f), (m_dec, d, f), (m_dec, f, d)]


def test_zamba2_fxp_rows_are_the_serve_shapes(monkeypatch):
    """chip_smoke.py's ZAMBA2_FXP, the products its phase 3 and edges hold
    fxp_matmul to at zamba2-2.7b's widths, are those serve_ssm hands the
    kernel: the tiny hybrid's int8 prefill and decode step call the dense
    unit at exactly ``_unit_shapes`` an application, and ZAMBA2_FXP is
    ``_unit_shapes`` of zamba2-2.7b at one CONT_PROMPT-token prompt and B
    slots."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    _, tc = _cfgs("hybrid")
    _, tp = _params("hybrid")
    seen = []
    orig = TO.dense_fwd

    def rec(x2, w, backend):
        seen.append((x2.shape[0],) + tuple(w.shape))
        return orig(x2, w, backend)
    monkeypatch.setattr(TO, "dense_fwd", rec)
    toks = torch.from_numpy(_tokens(8, 2, 12, tc.vocab_size))
    _, state = prefill(tp, tc, {"tokens": toks}, MAX_LEN, torch.bfloat16,
                       kernel_backend="int8")
    pre, seen[:] = list(seen), []
    with TO.kernel_backend_ctx("int8", "cpu"):
        decode_step(tp, tc, state, toks[:, :1])
    g = TLM.hybrid_groups(tc)[0]
    want_pre, want_dec = _unit_shapes(tc, 2 * 12, 2)
    assert pre == want_pre * g and seen == want_dec * g
    full_pre, full_dec = _unit_shapes(get_config(CS.HYBRID_ARCH),
                                      CS.CONT_PROMPT, CS.B)
    assert sorted(CS.ZAMBA2_FXP) == sorted(set(full_pre + full_dec))


def test_ssm_parity_limits_within_the_dense_ones():
    """serve_ssm's card-against-CPU limits, set from that check's own
    readings, are no looser than the dense check's PARITY_TOL, and the
    dropped-K controls cut a part of zamba2's down-projection K."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    assert set(CS.SSM_PARITY_TOL) == set(CS.PARITY_TOL)
    assert all(CS.SSM_PARITY_TOL[b] <= CS.PARITY_TOL[b]
               for b in CS.PARITY_TOL)
    assert all(0 < cut < get_config(CS.HYBRID_ARCH).d_ff
               for _, cut in CS.SSM_FAULTS)
