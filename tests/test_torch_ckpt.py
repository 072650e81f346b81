"""Port of the checkpoint layer (``repro_torch.ckpt``) against the JAX
package's ``repro.ckpt``.

Mirrors the checkpoint tests of ``tests/test_fault_tolerance.py`` and
``tests/test_fault_injection.py`` on torch trees, then holds the two
packages to one on-disk format: a checkpoint of the train driver's
``(params, opt_state)`` written by either restores bitwise in the other,
with the same leaf paths and the same ``extra``; and the port's msgpack
codec gives the bytes of ``msgpack.packb`` and reads what
``msgpack.unpackb`` reads.
"""
import pathlib

import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.ckpt import restore_checkpoint as j_restore
from repro.ckpt import save_checkpoint as j_save
from repro.ckpt import verify_checkpoint as j_verify
from repro.configs import get_config as j_get_config
from repro.core.steps import capture_resume_extra as j_capture
from repro.core.steps import init_train_state as j_init_state
from repro.launch.train import _reduce as j_reduce
from repro.models import lm as JLM
from repro.optim import OptimizerConfig as JOCfg
from repro_torch.ckpt import (AsyncCheckpointer, latest_step,
                              latest_valid_step, list_steps,
                              restore_checkpoint, save_checkpoint,
                              verify_checkpoint)
from repro_torch.ckpt import _msgpack
from repro_torch.configs import get_config
from repro_torch.core.steps import capture_resume_extra, init_train_state
from repro_torch.ft import FaultPlan, flip_one_bit
from repro_torch.launch.train import _reduce
from repro_torch.models import lm
from repro_torch.optim import OptimizerConfig
from repro_torch.util.tree import tree_leaves_with_path

KINDS = ("sgd", "momentum", "momentum8", "adam")


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}


def _equal(x, y) -> bool:
    return (x.dtype == y.dtype and x.shape == y.shape
            and bool(torch.equal(x, y)))


# ---------------------------------------------------------------------------
# Save, restore, retention (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 7, t, extra={"note": "hi"})
    assert latest_step(tmp_path) == 7
    restored, step, extra = restore_checkpoint(tmp_path, t)
    assert step == 7 and extra["note"] == "hi"
    assert _equal(restored["a"], t["a"]) and _equal(restored["b"]["c"],
                                                    t["b"]["c"])


def test_checkpoint_retention_and_latest(tmp_path):
    t = tree()
    for s in range(6):
        save_checkpoint(tmp_path, s, t, keep_n=3)
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    assert latest_step(tmp_path) == 5


def test_checkpoint_crash_leaves_no_corruption(tmp_path):
    """A stale tmp dir (simulated crash) must not break save/restore."""
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    stale = tmp_path / "step_00000002.tmp-9999"
    stale.mkdir()
    (stale / "garbage").write_text("x")
    save_checkpoint(tmp_path, 2, t)
    _, step, _ = restore_checkpoint(tmp_path, t)
    assert step == 2


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, tree())
    bad = {"a": torch.zeros((2, 2)), "b": {"c": torch.ones((5,))}}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, bad)


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    ck.save(3, tree())
    ck.wait()
    assert latest_step(tmp_path) == 3
    (t,) = ck.timings
    assert t["step"] == 3 and t["snapshot_s"] >= 0 and t["write_s"] > 0
    ck.close()


# ---------------------------------------------------------------------------
# The port's trees: tuples, empty state, devices, dtypes, snapshots
# ---------------------------------------------------------------------------

def test_tuple_paths_and_empty_state(tmp_path):
    """The driver's tree: sequence indices in the paths, an empty ``{}``
    (the sgd state) rebuilt as ``{}``, each leaf's dtype kept."""
    t = ({"w": torch.arange(6.0).reshape(2, 3), "q": torch.zeros(
        (2,), dtype=torch.int8)}, {"blocks": {}, "embed": {"m": torch.ones(
            3)}}, [torch.tensor(2.5)])
    save_checkpoint(tmp_path, 1, t)
    m = msgpack.unpackb((tmp_path / "step_00000001"
                         / "manifest.msgpack").read_bytes())
    assert [e["path"] for e in m["leaves"]] == ["0/q", "0/w", "1/embed/m",
                                                "2/0"]
    assert [e["dtype"] for e in m["leaves"]] == ["int8", "float32",
                                                 "float32", "float32"]
    got, _, _ = restore_checkpoint(tmp_path, t)
    assert isinstance(got, tuple) and isinstance(got[2], list)
    assert got[1]["blocks"] == {}
    assert _equal(got[0]["q"], t[0]["q"]) and _equal(got[2][0], t[2][0])


def test_bf16_leaf_raises_naming_its_path(tmp_path):
    t = {"x": {"w": torch.ones(4, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="x/w: numpy has no bfloat16"):
        save_checkpoint(tmp_path, 1, t)
    assert list_steps(tmp_path) == []


def test_async_save_snapshots_before_returning(tmp_path):
    """On the CPU ``Tensor.numpy()`` aliases the tensor: ``save`` copies,
    so training that goes on changing it in place does not reach the
    checkpoint."""
    t = tree()
    want = t["a"].clone()
    with AsyncCheckpointer(tmp_path) as ck:
        ck.save(1, t)
        t["a"].add_(100.0)
    got, _, _ = restore_checkpoint(tmp_path, tree())
    assert _equal(got["a"], want)


def test_restore_keeps_checkpoint_dtype_on_template_device(tmp_path):
    save_checkpoint(tmp_path, 1, tree())
    tmpl = {"a": torch.zeros((3, 4), dtype=torch.float64, device="meta"),
            "b": {"c": np.zeros(5)}}
    got, _, _ = restore_checkpoint(tmp_path, tmpl)
    assert got["a"].device.type == "meta" and got["a"].dtype == torch.float32
    assert isinstance(got["b"]["c"], np.ndarray)
    assert got["b"]["c"].dtype == np.int32


# ---------------------------------------------------------------------------
# Integrity: checksums, verify, fallback, retry (test_fault_injection.py)
# ---------------------------------------------------------------------------

def test_manifest_carries_checksums_and_verify_passes(tmp_path):
    save_checkpoint(tmp_path, 3, tree())
    assert verify_checkpoint(tmp_path, 3) == []
    assert latest_valid_step(tmp_path) == 3


def test_verify_detects_bit_flip(tmp_path):
    save_checkpoint(tmp_path, 3, tree())
    assert flip_one_bit(tmp_path, 3, seed=0) is not None
    problems = verify_checkpoint(tmp_path, 3)
    assert problems and "crc32 mismatch" in problems[0]
    assert latest_valid_step(tmp_path) is None


def test_verify_reports_a_garbled_manifest(tmp_path):
    save_checkpoint(tmp_path, 3, tree())
    mpath = tmp_path / "step_00000003" / "manifest.msgpack"
    mpath.write_bytes(mpath.read_bytes()[:-3])
    assert "unreadable manifest" in verify_checkpoint(tmp_path, 3)[0]


def test_restore_falls_back_past_corrupt_latest(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, t)
    flip_one_bit(tmp_path, 2, seed=1)
    assert latest_step(tmp_path) == 2
    assert latest_valid_step(tmp_path) == 1
    with pytest.warns(RuntimeWarning, match="failed verification"):
        restored, step, _ = restore_checkpoint(tmp_path, t)
    assert step == 1 and _equal(restored["a"], t["a"])


def test_restore_pinned_corrupt_step_raises(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, t)
    flip_one_bit(tmp_path, 2, seed=1)
    with pytest.raises(ValueError, match="failed verification"):
        restore_checkpoint(tmp_path, t, step=2)
    _, step, _ = restore_checkpoint(tmp_path, t, step=1)
    assert step == 1


def test_restore_all_corrupt_raises_with_history(tmp_path):
    t = tree()
    for s in (1, 2):
        save_checkpoint(tmp_path, s, t)
        flip_one_bit(tmp_path, s, seed=s)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
            restore_checkpoint(tmp_path, t)


def test_missing_latest_pointer_falls_back_to_dirs(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, t)
    (tmp_path / "LATEST").unlink()
    assert latest_step(tmp_path) == 2
    assert list_steps(tmp_path) == [1, 2]
    _, step, _ = restore_checkpoint(tmp_path, t)
    assert step == 2


@pytest.mark.parametrize("spec,step,fired", [
    ("io@5x2", 5, [("io", 5), ("io", 5)]),
    ("fsync@6x1;rename@6x1", 6, [("fsync", 6), ("rename", 6)])])
def test_save_retries_transient_failures(tmp_path, spec, step, fired):
    plan = FaultPlan.parse(spec)
    with pytest.warns(RuntimeWarning, match="retrying"):
        save_checkpoint(tmp_path, step, tree(), fault=plan.ckpt_fault,
                        backoff_s=0.01)
    assert plan.fired == fired
    assert verify_checkpoint(tmp_path, step) == []


def test_save_exhausts_retries_and_raises(tmp_path):
    plan = FaultPlan.parse("io@7x99")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(OSError, match="injected io failure"):
            save_checkpoint(tmp_path, 7, tree(), fault=plan.ckpt_fault,
                            retries=2, backoff_s=0.01)
    assert latest_step(tmp_path) is None


# ---------------------------------------------------------------------------
# AsyncCheckpointer lifecycle
# ---------------------------------------------------------------------------

def test_async_checkpointer_close_flushes_final_write(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    ck.save(3, tree())
    ck.close()  # no wait(): close must join the in-flight write
    assert latest_step(tmp_path) == 3
    ck.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(4, tree())


def test_async_checkpointer_context_manager(tmp_path):
    with AsyncCheckpointer(tmp_path) as ck:
        ck.save(1, tree())
    assert latest_step(tmp_path) == 1


def test_async_checkpointer_close_reraises_background_error(tmp_path):
    plan = FaultPlan.parse("io@2x99")
    ck = AsyncCheckpointer(tmp_path / "sub", fault=plan.ckpt_fault)
    with pytest.warns(RuntimeWarning):
        ck.save(2, tree())
        with pytest.raises(OSError, match="injected io failure"):
            ck.close()
    assert ck.timings == []
    ck.close()


def test_async_checkpointer_fault_threads_through(tmp_path):
    plan = FaultPlan.parse("io@3x1")
    with pytest.warns(RuntimeWarning, match="retrying"):
        with AsyncCheckpointer(tmp_path, fault=plan.ckpt_fault) as ck:
            ck.save(3, tree())
            ck.wait()
    assert latest_step(tmp_path) == 3


# ---------------------------------------------------------------------------
# Interop with the JAX package, both ways
# ---------------------------------------------------------------------------

def _jax_state(kind):
    cfg = j_reduce(j_get_config("qwen1.5-0.5b"))
    params = JLM.init_params(jax.random.key(0), cfg)
    return cfg, (params, j_init_state(params, JOCfg(kind=kind)))


def _port_state(kind):
    cfg = _reduce(get_config("qwen1.5-0.5b"))
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, (params, init_train_state(params, OptimizerConfig(kind=kind)))


def _manifest(d, step):
    return msgpack.unpackb((pathlib.Path(d) / f"step_{step:08d}"
                            / "manifest.msgpack").read_bytes())


@pytest.mark.parametrize("kind", KINDS)
def test_port_restores_a_jax_checkpoint_bitwise(tmp_path, kind):
    jcfg, jtree = _jax_state(kind)
    j_save(tmp_path, 3, jtree, extra=j_capture(jcfg, 3, user_extra={
        "loss": 6.5}))
    _, _, jextra = j_restore(tmp_path, jtree)
    _, tmpl = _port_state(kind)
    got, step, extra = restore_checkpoint(tmp_path, tmpl)
    assert step == 3 and extra == jextra and extra["data_step"] == 3
    want = {e["path"]: np.load(tmp_path / "step_00000003" / e["file"])
            for e in _manifest(tmp_path, 3)["leaves"]}
    mine = dict(tree_leaves_with_path(got))
    assert set(mine) == set(want)
    for path, x in mine.items():
        assert x.dtype == torch.from_numpy(want[path]).dtype, path
        np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)
    if kind == "sgd":
        assert got[1] == {k: {} for k in got[0]}


@pytest.mark.parametrize("kind", KINDS)
def test_jax_restores_a_port_checkpoint_bitwise(tmp_path, kind):
    cfg, ptree = _port_state(kind)
    extra = capture_resume_extra(cfg, 5, user_extra={"loss": 6.25})
    save_checkpoint(tmp_path, 5, ptree, extra=extra)
    assert j_verify(tmp_path, 5) == []
    m = _manifest(tmp_path, 5)
    assert m["version"] == 2 and m["extra"] == extra
    _, jtmpl = _jax_state(kind)
    got, step, jextra = j_restore(tmp_path, jtmpl)
    assert step == 5 and jextra == extra
    mine = dict(tree_leaves_with_path(ptree))
    jl = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
          np.asarray(v) for kp, v in jax.tree_util.tree_leaves_with_path(got)}
    assert set(jl) == set(mine)
    for path, x in mine.items():
        np.testing.assert_array_equal(jl[path], x.numpy(), err_msg=path)
        assert jl[path].dtype == x.numpy().dtype, path


def test_jax_checkpoint_with_jax_corruption_falls_back_in_the_port(
        tmp_path):
    """A JAX-written history with a bit-flipped LATEST: the port's restore
    warns and recovers the older step, as the JAX package's does."""
    jcfg, jtree = _jax_state("momentum")
    for s in (1, 2):
        j_save(tmp_path, s, jtree, extra=j_capture(jcfg, s))
    flip_one_bit(tmp_path, 2, seed=3)
    assert j_verify(tmp_path, 2) != [] and verify_checkpoint(tmp_path, 2)
    _, tmpl = _port_state("momentum")
    with pytest.warns(RuntimeWarning, match="failed verification"):
        _, step, extra = restore_checkpoint(tmp_path, tmpl)
    assert step == 1 and extra["data_step"] == 1


# ---------------------------------------------------------------------------
# The manifest codec
# ---------------------------------------------------------------------------

def test_codec_on_real_manifests(tmp_path):
    """Manifests written by each package: the port reads what msgpack
    reads, and re-encodes msgpack's bytes exactly."""
    jcfg, jtree = _jax_state("momentum8")
    j_save(tmp_path / "j", 1, jtree, extra=j_capture(jcfg, 1))
    cfg, ptree = _port_state("adam")
    save_checkpoint(tmp_path / "p", 1, ptree,
                    extra=capture_resume_extra(cfg, 1))
    for d in ("j", "p"):
        raw = (tmp_path / d / "step_00000001"
               / "manifest.msgpack").read_bytes()
        assert _msgpack.unpackb(raw) == msgpack.unpackb(raw)
        assert _msgpack.packb(msgpack.unpackb(raw)) == raw


BOUNDS = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
          2**63 - 1, 2**63, 2**64 - 1, -1, -31, -32, -33, -127, -128, -129,
          -32768, -32769, -2**31, -2**31 - 1, -2**63]
SCALARS = (st.none() | st.booleans() | st.sampled_from(BOUNDS)
           | st.integers(min_value=-2**63, max_value=2**64 - 1)
           | st.floats(allow_nan=False)
           | st.text(max_size=40) | st.sampled_from(["x" * 31, "x" * 32,
                                                    "y" * 255, "z" * 256,
                                                    "é" * 40000])
           | st.binary(max_size=300))
VALUES = st.recursive(
    SCALARS, lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(VALUES)
def test_codec_matches_msgpack(obj):
    raw = msgpack.packb(obj)
    assert _msgpack.packb(obj) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw)


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_codec_long_arrays_and_maps(n):
    for obj in (list(range(n)), {str(i): i for i in range(n)}):
        raw = msgpack.packb(obj)
        assert _msgpack.packb(obj) == raw
        assert _msgpack.unpackb(raw) == obj


def test_codec_reads_float32_and_refuses_bad_input():
    assert _msgpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert _msgpack.unpackb(msgpack.packb([0.25, {"a": -2.0}],
                                          use_single_float=True)) == [
        0.25, {"a": -2.0}]
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(bad)
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    raw = msgpack.packb({"k": [1, 2, 3]})
    for broken in (raw[:-1], raw + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            _msgpack.unpackb(broken)
    with pytest.raises(ValueError, match="map key"):
        _msgpack.unpackb(msgpack.packb({1: 2}))
