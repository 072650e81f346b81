"""Parity of the whole slice: the port's train driver against the JAX
package's, from one shared checkpoint.

The two packages draw their initial parameters from different RNGs, so the
test writes one step-0 checkpoint with the JAX package's
``save_checkpoint`` (``repro.models.lm.init_params(key(0))``, momentum
state, ``capture_resume_extra(cfg, 0)``), copies it into a directory for
each driver, and runs ``repro.launch.train.main`` and
``repro_torch.launch.train.main`` in-process with ``--resume`` on their
copies: the reduced qwen1.5-0.5b (f32), ``--quantize``, backend off, 6
steps of the same data and lr schedule.

Tolerance: the losses agree within LOSS_RTOL (relative).  The two sides
sum in other orders; where a value sits at an (I,F) rounding tie, one f32
rounding of difference moves it a grid step, and later steps carry that
on.  The test
measures that spread on the port alone: one f32 ulp on every master
weight of the shared checkpoint moves the port's 6 losses by a relative
``spread``, and LOSS_RTOL must stand at least twice above it.
"""
import re
import shutil

import jax
import numpy as np
import pytest

from repro.ckpt import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.core.steps import capture_resume_extra as j_capture
from repro.core.steps import init_train_state as j_init_state
from repro.dist.async_collectives import clear_transport_cache
from repro.kernels.ops import clear_tune_cache
from repro.launch import train as j_train
from repro.models import lm as JLM
from repro.optim import OptimizerConfig as JOCfg
from repro_torch.launch import train

STEPS = 6
COMMON = ["--arch", "qwen1.5-0.5b", "--reduced", "--seq-len", "32",
          "--global-batch", "8", "--quantize", "--kernel-backend", "off",
          "--steps", str(STEPS), "--log-every", "1", "--resume"]
LOSS_RTOL = 5e-5


def _step0_checkpoint(d, nudge=False):
    """JAX's step-0 state; ``nudge`` moves every float leaf of the params
    one f32 ulp up."""
    cfg = j_reduce_cfg()
    params = JLM.init_params(jax.random.key(0), cfg)
    if nudge:
        params = jax.tree.map(
            lambda x: np.nextafter(np.asarray(x), np.float32(np.inf)),
            params)
    state = j_init_state(params, JOCfg(kind="momentum"))
    j_save(d, 0, (params, state), extra=j_capture(cfg, 0))


def j_reduce_cfg():
    return j_train._reduce(j_get_config("qwen1.5-0.5b"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    _step0_checkpoint(root / "step0")
    _step0_checkpoint(root / "nudged", nudge=True)
    for d in ("jax", "port"):
        shutil.copytree(root / "step0", root / d)
    try:
        jax_losses = j_train.main(COMMON + ["--data", "1", "--model", "1",
                                            "--ckpt-dir", str(root / "jax"),
                                            "--ckpt-every", "3"])
    finally:
        clear_tune_cache()
        clear_transport_cache()
    port = train.main(COMMON + ["--device", "cpu",
                                "--ckpt-dir", str(root / "port")])
    nudged = train.main(COMMON + ["--device", "cpu",
                                  "--ckpt-dir", str(root / "nudged")])
    return root, jax_losses, port, nudged


def test_driver_losses_match_the_jax_driver(runs):
    _, jax_losses, port, nudged = runs
    assert len(port) == len(jax_losses) == STEPS
    spread = _rel(nudged, port)
    err = _rel(port, jax_losses)
    print(f"port vs JAX {err:.3g}, one-ulp spread {spread:.3g}, "
          f"tol {LOSS_RTOL}")
    assert 2 * spread <= LOSS_RTOL, (spread, LOSS_RTOL)
    assert err <= LOSS_RTOL, (port, jax_losses)


def test_port_resumes_a_jax_checkpoint_of_step_4(runs, tmp_path, capsys):
    """The JAX driver's own step-4 checkpoint (``--ckpt-every 3``), with
    its primed tune cache in the payload: the port resumes at step 4 and
    its two steps agree with the JAX driver's."""
    root, jax_losses, _, _ = runs
    d = tmp_path / "ck"
    shutil.copytree(root / "jax", d)
    shutil.rmtree(d / f"step_{STEPS:08d}")
    (d / "LATEST").write_text("step_00000004")
    losses = train.main(COMMON + ["--device", "cpu", "--ckpt-dir", str(d)])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert re.search(r"checkpoint carries 0 transport-cache and [1-9]\d* "
                     r"tune-cache decision\(s\); the port has no tuner", out)
    assert len(losses) == STEPS - 4
    assert _rel(losses, jax_losses[4:]) <= LOSS_RTOL, (losses, jax_losses)
