"""Parity of the whole slice: the port's train driver against the JAX
package's, from one shared checkpoint.

The two packages draw their initial parameters from different RNGs, so the
test writes one step-0 checkpoint with the JAX package's
``save_checkpoint`` (``repro.models.lm.init_params(key(0))``, momentum
state, ``capture_resume_extra(cfg, 0)``), copies it into a directory for
each driver, and runs ``repro.launch.train.main`` and
``repro_torch.launch.train.main`` in-process with ``--resume`` on their
copies: the reduced qwen1.5-0.5b (f32), ``--quantize``, backend off, 6
steps of the same data and lr schedule; and once more with
``--stochastic``, where both drivers key the noise ``fold_in(key(1),
step)`` and draw it bit for bit alike.

The same from the reduced mamba2-370m and zamba2-2.7b (the ssm and hybrid
families, ``SSM_ARCHS``), round-to-nearest.

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
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

STEPS = 6
ARCH = "qwen1.5-0.5b"
SSM_ARCHS = ["mamba2-370m", "zamba2-2.7b"]
COMMON = ["--arch", ARCH, "--reduced", "--seq-len", "32",
          "--global-batch", "8", "--quantize", "--kernel-backend", "off",
          "--steps", str(STEPS), "--log-every", "1", "--resume"]
LOSS_RTOL = 5e-5


def _step0_checkpoint(d, nudge=False, arch=ARCH):
    """JAX's step-0 state; ``nudge`` moves every float leaf of the params
    one f32 ulp up."""
    cfg = j_reduce_cfg(arch)
    params = JLM.init_params(jax.random.key(0), cfg)
    if nudge:
        params = jax.tree.map(
            lambda x: np.nextafter(np.asarray(x), np.float32(np.inf)),
            params)
    state = j_init_state(params, JOCfg(kind="momentum"))
    j_save(d, 0, (params, state), extra=j_capture(cfg, 0))


def j_reduce_cfg(arch=ARCH):
    return j_train._reduce(j_get_config(arch))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _three_runs(root, *flags, arch=ARCH):
    """(root, JAX's losses, the port's, the port's from the nudged
    checkpoint), each from its own copy of the step-0 checkpoint."""
    _step0_checkpoint(root / "step0", arch=arch)
    _step0_checkpoint(root / "nudged", nudge=True, arch=arch)
    for d in ("jax", "port"):
        shutil.copytree(root / "step0", root / d)
    args = COMMON + list(flags) + ["--arch", arch]
    try:
        jax_losses = j_train.main(args + ["--data", "1", "--model", "1",
                                          "--ckpt-dir", str(root / "jax"),
                                          "--ckpt-every", "3"])
    finally:
        clear_tune_cache()
        clear_transport_cache()
    port = train.main(args + ["--device", "cpu",
                              "--ckpt-dir", str(root / "port")])
    nudged = train.main(args + ["--device", "cpu",
                                "--ckpt-dir", str(root / "nudged")])
    return root, jax_losses, port, nudged


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _three_runs(tmp_path_factory.mktemp("parity"))


@pytest.fixture(scope="module")
def stochastic_runs(tmp_path_factory):
    return _three_runs(tmp_path_factory.mktemp("stochastic"), "--stochastic")


def _check_losses(jax_losses, port, nudged):
    assert len(port) == len(jax_losses) == STEPS
    spread = _rel(nudged, port)
    err = _rel(port, jax_losses)
    print(f"port vs JAX {err:.3g}, one-ulp spread {spread:.3g}, "
          f"tol {LOSS_RTOL}")
    assert 2 * spread <= LOSS_RTOL, (spread, LOSS_RTOL)
    assert err <= LOSS_RTOL, (port, jax_losses)


def test_driver_losses_match_the_jax_driver(runs):
    _check_losses(*runs[1:])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_driver_losses_match_the_jax_driver(arch, tmp_path):
    """The same rule on the ssm and hybrid families: the hybrid's engine
    units are its groups, its shared block is updated once a step."""
    _check_losses(*_three_runs(tmp_path, arch=arch)[1:])


def test_stochastic_driver_losses_match_the_jax_driver(runs,
                                                       stochastic_runs):
    """The same rule with ``--stochastic``; the noise moved the losses
    away from the round-to-nearest run's."""
    _check_losses(*stochastic_runs[1:])
    assert stochastic_runs[2] != runs[2]


def test_port_resumes_a_jax_checkpoint_of_step_4(runs, tmp_path, capsys):
    """The JAX driver's own step-4 checkpoint (``--ckpt-every 3``), with
    its primed tune cache in the payload, whose kinds the port skips: the
    port resumes at step 4 and its two steps agree with the JAX
    driver's."""
    root, jax_losses, _, _ = runs
    d = tmp_path / "ck"
    shutil.copytree(root / "jax", d)
    shutil.rmtree(d / f"step_{STEPS:08d}")
    (d / "LATEST").write_text("step_00000004")
    losses = train.main(COMMON + ["--device", "cpu", "--ckpt-dir", str(d)])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert re.search(r"restored 0 tune-cache decision\(s\) from checkpoint; "
                     r"skipped [1-9]\d* of the JAX package's", out)
    assert len(losses) == STEPS - 4
    assert _rel(losses, jax_losses[4:]) <= LOSS_RTOL, (losses, jax_losses)
