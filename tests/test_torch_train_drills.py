"""Recovery drills of the port's train driver on the CPU, mirroring
``tests/test_recovery_drills.py``: each runs the real driver in a
subprocess with an injected fault plan and holds it to the checkpoint
layer's contract.  Here: a kill at a seeded-random step and a restart
resume **bitwise** -- the final checkpoint's crc32s and the logged losses
equal an uninterrupted run's (the data stream and the lr schedule are
step-indexed), on the plain path and on the plain int8 datapath, and with
``--stochastic`` (as ``tests/test_recovery_drills.py`` runs it: the noise
is keyed by the step, so the resumed run draws the same noise).  The
other drills are in ``tests/test_torch_train_faults.py``; the elastic
drill (a restart on another device count) waits for multi-GPU (ROADMAP
A11).

Each run is a process of its own, so "bitwise" needs every process to
compute the same bits: ``repro_torch`` makes MKL's first vector-math call
on one thread (see ``repro_torch/__init__.py``; a first call split over
the threads now and then gives other bits,
``tools/cpu_bitwise_processes.py``).  Every run
here also passes a loader deadline no fetch can miss
(``DRILL_DEADLINE_S``): the deadline is the driver's one input that
depends on the wall clock, and a fetch that misses it is replaced by the
previous batch, by design, so under a loaded host a run could train on
another data stream than its twin.  The substitution keeps its own tests
(``tests/test_torch_ft.py``, ``tests/test_torch_train_faults.py``).
"""
import re

import msgpack
import pytest

from repro_torch.ft import FAULT_EXIT_CODE

from test_torch_train_driver import run_driver, step_losses

DRILL_DEADLINE_S = "600"

def manifest_crcs(ck, step):
    m = msgpack.unpackb((ck / f"step_{step:08d}"
                         / "manifest.msgpack").read_bytes())
    return {e["path"]: (int(e["crc32"]), int(e["nbytes"]))
            for e in m["leaves"]}


@pytest.mark.parametrize("backend", ["off", "int8"])
def test_kill_at_seeded_step_resumes_bitwise(tmp_path, backend):
    _kill_and_resume(tmp_path, backend)


def test_stochastic_kill_at_seeded_step_resumes_bitwise(tmp_path):
    _kill_and_resume(tmp_path, "int8", "--stochastic")


@pytest.mark.parametrize("arch", ["zamba2-2.7b"])
def test_ssm_families_stochastic_kill_resumes_bitwise(tmp_path, arch):
    """The hybrid's groups, its shared block and their momentum, killed
    and resumed: the [G, K, ...] leaves and the shared block's checkpoint
    crc32s and every logged loss equal the uninterrupted run's."""
    _kill_and_resume(tmp_path, "int8", "--stochastic", "--arch", arch)


def _kill_and_resume(tmp_path, backend, *flags):
    common = ("--steps", "12", "--ckpt-every", "4", "--quantize",
              "--lr", "3e-2", "--log-every", "1", "--kernel-backend", backend,
              "--deadline-s", DRILL_DEADLINE_S, *flags)
    ref_ck, ck = tmp_path / "ref", tmp_path / "ck"

    ref0 = run_driver(*common, "--ckpt-dir", str(ref_ck))
    ref = run_driver(*common, "--ckpt-dir", str(ref_ck))
    # the baseline itself must be run-to-run deterministic, or "bitwise
    # resume" would be unfalsifiable
    assert step_losses(ref.stdout) == step_losses(ref0.stdout), (
        ref0.stdout[-1500:], ref.stdout[-1500:])
    assert len(step_losses(ref.stdout)) == 12, ref.stdout[-1000:]
    assert f"kernel backend {backend}" in ref.stdout

    # the crash step is drawn from the plan seed inside [6, 11)
    killed = run_driver(*common, "--ckpt-dir", str(ck),
                        "--fault-plan", "crash@rand:6-11;seed=5",
                        expect_code=FAULT_EXIT_CODE)
    m = re.search(r"injected crash at step (\d+)", killed.stderr)
    assert m, killed.stderr[-2000:]
    crash_step = int(m.group(1))
    assert 6 <= crash_step < 11
    assert not (ck / "step_00000012").exists()

    resumed = run_driver(*common, "--ckpt-dir", str(ck), "--resume")
    rm = re.search(r"resumed from step (\d+)", resumed.stdout)
    assert rm, resumed.stdout[-2000:]
    assert 0 < int(rm.group(1)) <= crash_step

    assert manifest_crcs(ck, 12) == manifest_crcs(ref_ck, 12), (
        ref.stdout[-1500:], resumed.stdout[-1500:])
    ref_losses = step_losses(ref.stdout)
    res_losses = step_losses(resumed.stdout)
    assert sorted(res_losses) == list(range(int(rm.group(1)), 12))
    for step, loss in res_losses.items():
        assert loss == ref_losses[step], (
            f"step {step}: resumed {loss} != reference {ref_losses[step]}")
