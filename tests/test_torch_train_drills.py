"""Recovery drills of the port's train driver on the CPU, mirroring
``tests/test_recovery_drills.py``: each runs the real driver in a
subprocess with an injected fault plan and holds it to the checkpoint
layer's contract.  Here: a kill at a seeded-random step and a restart
resume **bitwise** -- the final checkpoint's crc32s and the logged losses
equal an uninterrupted run's (the data stream and the lr schedule are
step-indexed), on the plain path and on the plain int8 datapath.  The
other drills are in ``tests/test_torch_train_faults.py``; the elastic
drill (a restart on another device count) waits for multi-GPU (ROADMAP
A11).
"""
import re

import msgpack
import pytest

from repro_torch.ft import FAULT_EXIT_CODE

from test_torch_train_driver import run_driver, step_losses


def manifest_crcs(ck, step):
    m = msgpack.unpackb((ck / f"step_{step:08d}"
                         / "manifest.msgpack").read_bytes())
    return {e["path"]: (int(e["crc32"]), int(e["nbytes"]))
            for e in m["leaves"]}


@pytest.mark.parametrize("backend", ["off", "int8"])
def test_kill_at_seeded_step_resumes_bitwise(tmp_path, backend):
    common = ("--steps", "12", "--ckpt-every", "4", "--quantize",
              "--lr", "3e-2", "--log-every", "1", "--kernel-backend", backend)
    ref_ck, ck = tmp_path / "ref", tmp_path / "ck"

    ref0 = run_driver(*common, "--ckpt-dir", str(ref_ck))
    ref = run_driver(*common, "--ckpt-dir", str(ref_ck))
    # the baseline itself must be run-to-run deterministic, or "bitwise
    # resume" would be unfalsifiable
    assert step_losses(ref.stdout) == step_losses(ref0.stdout)
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

    assert manifest_crcs(ck, 12) == manifest_crcs(ref_ck, 12)
    ref_losses = step_losses(ref.stdout)
    res_losses = step_losses(resumed.stdout)
    assert sorted(res_losses) == list(range(int(rm.group(1)), 12))
    for step, loss in res_losses.items():
        assert loss == ref_losses[step], (
            f"step {step}: resumed {loss} != reference {ref_losses[step]}")
