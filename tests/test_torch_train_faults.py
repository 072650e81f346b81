"""Recovery drills of the port's train driver on the CPU, mirroring
``tests/test_recovery_drills.py`` (the kill drill is in
``tests/test_torch_train_drills.py``):

* a corrupted newest checkpoint is detected by checksum, warned about
  loudly, and recovery falls back to the previous valid one;
* transient checkpoint IO failures are retried away;
* a straggling fetch past the deadline is substituted, not fatal.
"""
import re

from repro_torch.ckpt import verify_checkpoint

from test_torch_train_driver import run_driver, step_losses


def test_corrupt_latest_falls_back_with_loud_warning(tmp_path):
    ck = tmp_path / "ck"
    # flip@12 corrupts the final checkpoint after it lands; checkpoints 5
    # and 9 stay valid
    run_driver("--steps", "12", "--ckpt-every", "4", "--ckpt-dir", str(ck),
               "--fault-plan", "flip@12")
    assert (ck / "step_00000012").exists()

    resumed = run_driver("--steps", "16", "--ckpt-every", "4",
                         "--ckpt-dir", str(ck), "--resume")
    assert "failed verification" in resumed.stderr, resumed.stderr[-3000:]
    assert re.search(r"recovered from checkpoint step 9", resumed.stderr)
    assert "resumed from step 9" in resumed.stdout, resumed.stdout[-2000:]
    assert (ck / "step_00000016").exists()


def test_transient_ckpt_io_failures_are_absorbed(tmp_path):
    ck = tmp_path / "ck"
    out = run_driver("--steps", "8", "--ckpt-every", "4",
                     "--ckpt-dir", str(ck), "--fault-plan", "io@5x2")
    assert "retrying" in out.stderr, out.stderr[-3000:]
    assert (ck / "step_00000008").exists()
    assert verify_checkpoint(ck, 5) == []
    assert verify_checkpoint(ck, 8) == []


def test_straggler_stall_does_not_break_resume(tmp_path):
    ck = tmp_path / "ck"
    out = run_driver("--steps", "8", "--ckpt-every", "4", "--log-every", "1",
                     "--ckpt-dir", str(ck), "--deadline-s", "0.3",
                     "--fault-plan", "stall@3:2.0")
    assert (ck / "step_00000008").exists()
    assert len(step_losses(out.stdout)) >= 6
