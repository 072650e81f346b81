"""Fault-tolerant checkpointing: atomic, async, verified (port of
``ckpt/checkpoint.py``, on the same on-disk format byte for byte, so a
checkpoint written by either package restores in the other).

Layout (one directory per step):

    <dir>/step_00000123/
        manifest.msgpack     # leaf paths, shapes, dtypes, crc32s, extra
        arr_00000.npy ...    # one file per leaf (host-local full arrays)
    <dir>/LATEST             # atomic pointer file (renamed into place)

A tree is nested dicts, tuples and lists of tensors (or numpy arrays).  A
leaf's path joins the dict keys (sorted, as ``jax.tree`` walks a dict) and
the sequence indices with "/" (``util.tree.tree_leaves_with_path``): the
train driver's ``(params, opt_state)`` gives ``0/blocks/attn/wq``,
``1/blocks/m/attn/wq``, the JAX package's strings; an empty dict (the sgd
state) has no leaves and is rebuilt as ``{}``.

Guarantees (each drilled in tests/test_torch_ckpt.py and
tests/test_torch_train_drills.py):

  * atomicity -- written to ``step_X.tmp-<pid>``, every file and the
    directory fsynced, then renamed; then the LATEST pointer is written to
    a tmp file, fsynced and renamed.  A crash mid-write never corrupts
    LATEST, and a crash between the two renames leaves LATEST on the
    previous (still valid) checkpoint.
  * integrity -- the manifest records a crc32 per leaf;
    ``verify_checkpoint`` checks presence, sizes and checksums, and
    ``restore_checkpoint`` verifies by default.
  * recovery -- when LATEST (or the requested step) fails verification,
    restore WARNS LOUDLY and falls back to the newest checkpoint that
    passes (``fallback=False`` to opt out; a pinned ``step=`` raises).
  * transient-failure tolerance -- a whole write attempt retries with
    capped exponential backoff, so an EIO on a leaf write, an fsync hiccup
    or a rename failure costs a retry, not the checkpoint.
  * placement -- restore puts each leaf on its template leaf's device and
    keeps the checkpoint's dtype (the JAX package's ``shardings=`` reshard
    comes with multi-GPU, ROADMAP A11).
  * async -- ``AsyncCheckpointer.save`` copies the tree to host memory
    synchronously and writes it in a background thread that touches only
    numpy; ``close()`` (or the context manager, or the atexit hook) joins
    the last write and re-raises its error.
  * retention -- all but the newest ``keep_n`` checkpoints are pruned after
    a successful write.

numpy has no bfloat16, so a bf16 tensor leaf raises naming its path rather
than being saved as something else.  Fault injection: ``fault=cb`` is
called at each hook point, ``cb("io"|"fsync"|"rename", step)``, and
simulates a failure by raising (``repro_torch.ft.FaultPlan.ckpt_fault``).
"""
from __future__ import annotations

import atexit
import os
import pathlib
import shutil
import sys
import threading
import time
import warnings
import zlib
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.ckpt._msgpack import packb, unpackb
from repro_torch.util.tree import tree_leaves_with_path, tree_unflatten

PyTree = Any
FaultCb = Optional[Callable[[str, int], None]]

MANIFEST_VERSION = 2  # v2 added per-leaf crc32 + nbytes


def _to_host(path: str, leaf, copy: bool) -> np.ndarray:
    """A leaf as a numpy array; ``copy`` snapshots it (on the CPU
    ``Tensor.numpy()`` aliases the tensor, which training goes on
    changing)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(
                f"{path}: numpy has no bfloat16, so the checkpoint cannot "
                f"hold this leaf; keep f32 masters")
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _host_leaves(tree, copy: bool) -> list:
    return [(p, _to_host(p, leaf, copy))
            for p, leaf in tree_leaves_with_path(tree)]


def _crc32(arr: np.ndarray) -> int:
    """``zlib.crc32(arr.tobytes())`` without the copy where ``arr`` is
    contiguous."""
    if not arr.flags.c_contiguous or arr.size == 0:
        return zlib.crc32(arr.tobytes())
    return zlib.crc32(memoryview(arr.reshape(-1)).cast("B"))


def _fsync_file(path: pathlib.Path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: pathlib.Path):
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _warn(msg: str):
    """Loud on both channels: warnings for in-process callers and tests,
    stderr for subprocess drills grepping the driver's output."""
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
    print(f"[ckpt] WARNING: {msg}", file=sys.stderr, flush=True)


def _write_attempt(directory: pathlib.Path, step: int, leaves, manifest_extra,
                   keep_n: int, fault: FaultCb) -> pathlib.Path:
    """One full write attempt: tmp dir -> leaves -> manifest -> fsync ->
    rename -> LATEST.  Raises on any failure; the caller retries."""
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest = {"version": MANIFEST_VERSION, "step": step,
                "time": time.time(), "extra": manifest_extra, "leaves": []}
    for i, (path, arr) in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        if fault is not None:
            fault("io", step)
        np.save(tmp / fname, arr, allow_pickle=False)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "nbytes": int(arr.nbytes),
             "crc32": _crc32(arr)})
    (tmp / "manifest.msgpack").write_bytes(packb(manifest))

    # durability before visibility: the rename must not land before the
    # bytes it points at
    if fault is not None:
        fault("fsync", step)
    for p in tmp.iterdir():
        _fsync_file(p)
    _fsync_dir(tmp)

    if final.exists():
        shutil.rmtree(final)
    if fault is not None:
        fault("rename", step)
    os.rename(tmp, final)
    _fsync_dir(directory)

    # atomic LATEST pointer
    ptr_tmp = directory / f"LATEST.tmp-{os.getpid()}"
    ptr_tmp.write_text(final.name)
    _fsync_file(ptr_tmp)
    os.rename(ptr_tmp, directory / "LATEST")
    _fsync_dir(directory)

    _prune(directory, keep_n)
    return final


def save_checkpoint(directory, step: int, tree: PyTree, *,
                    extra: Optional[dict] = None, keep_n: int = 3,
                    fault: FaultCb = None, retries: int = 3,
                    backoff_s: float = 0.05,
                    max_backoff_s: float = 2.0) -> pathlib.Path:
    """Synchronous atomic verified save.  Returns the final checkpoint path.

    Transient IO failures (leaf write, fsync, rename) are retried up to
    ``retries`` extra attempts with capped exponential backoff; the final
    failure propagates."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    # materialise leaves ONCE so retries rewrite identical bytes
    leaves = _host_leaves(tree, copy=False)

    attempt = 0
    while True:
        try:
            return _write_attempt(directory, step, leaves, extra or {},
                                  keep_n, fault)
        except OSError as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = min(backoff_s * (2 ** (attempt - 1)), max_backoff_s)
            _warn(f"save step {step} attempt {attempt}/{retries} failed "
                  f"({e}); retrying in {delay:.2f}s")
            time.sleep(delay)


def _prune(directory: pathlib.Path, keep_n: int):
    ckpts = sorted(p for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and ".tmp" not in p.name)
    for old in ckpts[:-keep_n]:
        shutil.rmtree(old, ignore_errors=True)


def list_steps(directory) -> List[int]:
    """All on-disk checkpoint steps, ascending (no validity check)."""
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name:
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    ptr = directory / "LATEST"
    if not ptr.exists():
        # a crash between the data rename and the pointer rename leaves a
        # complete checkpoint with no pointer; surface it rather than
        # claiming the directory is empty
        steps = list_steps(directory)
        return steps[-1] if steps else None
    name = ptr.read_text().strip()
    if not (directory / name / "manifest.msgpack").exists():
        steps = list_steps(directory)
        return steps[-1] if steps else None
    return int(name.split("_")[1])


def _read_manifest(cdir: pathlib.Path) -> dict:
    return unpackb((cdir / "manifest.msgpack").read_bytes())


def verify_checkpoint(directory, step: int) -> List[str]:
    """Integrity check: manifest readable, every leaf file present with the
    manifest's byte size and crc32.  Returns the list of problems (empty ==
    valid)."""
    cdir = pathlib.Path(directory) / f"step_{step:08d}"
    problems: List[str] = []
    if not (cdir / "manifest.msgpack").exists():
        return [f"{cdir.name}: missing manifest"]
    try:
        manifest = _read_manifest(cdir)
    except ValueError as e:  # corrupt manifest bytes
        return [f"{cdir.name}: unreadable manifest ({e})"]
    if not isinstance(manifest, dict):
        return [f"{cdir.name}: unreadable manifest (not a map)"]
    for entry in manifest.get("leaves", []):
        fpath = cdir / entry["file"]
        if not fpath.exists():
            problems.append(f"{cdir.name}/{entry['file']}: missing")
            continue
        if "crc32" not in entry:
            continue  # v1 manifest: presence is all we can check
        try:
            arr = np.load(fpath, allow_pickle=False)
        except (OSError, ValueError, EOFError) as e:  # torn or garbled
            problems.append(f"{cdir.name}/{entry['file']}: unreadable ({e})")
            continue
        if int(arr.nbytes) != int(entry.get("nbytes", arr.nbytes)):
            problems.append(
                f"{cdir.name}/{entry['file']}: size {arr.nbytes} != "
                f"manifest {entry['nbytes']}")
        elif _crc32(arr) != entry["crc32"]:
            problems.append(
                f"{cdir.name}/{entry['file']}: crc32 mismatch "
                f"(bit rot or torn write)")
    return problems


def latest_valid_step(directory) -> Optional[int]:
    """Newest step that passes ``verify_checkpoint`` (LATEST-first order)."""
    for step in _candidate_steps(directory):
        if not verify_checkpoint(directory, step):
            return step
    return None


def _candidate_steps(directory) -> List[int]:
    """Restore order: the LATEST pointer's step first, then every other
    on-disk step, newest first."""
    steps = sorted(list_steps(directory), reverse=True)
    head = latest_step(directory)
    if head in steps:
        steps.remove(head)
        steps.insert(0, head)
    return steps


def restore_checkpoint(directory, template: PyTree, *,
                       step: Optional[int] = None, verify: bool = True,
                       fallback: bool = True):
    """Restore into the structure of ``template``, each leaf on its template
    leaf's device, in the checkpoint's dtype.

    With ``verify`` (default) each candidate's checksums are checked before
    it is loaded; with ``fallback`` (default, only when ``step`` is not
    pinned) a failing candidate is skipped WITH A LOUD WARNING and the next
    newest is tried, so a bit-flipped or torn LATEST costs one checkpoint
    interval, not the run.  A pinned ``step=`` that fails verification
    raises instead.

    Returns (tree, step, extra).
    """
    directory = pathlib.Path(directory)
    if step is not None:
        candidates = [step]
        allow_fallback = False
    else:
        candidates = _candidate_steps(directory)
        allow_fallback = fallback
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {directory}")

    errors: List[str] = []
    for i, cand in enumerate(candidates):
        if verify:
            problems = verify_checkpoint(directory, cand)
            if problems:
                msg = (f"checkpoint step {cand} failed verification: "
                       + "; ".join(problems))
                if not allow_fallback:
                    raise ValueError(msg)
                _warn(msg + " — falling back to the previous checkpoint")
                errors.append(msg)
                continue
        try:
            tree, got_step, extra = _load_checkpoint(directory, cand,
                                                     template)
        except (OSError, KeyError) as e:
            # ValueError (template shape mismatch) propagates: that is a
            # CALLER bug every candidate shares, not checkpoint damage
            if not allow_fallback:
                raise
            msg = f"checkpoint step {cand} failed to load: {e}"
            _warn(msg + " — falling back to the previous checkpoint")
            errors.append(msg)
            continue
        if i > 0:
            _warn(f"recovered from checkpoint step {cand} after "
                  f"{i} newer candidate(s) failed")
        return tree, got_step, extra
    raise FileNotFoundError(
        f"no valid checkpoint in {directory}; tried {candidates}: "
        + " | ".join(errors))


def _load_checkpoint(directory: pathlib.Path, step: int, template: PyTree):
    cdir = directory / f"step_{step:08d}"
    manifest = _read_manifest(cdir)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for path, tmpl in tree_leaves_with_path(template):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(cdir / entry["file"], allow_pickle=False)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"{path}: checkpoint shape {arr.shape} != template "
                f"{tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            arr = torch.from_numpy(arr).to(tmpl.device)
        out.append(arr)
    tree = tree_unflatten(template, out)
    return tree, manifest["step"], manifest.get("extra", {})


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background thread.

    ``save`` blocks only for the device->host copy; the previous write is
    joined first (at most one outstanding write, bounding host memory).
    ``timings`` lists each landed write's step, its blocking snapshot
    seconds and its background write seconds (files, crc32s, fsyncs and
    renames).

    Lifecycle: the writer thread is a daemon, so WITHOUT an explicit join
    the interpreter would exit mid-write and silently drop the final
    checkpoint.  ``close()`` joins the in-flight write and re-raises any
    background error; it runs automatically via the context-manager exit
    and an ``atexit`` hook (atexit fires before daemon threads are killed).
    Only a hard kill (os._exit / SIGKILL) skips it, which is exactly the
    crash the on-disk atomicity covers."""

    def __init__(self, directory, keep_n: int = 3, fault: FaultCb = None):
        self.directory = pathlib.Path(directory)
        self.keep_n = keep_n
        self.fault = fault
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.last_error: Optional[Exception] = None
        self.timings: List[dict] = []
        self._atexit = atexit.register(self._atexit_close)

    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None):
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self.wait()
        t0 = time.perf_counter()
        host_tree = tree_unflatten(tree, [arr for _, arr in _host_leaves(
            tree, copy=True)])  # snapshot
        snapshot_s = time.perf_counter() - t0

        def _write():
            t1 = time.perf_counter()
            try:
                save_checkpoint(self.directory, step, host_tree,
                                extra=extra, keep_n=self.keep_n,
                                fault=self.fault)
            except Exception as e:  # noqa: BLE001 - surfaced on next wait()
                self.last_error = e
                return
            self.timings.append({"step": step, "snapshot_s": snapshot_s,
                                 "write_s": time.perf_counter() - t1})

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def close(self):
        """Flush the in-flight write and surface its error; idempotent."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit_close)
        self.wait()

    def _atexit_close(self):
        try:
            self.close()
        except Exception as e:  # noqa: BLE001 - atexit must not re-raise
            print(f"[ckpt] WARNING: final checkpoint write failed at "
                  f"interpreter exit: {e}", file=sys.stderr, flush=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # don't mask an in-flight training exception with a flush error
        if exc_type is not None:
            try:
                self.close()
            except Exception as e:  # noqa: BLE001
                print(f"[ckpt] WARNING: checkpoint flush failed during "
                      f"exception unwind: {e}", file=sys.stderr, flush=True)
            return False
        self.close()
        return False
