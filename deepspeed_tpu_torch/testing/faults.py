"""Fault-injection harness for the crash-safe checkpoint / recovery paths
(counterpart of `deepspeed_tpu/testing/faults.py`, over the port's saver).

Three fault families, matching the failure modes that actually brick long
training runs:

  * `crash_save(point)` — kill a `save_checkpoint` at a precise moment of the
    atomic-commit protocol (state written / manifest written / committed but
    `latest` not advanced), via the hook points `checkpoint/saver.py` exposes.
  * `corrupt_checkpoint` / `corrupt_file` — bit-flip, truncate or delete
    checkpoint payload or manifest files on disk, the way a partial write or
    storage fault would.
  * `poison_batch` — plant a NaN in a batch so the very next step produces
    non-finite gradients/loss at a chosen moment, driving the engine's
    bad-state sentinel (`runtime/sentinel.py`).

Used by `tests/test_torch_fault_tolerance.py` and `chip_smoke.py` to prove
every recovery path end-to-end; safe to use in integration harnesses (the context managers always
deinstall their hooks).
"""

import contextlib
import copy
import os
import pathlib

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import manifest as manifest_mod
from deepspeed_tpu_torch.checkpoint import saver as saver_mod


class FaultInjected(RuntimeError):
    """The simulated failure raised by installed fault hooks."""


# ----------------------------------------------------------------------
# mid-save crash injection
# ----------------------------------------------------------------------

SAVE_CRASH_POINTS = ("after_state_save", "before_commit", "after_commit")


@contextlib.contextmanager
def crash_save(point="before_commit", match_tag=None):
    """Make the next `save_checkpoint` die at `point`:

      after_state_save — state durable, no metadata/manifest yet (the classic
                         preemption-during-save): tag stays uncommitted
      before_commit    — manifest written but rename-commit never runs: the
                         staging dir is orphaned, `latest` untouched
      after_commit     — tag committed but `latest` never advances: the scan
                         fallback must still find it

    `match_tag` restricts the crash to one tag (other saves pass through).
    The exception surfaces as `FaultInjected` (sync saves) or out of
    `wait_pending_save` / the async engine's `wait()` (async saves).
    """
    assert point in SAVE_CRASH_POINTS, f"unknown crash point {point!r}"

    def hook(point=None, tag=None, **_ctx):
        if match_tag is not None and str(tag) != str(match_tag):
            return
        raise FaultInjected(f"injected crash at {point} (tag={tag})")

    prev = saver_mod._FAULT_HOOKS.get(point)
    saver_mod._FAULT_HOOKS[point] = hook
    try:
        yield
    finally:
        if prev is None:
            saver_mod._FAULT_HOOKS.pop(point, None)
        else:
            saver_mod._FAULT_HOOKS[point] = prev


# ----------------------------------------------------------------------
# on-disk corruption
# ----------------------------------------------------------------------


def corrupt_file(path, n_bytes=16, offset=None, mode="flip"):
    """Damage a file in place: `flip` XORs `n_bytes` at `offset` (default:
    the middle of the file), `truncate` drops the second half, `delete`
    removes it."""
    path = pathlib.Path(path)
    assert path.is_file(), f"cannot corrupt missing file {path}"
    if mode == "delete":
        path.unlink()
        return
    size = path.stat().st_size
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 0))
        return
    assert mode == "flip", f"unknown corruption mode {mode!r}"
    if size == 0:
        with open(path, "ab") as f:
            f.write(b"\xff")
        return
    off = size // 2 if offset is None else min(offset, size - 1)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n_bytes)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


def corrupt_checkpoint(save_dir, tag=None, target="state", mode="flip"):
    """Corrupt a committed checkpoint tag. `target`:

      state    — the largest state payload file (state.pt / state.npz)
      manifest — the integrity manifest itself
      client   — client.json

    Returns the corrupted file's path."""
    save_dir = pathlib.Path(save_dir)
    tag = tag or saver_mod.get_latest_tag(save_dir)
    assert tag is not None, f"no checkpoint tag to corrupt in {save_dir}"
    ckpt_dir = save_dir / str(tag)
    if target == "manifest":
        victim = ckpt_dir / manifest_mod.MANIFEST_FILE
    elif target == "client":
        victim = ckpt_dir / "client.json"
    else:
        assert target == "state", f"unknown corruption target {target!r}"
        state_files = [p for p in (ckpt_dir / "state").rglob("*")
                       if p.is_file()]
        assert state_files, f"no state files under {ckpt_dir / 'state'}"
        victim = max(state_files, key=lambda p: p.stat().st_size)
    corrupt_file(victim, mode=mode)
    return str(victim)


# ----------------------------------------------------------------------
# NaN-gradient injection
# ----------------------------------------------------------------------


def poison_batch(batch, value=np.nan):
    """Return a copy of `batch` with `value` planted in its first float leaf —
    the next `train_batch` on it produces non-finite loss/gradients, which is
    how a real numeric blow-up presents to the engine's sentinel."""
    poisoned = copy.deepcopy(batch)

    def _plant(tree):
        if isinstance(tree, dict):
            for k in tree:
                if _plant_leaf(tree, k):
                    return True
            for k in tree:
                if isinstance(tree[k], dict) and _plant(tree[k]):
                    return True
        return False

    def _plant_leaf(d, k):
        leaf = d[k]
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and leaf.numel():
                t = leaf.clone()
                t.view(-1)[0] = value
                d[k] = t
                return True
            return False
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and arr.size:
            arr = np.array(arr)  # writable copy
            arr.flat[0] = value
            d[k] = arr
            return True
        return False

    assert isinstance(poisoned, dict), "poison_batch expects a dict batch"
    assert _plant(poisoned), \
        "poison_batch: batch has no float leaf to plant a NaN in " \
        "(token-only batches: poison the loss/labels path instead)"
    return poisoned


class NaNAtStep:
    """Stateful wrapper around a batch source: yields clean batches except at
    the chosen global steps, where the batch is poisoned. Drives "inject NaN
    gradients at step k" scenarios without touching the engine."""

    def __init__(self, make_batch, nan_steps):
        self.make_batch = make_batch
        self.nan_steps = set(int(s) for s in nan_steps)
        self.calls = 0

    def __call__(self):
        batch = self.make_batch()
        if self.calls in self.nan_steps:
            batch = poison_batch(batch)
        self.calls += 1
        return batch
