"""Checkpoint rotation, writes on a writer thread, and resume discovery
(mirrors ``repro.ckpt.manager``).

``save`` copies every leaf to host numpy on the caller's thread before the
writer thread starts (the reference's ``jax.device_get`` snapshot): the
next optimizer step updates the parameters and moments in place, so a
thread handed the live tensors would write a torn state.

With a process ``group`` (a sharded trainer, whose caller gathers the
whole tree first), only the group's rank 0 writes, and every ``wait``
ends in a barrier, so no rank reads a checkpoint before it is written.
"""
from __future__ import annotations

import os
import re
import shutil
import threading

import torch.distributed as dist

from repro_torch.ckpt.checkpoint import (host_copy, load_checkpoint,
                                         save_checkpoint)

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """keep_n rotation; saves run on a writer thread so the train loop is
    not blocked on serialization (the device-to-host copy happens on the
    caller's thread, to snapshot a consistent state)."""

    def __init__(self, root: str, keep_n: int = 3, async_save: bool = True,
                 group=None):
        self.root = root
        self.keep_n = keep_n
        self.async_save = async_save
        self.group = group
        self.writer = group is None or dist.get_rank(group) == 0
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(root, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:
            dist.barrier(group=self.group)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, tree: dict, step: int, extra: dict | None = None) -> None:
        """Snapshot the flat ``tree`` ({path: tensor, ndarray or HostArray})
        to host memory now; write it as ``step_<step>`` on the writer thread
        (or here, without ``async_save``), then drop all but the newest
        ``keep_n``.  A rank other than the writer only waits."""
        host_tree = {k: host_copy(v) for k, v in tree.items()}
        self.wait()
        if not self.writer:
            return

        def work():
            save_checkpoint(self._path(step), host_tree, step, extra)
            self._gc()

        if not self.async_save:
            work()
            return

        def guarded():
            try:
                work()
            except Exception as e:  # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def restore(self, like_tree: dict | None = None, step: int | None = None):
        """``(tree, step, extra)`` of checkpoint ``step`` (the newest when
        None), or None when there is none.  A write still in flight is
        waited for first, so the newest is the last one saved."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return load_checkpoint(self._path(step), like_tree)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self._path(s), ignore_errors=True)
