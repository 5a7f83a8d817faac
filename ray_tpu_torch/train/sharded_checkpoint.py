"""Durable stage shards of the MPMD pipeline trainer.

Counterpart of the stage-shard half of ``ray_tpu/train/
sharded_checkpoint.py``. The elastic pipeline trainer (``train/mpmd.py``)
snapshots each stage's (params, optimizer state) to host memory at step
boundaries; these durable shards are the fallback restore source when
that snapshot is gone. One shard is one stage on one host, so there is
nothing to coordinate: a shard is a ``torch.save`` of the snapshot's CPU
tensors and numbers, written through ``util.storage`` and read back with
``weights_only=True``. The orbax half of the JAX module (mesh-sharded
save/restore, restore-and-broadcast) is not ported yet (ROADMAP.md,
Queue A item A7).
"""

from __future__ import annotations

import io
import threading
from typing import Any, Optional

import torch

from ray_tpu_torch.util import storage as _storage


def _stage_shard_path(root: str, stage_idx: int) -> str:
    return _storage.join(root, f"stage_{stage_idx:03d}", "shard.pt")


def save_stage_shard(root: str, stage_idx: int, snapshot: Any) -> str:
    """Persist one pipeline stage's host snapshot under
    ``root/stage_NNN/`` (local path or fsspec URI). Overwrites the
    previous boundary — the replay buffer only ever needs the latest."""
    path = _stage_shard_path(root, stage_idx)
    _storage.makedirs(_storage.join(root, f"stage_{stage_idx:03d}"))
    buf = io.BytesIO()
    torch.save(snapshot, buf)
    _storage.write_bytes(path, buf.getvalue())
    return path


def restore_stage_shard(root: str, stage_idx: int) -> Any:
    """Read one stage shard back: the snapshot, its tensors on the CPU."""
    data = _storage.read_bytes(_stage_shard_path(root, stage_idx))
    return torch.load(io.BytesIO(data), weights_only=True)


class AsyncShardWriter:
    """Off-step durable shard writes: ``submit()`` enqueues a stage's
    latest boundary snapshot and returns immediately; one daemon thread
    writes the blobs through :func:`save_stage_shard`, so the training
    hot path never waits on storage. A newer submission for the same
    stage supersedes a queued older one (only the latest boundary
    matters for recovery). ``barrier()`` drains the queue and belongs on
    the recovery path, never per step; write failures are remembered and
    raised there (the shards are the FALLBACK restore source behind the
    in-memory snapshot, so a missed write degrades, it does not
    corrupt)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict = {}          # (root, stage_idx) -> snapshot
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.writes = 0

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="shard-writer", daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            self._wake.wait()
            with self._lock:
                if self._stop and not self._pending:
                    return
                if not self._pending:
                    self._wake.clear()
                    self._idle.set()
                    continue
                key, snap = next(iter(self._pending.items()))
                del self._pending[key]
            try:
                save_stage_shard(key[0], key[1], snap)
                with self._lock:
                    self.writes += 1
            except Exception as e:   # raised at the next barrier
                with self._lock:
                    self.last_error = e

    def submit(self, root: str, stage_idx: int, snapshot: Any):
        with self._lock:
            self._pending[(root, stage_idx)] = snapshot
            self._idle.clear()
        self._wake.set()
        self._ensure_thread()

    def barrier(self, timeout: Optional[float] = None) -> bool:
        """Drain queued writes (recovery-time only). Returns False on
        timeout; re-raises the last write error, if any, exactly once."""
        drained = True if self._thread is None else self._idle.wait(timeout)
        with self._lock:
            err, self.last_error = self.last_error, None
        if err is not None:
            raise RuntimeError("async stage-shard write failed") from err
        return drained

    def stop(self):
        with self._lock:
            self._stop = True
        self._wake.set()
