"""Checkpoints: a directory of files, moved via the object store.

Counterpart of ``ray_tpu/train/checkpoint.py`` (reference:
python/ray/train/_checkpoint.py — dir + pyarrow fs; here the transport is
the shared-memory object store and persistence is a local / NFS / fuse
path or any fsspec URI). What a training loop writes into the directory
is its own choice, for example ``torch.save`` of its state."""

from __future__ import annotations

import os
import shutil
import tarfile
import tempfile
import uuid
from io import BytesIO
from typing import Any, Dict, Optional


class Checkpoint:
    """Either a path-backed or bytes-backed (in object store) checkpoint."""

    def __init__(self, path: Optional[str] = None,
                 _blob: Optional[bytes] = None,
                 metrics: Optional[Dict[str, Any]] = None):
        self.path = path
        self._blob = _blob
        self.metrics = metrics or {}

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        buf = BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(path, arcname=".")
        return cls(_blob=buf.getvalue())

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        import cloudpickle
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "data.pkl"), "wb") as f:
                cloudpickle.dump(data, f)
            return cls.from_directory(d)

    def to_directory(self, path: Optional[str] = None) -> str:
        from ray_tpu_torch.util import storage as _storage
        if path is None:
            path = tempfile.mkdtemp(prefix="rt_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._blob is not None:
            with tarfile.open(fileobj=BytesIO(self._blob)) as tar:
                tar.extractall(path, filter="data")
        elif self.path is not None and _storage.is_remote(self.path):
            # URI-persisted checkpoint: single tar object (see persist)
            tar_uri = _storage.join(self.path, "ckpt.tar")
            if _storage.exists(tar_uri):
                raw = _storage.read_bytes(tar_uri)
                with tarfile.open(fileobj=BytesIO(raw)) as tar:
                    tar.extractall(path, filter="data")
            else:
                _storage.download_dir(self.path, path)
        elif self.path is not None and os.path.abspath(self.path) != \
                os.path.abspath(path):
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def to_dict(self) -> Dict[str, Any]:
        import cloudpickle
        with tempfile.TemporaryDirectory() as d:
            self.to_directory(d)
            with open(os.path.join(d, "data.pkl"), "rb") as f:
                return cloudpickle.load(f)

    def persist(self, storage_dir: str, name: Optional[str] = None) -> str:
        """Write this checkpoint under storage_dir (local path or any
        fsspec URI — gs://bucket/exp on real pods; reference: Train's
        StorageContext uploads to pyarrow filesystems). Returns the new
        path/URI."""
        from ray_tpu_torch.util import storage as _storage
        _storage.validate_root(storage_dir, "checkpoint")
        name = name or f"checkpoint_{uuid.uuid4().hex[:8]}"
        if _storage.is_remote(storage_dir):
            uri = _storage.join(storage_dir, name)
            blob = self._blob
            if blob is None:
                tar_uri = _storage.join(self.path, "ckpt.tar")
                if _storage.is_remote(self.path):
                    # already tarred at the source URI: copy the bytes
                    # (tar.add only reads local paths anyway)
                    blob = _storage.read_bytes(tar_uri)
                else:
                    buf = BytesIO()
                    with tarfile.open(fileobj=buf, mode="w") as tar:
                        tar.add(self.path, arcname=".")
                    blob = buf.getvalue()
            _storage.write_bytes(_storage.join(uri, "ckpt.tar"), blob)
            self.path = uri
            self._blob = None
            return uri
        path = os.path.join(storage_dir, name)
        self.to_directory(path)
        self.path = path
        self._blob = None
        return path

    def __reduce__(self):
        return (Checkpoint, (self.path, self._blob, self.metrics))


class CheckpointManager:
    """Top-k retention by score (reference:
    python/ray/train/_internal/checkpoint_manager.py)."""

    def __init__(self, storage_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, order: str = "max"):
        from ray_tpu_torch.util import storage as _storage
        _storage.validate_root(storage_dir, "checkpoint")
        self.storage_dir = storage_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.order = order
        self.checkpoints = []   # [(score, path, metrics)]
        self._counter = 0
        _storage.makedirs(storage_dir)

    def register(self, ckpt: Checkpoint, metrics: Dict[str, Any]) -> str:
        self._counter += 1
        path = ckpt.persist(self.storage_dir,
                            f"checkpoint_{self._counter:06d}")
        score = None
        if self.score_attribute:
            score = metrics.get(self.score_attribute)
        self.checkpoints.append((score, path, dict(metrics)))
        self._enforce_retention()
        return path

    def _enforce_retention(self):
        if self.num_to_keep is None or \
                len(self.checkpoints) <= self.num_to_keep:
            return
        if self.score_attribute:
            # unscored checkpoints must rank BELOW every scored one in
            # either direction
            if self.order == "max":
                ranked = sorted(
                    self.checkpoints,
                    key=lambda t: (t[0] is not None,
                                   t[0] if t[0] is not None
                                   else float("-inf")),
                    reverse=True)
            else:
                ranked = sorted(
                    self.checkpoints,
                    key=lambda t: (t[0] is None,
                                   t[0] if t[0] is not None
                                   else float("inf")))
        else:
            ranked = list(self.checkpoints)   # FIFO: oldest dropped
            ranked = ranked[::-1]
        keep = set(id(t) for t in ranked[:self.num_to_keep])
        from ray_tpu_torch.util import storage as _storage
        for t in list(self.checkpoints):
            if id(t) not in keep:
                if _storage.is_remote(t[1]):
                    _storage.delete_dir(t[1])
                else:
                    shutil.rmtree(t[1], ignore_errors=True)
                self.checkpoints.remove(t)

    def best_checkpoint(self):
        if not self.checkpoints:
            return None
        if self.score_attribute:
            scored = [t for t in self.checkpoints if t[0] is not None]
            if scored:
                best = (max if self.order == "max" else min)(
                    scored, key=lambda t: t[0])
                return Checkpoint(path=best[1], metrics=best[2])
        t = self.checkpoints[-1]
        return Checkpoint(path=t[1], metrics=t[2])

    def latest_checkpoint(self):
        if not self.checkpoints:
            return None
        t = self.checkpoints[-1]
        return Checkpoint(path=t[1], metrics=t[2])
