"""Sharded checkpoints: save and restore a (possibly DTensor-sharded)
state dict without gathering it to one process, and the durable stage
shards of the MPMD pipeline trainer.

Counterpart of ``ray_tpu/train/sharded_checkpoint.py``. Where the JAX
module writes through orbax, this one writes through
``torch.distributed.checkpoint`` (DCP), PyTorch's own format for sharded
state: every rank writes only its own shards (a plain tensor, replicated
on every rank, is written once), and a restore reads into the layout of
the state dict it is given (``abstract_like``): plain tensors, or
DTensors on another mesh or with other placements than were saved.
Without a process group one process writes and reads everything. The
host form of a checkpoint (``restore_host_arrays``) is a state dict of
CPU tensors, which the weight plane carries (``broadcast_weights``); bf16
has no numpy dtype, so nothing here goes through numpy. A checkpoint of
this package and one of the JAX package cannot read each other.

The elastic pipeline trainer (``train/mpmd.py``) snapshots each stage's
(params, optimizer state) to host memory at step boundaries; the stage
shards are the fallback restore source when that snapshot is gone. One
shard is one stage on one host, so there is nothing to coordinate: a
shard is a ``torch.save`` of the snapshot's CPU tensors and numbers,
written through ``util.storage`` and read back with
``weights_only=True``.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import threading
import warnings
from typing import Any, Optional

import torch

from ray_tpu_torch.util import storage as _storage


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


@contextlib.contextmanager
def _one_process():
    """DCP warns when it runs without a process group, which is meant."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is")
        yield


def save_sharded(state: Any, path: str, *, force: bool = True) -> str:
    """Write a state dict (nested dicts of tensors, DTensors and plain
    values); every rank writes its own shards (DCP plans the write over
    the default process group). ``force`` replaces a checkpoint already
    at ``path``."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    dist = _dist()
    if force and (dist is None or dist.get_rank() == 0) \
            and os.path.exists(path):
        shutil.rmtree(path)
    if dist is not None:
        dist.barrier()
    with _one_process():
        dcp.save(state, checkpoint_id=path, no_dist=dist is None)
    return path


def restore_sharded(path: str, abstract_state: Any) -> Any:
    """Restore into ``abstract_state`` (``abstract_like``): each tensor
    is filled in place in its own layout, so a DTensor's rank reads only
    the shards it holds. Returns the filled state dict."""
    import torch.distributed.checkpoint as dcp
    with _one_process():
        dcp.load(abstract_state, checkpoint_id=os.path.abspath(path),
                 no_dist=_dist() is None)
    return abstract_state


def abstract_like(state: Any, layouts: Optional[Any] = None,
                  device: Optional[Any] = None) -> Any:
    """The unfilled target state dict ``restore_sharded`` needs: for each
    tensor of ``state`` (real or on the meta device) an empty one of its
    shape and dtype, laid out as its entry in ``layouts`` says (a tree
    like ``state`` of ``(device_mesh, placements)``, or None for a plain
    tensor), else as the tensor itself is (a DTensor keeps its mesh and
    placements). Plain tensors go to ``device`` (default: the tensor's
    own, the CPU for a meta tensor). Other values are kept."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import empty as dt_empty

    def mk(x, lay):
        if not isinstance(x, torch.Tensor):
            return x
        if lay is None and isinstance(x, DTensor):
            lay = (x.device_mesh, tuple(x.placements))
        if lay is not None:
            mesh, placements = lay
            return dt_empty(*x.shape, dtype=x.dtype, device_mesh=mesh,
                            placements=list(placements))
        dev = device if device is not None else (
            "cpu" if x.device.type == "meta" else x.device)
        return torch.empty(x.shape, dtype=x.dtype, device=dev)

    def walk(x, lay):
        if isinstance(x, dict):
            return {k: walk(v, None if lay is None else lay.get(k))
                    for k, v in x.items()}
        return mk(x, lay)
    return walk(state, layouts)


# ------------------------------------------------- broadcast-backed restore
# Cold start or elastic restart: ONE process reads the checkpoint off
# storage, then the weight-distribution plane fans the host tree out to
# every node as one sealed arena object over the relay tree, so N-1 hosts
# read their local arena instead of N hosts reading the checkpoint's
# storage.

def restore_host_arrays(path: str) -> Any:
    """Read a whole checkpoint into CPU tensors, with no placement: the
    form the weight plane broadcasts. The target is built from the
    checkpoint's own metadata (each entry's nesting, shape and dtype)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    path = os.path.abspath(path)
    md = dcp.FileSystemReader(path).read_metadata()
    state: dict = {}
    for fqn, item in md.state_dict_metadata.items():
        keys = (md.planner_data or {}).get(fqn, (fqn,))
        node = state
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (
            torch.empty(tuple(item.size), dtype=item.properties.dtype)
            if isinstance(item, TensorStorageMetadata) else None)
    with _one_process():
        dcp.load(state, checkpoint_id=path, no_dist=True)
    return state


def restore_and_broadcast(path: str, abstract_state: Any = None,
                          node_ids: Optional[Any] = None):
    """Read a checkpoint in THIS process and place it cluster-wide with
    ``ray_tpu_torch.broadcast_weights``. Returns the ObjectRef every
    other host passes to :func:`restore_from_broadcast`.
    ``abstract_state=None`` reads CPU tensors (the broadcast form: each
    host places them at attach); with a target state dict the restored
    tensors are gathered whole to the CPU and broadcast."""
    import ray_tpu_torch
    if abstract_state is None:
        state = restore_host_arrays(path)
    else:
        from torch.distributed.tensor import DTensor
        state = _map(restore_sharded(path, abstract_state),
                     lambda x: (x.full_tensor() if isinstance(x, DTensor)
                                else x).cpu())
    return ray_tpu_torch.broadcast_weights(state, node_ids=node_ids)


def restore_from_broadcast(ref, abstract_state: Any = None) -> Any:
    """Materialize a broadcast checkpoint on this host: a zero-copy get
    from the local arena, then, given a target state dict, each tensor
    cast to its dtype and placed in its layout (a DTensor target keeps
    only this rank's shards)."""
    import ray_tpu_torch
    state = ray_tpu_torch.get(ref)
    if abstract_state is None:
        return state
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(x, ab):
        if not isinstance(ab, torch.Tensor):
            return x
        if isinstance(ab, DTensor):
            return distribute_tensor(
                x.to(ab.dtype).to(ab.device_mesh.device_type),
                ab.device_mesh, ab.placements, src_data_rank=None)
        return x.to(device=ab.device, dtype=ab.dtype)

    def walk(x, ab):
        if isinstance(x, dict):
            return {k: walk(v, ab[k]) for k, v in x.items()}
        return place(x, ab)
    return walk(state, abstract_state)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


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


def restore_stage_shard(root: str, stage_idx: int,
                        broadcast: bool = False) -> Any:
    """Read one stage shard back: the snapshot, its tensors on the CPU.
    ``broadcast=True`` (cluster recovery) sends it through
    ``ray_tpu_torch.broadcast_weights`` and returns the ObjectRef, so the
    replacement stage reads it from its local arena (a plain put where
    the weight plane is unavailable)."""
    data = _storage.read_bytes(_stage_shard_path(root, stage_idx))
    snap = torch.load(io.BytesIO(data), weights_only=True)
    if not broadcast:
        return snap
    import ray_tpu_torch
    try:
        return ray_tpu_torch.broadcast_weights(snap)
    except Exception:
        # weight plane unavailable (one node, no data plane): the plain
        # put still parks the shard in the arena for the replacement
        return ray_tpu_torch.put(snap)


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
