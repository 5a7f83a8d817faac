"""Per-worker training session (counterpart of
``ray_tpu/train/session.py``; reference:
python/ray/train/_internal/session.py:111 _TrainSession — report/checkpoint
queue :403). `report()` is called from the user's training loop inside a
worker actor; results buffer in the actor and the driver drains them."""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class TrainContext:
    world_size: int
    world_rank: int
    local_rank: int
    node_rank: int
    trial_name: str = "train"
    experiment_name: str = "train"

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank


class _Session:
    def __init__(self, context: TrainContext):
        self.context = context
        self.results: List[Dict[str, Any]] = []
        self.lock = threading.Lock()
        self.latest_checkpoint: Optional[Checkpoint] = None
        self.dataset_shards: Dict[str, Any] = {}

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        with self.lock:
            self.results.append({"metrics": dict(metrics),
                                 "checkpoint": checkpoint})

    def drain(self) -> List[Dict[str, Any]]:
        with self.lock:
            out = self.results
            self.results = []
            return out


_session: Optional[_Session] = None


def _init_session(context: TrainContext) -> _Session:
    global _session
    _session = _Session(context)
    return _session


def _shutdown_session():
    global _session
    _session = None


def get_session() -> Optional[_Session]:
    return _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (rank 0's checkpoint is persisted by the driver)."""
    s = _session
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside "
                           "a training worker")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = _session
    if s is None:
        raise RuntimeError("not inside a training worker")
    return s.context


def get_checkpoint() -> Optional[Checkpoint]:
    s = _session
    return s.latest_checkpoint if s else None


_step_profiler = None


def step_profiler():
    """The training loop's StepProfiler (util/profiling.py), named
    ``train_step`` so its gauges land as ``runtime_train_step_mfu`` +
    phase attribution. One per process: inside a training worker every
    epoch shares it; outside (bare scripts, tests) it still works — the
    gauges just push from whatever process runs the loop.

    Usage inside ``train_loop_per_worker``::

        prof = ray_tpu_torch.train.step_profiler()
        step = prof.wrap_step(step_fn)          # counted FLOPs
        for batch in loader:
            with prof.step(tokens=batch.numel()) as s:
                s.data_ready()
                state, metrics = step(state, batch)
                s.block(metrics["loss"])

    (``parallel.make_train_fns(..., profiler=prof)`` does this itself.)
    """
    global _step_profiler
    if _step_profiler is None:
        from ray_tpu_torch.util.profiling import StepProfiler
        _step_profiler = StepProfiler("train_step")
    return _step_profiler


def get_dataset_shard(name: str = "train"):
    """This worker's streaming shard of a Dataset passed to the trainer
    (reference: ray.train.get_dataset_shard — DataIterator per worker)."""
    s = _session
    if s is None:
        raise RuntimeError("not inside a training worker")
    shard = s.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset shard {name!r}; trainer datasets: "
            f"{sorted(s.dataset_shards)}")
    return shard
