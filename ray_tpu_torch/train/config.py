"""Train config dataclasses (counterpart of ``ray_tpu/train/config.py``;
reference: python/ray/air/config.py — ScalingConfig, RunConfig,
FailureConfig, CheckpointConfig). A worker asks for a card with
``use_gpu`` ({"GPU": 1}); a gang of several GPU workers starts
``torch.distributed``'s default process group before the loop runs, over
which a ``mesh`` (``parallel/mesh.MeshConfig``) lays out each worker's
model."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:
    from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    # a pod-slice topology; gang scheduling on one is not ported
    # (ROADMAP.md, Queue A item A3c-2) and BackendExecutor.start raises
    topology: Optional[str] = None
    mesh: Optional[MeshConfig] = None     # per-worker device mesh axes
    placement_strategy: str = "PACK"
    # None -> follow use_gpu; True forces the torch.distributed rendezvous
    # even on CPU workers (gloo, used in CI)
    use_torch_distributed: Optional[bool] = None

    def torch_distributed_enabled(self) -> bool:
        """Explicit True/False wins (even for one worker); default follows
        use_gpu, where a single-worker run needs no rendezvous."""
        if self.use_torch_distributed is not None:
            return self.use_torch_distributed
        return self.use_gpu and self.num_workers > 1

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res


@dataclasses.dataclass
class DataConfig:
    """Which datasets are streaming-split across train workers; others are
    replicated per worker (reference: ray.train DataConfig,
    python/ray/train/_internal/data_config.py)."""
    datasets_to_split: Any = "all"      # "all" | list of names


@dataclasses.dataclass
class FailureConfig:
    """Failure budget + restart granularity for training runs.

    restart_policy:
      "job"   — any worker death restarts the WHOLE gang from the latest
                checkpoint (the only safe granularity for a
                torch.distributed gang, which fails as a unit).
      "stage" — only the dead party restarts: TorchTrainer replaces the
                failed worker in place (BackendExecutor per-worker
                replace, latest-checkpoint resume pushed to it) and the
                MPMD pipeline trainer replaces the lost STAGE (park →
                restore shard → replay) while survivors keep their
                state. Falls back to job-level restart where per-worker
                replace is unsound (torch.distributed gangs).
    restart_backoff_s: delay before any restart/replace attempt.
    """
    max_failures: int = 0
    restart_policy: str = "job"
    restart_backoff_s: float = 1.0

    def __post_init__(self):
        if self.restart_policy not in ("job", "stage"):
            raise ValueError(
                f"restart_policy must be 'job' or 'stage', "
                f"got {self.restart_policy!r}")
        if self.restart_backoff_s < 0:
            raise ValueError("restart_backoff_s must be >= 0")


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
