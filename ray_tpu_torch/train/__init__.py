"""Training beyond one step: the train executor (``TorchTrainer`` over a
gang of worker actors, with per-worker sessions, checkpoints and the
failure ladder) and the MPMD pipeline trainer (stages in process or as
actors of the port's runtime), their configs and durable stage shards.

The MPMD trainer and the stage shards load on first touch, as in the JAX
package: ``import ray_tpu_torch.train`` imports no torch, so a train
worker whose loop needs none starts without it."""

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (CheckpointConfig, DataConfig,
                                        FailureConfig, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.session import (get_checkpoint, get_context,
                                         get_dataset_shard, report,
                                         step_profiler)
from ray_tpu_torch.train.trainer import Result, TorchTrainer

_LAZY = {
    "ActorStageHandle": "mpmd", "GangStageHandle": "mpmd",
    "LocalStageHandle": "mpmd", "MicrobatchReplayBuffer": "mpmd",
    "MPMDConfig": "mpmd", "MPMDPipelineTrainer": "mpmd",
    "PipelineDegradedError": "mpmd", "PipelineStageActor": "mpmd",
    "StageDefinition": "mpmd", "StageLostError": "mpmd",
    "StageRuntime": "mpmd", "block_stage_builders": "mpmd",
    "AsyncShardWriter": "sharded_checkpoint",
    "restore_stage_shard": "sharded_checkpoint",
    "save_stage_shard": "sharded_checkpoint",
}

__all__ = ["Checkpoint", "CheckpointConfig", "CheckpointManager",
           "DataConfig", "FailureConfig", "Result", "RunConfig",
           "ScalingConfig", "TorchTrainer", "get_checkpoint", "get_context",
           "get_dataset_shard", "report", "step_profiler", *sorted(_LAZY)]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(
            f"ray_tpu_torch.train.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.train' has no attribute {name!r}")
