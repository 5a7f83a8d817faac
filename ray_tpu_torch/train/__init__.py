"""Training beyond one step: the in-process MPMD pipeline trainer, its
failure config and its durable stage shards."""

from ray_tpu_torch.train.config import FailureConfig
from ray_tpu_torch.train.mpmd import (GangStageHandle, LocalStageHandle,
                                      MicrobatchReplayBuffer, MPMDConfig,
                                      MPMDPipelineTrainer,
                                      PipelineDegradedError, StageDefinition,
                                      StageLostError, StageRuntime,
                                      block_stage_builders)
from ray_tpu_torch.train.sharded_checkpoint import (AsyncShardWriter,
                                                    restore_stage_shard,
                                                    save_stage_shard)

__all__ = ["AsyncShardWriter", "FailureConfig", "GangStageHandle",
           "LocalStageHandle", "MPMDConfig", "MPMDPipelineTrainer",
           "MicrobatchReplayBuffer", "PipelineDegradedError",
           "StageDefinition", "StageLostError", "StageRuntime",
           "block_stage_builders", "restore_stage_shard", "save_stage_shard"]
