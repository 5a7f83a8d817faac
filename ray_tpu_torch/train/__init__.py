"""Training beyond one step: the MPMD pipeline trainer (stages in process
or as actors of the port's runtime), its failure config and its durable
stage shards."""

from ray_tpu_torch.train.config import FailureConfig
from ray_tpu_torch.train.mpmd import (ActorStageHandle, GangStageHandle,
                                      LocalStageHandle,
                                      MicrobatchReplayBuffer, MPMDConfig,
                                      MPMDPipelineTrainer,
                                      PipelineDegradedError,
                                      PipelineStageActor, StageDefinition,
                                      StageLostError, StageRuntime,
                                      block_stage_builders)
from ray_tpu_torch.train.sharded_checkpoint import (AsyncShardWriter,
                                                    restore_stage_shard,
                                                    save_stage_shard)

__all__ = ["ActorStageHandle", "AsyncShardWriter", "FailureConfig",
           "GangStageHandle", "LocalStageHandle", "MPMDConfig",
           "MPMDPipelineTrainer", "MicrobatchReplayBuffer",
           "PipelineDegradedError", "PipelineStageActor", "StageDefinition",
           "StageLostError", "StageRuntime", "block_stage_builders",
           "restore_stage_shard", "save_stage_shard"]
