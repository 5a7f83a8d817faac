from ray_tpu_torch.parallel.mesh import (MESH_AXES, MeshConfig, current_mesh,
                                         init_world, local_mesh, make_mesh,
                                         use_mesh)
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, batch_sharding,
                                             constrain, logical_to_mesh_axes,
                                             make_sharding_rules,
                                             param_shardings)
from ray_tpu_torch.parallel.optim import adafactor, adamw
from ray_tpu_torch.parallel.pipeline import (make_pipeline_fns,
                                             make_schedule, pipeline_apply,
                                             pipeline_bubble_fraction,
                                             shard_stage_params,
                                             stack_stage_params,
                                             stage_param_specs)
from ray_tpu_torch.parallel.train_step import (TrainState,
                                               chunked_cross_entropy,
                                               cross_entropy_loss,
                                               load_params, make_infer_fns,
                                               make_train_fns,
                                               state_shardings)

__all__ = ["DEFAULT_RULES", "MESH_AXES", "MeshConfig", "TrainState",
           "adafactor", "adamw", "batch_sharding", "chunked_cross_entropy",
           "constrain", "cross_entropy_loss", "current_mesh", "init_world",
           "load_params", "local_mesh", "logical_to_mesh_axes",
           "make_infer_fns", "make_mesh", "make_pipeline_fns",
           "make_schedule", "make_sharding_rules", "make_train_fns",
           "param_shardings", "pipeline_apply", "pipeline_bubble_fraction",
           "shard_stage_params", "stack_stage_params", "stage_param_specs",
           "state_shardings", "use_mesh"]
