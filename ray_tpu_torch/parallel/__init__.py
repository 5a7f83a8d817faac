"""Parallelism: the device mesh, sharding rules, optimizers, the train
step and the pipeline. The exports load on first use (a module
``__getattr__``), so a process that needs one module, such as a pipeline
stage actor that needs only the MPMD schedules, does not import
``torch.distributed.tensor`` with the rest."""

_LAZY = {
    **dict.fromkeys(("MESH_AXES", "MeshConfig", "current_mesh", "init_world",
                     "local_mesh", "make_mesh", "use_mesh"),
                    "ray_tpu_torch.parallel.mesh"),
    **dict.fromkeys(("DEFAULT_RULES", "batch_sharding", "constrain",
                     "logical_to_mesh_axes", "make_sharding_rules",
                     "param_shardings"),
                    "ray_tpu_torch.parallel.sharding"),
    **dict.fromkeys(("adafactor", "adamw"), "ray_tpu_torch.parallel.optim"),
    **dict.fromkeys(("make_pipeline_fns", "make_schedule", "pipeline_apply",
                     "pipeline_bubble_fraction", "shard_stage_params",
                     "stack_stage_params", "stage_param_specs"),
                    "ray_tpu_torch.parallel.pipeline"),
    **dict.fromkeys(("TrainState", "chunked_cross_entropy",
                     "cross_entropy_loss", "load_params", "make_infer_fns",
                     "make_train_fns", "state_shardings"),
                    "ray_tpu_torch.parallel.train_step"),
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'ray_tpu_torch.parallel' has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


__all__ = sorted(_LAZY)
