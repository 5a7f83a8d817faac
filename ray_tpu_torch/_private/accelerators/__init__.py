from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch._private.accelerators.gpu import (GPUAcceleratorManager,
                                                     GpuIdPool)

_MANAGERS = {"GPU": GPUAcceleratorManager}


def get_accelerator_manager(resource_name: str):
    return _MANAGERS.get(resource_name)


def all_accelerator_managers():
    return dict(_MANAGERS)


def detect_gpu_ids():
    """Actual GPU ids this node owns (respects CUDA_VISIBLE_DEVICES on a
    partitioned host — ids are NOT simply range(n))."""
    visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
    if visible is not None:
        return list(visible)
    n = GPUAcceleratorManager.get_current_node_num_accelerators()
    return [str(i) for i in range(n)]


def detect_node_accelerators():
    """Returns {resource_name: count} plus any extra resources for this
    node."""
    resources = {}
    for name, mgr in _MANAGERS.items():
        n = mgr.get_current_node_num_accelerators()
        if n > 0:
            resources[name] = float(n)
            resources.update(mgr.get_current_node_additional_resources())
    return resources


__all__ = ["AcceleratorManager", "GPUAcceleratorManager", "GpuIdPool",
           "get_accelerator_manager", "detect_node_accelerators"]
