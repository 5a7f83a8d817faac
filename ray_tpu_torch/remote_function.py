"""@ray_tpu_torch.remote for functions (reference:
python/ray/remote_function.py:266 — options resolution and submission)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional


def _resources_from_options(opts: Dict[str, Any]) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_tpus") is not None:      # a plain custom resource here
        res["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus") is not None:
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("memory") is not None:
        res["memory"] = float(opts["memory"])
    if "CPU" not in res and "TPU" not in res and "GPU" not in res:
        res["CPU"] = 1.0
    if "GPU" in res:
        from ray_tpu_torch._private.accelerators import GPUAcceleratorManager
        ok, reason = GPUAcceleratorManager.validate_resource_request_quantity(
            res["GPU"])
        if not ok:
            raise ValueError(f"invalid GPU request {res['GPU']}: {reason}")
    return res


def _scheduling_from_options(opts: Dict[str, Any]) -> Dict[str, Any]:
    strategy = opts.get("scheduling_strategy")
    sched: Dict[str, Any] = {}
    if strategy is None:
        return sched
    if isinstance(strategy, str):
        sched["strategy"] = strategy
        return sched
    # strategy objects from util.scheduling_strategies
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy,
        SpreadSchedulingStrategy)
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        sched["placement_group_id"] = strategy.placement_group.id
        sched["placement_group_bundle_index"] = strategy.placement_group_bundle_index
    elif isinstance(strategy, NodeAffinitySchedulingStrategy):
        sched["strategy"] = "NODE_AFFINITY"
        sched["node_id"] = strategy.node_id
        sched["soft"] = strategy.soft
    elif isinstance(strategy, SpreadSchedulingStrategy):
        sched["strategy"] = "SPREAD"
    return sched


class RemoteFunction:
    def __init__(self, function, options: Optional[Dict[str, Any]] = None):
        self._function = function
        self._options = options or {}
        try:
            functools.update_wrapper(self, function)
        except AttributeError:
            # callables without __name__/__doc__ (e.g. joblib wrappers)
            self.__name__ = type(function).__name__

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.client import current_client
        cc = current_client()
        if cc is not None:   # client-mode hook (reference: client_mode_hook)
            return cc.remote(self._function, **self._options).remote(
                *args, **kwargs)
        from ray_tpu_torch import _get_worker
        w = _get_worker()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        if num_returns == "streaming":
            # -> ObjectRefGenerator (reference: _raylet.pyx:281)
            return w.submit_streaming(
                self._function, args, kwargs,
                resources=_resources_from_options(opts),
                scheduling=_scheduling_from_options(opts),
                name=opts.get("name") or getattr(
                    self._function, "__name__",
                    type(self._function).__name__),
                runtime_env=opts.get("runtime_env"),
                backpressure=opts.get("_generator_backpressure"))
        refs = w.submit(
            self._function, args, kwargs,
            num_returns=num_returns,
            resources=_resources_from_options(opts),
            max_retries=opts.get("max_retries"),
            scheduling=_scheduling_from_options(opts),
            name=opts.get("name") or getattr(self._function, "__name__",
                                 type(self._function).__name__),
            runtime_env=opts.get("runtime_env"))
        return refs[0] if num_returns == 1 else refs

    def options(self, **new_options) -> "RemoteFunction":
        merged = {**self._options, **new_options}
        return RemoteFunction(self._function, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__name__}' cannot be called "
            "directly; use .remote().")
