"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

It stands beside ``ray_tpu`` (the JAX reference, which it never imports).
Two halves share the package:

- the runtime core (reference: python/ray/_private/worker.py — ray.init
  :1260, get/put/wait/remote): tasks, actors and objects over the port's
  own GCS, node managers, workers and C++ shared-memory object store,
  with GPUs (``num_gpus``, ``CUDA_VISIBLE_DEVICES``) as the accelerator.
  Importing the package imports no torch, so the control-plane processes
  never do;
- the model, training and serving path (``TransformerLM``,
  ``make_train_fns``, ``InferenceEngine``, ...), exported lazily. Plain
  tensor code is PyTorch; each Pallas kernel of ``ray_tpu`` becomes a
  kernel written by hand for Hopper under ``ops/csrc``, built at first
  use. Entry points run on the card unless the caller passes
  ``device="cpu"``.
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private.generator import ObjectRefGenerator
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.serialization import (ActorDiedError, ObjectLostError,
                                            TaskCancelledError, TaskError,
                                            WorkerCrashedError)
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.2.0"

_ctx_lock = threading.RLock()
_context: Optional["_Context"] = None


class _Context:
    def __init__(self, worker, node=None, owns_node=False, job_id=0):
        self.worker = worker
        self.node = node
        self.owns_node = owns_node
        self.job_id = job_id


def _get_worker():
    ctx = _context
    if ctx is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return ctx.worker


def is_initialized() -> bool:
    return _context is not None


def _set_connected_from_worker(core):
    """Called by worker_main: tasks executing here see a connected API."""
    global _context
    from ray_tpu_torch._private import worker as worker_mod
    with _ctx_lock:
        if _context is None:
            _context = _Context(worker_mod.global_worker, node=None,
                                owns_node=False, job_id=core.job_id)



def _apply_system_config(values: Dict[str, Any]) -> None:
    """Validate + coerce every entry first (fail fast, no partial
    application), then set cfg and export env overrides so spawned GCS /
    node-manager processes resolve the same values (the GCS then
    re-propagates its snapshot to every joining node). The exported keys
    are recorded so shutdown() can remove them."""
    import os
    from ray_tpu_torch._private.config import cfg, flags
    table = flags()
    coerced = {}
    for k, v in values.items():
        flag = table.get(k)
        if flag is None:
            raise KeyError(f"unknown system config flag {k!r}")
        try:
            coerced[k] = flag.parse(str(v))
        except (TypeError, ValueError):
            raise ValueError(
                f"system config flag {k!r}={v!r} is not a valid "
                f"{flag.type.__name__}")
    for k, v in coerced.items():
        cfg.set(k, v)
        os.environ["RAY_TPU_TORCH_" + k.upper()] = str(v)
        _exported_config_env.append(("RAY_TPU_TORCH_" + k.upper(), k))


_exported_config_env: List[tuple] = []

def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         namespace: str = "default",
         labels: Optional[Dict[str, str]] = None,
         ignore_reinit_error: bool = False,
         _node_address: Optional[str] = None,
         _store_path: Optional[str] = None,
         _node_id: Optional[str] = None,
         _system_config: Optional[Dict[str, Any]] = None):
    """Connect to (or start) a cluster. With no address, starts a local
    head: GCS + node manager subprocesses (reference: ray.init at
    python/ray/_private/worker.py:1260)."""
    global _context
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.worker import Worker

    import os
    if address is None:
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if address is not None and address.startswith("ray://"):
        return _connect_client(address, ignore_reinit_error)
    if _system_config and address is not None:
        raise ValueError(
            "_system_config is only valid when starting a new head; "
            "when joining an existing cluster the head's config wins")
    with _ctx_lock:
        if _context is not None:
            if ignore_reinit_error:
                return _context
            raise RuntimeError("ray_tpu_torch.init() already called "
                               "(use ignore_reinit_error=True)")
        owns_node = False
        node = None
        if _system_config:
            _apply_system_config(_system_config)
        try:
            return _init_locked(address, num_cpus, resources,
                                object_store_memory, namespace, labels,
                                _node_address, _store_path, _node_id,
                                node_mod, worker_mod, Worker)
        except BaseException:
            if _system_config:
                _drain_config_exports()
            raise


def _drain_config_exports() -> None:
    import os
    from ray_tpu_torch._private.config import cfg as _cfg
    for env_key, flag_name in _exported_config_env:
        os.environ.pop(env_key, None)
        _cfg.reset(flag_name)
    _exported_config_env.clear()


def _init_locked(address, num_cpus, resources, object_store_memory,
                 namespace, labels, _node_address, _store_path, _node_id,
                 node_mod, worker_mod, Worker):
        global _context
        owns_node = False
        node = None
        if address is None:
            node = node_mod.start_head(
                num_cpus=num_cpus, resources=resources,
                object_store_memory=object_store_memory, labels=labels)
            owns_node = True
            gcs_address = node.gcs_address
            node_address = node.node_address
            store_path = node.store_path
            node_id = node.node_id
        else:
            gcs_address = address
            node_address = _node_address
            store_path = _store_path
            node_id = _node_id
            if node_address is None:
                # find (or start) a node manager on this host via GCS
                probe = Worker.start(mode="driver", gcs_address=gcs_address,
                                     node_address="", store_path="",
                                     node_id="probe", namespace=namespace)
                try:
                    nodes_list = probe.gcs_call("get_all_nodes")
                finally:
                    probe.stop()
                from ray_tpu_torch._private.rpc import node_ip_address
                my_ip = node_ip_address()
                local = [n for n in nodes_list
                         if n["alive"] and n["node_ip"] in (my_ip, "127.0.0.1")]
                if local:
                    node_address = local[0]["address"]
                    store_path = local[0]["object_store_address"]
                    node_id = local[0]["node_id"]
                else:
                    ln = node_mod.start_node(gcs_address, num_cpus=num_cpus,
                                             resources=resources,
                                             object_store_memory=object_store_memory)
                    node = ln
                    owns_node = True
                    node_address = ln.node_address
                    store_path = ln.store_path
                    node_id = ln.node_id

        worker = Worker.start(mode="driver", gcs_address=gcs_address,
                              node_address=node_address,
                              store_path=store_path, node_id=node_id,
                              namespace=namespace)
        job_id = worker.gcs_call("register_job",
                                 driver_address=worker.core.address,
                                 metadata={})
        worker.core.job_id = job_id
        worker_mod.global_worker = worker
        _context = _Context(worker, node, owns_node, job_id)
        # a prior shutdown() in this process retired the metrics pusher;
        # metrics registered back then must resume pushing now
        from ray_tpu_torch.util import metrics as _metrics
        _metrics.resume_pusher()
        atexit.register(shutdown)
        return _context


def shutdown():
    global _context
    with _ctx_lock:
        ctx = _context
        if ctx is None:
            cc = _client()
            if cc is not None:      # client mode: drop the proxy session
                cc.disconnect()
            return
        _context = None
        try:
            ctx.worker.gcs_call("finish_job", job_id=ctx.job_id)
        except Exception:
            pass
        ctx.worker.stop()
        if ctx.owns_node and ctx.node is not None:
            ctx.node.kill()
        from ray_tpu_torch._private import worker as worker_mod
        worker_mod.global_worker = None
        # retire the registry pusher: without a worker it would spin on
        # is_initialized() forever (resume_pusher on the next init)
        from ray_tpu_torch.util import metrics as _metrics
        _metrics.stop_pusher()
        # undo _system_config exports so a later init (or unrelated
        # tooling spawned from this process) doesn't inherit stale values
        _drain_config_exports()


def remote(*args, **kwargs):
    """Decorator making a function a remote task or a class an actor class
    (reference: python/ray/_private/worker.py remote decorator)."""
    def make(obj):
        if isinstance(obj, type):
            return ActorClass(obj, kwargs)
        return RemoteFunction(obj, kwargs)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    return make


def _connect_client(address: str, ignore_reinit_error: bool):
    """init("ray://host:port"): client mode. The process holds no runtime;
    the public API goes through the cluster's client proxy
    (``client.serve_proxy``). A process that holds a runtime, or is
    already a client, cannot become one."""
    from ray_tpu_torch import client
    with _ctx_lock:
        if _context is not None:
            raise RuntimeError("ray_tpu_torch.init() already called: a "
                               "process that holds a runtime cannot be a "
                               "client")
        cc = client.current_client()
        if cc is not None:
            if ignore_reinit_error:
                return cc
            raise RuntimeError("ray_tpu_torch.init() already called "
                               "(use ignore_reinit_error=True)")
        return client.connect(address)


def _client():
    from ray_tpu_torch.client import current_client
    return current_client()


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    cc = _client()
    if cc is not None:
        return cc.get(refs, timeout=timeout)
    return _get_worker().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    cc = _client()
    if cc is not None:
        return cc.put(value)
    return _get_worker().put(value)


def broadcast_weights(weights: Any, node_ids: Optional[Sequence[str]] = None,
                      *, max_retries: int = 2) -> ObjectRef:
    """Distribute one (multi-GB) weight blob to every node, fast.

    One source ``put`` into a pinned arena span (objects larger than one
    arena stripe land in a spanning allocation transparently), then a
    log-depth binomial relay tree fans the sealed bytes out across the
    cluster over the striped raw-socket data plane — senders stream
    pinned memoryviews, receivers ``recv_into`` their own spanning
    allocations, zero staging copies end to end. If a relay node dies
    mid-subtree the root retries through the surviving holders.

    ``weights`` may be any serializable value (a params pytree, a state
    dict, raw bytes) or an existing :class:`ObjectRef`. Returns the ref;
    consumers on every node ``ray_tpu_torch.get`` it zero-copy from their
    local arena. ``node_ids=None`` targets every node in the cluster.
    """
    w = _get_worker()
    ref = weights if isinstance(weights, ObjectRef) else w.put(weights)
    w.broadcast_weights(ref, list(node_ids) if node_ids is not None
                        else None, max_retries=max_retries)
    return ref


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    cc = _client()
    if cc is not None:
        return cc.wait(list(refs), num_returns=num_returns, timeout=timeout)
    return _get_worker().wait(list(refs), num_returns=num_returns,
                              timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    cc = _client()
    if cc is not None:
        return cc.kill(actor)
    _get_worker().kill_actor(actor._id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    """Cancel a pending/queued task (reference: ray.cancel — queued tasks
    drop with TaskCancelledError; force also kills a running worker)."""
    return _get_worker().cancel(ref, force=force)


def timeline(filename: Optional[str] = None):
    """Export the unified timeline — task executions PLUS the flight
    recorder's runtime events (engine steps, spills, serve phases, train
    steps as per-subsystem tracks) PLUS gauge time-series as counter
    tracks (slot occupancy, MFU) — as a chrome://tracing JSON (reference:
    `ray timeline`, python/ray/_private/state.py chrome trace export).
    With ``filename`` the JSON is written there and the name returned;
    else the event list is returned."""
    import json

    from ray_tpu_torch._private import events as _events
    from ray_tpu_torch.util.metrics import push_once as _push_metrics
    from ray_tpu_torch.util.tracing import task_events_to_chrome
    _events.flush()     # this process's buffered spans make the export
    _push_metrics()     # ...and its freshest gauge samples
    rows = _get_worker().gcs_call("list_task_events", limit=20000)
    series = _get_worker().gcs_call("dump_metric_series", kinds=["gauge"])
    events = task_events_to_chrome(rows, gauge_series=series)
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
        return filename
    return events


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    cc = _client()
    if cc is not None:
        return cc.get_actor(name, namespace)
    info = _get_worker().gcs_call("get_named_actor", name=name,
                                  namespace=namespace)
    if info is None:
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    return ActorHandle(info["actor_id"], info.get("method_names") or [], {})


def nodes() -> List[Dict]:
    return _get_worker().gcs_call("get_all_nodes")


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for k, v in n["total"].items():
                total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    avail: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for k, v in n["available"].items():
                avail[k] = avail.get(k, 0.0) + v
    return avail


def get_gcs_address() -> str:
    ctx = _context
    if ctx is None:
        raise RuntimeError("not initialized")
    return ctx.worker.core.gcs_address


def get_runtime_context():
    ctx = _context
    w = _get_worker()
    return {"job_id": w.core.job_id, "node_id": w.core.node_id,
            "worker_id": w.core.worker_id,
            "actor_id": w.core.actor_id,
            "gcs_address": w.core.gcs_address}


def get_gpu_ids() -> List[str]:
    """The GPU ids the runtime assigned to the running task or actor
    (the ids its ``CUDA_VISIBLE_DEVICES`` mask was set from); empty in
    the main program and in work that asked for no GPU."""
    ids = getattr(_get_worker().core, "accelerator_ids", None) or {}
    return [str(i) for i in ids.get("GPU", [])]


import ray_tpu_torch.util as util  # noqa: E402  (public subpackage)

# The model, ops and parallel exports load on first use, so that
# `import ray_tpu_torch` in the GCS, node-manager and worker processes
# imports no torch.
_LAZY = {
    "EngineConfig": "ray_tpu_torch.inference",
    "InferenceEngine": "ray_tpu_torch.inference",
    "SpecDecodeConfig": "ray_tpu_torch.inference",
    "MODEL_REGISTRY": "ray_tpu_torch.models",
    "TransformerConfig": "ray_tpu_torch.models",
    "TransformerLM": "ray_tpu_torch.models",
    "init_cache": "ray_tpu_torch.models",
    "init_params": "ray_tpu_torch.models",
    "make_generate_fn": "ray_tpu_torch.models",
    "params_from_jax": "ray_tpu_torch.models",
    "flash_attention": "ray_tpu_torch.ops",
    "TrainState": "ray_tpu_torch.parallel",
    "adafactor": "ray_tpu_torch.parallel",
    "adamw": "ray_tpu_torch.parallel",
    "make_train_fns": "ray_tpu_torch.parallel",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'ray_tpu_torch' has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put",
    "broadcast_weights", "wait",
    "kill", "cancel", "timeline", "get_actor", "nodes", "cluster_resources",
    "available_resources", "ObjectRef", "ObjectRefGenerator",
    "ActorHandle", "ActorClass",
    "RemoteFunction", "TaskError", "ActorDiedError", "ObjectLostError",
    "WorkerCrashedError", "TaskCancelledError", "util", "method",
    "get_runtime_context", "get_gcs_address", "get_gpu_ids",
] + sorted(_LAZY)
