"""@ray_tpu_torch.remote for classes: ActorClass / ActorHandle (reference:
python/ray/actor.py:293 ActorClass._remote, :721 method wrappers).

An ActorHandle is picklable and carries (actor_id, method names, owner gcs),
so handles can be passed into tasks and other actors; calls from any holder
go directly to the actor's worker over its own connection (reference:
direct worker→worker transport, actor_task_submitter.h:75)."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional

from ray_tpu_torch.remote_function import (_resources_from_options,
                                           _scheduling_from_options)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs,
                                    self._handle._options)

    def bind(self, *args, **kwargs):
        """Capture a compiled-DAG node (reference: dag class_node bind)."""
        from ray_tpu_torch.dag.nodes import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def options(self, **opts):
        # a plain instance, NOT a class defined in this closure: the
        # closure-class pattern forms a reference cycle (class -> method
        # -> cell -> handle) that defers the owner handle's
        # refcount-driven __del__ (= actor termination) to a gc pass
        return _BoundActorMethod(self._handle, self._name, opts)


class _BoundActorMethod:
    __slots__ = ("_handle", "_name", "_opts")

    def __init__(self, handle, name, opts):
        self._handle = handle
        self._name = name
        self._opts = opts

    def remote(self, *args, **kwargs):
        merged = {**self._handle._options, **self._opts}
        return self._handle._invoke(self._name, args, kwargs, merged)


class ActorHandle:
    def __init__(self, actor_id: str, method_names: List[str],
                 options: Optional[Dict[str, Any]] = None,
                 is_owner: bool = False):
        self._actor_id = actor_id
        self._method_names = list(method_names)
        self._options = options or {}
        # The original handle returned by ActorClass.remote() owns the actor's
        # lifetime: dropping it terminates a non-detached actor (reference:
        # actor GC on out-of-scope handles, gcs_actor_manager.cc ownership).
        self._is_owner = is_owner

    @property
    def _id(self) -> str:
        return self._actor_id

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(
                f"actor has no method {name!r}; methods: {self._method_names}")
        # NOT cached on the handle: that would create a reference cycle
        # (handle -> method -> handle) deferring the owner handle's
        # refcount-driven __del__ (= actor termination) to a gc pass
        return ActorMethod(self, name)

    def _invoke(self, method: str, args, kwargs, opts: Dict[str, Any]):
        from ray_tpu_torch import _get_worker
        w = _get_worker()
        num_returns = opts.get("num_returns") \
            or opts.get("method_num_returns", {}).get(method, 1)
        if num_returns == "streaming":
            return w.submit_actor_streaming(
                self._actor_id, method, args, kwargs,
                concurrency_group=opts.get("concurrency_group"),
                backpressure=opts.get("_generator_backpressure"))
        refs = w.submit_actor_task(
            self._actor_id, method, args, kwargs,
            num_returns=num_returns,
            max_task_retries=opts.get("max_task_retries", 0),
            concurrency_group=opts.get("concurrency_group"))
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names,
                              self._options))

    def __del__(self):
        if not getattr(self, "_is_owner", False):
            return
        try:
            import ray_tpu_torch
            if ray_tpu_torch.is_initialized():
                # fire-and-forget: __del__ can run via GC on ANY thread —
                # including the worker's own event-loop thread (e.g. during
                # cloudpickle of a task argument) — so a blocking bridge
                # here deadlocks the loop on itself
                w = ray_tpu_torch._get_worker()
                if w.core._shutdown:
                    # too late to reach the GCS; finish_job reaps the
                    # job's actors server-side (spawning here would leak
                    # a task through the drained shutdown)
                    return
                import asyncio

                def _kick():
                    if not w.core._shutdown:
                        w.core._spawn(w.core.kill_actor_async(
                            self._actor_id, no_restart=True))

                w.core.loop.call_soon_threadsafe(_kick)
        except Exception:
            pass

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:12]})"


def _public_methods(cls) -> List[str]:
    names = []
    for name, member in inspect.getmembers(cls):
        if name.startswith("__") and name != "__call__":
            continue
        if callable(member):
            names.append(name)
    return names


def _method_groups(cls) -> Dict[str, str]:
    """method name -> concurrency group declared via @ray_tpu_torch.method."""
    inner = getattr(cls, "__ray_tpu_actual_class__", cls)
    out = {}
    for name, member in inspect.getmembers(inner):
        group = getattr(member, "__concurrency_group__", None)
        if group:
            out[name] = group
    return out


def _method_num_returns(cls) -> Dict[str, int]:
    """method name -> num_returns declared via @ray_tpu_torch.method."""
    inner = getattr(cls, "__ray_tpu_actual_class__", cls)
    out = {}
    for name, member in inspect.getmembers(inner):
        n = getattr(member, "__num_returns__", None)
        if n is not None:
            out[name] = int(n)
    return out


def method(*, concurrency_group: Optional[str] = None, num_returns=None):
    """Method decorator (reference: ray.method — python/ray/actor.py).
    Declares the concurrency group an actor method executes in; groups
    and their widths are given at class level via
    ``@ray_tpu_torch.remote(concurrency_groups={"io": 2})``."""
    def deco(fn):
        if concurrency_group:
            fn.__concurrency_group__ = concurrency_group
        if num_returns is not None:
            fn.__num_returns__ = num_returns
        return fn
    return deco


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = options or {}
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.client import current_client
        cc = current_client()
        if cc is not None:   # client-mode hook (reference: client_mode_hook)
            return cc.remote(self._cls, **self._options).remote(
                *args, **kwargs)
        from ray_tpu_torch import _get_worker
        w = _get_worker()
        opts = self._options
        actor_id = w.create_actor(
            self._cls, args, kwargs,
            resources=_resources_from_options(opts),
            name=opts.get("name"),
            namespace=opts.get("namespace"),
            max_restarts=opts.get("max_restarts", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            scheduling=_scheduling_from_options(opts),
            lifetime=opts.get("lifetime"),
            method_names=_public_methods(self._cls),
            runtime_env=opts.get("runtime_env"),
            concurrency_groups=opts.get("concurrency_groups"),
            method_groups=_method_groups(self._cls))
        return ActorHandle(
            actor_id, _public_methods(self._cls),
            {"max_task_retries": opts.get("max_task_retries", 0),
             "method_num_returns": _method_num_returns(self._cls)},
            is_owner=opts.get("lifetime") != "detached")

    def options(self, **new_options) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **new_options})

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            "use .remote().")
