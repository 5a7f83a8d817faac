"""Model multiplexing: many models share a replica pool, each replica
holding an LRU cache of loaded models (reference: python/ray/serve/
multiplex.py — @serve.multiplexed + get_multiplexed_model_id; the
reference router prefers replicas that report the model loaded, here the
handle router keeps a sticky model→replica map, the cached-routing
variant of the same affinity)."""

from __future__ import annotations

import asyncio
import collections
import contextvars
import functools
import threading
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this request was routed with."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    return _current_model_id.set(model_id)


class _ModelCache:
    """Per-wrapper LRU of loaded models; evicts with __del__ semantics."""

    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self.models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self.lock = threading.Lock()

    async def get(self, owner, model_id: str):
        # rtlint: disable=RT001 — bounded dict-op critical section, never
        # held across an await; sync callers (loaded_ids/__getstate__)
        # share the same threading.Lock so an asyncio.Lock can't replace it
        with self.lock:
            if model_id in self.models:
                self.models.move_to_end(model_id)
                return self.models[model_id]
        model = self.loader(owner, model_id)
        if asyncio.iscoroutine(model):
            model = await model
        # rtlint: disable=RT001 — bounded dict-op critical section (above)
        with self.lock:
            self.models[model_id] = model
            self.models.move_to_end(model_id)
            while len(self.models) > self.max_models:
                old_id, old = self.models.popitem(last=False)
                del old
        return model

    def loaded_ids(self):
        with self.lock:
            return list(self.models)

    def __getstate__(self):
        # ships with the deployment class: locks and loaded models are
        # per-replica state, recreated empty on the other side
        return {"loader": self.loader, "max_models": self.max_models}

    def __setstate__(self, state):
        self.loader = state["loader"]
        self.max_models = state["max_models"]
        self.models = collections.OrderedDict()
        self.lock = threading.Lock()


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a model-loader method: `async def get_model(self,
    model_id)`. Calls are cached per replica in LRU order."""

    def wrap(fn):
        cache = _ModelCache(fn, max_num_models_per_replica)

        @functools.wraps(fn)
        async def wrapper(self, model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            return await cache.get(self, model_id)

        wrapper.__serve_multiplex_cache__ = cache
        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap
