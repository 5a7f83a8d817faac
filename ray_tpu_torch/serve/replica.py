"""Replica actor: hosts one copy of a deployment's callable (reference:
python/ray/serve/_private/replica.py:233 ReplicaActor + UserCallableWrapper
:810). Runs with max_concurrency = max_ongoing_requests so requests overlap
and health probes are never stuck behind user code; tracks its ongoing
count for autoscaling."""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Tuple

logger = logging.getLogger(__name__)


class ReplicaDrainingError(Exception):
    """Raised at the replica boundary for calls that arrive AFTER a
    drain notice (router staleness window): the replica is alive and
    finishing in-flight work but takes nothing new. The handle layer
    treats it like replica death — refresh the routing table and
    re-route once — so clients of a preempted replica see a survivor,
    not an error."""


class Replica:
    def __init__(self, serialized_callable: bytes, init_args: Tuple,
                 init_kwargs: Dict, is_function: bool):
        self._init_state()
        self._init_callable(serialized_callable, init_args, init_kwargs,
                            is_function)

    # split so a pre-warmed ReplicaShell (serve/fleet.py) can pay the
    # process/import cost at pool time and run the callable
    # construction later, at attach
    def _init_state(self):
        self._callable = None
        self._is_function = False
        self._ongoing = 0
        self._lock = threading.Lock()
        self._draining = False

    def _init_callable(self, serialized_callable: bytes, init_args: Tuple,
                       init_kwargs: Dict, is_function: bool):
        import cloudpickle
        target = cloudpickle.loads(serialized_callable)
        self._is_function = is_function
        if is_function:
            self._callable = target
        else:
            self._callable = target(*init_args, **init_kwargs)
        # spot preemption notices: on GCE (or under chaos injection) a
        # watcher polls the metadata channel and flips this replica into
        # draining before the platform kills the VM — the controller
        # sees it on its next state probe and pre-starts a replacement
        from ray_tpu_torch._private.accelerators import gpu as gpu_accel
        if gpu_accel.preemption_watch_enabled():
            threading.Thread(target=self._preemption_watch,
                             name="serve-preempt-watch",
                             daemon=True).start()

    def _preemption_watch(self):
        from ray_tpu_torch._private.accelerators import gpu as gpu_accel
        poll_s = float(os.environ.get("RAY_TPU_TORCH_PREEMPT_POLL_S", "1.0"))
        while not self._draining:
            try:
                if gpu_accel.check_preemption_notice():
                    logger.warning("preemption notice received; draining")
                    self.begin_drain()
                    return
            except Exception:
                logger.debug("preemption poll failed", exc_info=True)
            time.sleep(poll_s)

    # ------------------------------------------------------------- draining
    def begin_drain(self) -> bool:
        """Preemption notice / graceful retirement: stop taking new
        work. The routing layer drops this replica on the controller's
        next probe; streams already in flight run to completion (the
        engine's drain mode refuses only NEW submissions). Idempotent."""
        with self._lock:
            if self._draining:
                return True
            self._draining = True
        fn = getattr(self._callable, "begin_drain", None)
        if fn is not None:
            try:
                fn()
            except Exception:
                logger.warning("callable begin_drain failed",
                               exc_info=True)
        return True

    def get_runtime_state(self) -> Dict:
        """One-probe view for the controller's reconcile tick: queue
        depth (autoscaling + router load push) and the draining flag
        (preemption pickup)."""
        return {"queue_len": self._ongoing, "draining": self._draining}

    @staticmethod
    def _stash_peer_hint(kwargs: Dict):
        """Routing metadata from the handle's prefix router: which OTHER
        replica covers this prompt deepest. Parked in a thread-local for
        the decode tier's KV-fabric rung (serve/disagg.py) — advisory,
        so any failure here just costs the optimization."""
        hint = kwargs.pop("__serve_peer_hint", None)
        if hint is not None:
            try:
                from ray_tpu_torch.serve.disagg import set_peer_hint
                set_peer_hint(hint)
            except Exception:
                pass

    def handle_request(self, method: str, args: Tuple, kwargs: Dict):
        import ray_tpu_torch
        from ray_tpu_torch import ObjectRef
        if self._draining:
            raise ReplicaDrainingError(
                "replica is draining (preemption notice); re-route")
        # composed calls pass upstream DeploymentResponses as refs; resolve
        # to values before invoking user code (reference: handle.py resolves
        # nested DeploymentResponses)
        args = tuple(ray_tpu_torch.get(a) if isinstance(a, ObjectRef) else a
                     for a in args)
        kwargs = {k: (ray_tpu_torch.get(v) if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
        model_id = kwargs.pop("__serve_model_id", "")
        kwargs.pop("__serve_tenant", "")   # routing metadata, not an arg
        Replica._stash_peer_hint(kwargs)
        from ray_tpu_torch._private import events
        with self._lock:
            self._ongoing += 1
        try:
            if self._is_function:
                fn = self._callable
            else:
                fn = getattr(self._callable, method)
            import asyncio
            import inspect

            from ray_tpu_torch.serve import multiplex
            # replica phase span: parents under this actor task's
            # propagated trace context (set by the executing worker), so
            # user-code time separates from arg-resolution time above
            rspan = events.start_span("replica.call", category="serve",
                                      method=method, ongoing=self._ongoing)
            if inspect.iscoroutinefunction(fn):
                # we're on an executor thread; hop onto the worker loop —
                # the model-id contextvar is set inside the coroutine so
                # it lives in the loop-side execution context
                async def _call():
                    tok = multiplex._set_model_id(model_id)
                    try:
                        return await fn(*args, **kwargs)
                    finally:
                        multiplex._current_model_id.reset(tok)
                from ray_tpu_torch._private.worker import global_worker
                try:
                    return asyncio.run_coroutine_threadsafe(
                        _call(), global_worker.core.loop).result()
                finally:
                    rspan.end()
            tok = multiplex._set_model_id(model_id)
            try:
                return fn(*args, **kwargs)
            finally:
                rspan.end()
                multiplex._current_model_id.reset(tok)
        finally:
            with self._lock:
                self._ongoing -= 1

    # ------------------------------------------------------------ streaming
    def handle_stream(self, method: str, args: Tuple, kwargs: Dict):
        """Generator method invoked with num_returns='streaming': each
        yielded chunk becomes one item on the caller's
        ObjectRefGenerator, riding the core streaming-generator protocol
        (reference: streaming DeploymentResponseGenerator over
        ObjectRefGenerator, serve/handle.py)."""
        from ray_tpu_torch._private import events
        from ray_tpu_torch.serve import multiplex
        if self._draining:
            raise ReplicaDrainingError(
                "replica is draining (preemption notice); re-route")
        model_id = kwargs.pop("__serve_model_id", "")
        kwargs.pop("__serve_tenant", "")
        Replica._stash_peer_hint(kwargs)
        with self._lock:
            self._ongoing += 1
        # the body's first resumption runs under the streaming task's
        # trace context, so this span parents under the replica task —
        # ended in the outer finally (which also runs on close())
        sspan = events.start_span("replica.stream", category="serve",
                                  method=method)
        chunks = 0      # wire frames yielded (coalesced batches count 1)
        items = 0       # items inside them (tokens, for coalesced LLMs)
        try:
            fn = self._callable if self._is_function \
                else getattr(self._callable, method)
            # the streaming executor resumes each next() on whatever
            # pool thread is free: set/reset the multiplex contextvar
            # WITHIN each resumption (a token created on one thread
            # cannot be reset on another, and a cross-thread reset in a
            # finally would leak the _ongoing decrement below)
            tok = multiplex._set_model_id(model_id)
            try:
                it = iter(fn(*args, **kwargs))
            finally:
                multiplex._current_model_id.reset(tok)
            try:
                while True:
                    tok = multiplex._set_model_id(model_id)
                    try:
                        chunk = next(it)
                    except StopIteration:
                        break
                    finally:
                        multiplex._current_model_id.reset(tok)
                    chunks += 1
                    items += (len(chunk)
                              if isinstance(chunk, (list, tuple)) else 1)
                    yield chunk
            finally:
                # consumer walked away (GeneratorExit lands on the yield
                # above) or the stream errored: close the USER generator
                # deterministically so its finally/except runs NOW —
                # engine slots, file handles etc. free immediately
                # instead of at some future GC pass
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
        finally:
            sspan.end(chunks=chunks, items=items)
            with self._lock:
                self._ongoing -= 1

    def get_queue_len(self) -> int:
        return self._ongoing

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def reconfigure(self, user_config):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True
