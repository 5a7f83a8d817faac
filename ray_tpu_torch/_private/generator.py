"""Streaming generator returns (reference: num_returns="streaming" and
ObjectRefGenerator, python/ray/_raylet.pyx:281; the executor reports
items incrementally via ReportGeneratorItemReturns,
src/ray/protobuf/core_worker.proto:400).

TPU-runtime design: the item stream rides the SAME PARTIAL-frame
mechanism every other streamed reply uses (rpc.py call_start_parts) —
one request out (`push_task_streaming`), one PARTIAL back per yielded
item, one final RESPONSE when the generator is exhausted. Each PARTIAL
carries the item's encoded return (inline wire bytes or a shm location),
which the owner materializes into a brand-new owned ObjectRef.
Backpressure is executor-side: at most K unconsumed items in flight
(cfg.streaming_backpressure / per-call override); the consumer's
`next()` sends a consumption ack that opens the window.

Divergence from the reference (stated): streaming tasks don't retry and
their items aren't lineage-reconstructable — a lost item fails the read
instead of re-running the generator (re-running a partially-consumed
generator would double its side effects; the reference only supports
this for idempotent tasks, and Data/Serve here never rely on it).
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional

from ray_tpu_torch._private.object_ref import ObjectRef


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming task's yields.

    Sync iteration (driver threads)::

        gen = f.options(num_returns="streaming").remote()
        for ref in gen:              # blocks until the next item lands
            block = ray_tpu_torch.get(ref)

    Async iteration (inside async actors): ``async for ref in gen``.

    ``completed()`` returns the task-level ref that resolves to the item
    count once the generator finishes (and carries the task error if the
    generator itself failed to start).
    """

    def __init__(self, core, task_id: bytes, completed_ref: ObjectRef):
        self._core = core
        self._task_id = task_id
        self._completed_ref = completed_ref
        self._items: deque = deque()
        self._event = asyncio.Event()
        self._done = False
        self._exc: Optional[BaseException] = None
        self._consumed = 0
        self._closed = False
        self._worker_address: Optional[str] = None   # set at dispatch

    # ---------------------------------------------------------- loop side
    def _push(self, ref: ObjectRef) -> None:
        self._items.append(ref)
        self._event.set()

    def _finish(self) -> None:
        self._done = True
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True
        self._event.set()

    # ------------------------------------------------------ consumer side
    async def _next_async(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else \
            asyncio.get_event_loop().time() + timeout
        while True:
            if self._items:
                ref = self._items.popleft()
                self._consumed += 1
                self._core._gen_send_ack(self)
                return ref
            if self._done:
                if self._exc is not None:
                    raise self._exc
                raise StopAsyncIteration
            self._event.clear()
            if deadline is None:
                await self._event.wait()
            else:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    raise TimeoutError("ObjectRefGenerator.next timed out")
                try:
                    await asyncio.wait_for(self._event.wait(), remaining)
                except asyncio.TimeoutError:
                    raise TimeoutError(
                        "ObjectRefGenerator.next timed out") from None

    def __aiter__(self):
        return self

    def __anext__(self):
        return self._next_async()

    def _guard_loop_thread(self):
        import threading
        if threading.get_ident() == getattr(
                self._core, "_loop_thread_ident", None):
            raise RuntimeError(
                "blocking ObjectRefGenerator iteration on the core event "
                "loop thread would deadlock; use `async for ref in gen`")

    def __iter__(self):
        return self

    def __next__(self):
        self._guard_loop_thread()
        try:
            return asyncio.run_coroutine_threadsafe(
                self._next_async(), self._core.loop).result()
        except StopAsyncIteration:
            raise StopIteration from None

    def next(self, timeout: Optional[float] = None) -> ObjectRef:
        """Blocking next with an explicit timeout."""
        self._guard_loop_thread()
        try:
            return asyncio.run_coroutine_threadsafe(
                self._next_async(timeout), self._core.loop).result()
        except StopAsyncIteration:
            raise StopIteration from None

    def completed(self) -> ObjectRef:
        return self._completed_ref

    def close(self) -> None:
        """Stop the producer and drop any unconsumed items (the owner
        frees them; the executor's generator is closed)."""
        if self._closed:
            return
        self._closed = True
        import threading
        if threading.get_ident() == getattr(
                self._core, "_loop_thread_ident", None):
            asyncio.ensure_future(self._core._gen_close_async(self))
            return
        asyncio.run_coroutine_threadsafe(
            self._core._gen_close_async(self), self._core.loop).result()

    def __del__(self):
        # best-effort: dropping the generator cancels the producer
        if not self._closed and not self._done:
            try:
                self._closed = True
                self._core.loop.call_soon_threadsafe(
                    lambda: asyncio.ensure_future(
                        self._core._gen_close_async(self)))
            except Exception:
                pass
