"""Runtime sanitizers for the asyncio-native control plane.

The reference structures its concurrency with per-component
`instrumented_io_context` event loops (src/ray/common/asio/ — per-handler
event stats + lag probes, event_stats.cc), single-thread assertions
(src/ray/util/thread_checker.h) and tsan/asan CI builds (.bazelrc
build:tsan/build:asan). This package's runtime is asyncio, so the analogs
are loop-shaped rather than thread-shaped:

- **Loop sanitizer** (`maybe_install`): times EVERY callback/handle the
  loop runs (one process-wide patch of `asyncio.events.Handle._run`),
  aggregates per-callback event stats (count / total / max — the
  event_stats.cc surface), and records a ring of "slow callback" events
  whose duration exceeded the threshold. A callback that blocks the loop
  is this runtime's data race: every daemon on that loop stalls.
- **Lag probe**: a background task that sleeps a fixed interval and
  measures scheduling drift — the loop-lag metric the reference derives
  from instrumented contexts.
- **SingleLoopChecker**: thread_checker.h analog — pins the first loop
  that touches a component and asserts every later touch happens on the
  same loop.

Native code gets the real thing: `native/build.py:build_selftest`
compiles standalone harnesses (native/shm_store_selftest.cpp) with
`-fsanitize=address,undefined`, and the suite runs them as
subprocesses (tests/test_sanitizers.py).

Enable with ``RAY_TPU_TORCH_LOOP_SANITIZER=1`` (threshold via
``RAY_TPU_TORCH_SLOW_CALLBACK_S``, default 0.1s). Daemons call
`maybe_install()` at startup; stats ride the existing `dump_stacks`
debug RPC so `ray_tpu_torch stack` shows them cluster-wide.
"""

from __future__ import annotations

import asyncio
import collections
import os
import threading
import time
from typing import Dict, Optional

_LOCK = threading.Lock()
_INSTALLED = False
_SLOW_RING_MAX = 64


class _Stats:
    """Per-callback-name event stats + slow-event ring (event_stats.cc
    shape: count, cumulative time, max time). Locked: the Handle._run
    patch is process-wide, so executor-thread loops record concurrently
    with the main loop's snapshot()."""

    def __init__(self) -> None:
        self.events: Dict[str, list] = {}  # name -> [count, total_s, max_s]
        self.slow = collections.deque(maxlen=_SLOW_RING_MAX)
        self.lag_max_s = 0.0
        self.lag_avg_s = 0.0
        self._lag_n = 0
        self._mu = threading.Lock()

    def record(self, name: str, dt: float, threshold: float) -> None:
        with self._mu:
            e = self.events.get(name)
            if e is None:
                e = self.events[name] = [0, 0.0, 0.0]
            e[0] += 1
            e[1] += dt
            if dt > e[2]:
                e[2] = dt
            if dt >= threshold:
                self.slow.append({"callback": name,
                                  "duration_s": round(dt, 4),
                                  "ts": time.time()})

    def record_lag(self, lag: float) -> None:
        with self._mu:
            self._lag_n += 1
            self.lag_avg_s += (lag - self.lag_avg_s) / self._lag_n
            if lag > self.lag_max_s:
                self.lag_max_s = lag

    def snapshot(self, top: int = 20) -> Dict:
        with self._mu:
            ranked = sorted(self.events.items(),
                            key=lambda kv: -kv[1][1])[:top]
            return {
                "handlers": {n: {"count": c, "total_s": round(t, 4),
                                 "max_s": round(m, 4)}
                             for n, (c, t, m) in ranked},
                "slow_callbacks": list(self.slow),
                "loop_lag": {"max_s": round(self.lag_max_s, 4),
                             "avg_s": round(self.lag_avg_s, 5)},
            }


_STATS = _Stats()


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_LOOP_SANITIZER", "") not in ("", "0")


def threshold_s() -> float:
    return float(os.environ.get("RAY_TPU_TORCH_SLOW_CALLBACK_S", "0.1"))


def _callback_name(cb) -> str:
    # unwrap the functools/bound-method layers asyncio hands us
    for attr in ("__func__", "func"):
        inner = getattr(cb, attr, None)
        if inner is not None:
            cb = inner
    name = getattr(cb, "__qualname__", None) or repr(cb)
    mod = getattr(cb, "__module__", "") or ""
    if mod.startswith("asyncio"):
        # Task.__step etc. — attribute to the coroutine being driven
        return name
    return f"{mod}.{name}" if mod else name


def _patch_handle_run() -> None:
    orig = asyncio.events.Handle._run
    thr = threshold_s()

    def timed_run(self):
        t0 = time.perf_counter()
        try:
            return orig(self)
        finally:
            dt = time.perf_counter() - t0
            if dt >= 1e-4:  # skip no-op wakeups; keep the dict small
                cb = getattr(self, "_callback", None)
                # a Task step is more useful named after its coroutine
                task = getattr(cb, "__self__", None)
                if isinstance(task, asyncio.Task):
                    coro = task.get_coro()
                    name = getattr(coro, "__qualname__", repr(coro))
                else:
                    name = _callback_name(cb)
                _STATS.record(name, dt, thr)

    asyncio.events.Handle._run = timed_run


async def _lag_probe(interval: float = 0.05) -> None:
    """Measure event-loop scheduling drift: how much later than asked
    the loop wakes us. Runs forever; daemons fire-and-forget it."""
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(interval)
        _STATS.record_lag(max(0.0, loop.time() - t0 - interval))


def maybe_install(start_lag_probe: bool = True) -> bool:
    """Install the loop sanitizer if RAY_TPU_TORCH_LOOP_SANITIZER is set.
    Idempotent; safe to call from every daemon main. Returns True when
    active. Must be called with a running loop for the lag probe to
    start (otherwise stats-only)."""
    global _INSTALLED
    if not enabled():
        return False
    with _LOCK:
        if not _INSTALLED:
            _patch_handle_run()
            _INSTALLED = True
    if start_lag_probe:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None and not getattr(loop, "_rt_lag_probe", None):
            loop._rt_lag_probe = loop.create_task(_lag_probe())
    return True


def stats_snapshot() -> Optional[Dict]:
    """Current sanitizer stats, or None when inactive (the dump_stacks
    RPC attaches this so `ray_tpu_torch stack` surfaces loop health)."""
    if not _INSTALLED:
        return None
    return _STATS.snapshot()


class SingleLoopChecker:
    """thread_checker.h analog: asserts a component is only touched from
    the event loop that first touched it.

    Usage: ``self._checker = SingleLoopChecker("NodeManager")`` then
    ``self._checker.check()`` at hot entry points. check() is a no-op
    unless the sanitizer is enabled, so production pays one attribute
    load + one truthiness test."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._loop = None
        self._active = enabled()

    def check(self) -> None:
        if not self._active:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if self._loop is None:
            self._loop = loop
        elif loop is not self._loop:
            raise AssertionError(
                f"{self.name}: touched from loop {loop!r}, owned by "
                f"{self._loop!r} — single-loop discipline violated")
