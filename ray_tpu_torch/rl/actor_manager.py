"""Fault-tolerant env-runner set (reference:
rllib/utils/actor_manager.py FaultTolerantActorManager +
Algorithm.restart_failed_env_runners — RLlib restarts dead env runners
mid-training and keeps the training loop alive on the survivors).

Re-designed for this package's driver loops: a list-compatible
container (algorithms iterate/len it like the plain list it replaces)
whose `foreach` fans a method out to every runner, drops the round's
results from runners that died (ActorDiedError), and replaces each dead
runner in its slot — same runner_index config, fresh actor — pushing
current weights via the `on_restart` hook. Async drivers (IMPALA) call
`replace` directly when a sampled future surfaces a dead actor.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

logger = logging.getLogger(__name__)


class RunnerSetBroken(RuntimeError):
    """All runners failed, or the restart budget is exhausted."""


class FaultTolerantRunnerSet(list):
    """List of actor handles + restart policy. Slots are stable: the
    runner at index i is always configured with runner_index=i, so
    restarts preserve seeding/sharding structure."""

    def __init__(self, make_runner: Callable[[int], Any], num: int,
                 max_restarts: int = 3, restart_enabled: bool = True,
                 on_restart: Optional[Callable[[Any], None]] = None):
        super().__init__(make_runner(i) for i in range(num))
        self._make = make_runner
        self._on_restart = on_restart
        self.max_restarts = max_restarts
        self.restart_enabled = restart_enabled
        self.num_restarts = 0
        self._fell_back = False

    def set_on_restart(self, fn: Callable[[Any], None]) -> None:
        self._on_restart = fn

    def broadcast_weights(self, weights) -> Any:
        """Put `weights` once and pre-position the sealed blob on EVERY
        node through the weight-distribution plane (the runtime's
        ``broadcast_weights``: spanning arena allocation for
        multi-GB params, log-depth binomial relay fan-out over the
        striped data plane) — so N runners' ``set_weights`` resolve
        their arg from the local arena instead of N point-to-point
        pulls off the learner's node. Returns the ObjectRef to pass to
        ``foreach("set_weights", ref)``. Falls back to a plain put when
        the broadcast plane is unavailable (client mode, degraded
        cluster, or weights small enough to travel inline, as a
        CartPole net's do) — runners then pull point-to-point as before.
        The first fallback is logged with its cause, later ones at debug
        level (a small net falls back on every sync)."""
        import ray_tpu_torch as rt
        try:
            return rt.broadcast_weights(weights)
        except Exception:
            logger.log(logging.DEBUG if self._fell_back else logging.WARNING,
                       "weight broadcast unavailable; falling back to "
                       "point-to-point weight pulls", exc_info=True)
            self._fell_back = True
            return rt.put(weights)

    def replace(self, runner) -> Optional[Any]:
        """Runner observed dead: recreate it in its slot; returns the
        replacement. Returns None if the runner was ALREADY replaced (a
        stale in-flight future can surface one death twice — once via
        foreach, once via the async loop). Raises RunnerSetBroken once
        the restart budget is spent (a persistent crash loop should
        fail the experiment, not spin)."""
        import ray_tpu_torch as rt
        try:
            i = self.index(runner)
        except ValueError:
            logger.debug("runner already replaced; ignoring")
            return None
        if not self.restart_enabled or \
                self.num_restarts >= self.max_restarts:
            raise RunnerSetBroken(
                f"env runner {i} died and restarts are "
                f"{'disabled' if not self.restart_enabled else 'exhausted'}"
                f" ({self.num_restarts}/{self.max_restarts})")
        self.num_restarts += 1
        try:
            rt.kill(runner)
        except Exception:
            pass
        logger.warning("env runner %d died; restarting (%d/%d)",
                       i, self.num_restarts, self.max_restarts)
        fresh = self._make(i)
        self[i] = fresh
        if self._on_restart is not None:
            try:
                self._on_restart(fresh)
            except Exception:
                logger.exception("on_restart hook failed for runner %d", i)
        return fresh

    def foreach(self, method: str, *args, timeout: float = 600.0,
                **kwargs) -> List[Any]:
        """Call `method` on every runner; per-runner result gather.
        Dead AND timed-out runners are replaced and their result dropped —
        callers get >=1 result or RunnerSetBroken. `timeout` is ONE shared
        deadline for the whole gather (N runners never stretch a round to
        N x timeout; a runner that hangs past the deadline is treated as
        failed exactly like one that died)."""
        import time

        import ray_tpu_torch as rt
        calls = [(r, getattr(r, method).remote(*args, **kwargs))
                 for r in list(self)]
        results = []
        deadline = time.monotonic() + timeout
        for runner, ref in calls:
            remaining = deadline - time.monotonic()
            try:
                results.append(
                    rt.get(ref, timeout=max(0.001, remaining)))
            except rt.ActorDiedError:
                self.replace(runner)
            except TimeoutError:   # asyncio.TimeoutError is an alias
                logger.warning(
                    "env runner hung in %s past the %.0fs deadline; "
                    "treating it as failed", method, timeout)
                self.replace(runner)
        if not results:
            raise RunnerSetBroken(f"every env runner died during {method}")
        return results
