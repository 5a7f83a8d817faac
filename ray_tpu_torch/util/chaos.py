"""Chaos-testing utilities (the port keeps those it tests with: the
shared-memory create killer, the pipeline's stage killer, and Serve's
replica killer and prefill-export killer). RPC-level
failure injection lives in _private/rpc.py behind
RAY_TPU_TORCH_TESTING_RPC_FAILURE; the ``push_chunk`` key there covers
both object-transfer transports (the msgpack chunk RPCs and the data
plane, which runs the same hook before every raw chunk send).

Shared-memory chaos lives in its own spec because the failure mode is a
process DEATH, not an exception: ``RAY_TPU_TORCH_TESTING_SHM_FAILURE=
"shm_create=N"`` makes the armed process SIGKILL itself inside its Nth
``rt_create`` while it HOLDS a stripe mutex mid-mutation (the hook is in
shm_store.cpp) — the worst-case death the robust-mutex recovery path
must repair from. Arm child client processes via ``ShmCreateKiller``."""

from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Optional


class ShmCreateKiller:
    """Arms a (child) process to SIGKILL itself mid-``rt_create`` while
    holding a shared-arena stripe mutex — the object-store analog of
    NodeKiller. The kill happens INSIDE the native create, after the
    stripe's heap has been mutated but before the entry is published, so
    survivors must hit ``EOWNERDEAD`` on that stripe's robust mutex,
    repair it, and keep serving puts.

    Usage::

        killer = ShmCreateKiller(nth_create=3)
        proc = ctx.Process(target=..., env-injected via killer.env())
        # or: subprocess.Popen(..., env=killer.env())
        killer.assert_killed(proc)   # died by SIGKILL, not cleanly
    """

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_SHM_FAILURE"

    def __init__(self, nth_create: int = 1):
        if nth_create < 1:
            raise ValueError("nth_create must be >= 1")
        self.nth_create = nth_create

    def spec(self) -> str:
        return f"shm_create={self.nth_create}"

    def env(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """Environment for the victim process (a copy; the arming env var
        must never leak into the parent — the spec is parsed once per
        process at first create)."""
        e = dict(base if base is not None else os.environ)
        e[self.SPEC_ENV] = self.spec()
        return e

    @staticmethod
    def assert_killed(proc, timeout_s: float = 30.0) -> None:
        """Join a multiprocessing.Process victim and assert it died by
        SIGKILL (exitcode -9), i.e. the injection actually fired."""
        proc.join(timeout_s)
        if proc.exitcode != -9:
            raise AssertionError(
                f"victim exitcode {proc.exitcode!r}; expected -9 (SIGKILL "
                "from the shm_create injection)")


class StageKiller:
    """Injects stage loss into the elastic MPMD pipeline trainer
    (train/mpmd.py) through BOTH failure channels the recovery path must
    handle:

    * ``stage_step=p`` — the armed stage runs the injection hook at
      forward/backward entry; when it fires, an ACTOR stage SIGKILLs its
      own process mid-step (the crash shape: no exception reaches the
      controller, the actor just dies holding in-flight microbatches),
      while a LOCAL stage handle marks itself dead and raises — the
      in-process stand-in for the same loss. Surviving stages must park
      at the recovery barrier, the controller re-provisions the stage
      from its shard checkpoint, and replay rejoins the pipeline.
    * ``stage_seal`` — the armed ACTOR stage SIGKILLs itself when the
      controller asks for a boundary's snapshot, before the snapshot is
      sealed in the object store: the boundary is lost with the stage,
      and recovery must fall back to the last sealed one.
    * :meth:`preempt_stage` — writes the stage's preemption-notice
      marker file (the ``gpu.check_preemption_notice`` test channel);
      the stage's watch
      thread reports ``preempting`` and the controller migrates it at
      the NEXT step boundary — the graceful notice → drain → replace
      path, zero replayed steps.

    Spec: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="stage_step=p"``, or with
    ``at_call=N`` ``"<channel>=#N"``: only the Nth check of the channel in
    the armed process fires, a death at a fixed point (a stage actor
    checks ``stage_step`` once per forward and once per backward). Like
    the other RPC-chaos specs the env must be set before the victim
    process parses it (first injection check caches the spec; a stage
    actor parses it anew in its constructor). ``arm_local`` /
    ``disarm_local`` reset the cache for in-process tests."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"
    CHANNELS = ("stage_step", "stage_seal")

    def __init__(self, probability: float = 1.0, *,
                 at_call: Optional[int] = None, channel: str = "stage_step"):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        if at_call is not None and at_call < 1:
            raise ValueError("at_call must be >= 1")
        if channel not in self.CHANNELS:
            raise ValueError(f"channel must be one of {self.CHANNELS}")
        self.probability = probability
        self.at_call = at_call
        self.channel = channel

    def spec(self) -> str:
        if self.at_call is not None:
            return f"{self.channel}=#{self.at_call}"
        return f"{self.channel}={self.probability}"

    def env(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        e = dict(base if base is not None else os.environ)
        prior = e.get(self.SPEC_ENV)
        e[self.SPEC_ENV] = f"{prior},{self.spec()}" if prior else self.spec()
        return e

    def arm_local(self):
        """Arm the CURRENT process (LocalStageHandle tests): sets the
        env var and resets rpc.py's parsed-spec cache so the next
        injection check re-reads it. Pair with :meth:`disarm_local`."""
        from ray_tpu_torch._private import rpc
        os.environ[self.SPEC_ENV] = self.spec()
        rpc._CHAOS_SPEC = None

    @staticmethod
    def disarm_local():
        from ray_tpu_torch._private import rpc
        os.environ.pop(StageKiller.SPEC_ENV, None)
        rpc._CHAOS_SPEC = None

    # ------------------------------------------- graceful notice channel
    @staticmethod
    def preempt_stage(marker_path: str) -> None:
        """Flip a LIVE stage's preemption notice by creating its marker
        file (the path passed to the stage as ``preempt_marker``; the
        watch thread polls it at ``mpmd_health_poll_s``)."""
        with open(marker_path, "w") as f:
            f.write("preempt\n")

    @staticmethod
    def clear_notice(marker_path: str) -> None:
        try:
            os.remove(marker_path)
        except FileNotFoundError:
            pass


class PrefillExportKiller:
    """Injects failure into the disaggregated-serving KV hand-off: the
    prefill tier's ``prefill_export`` runs the injection hook at entry
    AND right before returning (``serve/disagg.py``), so with
    probability ``p`` an export dies either before any prefill work or
    AFTER the payload object exists but before the hand-off completes —
    the two halves of "prefill replica killed mid-export". The decode
    tier must fall back to LOCAL prefill with exactly-once token
    delivery preserved (nothing has streamed when the rung fails).

    Spec: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="prefill_export=p"``; like the
    other RPC-chaos specs it must be in the environment BEFORE the
    victim process parses it (first injection check caches the spec).
    Compose with :class:`ServeReplicaKiller` on the prefill deployment
    to exercise the actor-death (rather than exception) variant."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"

    def __init__(self, probability: float = 1.0):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        self.probability = probability

    def spec(self) -> str:
        return f"prefill_export={self.probability}"

    def env(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        e = dict(base if base is not None else os.environ)
        prior = e.get(self.SPEC_ENV)
        e[self.SPEC_ENV] = f"{prior},{self.spec()}" if prior else self.spec()
        return e

    def arm_local(self):
        """Arm the CURRENT process (direct-instantiation tests): sets
        the env var and resets rpc.py's parsed-spec cache so the next
        injection check re-reads it. Pair with :meth:`disarm_local`."""
        from ray_tpu_torch._private import rpc
        os.environ[self.SPEC_ENV] = self.spec()
        rpc._CHAOS_SPEC = None

    @staticmethod
    def disarm_local():
        from ray_tpu_torch._private import rpc
        os.environ.pop(PrefillExportKiller.SPEC_ENV, None)
        rpc._CHAOS_SPEC = None


class ServeReplicaKiller:
    """Kill serve replica actors mid-request (streaming included) and
    let the controller's reconcile loop replace them — the serving
    analog of NodeKiller. Used by the kill-replica-mid-stream tests to
    assert that per-replica resources (inference-engine slots, queue
    gauges) come back clean on the replacement replica."""

    def __init__(self, app_name: str, deployment_name: str, seed: int = 0):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self.killed = 0
        self.preempted = 0
        self._rng = random.Random(seed)

    def _controller(self):
        from ray_tpu_torch.serve.api import _get_controller
        return _get_controller()

    def _info(self):
        import ray_tpu_torch
        return ray_tpu_torch.get(self._controller().get_deployment_info.remote(
            self.app_name, self.deployment_name), timeout=30)

    def replicas(self) -> List:
        return list(self._info().get("replicas") or [])

    def kill_one(self, prefer_busy: bool = False) -> bool:
        """Kill one (random) replica actor; returns False when none are
        up. The controller detects the death on its next reconcile and
        builds a replacement. prefer_busy=True targets a replica with a
        non-empty queue when one exists — the interesting victim for
        stream-resume tests (killing an idle replica severs nothing)."""
        import ray_tpu_torch
        reps = self.replicas()
        if not reps:
            return False
        victim = None
        if prefer_busy:
            for r in reps:
                try:
                    if ray_tpu_torch.get(r.get_queue_len.remote(),
                                   timeout=10) > 0:
                        victim = r
                        break
                except Exception:
                    continue
        if victim is None:
            victim = self._rng.choice(reps)
        try:
            ray_tpu_torch.kill(victim)
        except Exception:
            return False
        self.killed += 1
        return True

    def preempt_one(self, grace_s: Optional[float] = None) -> bool:
        """Graceful-notice preemption: the controller delivers a drain
        notice to one (random) replica, drops it from the routing table,
        and pre-starts a replacement — exercising the notice -> drain ->
        replace path instead of the crash path. The drained replica is
        force-killed at the grace deadline if its queue never empties."""
        import ray_tpu_torch
        n = len(self.replicas())
        if not n:
            return False
        ok = ray_tpu_torch.get(self._controller().preempt_replica.remote(
            self.app_name, self.deployment_name,
            self._rng.randrange(n), grace_s), timeout=30)
        if ok:
            self.preempted += 1
        return bool(ok)

    def wait_for_replacement(self, timeout_s: float = 60.0,
                             min_running: int = 1, handle=None) -> bool:
        """Block until the deployment again reports >= min_running
        replicas under a NEW version set (the controller bumps the
        router view when the replica set changes). Pass the test's
        DeploymentHandle as `handle` to ALSO wait for router-view
        propagation — the handle's router must have applied the new
        replica set, otherwise the next `handle.remote(...)` races the
        stale routing table and lands on the corpse."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                info = self._info()
                reps = list(info.get("replicas") or [])
                if len(reps) >= min_running:
                    import ray_tpu_torch
                    # replacement must actually answer, not just exist
                    ray_tpu_torch.get([r.get_queue_len.remote() for r in reps],
                                timeout=10)
                    if handle is None:
                        return True
                    router = handle._router
                    router.refresh(force=True)
                    with router.lock:
                        if (router.version >= info["version"]
                                and len(router.replicas) >= min_running):
                            return True
            except Exception:
                pass
            time.sleep(0.5)
        return False
