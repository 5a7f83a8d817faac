"""Chaos-testing utilities (the port keeps the two it tests with: the
shared-memory create killer and the pipeline's stage killer). RPC-level
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
from typing import Dict, Optional


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
