"""Chaos-testing utilities (reference: ResourceKillerActor / RayletKiller
python/ray/_private/test_utils.py:1433,1536 used by the chaos suites —
kill random nodes during workloads and assert completion). RPC-level
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
import threading
import time
from typing import Dict, List, Optional


class NodeKiller:
    """Kills random worker nodes of a cluster_utils.Cluster at an
    interval; never touches protected nodes (e.g. the head)."""

    def __init__(self, cluster, interval_s: float = 2.0,
                 protected_node_ids: Optional[List[str]] = None,
                 max_kills: int = 1, seed: int = 0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.protected = set(protected_node_ids or [])
        self.max_kills = max_kills
        self.killed: List[str] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self):
        while not self._stop.is_set() and len(self.killed) < self.max_kills:
            if self._stop.wait(self.interval_s):
                return
            victims = [n for n in self.cluster.nodes
                       if n.node_id not in self.protected
                       and n.node_id not in self.killed]
            if not victims:
                continue
            v = self._rng.choice(victims)
            try:
                v.kill()
                self.killed.append(v.node_id)
            except Exception:
                pass

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


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


class ShmSpanCreateKiller(ShmCreateKiller):
    """Arms a (child) process to SIGKILL itself mid-SPANNING-create —
    inside the native span claim loop, while it holds BOTH the arena's
    span mutex and a member stripe's mutex, with the descriptor still
    CLAIMING and at least one stripe already marked span-owned. The
    worst-case death of the weight-distribution plane: survivors must
    repair on two levels (stripe EOWNERDEAD marks the span broken; span
    EOWNERDEAD frees every claimed member stripe) and the half-claimed
    span must be freed or invalidated WHOLE — never half.

    Spec: ``RAY_TPU_TORCH_TESTING_SHM_FAILURE="shm_span_create=N"`` (the Nth
    spanning create of the armed process dies). Same ``env()`` /
    ``assert_killed`` usage as :class:`ShmCreateKiller`."""

    def spec(self) -> str:
        return f"shm_span_create={self.nth_create}"


class BroadcastRelayKiller:
    """Injects relay-node failure into tree broadcasts: every
    ``h_request_push`` that carries a non-empty relay list (i.e. an
    interior node of the binomial broadcast tree) fails with the given
    probability, so the root's await observes a dead subtree and must
    retry through the surviving holders. Leaf pushes (empty relay) are
    untouched — exactly the partial-delivery shape a mid-broadcast relay
    death leaves behind.

    Spec: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="relay_push=p"``; the env must
    be set BEFORE the daemon tree spawns (the spec is parsed once per
    process)."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"

    def __init__(self, probability: float = 1.0):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        self.probability = probability

    def spec(self) -> str:
        return f"relay_push={self.probability}"

    def env(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        e = dict(base if base is not None else os.environ)
        prior = e.get(self.SPEC_ENV)
        e[self.SPEC_ENV] = f"{prior},{self.spec()}" if prior else self.spec()
        return e


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


class PeerExportKiller:
    """Injects failure into the decode→decode KV fabric: a decode
    replica's ``peer_export`` (serve/disagg.py) runs the injection hook
    at entry AND right before returning, so with probability ``p`` an
    export dies either before the live-trie fingerprint check or AFTER
    the payload exists but before the peer receives it — the two halves
    of "peer replica killed mid-export". The importing replica must
    fall down its ladder (prefill hand-off, then LOCAL prefill) with
    exactly-once token delivery preserved.

    Spec: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="peer_export=p"``; like the
    other RPC-chaos specs it must be in the environment BEFORE the
    victim process parses it. Compose with :class:`ServeReplicaKiller`
    on the decode deployment for the actor-death variant."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"

    def __init__(self, probability: float = 1.0):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        self.probability = probability

    def spec(self) -> str:
        return f"peer_export={self.probability}"

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
        os.environ.pop(PeerExportKiller.SPEC_ENV, None)
        rpc._CHAOS_SPEC = None


class ShellAttachKiller:
    """Injects failure into the fleet plane's cold-start path: a
    pre-warmed replica shell's ``attach`` (serve/fleet.py ReplicaShell)
    runs the injection hook at entry AND after the callable is
    constructed but before the shell reports ready — the two halves of
    "shell killed mid-weight-attach". The fleet manager must discard
    the poisoned shell and serve the revival through a FRESH shell or a
    cold replica build; requests held at the router (they are parked
    un-submitted until a replica is published) are therefore delivered
    exactly once either way.

    Spec: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="shell_attach=p"``; like the
    other RPC-chaos specs the env must be set before the victim process
    parses it (first injection check caches the spec). ``arm_local`` /
    ``disarm_local`` reset the cache for in-process tests."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"

    def __init__(self, probability: float = 1.0):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        self.probability = probability

    def spec(self) -> str:
        return f"shell_attach={self.probability}"

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
        os.environ.pop(ShellAttachKiller.SPEC_ENV, None)
        rpc._CHAOS_SPEC = None


class GangRankKiller:
    """Kills one NON-ZERO rank of a sharded serving replica gang
    mid-decode: :class:`~ray_tpu_torch.serve.sharded.ShardedEngineReplica`
    runs the ``gang_rank`` injection hook before every engine step on
    ranks != 0, and when it fires the rank SIGKILLs its own process —
    the crash shape (no exception crosses the actor boundary; the peer
    simply stops answering while rank 0 is mid-stream).

    What the recovery path must then deliver, in order:

    1. rank 0's collective with the dead peer fails (gloo sees the
       connection close, or the gang's process-group timeout expires)
       and its bounded peer-drain wait fails → the gang WEDGES
       (``_wedged``) — a half-dead SPMD world is never reused;
    2. ``check_health`` raises → the controller retires every member +
       the placement group as one unit (whole-gang drain);
    3. the fleet manager revives through ``checkout_many`` +
       ``attach_shard`` (gang-aware pre-warm) or a cold gang build;
    4. the severed stream re-routes with ``resume_tokens`` — delivered
       tokens ride the prompt, so the client sees each token exactly
       once and a greedy stream continues bit-identically.

    Spec: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="gang_rank=p"``, or with
    ``at_call=N`` ``"gang_rank=#N"``: only the Nth engine step of the
    armed rank's process fires (counted from when the spec reached the
    process), a death at a fixed point mid-decode. The env must reach the
    victim actor through its ``runtime_env``: the worker makes the RPC
    layer parse the spec anew when a runtime env sets it
    (``_private/worker.py``). ``arm_local`` /
    ``disarm_local`` reset the cache for in-process tests (rank 0 never
    checks the hook, so arming a single-process gang is inert — the
    unit tier patches ``os.kill`` to observe the would-be death)."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"

    def __init__(self, probability: float = 1.0, *,
                 at_call: Optional[int] = None):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        if at_call is not None and at_call < 1:
            raise ValueError("at_call must be >= 1")
        self.probability = probability
        self.at_call = at_call

    def spec(self) -> str:
        if self.at_call is not None:
            return f"gang_rank=#{self.at_call}"
        return f"gang_rank={self.probability}"

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
        os.environ.pop(GangRankKiller.SPEC_ENV, None)
        rpc._CHAOS_SPEC = None


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
    process parses it (first injection check caches the spec; a spec
    set by an actor's ``runtime_env`` is parsed anew, see
    ``GangRankKiller``). ``arm_local`` /
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


class GcsRpcDelayer:
    """Injects latency into ONE named GCS handler: the observability
    wrapper (``_private/gcs_obs.py``) checks the spec before dispatching
    each ``h_*`` RPC and sleeps the armed handler on the event loop
    (``asyncio.sleep`` — other handlers keep flowing, exactly the shape
    of one slow table scan wedging a single RPC family). Used to drive
    the slow-handler span path (``gcs.rpc`` runtime events over
    ``gcs_slow_rpc_ms``) and the p99 histogram tail deterministically.

    Spec: ``RAY_TPU_TORCH_TESTING_GCS_RPC_DELAY="gcs_rpc=handler:ms"`` where
    ``handler`` is the RPC method name without the ``h_`` prefix (e.g.
    ``gcs_rpc=kv_get:75``); comma-compose entries to delay several
    handlers. The env must reach the GCS process before its first RPC
    (the spec is parsed once and cached); ``arm_local`` /
    ``disarm_local`` reset the cache for in-process GcsServer tests."""

    SPEC_ENV = "RAY_TPU_TORCH_TESTING_GCS_RPC_DELAY"

    def __init__(self, handler: str, delay_ms: float):
        if delay_ms < 0:
            raise ValueError("delay_ms must be >= 0")
        self.handler = handler
        self.delay_ms = delay_ms

    def spec(self) -> str:
        return f"gcs_rpc={self.handler}:{self.delay_ms}"

    def env(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        e = dict(base if base is not None else os.environ)
        prior = e.get(self.SPEC_ENV)
        e[self.SPEC_ENV] = f"{prior},{self.spec()}" if prior else self.spec()
        return e

    def arm_local(self):
        """Arm the CURRENT process (in-process GcsServer tests): sets
        the env var and resets gcs_obs's parsed-spec cache so the next
        dispatch re-reads it. Pair with :meth:`disarm_local`."""
        from ray_tpu_torch._private import gcs_obs
        os.environ[self.SPEC_ENV] = self.spec()
        gcs_obs._DELAY_SPEC = None

    @staticmethod
    def disarm_local():
        from ray_tpu_torch._private import gcs_obs
        os.environ.pop(GcsRpcDelayer.SPEC_ENV, None)
        gcs_obs._DELAY_SPEC = None


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


class QuotaLeaseRevoker:
    """Revoke a proxy's tenant-quota lease at the GCS mid-traffic and
    assert the no-over-admission invariant of the lease protocol
    (serve/fleet.py QuotaLeaseClient + _private/gcs.py quota_lease_*):

      * the GCS ESCROWS the revoked share — the lease row stays in the
        denominator of the per-proxy split, so surviving proxies' shares
        do NOT grow while the revoked proxy may still be admitting;
      * the revoked proxy learns of the revocation on its next renew and
        degrades every local bucket to ``quota_lease_conservative_frac``
        of its last share (strictly below the escrowed share), so the
        cluster-wide admitted rate can only FALL during the window;
      * the proxy re-acquires on a later renew tick and is restored to a
        full (re-split) share — degradation is transient, not sticky.

    Unlike the RPC-failure killers this is not env-spec injection: the
    action is a real ``quota_lease_revoke`` control call against a live
    GCS, so the revoker holds a ``gcs_call``-style callable (e.g.
    ``worker.gcs_call`` or a test's fake-GCS shim)."""

    def __init__(self, gcs_call, seed: int = 0):
        self._call = gcs_call
        self.revoked: List[str] = []
        self._rng = random.Random(seed)

    def status(self) -> Dict:
        """Raw ``quota_lease_status`` row: epoch, lease table (with
        per-row ``revoked`` flags), cluster tenant burn totals."""
        return self._call("quota_lease_status") or {}

    def lease_ids(self, live_only: bool = True) -> List[str]:
        rows = self.status().get("leases") or []
        return [r["proxy_id"] for r in rows
                if not (live_only and r.get("revoked"))]

    def revoke(self, proxy_id: str) -> bool:
        """Revoke one proxy's lease. Returns False when the GCS has no
        such lease (already expired/released)."""
        ok = bool(self._call("quota_lease_revoke", proxy_id=proxy_id))
        if ok:
            self.revoked.append(proxy_id)
        return ok

    def revoke_one(self) -> Optional[str]:
        """Revoke a random live lease; returns its proxy_id or None when
        no live lease exists."""
        ids = self.lease_ids(live_only=True)
        if not ids:
            return None
        pid = self._rng.choice(sorted(ids))
        return pid if self.revoke(pid) else None

    def wait_for_degraded(self, lease_client, timeout_s: float = 15.0,
                          poke=None) -> bool:
        """Block until ``lease_client`` (the victim proxy's
        QuotaLeaseClient) has observed the revocation and entered
        conservative mode. The client only learns on a renew, and
        renews ride the request path — pass ``poke`` (a zero-arg
        callable, e.g. ``lambda: client.maybe_renew(now)``) to drive
        ticks when no traffic is flowing."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if poke is not None:
                try:
                    poke()
                except Exception:
                    pass
            if lease_client.revoked:
                return True
            time.sleep(0.05)
        return False

    def wait_for_release(self, lease_client, timeout_s: float = 15.0,
                         poke=None) -> bool:
        """Block until the victim has re-acquired a live lease (revoked
        flag cleared) — the restore half of the chaos round-trip."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if poke is not None:
                try:
                    poke()
                except Exception:
                    pass
            if not lease_client.revoked and lease_client.stats()["epoch"]:
                return True
            time.sleep(0.05)
        return False
