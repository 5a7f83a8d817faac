"""Typed runtime flag registry with env overrides and head propagation.

The reference defines 218 ``RAY_CONFIG(type, name, default)`` flags
(reference: src/ray/common/ray_config_def.h), each overridable via a
``RAY_<name>`` env var, and the head node serializes its resolved config to
every joining node (``GetSystemConfig``, node_manager.proto:432). This is
the same capability with a TPU-sized surface:

- every tunable in the runtime lives here (one place to discover/tune);
- ``RAY_TPU_TORCH_<NAME>`` env vars override defaults at process start;
- the GCS snapshots its resolved values and ships them to node managers in
  the ``register_node`` reply and to drivers/workers via
  ``get_system_config``, so one head-side setting governs the cluster.

Usage::

    from ray_tpu_torch._private.config import cfg
    timeout = cfg.lease_idle_timeout_s

Values resolve in priority order: explicit ``cfg.apply()`` (propagated
snapshot) > ``RAY_TPU_TORCH_*`` env var > registered default.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional

_ENV_PREFIX = "RAY_TPU_TORCH_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _Flag:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, typ: Callable, default: Any, doc: str):
        self.name = name
        self.type = typ
        self.default = default
        self.doc = doc

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return _parse_bool(raw)
        return self.type(raw)


_REGISTRY: Dict[str, _Flag] = {}


def _flag(name: str, typ: Callable, default: Any, doc: str) -> None:
    _REGISTRY[name] = _Flag(name, typ, default, doc)


# ----------------------------------------------------------------- registry
# Core worker / task submission
_flag("lease_idle_timeout_s", float, 1.0,
      "How long a granted worker lease may sit idle before being returned "
      "to the node manager.")
_flag("task_max_retries", int, 3,
      "Default retry budget for tasks whose worker died (mirrors "
      "@remote(max_retries=...) default).")
_flag("max_dispatchers_per_sig", int, 32,
      "Max concurrent lease-holding dispatchers per (resources, scheduling) "
      "task signature in one submitter process.")
_flag("actor_restart_probe_s", float, 0.2,
      "Delay before probing the GCS for a restarted actor's new address "
      "after an actor connection drops.")
_flag("wait_poll_floor_s", float, 0.02,
      "Floor for KV/rendezvous polling sleeps.")
_flag("lineage_max_depth", int, 16,
      "Maximum reconstruction attempts per lost object (bounds recursive "
      "lineage re-execution storms; reference caps lineage similarly via "
      "max_lineage_bytes / task retry budgets).")

# Worker hot paths
_flag("actor_push_batch", int, 32,
      "Max actor calls coalesced into one wire frame by the per-actor "
      "sender (amortizes frame + dispatch overhead; reference pipelines "
      "per-call over C++ gRPC, actor_task_submitter.h:75 — Python pays "
      "more per frame, so we batch).")
_flag("task_push_batch", int, 32,
      "Max queued same-signature tasks pushed to a leased worker in one "
      "frame.")
_flag("task_events_per_s", int, 2000,
      "Per-process task-event budget; beyond it the recorder keeps a "
      "deterministic 1-in-8 sample by task id (all states of sampled "
      "tasks are kept, so the timeline stays representative).")
_flag("gcs_wal_fsync", bool, False,
      "fsync the GCS write-ahead log after every append. Off by default: "
      "the WAL then survives a process kill but not a host crash (the "
      "snapshot still bounds loss to the snapshot interval). Turn on for "
      "single-head clusters whose state must survive power loss.")
_flag("inline_exec_threshold_s", float, 0.002,
      "Actor/task methods whose running-average duration is below this "
      "execute inline on the event loop instead of a thread-pool hop "
      "(adaptive: first call always measures on the pool; a method that "
      "turns slow migrates back).")

# Node manager
_flag("transfer_chunk_bytes", int, 8 * 1024 * 1024,
      "Chunk size for node-to-node object transfer (reference default is "
      "5 MiB, object_manager.h).")
_flag("push_window_chunks", int, 4,
      "Chunks in flight per push stream: pipelines the wire without "
      "unbounded receiver buffering (reference: PushManager per-push "
      "in-flight cap, push_manager.h:30).")
_flag("data_plane_enabled", bool, True,
      "Advertise and use the raw-socket binary data plane for cross-node "
      "object transfer (sender writes arena memoryviews, receiver "
      "recv_into()s straight into store.create regions). Off = legacy "
      "msgpack chunks on the control-plane RPC connection.")
_flag("transfer_streams", int, 2,
      "Parallel data-plane connections a large object push is striped "
      "across (per-stripe contiguous offset ranges). More streams help "
      "multi-core nodes overlap kernel copies; each stream keeps its own "
      "push_window_chunks flow-control window.")
_flag("transfer_stripe_min_bytes", int, 8 * 1024 * 1024,
      "Minimum bytes per stripe before a push fans out across an "
      "additional data-plane connection (small objects stay on one "
      "stream; striping overhead would dominate).")
_flag("transfer_streams_large", int, 8,
      "Stream count for weight-sized transfers: objects at or above "
      "transfer_large_object_bytes stripe across this many data-plane "
      "connections instead of transfer_streams (multi-GB weight "
      "broadcasts want every core's kernel copy bandwidth; small "
      "transfers keep the low default). <= transfer_streams disables "
      "the escalation.")
_flag("transfer_large_object_bytes", int, 256 * 1024 * 1024,
      "Size threshold at which a transfer counts as weight-sized and "
      "fans out across transfer_streams_large connections.")
_flag("pull_inflight_bytes", int, 256 * 1024 * 1024,
      "Admission budget for concurrent inbound object transfers on one "
      "node; pulls past it queue FIFO (reference: PullManager "
      "admission-controlled bundles, pull_manager.h:52).")
_flag("heartbeat_interval_s", float, 0.5,
      "Node manager -> GCS heartbeat period (also carries the resource "
      "view).")
_flag("streaming_backpressure", int, 16,
      "Max unconsumed items a streaming-generator task may have in "
      "flight before the executor pauses the generator (reference: "
      "_generator_backpressure_num_objects on ReportGeneratorItemReturns"
      ", core_worker.proto:400).")
_flag("gcs_reconnect_timeout_s", float, 60.0,
      "How long a node manager keeps retrying an unreachable GCS before "
      "giving up, reaping its workers, and exiting (reference: raylet "
      "gcs_rpc_server_reconnect_timeout_s, src/ray/raylet/main.cc:123; "
      "without it a node manager retries forever).")
_flag("view_refresh_s", float, 1.0,
      "Period for refreshing the cluster resource view used by spillback "
      "scheduling.")
_flag("lease_wait_timeout_s", float, 300.0,
      "Server-side cap on how long a lease request may queue for local "
      "resources before erroring.")
_flag("actor_resource_wait_s", float, 60.0,
      "How long actor creation waits for local resources before failing.")
_flag("infeasible_grace_s", float, 30.0,
      "How long a request may be cluster-wide infeasible before it is "
      "failed (it stays queued as autoscaler demand until then).")
_flag("spill_uri", str, "",
      "Spill target as a URI (empty = node-local directory). Any "
      "fsspec-resolvable scheme works — gs://bucket/spill on TPU pods, "
      "s3://, memory:// in tests (reference: external_storage.py "
      "filesystem-or-cloud spill).")
_flag("spill_check_interval_s", float, 2.0,
      "Period of the object-spill pressure check loop.")
_flag("spill_high_watermark", float, 0.8,
      "Arena utilization above which primary copies spill to disk.")
_flag("log_tail_interval_s", float, 0.5,
      "Period of the worker-log tail loop feeding the driver log stream.")

# GCS
_flag("node_death_timeout_s", float, 5.0,
      "Heartbeat silence after which the GCS declares a node dead.")
_flag("gcs_snapshot_interval_s", float, 2.0,
      "Period between GCS table snapshots to disk (fault-tolerance "
      "restore source).")
_flag("health_check_interval_s", float, 0.5,
      "GCS-side period for scanning node liveness.")

# Object store
_flag("object_store_memory", int, 0,
      "Default per-node object store arena size in bytes (0 = auto).")
_flag("arena_stripes", int, 0,
      "Number of independently locked sub-heaps the shared-memory arena "
      "is striped into (0 = auto: RAY_TPU_TORCH_ARENA_STRIPES env, else "
      "size/128MiB capped at 8). More stripes let more same-node clients "
      "put in parallel; the largest single object must fit one stripe.")
_flag("spill_probe_interval_puts", int, 32,
      "How many puts a worker may do between refreshes of its cached "
      "store-usage snapshot for the spill-pressure check (the probe also "
      "refreshes immediately on MemoryError; between refreshes the worker "
      "accounts its own put bytes locally).")
_flag("memory_monitor_interval_s", float, 1.0,
      "Period of the per-node worker memory monitor (0 disables).")
_flag("memory_usage_threshold", float, 0.95,
      "Fraction of system memory above which the node manager kills the "
      "largest retriable worker (OOM defense).")

_flag("pip_worker_idle_timeout_s", float, 300.0,
      "Idle eviction for workers dedicated to a pip runtime env (they "
      "serve exactly one env and would otherwise live forever).")
_flag("slice_wait_timeout_s", float, 60.0,
      "How long a gang waits for a whole healthy TPU slice before "
      "failing the attempt.")
_flag("spill_low_watermark", float, 0.6,
      "Spilling stops once arena utilization falls below this fraction.")
# Observability: time-series metrics plane (GCS) + registry pusher
_flag("metrics_push_interval_s", float, 2.0,
      "Base cadence of the per-process metrics registry push to the GCS "
      "(each push is jittered +/-25% so a fleet of workers doesn't "
      "synchronize on the control plane).")
_flag("metrics_ts_retention_s", float, 600.0,
      "How far back the GCS time-series plane keeps metric samples; "
      "windowed query_metrics() calls can look back at most this far.")
_flag("metrics_ts_max_samples", int, 600,
      "Per-series ring capacity in the GCS time-series plane (at the "
      "2s push cadence, 600 samples ~= 20 minutes per pushing process).")
_flag("metrics_ts_max_series", int, 4096,
      "Total (metric, tags, worker) series the GCS time-series plane "
      "retains; new series past the cap are counted and dropped.")
# Observability: GCS hot-path tracing + launch attribution (gcs_obs.py)
_flag("gcs_slow_rpc_ms", float, 50.0,
      "A GCS handler call slower than this emits a gcs.rpc span onto "
      "the runtime-event timeline (always, regardless of sampling); "
      "faster calls are sampled 1-in-gcs_rpc_sample_n. 0 disables the "
      "span path entirely (histograms still accumulate).")
_flag("gcs_rpc_sample_n", int, 100,
      "Sample rate for FAST handler spans: every Nth sub-threshold call "
      "per handler also emits a gcs.rpc span (0 = slow calls only). "
      "Latency/inflight histograms always record every call.")
_flag("gcs_obs_interval_s", float, 2.0,
      "Cadence of the GCS self-metrics loop (per-handler RPC "
      "histograms, pubsub backlog/latency, KV and table size gauges "
      "ingested into the time-series plane as worker 'gcs'). 0 "
      "disables the loop.")
_flag("launch_trace_enabled", bool, True,
      "Thread an actor.launch root span through GCS placement, node "
      "manager resource wait/worker obtain, and worker callable init, "
      "so every actor/replica launch renders as a phase-decomposed "
      "track in `ray_tpu_torch timeline` and feeds the "
      "runtime_launch_phase_ms{phase} gauges.")
# Observability: crash black boxes (blackbox.py)
_flag("blackbox_enabled", bool, True,
      "Every daemon (GCS, node managers, workers) mirrors its flight-"
      "recorder ring and periodic metrics snapshots to a bounded "
      "on-disk NDJSON black box, sealed on clean exit / SIGTERM / "
      "GCS-disconnect death. `ray_tpu_torch blackbox` stitches surviving "
      "boxes into one cross-node post-mortem timeline.")
_flag("blackbox_dir", str, "",
      "Directory for black-box files (empty = "
      "$TMPDIR/raytpu_torch/<session>/blackbox). One <process>-<pid>.bbox.ndjson "
      "per process plus at most one rotated .1 segment each.")
_flag("blackbox_max_bytes", int, 4 * 1024 * 1024,
      "Per-process black-box size bound: the live segment rotates to a "
      "single .1 segment at half this, so live+rotated never exceed it.")
_flag("blackbox_metrics_interval_s", float, 5.0,
      "Cadence of the black box's metrics-registry snapshot records "
      "(the 'last known metrics' a post-mortem sees for a SIGKILL'd "
      "process). 0 disables periodic snapshots (seal still writes one).")
# Observability: object-lifetime ledger (GCS object_ledger table)
_flag("ledger_enabled", bool, True,
      "Maintain per-object provenance records (creator, owner, size, "
      "placement, lifecycle timestamps, location set) in the GCS "
      "object_ledger table. Workers record create/seal/free events; node "
      "managers reconcile presence + pin counts at "
      "ledger_report_interval_s. Off = `ray_tpu_torch memory` falls back to "
      "the local arena + owned-table view only.")
_flag("ledger_leak_after_s", float, 30.0,
      "A sealed, resident object with no pins whose owner exited (or "
      "reports zero references) older than this is flagged as leaked by "
      "the GCS ledger sweep (gauge store_leaked_bytes + store.leak "
      "instants + an eviction hint to the holding node's sweep).")
_flag("ledger_sweep_interval_s", float, 5.0,
      "Period of the GCS leak-detector sweep over the object ledger "
      "(0 disables the loop; the ledger_sweep handler still works).")
_flag("ledger_report_interval_s", float, 5.0,
      "Period of each node manager's arena census push into the object "
      "ledger (presence, pin counts, stripe/span placement). The census "
      "is the authority for an object's current location set — LRU "
      "evictions emit no event and are reconciled here.")
_flag("ledger_max_entries", int, 20000,
      "Object-ledger table capacity in the GCS; past it, freed rows are "
      "retired first, then the oldest rows (same bounded-ring discipline "
      "as the task-event sink).")
# Disaggregated serving: cluster-wide prefix routing (serve/disagg.py)
_flag("prefix_summary_interval_s", float, 2.0,
      "Cadence at which a prefix-routed serving replica publishes its "
      "radix-trie summary (top-K path fingerprints) to the GCS "
      "prefix_summaries table.")
_flag("prefix_summary_ttl_s", float, 10.0,
      "A prefix summary older than this is expired at read time — a "
      "dead replica stops attracting cluster-prefix routes within one "
      "TTL without explicit teardown.")
_flag("prefix_summary_top_k", int, 128,
      "Fingerprints per published trie summary (most recently touched "
      "first); ~8 bytes each on the wire, so the default is ~1KB per "
      "replica per publish.")
# Multi-model fleet plane (serve/fleet.py)
_flag("fleet_shell_pool_size", int, 1,
      "Pre-warmed replica shells the fleet manager keeps pooled for "
      "scale-to-zero revivals (process + imports paid; the deployment's "
      "callable/weights attach at cold start). 0 disables pooling — "
      "revivals fall back to a cold replica build.")
_flag("fleet_cold_start_timeout_s", float, 60.0,
      "How long a router holds requests for a scaled-to-zero deployment "
      "while a revival is in flight before surfacing no-replicas "
      "(serve/handle.py hold queue).")
_flag("fleet_attach_timeout_s", float, 120.0,
      "Per-shell attach RPC deadline during a revival (callable "
      "construction + weight load + warmup inside the shell); past it "
      "the shell is discarded and the next shell (or a cold build) "
      "serves the revival.")
_flag("serve_reconcile_period_s", float, 2.0,
      "Period of the serve controller's reconcile loop (health checks, "
      "autoscaling, rolling-update steps, proxy upkeep). For tests only, "
      "which shorten it to wait less on the loop; deployments keep the "
      "default.")
_flag("prefix_summary_push", bool, True,
      "Push prefix_summaries table changes to routers over the serve "
      "long-poll plane (the controller snapshots the GCS table each "
      "reconcile tick and bumps listeners on change). Off = routers "
      "fall back to the 1 Hz GCS pull.")
# Serve tenancy (serve/fleet.py TenantAdmission; GCS tenant_quotas table)
_flag("tenant_default_quota", int, 0,
      "Default per-tenant concurrency quota at the serve ingress "
      "(max in-flight requests per tenant). <= 0 = unlimited, which "
      "keeps untagged traffic zero-cost; per-tenant overrides live in "
      "the GCS tenant_quotas table (serve.set_tenant_quota).")
_flag("tenant_default_weight", float, 1.0,
      "Default deficit-round-robin weight for tenants queued at the "
      "serve ingress; a backlogged tenant's service share is "
      "proportional to its weight.")
_flag("tenant_queue_max", int, 64,
      "Per-tenant ingress wait-queue bound; requests past it are shed "
      "with 429 + Retry-After instead of collapsing the queue.")
_flag("tenant_retry_after_s", float, 1.0,
      "Fallback Retry-After hint attached to tenant-quota 429 responses "
      "when no token bucket exists for the tenant (bucketed tenants "
      "derive the hint from their actual refill deficit instead, so "
      "retries spread out rather than herding into synchronized waves).")
# Cluster-edge shared tenant quotas (serve/fleet.py QuotaLeaseClient;
# GCS quota_leases table)
_flag("quota_lease_interval_s", float, 2.0,
      "Cadence at which each ingress proxy renews its tenant-quota "
      "lease against the GCS (pushing local burn deltas and picking up "
      "epoch changes) — the metrics cadence of the shared fair-share "
      "plane.")
_flag("quota_lease_ttl_s", float, 10.0,
      "A proxy lease older than this is expired by the GCS (its rate "
      "share re-splits to the survivors) and a proxy that cannot renew "
      "for this long degrades itself to the conservative local quota.")
_flag("quota_lease_conservative_frac", float, 0.25,
      "Fraction of its last known per-tenant rate share a proxy keeps "
      "admitting at while its lease is revoked or unrenewable. The GCS "
      "escrows a revoked proxy's share (it is NOT re-split until the "
      "lease expires or re-acquires), so conservative admission below "
      "the escrowed share can never over-admit cluster-wide.")
# Cluster-wide KV fabric (serve/disagg.py decode->decode hand-off)
_flag("kv_fabric_enabled", bool, True,
      "Let a decode replica pull prefix KV blocks from ANY peer replica "
      "whose published trie summary covers the prompt (decode->decode "
      "hand-off over the data plane) before falling back to the prefill "
      "tier and then to local prefill. Off = prefill-tier funnel only.")
_flag("kv_fabric_relay_min", int, 2,
      "Minimum number of concurrent same-fingerprint export waiters on "
      "distinct nodes before the exporter relays the payload through "
      "the broadcast tree instead of serving point-to-point pulls.")
# Multi-model fleet plane: weight source for shell attach / revival
_flag("fleet_weights_from_arena", bool, True,
      "Deployments whose weights come from a params_fn resolve them "
      "through the cluster weight plane by default: the first replica "
      "to construct the callable publishes the loaded tree via "
      "broadcast_weights (plain put when the plane is unavailable) and "
      "records the ref in the GCS KV; every later attach — shell "
      "revivals included — gets the tree from its local arena instead "
      "of re-running the loader. Off = every attach re-runs params_fn.")
# Elastic MPMD pipeline training (train/mpmd.py)
_flag("mpmd_replay_depth", int, 2,
      "Steps of input microbatches the MPMD pipeline controller retains "
      "in its bounded replay buffer; a stage lost to preemption can "
      "rejoin from a shard checkpoint at most this many steps old, so "
      "recovery replays <= replay_depth + 1 steps.")
_flag("mpmd_barrier_deadline_s", float, 30.0,
      "How long surviving pipeline stages may take to park (abort the "
      "in-flight step and roll back to the checkpoint boundary) after a "
      "stage loss; a survivor that misses the barrier degrades the "
      "recovery to a job-level failure instead of hanging the pipeline.")
_flag("mpmd_restart_backoff_s", float, 1.0,
      "Delay before re-provisioning a lost pipeline stage (and between "
      "consecutive stage-replace attempts).")
_flag("mpmd_health_poll_s", float, 0.5,
      "Cadence of the per-stage preemption-notice watch thread "
      "(gpu.check_preemption_notice + the per-stage marker file).")
_flag("mpmd_step_timeout_s", float, 300.0,
      "Deadline for one pipeline step's optimizer-apply barrier; past "
      "it the controller treats unresponsive stages as lost.")
# Object store: spanning-object spill (weight-distribution plane)
_flag("span_spill_min_idle_s", float, 5.0,
      "A sealed, unpinned spanning object younger than this is never "
      "spilled by the pressure sweep (a weight blob mid-broadcast is "
      "briefly unpinned between the relay write and the first consumer "
      "attach; age-gating keeps the sweep off that window).")
# NOTE: RPC chaos injection is configured through rpc.py's own
# RAY_TPU_TORCH_TESTING_RPC_FAILURE spec string ("method=prob"), not a flag here.


class Config:
    """Resolved view over the registry; thread-safe; importable singleton."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._explicit: Dict[str, Any] = {}

    def __getattr__(self, name: str) -> Any:
        flag = _REGISTRY.get(name)
        if flag is None:
            raise AttributeError(f"unknown ray_tpu_torch config flag {name!r}")
        with self._lock:
            if name in self._explicit:
                return self._explicit[name]
        raw = os.environ.get(_ENV_PREFIX + name.upper())
        if raw is not None:
            try:
                return flag.parse(raw)
            except (TypeError, ValueError):
                raise ValueError(
                    f"bad value {raw!r} for {_ENV_PREFIX}{name.upper()} "
                    f"(expected {flag.type.__name__})")
        return flag.default

    def set(self, name: str, value: Any) -> None:
        flag = _REGISTRY.get(name)
        if flag is None:
            raise KeyError(f"unknown ray_tpu_torch config flag {name!r}")
        with self._lock:
            self._explicit[name] = value

    def reset(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._explicit.clear()
            else:
                self._explicit.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        """Fully-resolved {name: value} map — what the head ships to
        joining nodes so the whole cluster runs one config."""
        return {name: getattr(self, name) for name in _REGISTRY}

    def apply(self, values: Dict[str, Any]) -> None:
        """Apply a propagated snapshot (unknown keys are ignored so a
        newer head can talk to an older node)."""
        for k, v in values.items():
            if k in _REGISTRY:
                with self._lock:
                    self._explicit[k] = v

    def describe(self) -> str:
        lines = []
        for name, flag in sorted(_REGISTRY.items()):
            cur = getattr(self, name)
            mark = "" if cur == flag.default else "  [override]"
            lines.append(f"{name} = {cur!r}{mark}\n    {flag.doc}")
        return "\n".join(lines)


cfg = Config()


def flags() -> Dict[str, _Flag]:
    return dict(_REGISTRY)
