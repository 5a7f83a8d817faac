"""GCS — global control service: the cluster-singleton control plane.

Re-design of the reference's GCS server (reference:
src/ray/gcs/gcs_server/gcs_server.cc, gcs_actor_manager.h:308,
gcs_node_manager.h, gcs_placement_group_manager, gcs_kv_manager.h,
gcs_health_check_manager.h:39). One asyncio process holding authoritative
tables for nodes, actors, jobs, placement groups and a namespaced KV store,
plus pubsub. Differences from the reference, deliberately:

- Transport is the symmetric rpc.py protocol; node managers hold one
  persistent bidirectional connection, so GCS→raylet commands (create actor
  worker, reserve bundle) and pubsub pushes reuse it — no per-service gRPC
  stubs or long-poll channels (reference: src/ray/pubsub/publisher.h:296).
- The cluster resource view (the reference's ray_syncer gossip,
  src/ray/common/ray_syncer/ray_syncer.h:88) is piggybacked on node
  heartbeats and re-broadcast to subscribers on change.
- Persistence is a pluggable snapshot (in-memory by default; file-backed
  snapshot for GCS restart) instead of Redis.

Actor scheduling follows the reference's GCS-based actor scheduling: GCS
picks the node (shared policy in scheduling.py) and leases a worker from
that node's manager (reference: gcs_actor_scheduler.cc:49).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import scheduling
from ray_tpu_torch._private.config import cfg
from ray_tpu_torch._private.proc_util import runtime_dir

logger = logging.getLogger(__name__)

# tunables live in config.py (health_check_interval_s,
# node_death_timeout_s, gcs_snapshot_interval_s)

# Actor states (reference: src/ray/protobuf/gcs.proto ActorTableData.ActorState)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class GcsServer:
    def __init__(self, port: int = 0, session_name: str = "session",
                 persist_path: Optional[str] = None):
        self.port = port
        self.session_name = session_name
        self.persist_path = persist_path
        # persistence behind the store-client interface (reference:
        # gcs/store_client/ — file impl today, external URI impl for
        # off-node durability; see _private/store_client.py)
        from ray_tpu_torch._private.store_client import store_client_for
        self.store_client = store_client_for(
            persist_path, fsync=cfg.gcs_wal_fsync) if persist_path else None
        self._wal_actors: set = set()   # actors whose full row is in WAL
        self.address: Optional[str] = None

        self.kv: Dict[str, Dict[bytes, bytes]] = {}          # namespace -> {k: v}
        self.nodes: Dict[str, Dict] = {}                     # node_id -> info
        self._view_version = 0        # bumps on any node-state change
        self.node_conns: Dict[str, rpc.Connection] = {}      # node_id -> conn
        self.actors: Dict[str, Dict] = {}                    # actor_id -> table row
        self.named_actors: Dict[tuple, str] = {}             # (ns, name) -> actor_id
        self.jobs: Dict[int, Dict] = {}
        self.placement_groups: Dict[str, Dict] = {}
        self.subscribers: Dict[str, set] = {}                # channel -> {conn}
        self._next_job_id = 1
        self._death_checker: Optional[asyncio.Task] = None
        self._pending_actor_queue: List[str] = []
        # task-event sink: ring buffer of merged per-task rows (reference:
        # GcsTaskManager, src/ray/gcs/gcs_server/gcs_task_manager.h:86)
        self.task_events: Dict[str, Dict] = {}
        # runtime events (the flight recorder's kind="runtime_event"
        # rows) share this ring with task rows; sized so a burst of
        # engine-step spans can't evict the whole task timeline
        self.max_task_events = 20000
        # object-lifetime ledger (ledger.py write side): one provenance
        # row per object id, merged from worker event deltas and node-
        # manager arena censuses. Bounded like the task-event ring —
        # freed rows retire first, then the oldest.
        self.object_ledger: Dict[str, Dict] = {}
        self._ledger_exited: set = set()   # worker ids that died/exited
        self._ledger_sweeper: Optional[asyncio.Task] = None
        # cluster-wide prefix routing (serve/disagg.py): one compact trie
        # summary per serving replica (top-K path fingerprints), expiring
        # after cfg.prefix_summary_ttl_s so dead replicas fall out of
        # routing within one TTL without explicit teardown
        self.prefix_summaries: Dict[str, Dict] = {}
        # serve tenancy (serve/fleet.py TenantAdmission): per-tenant
        # concurrency quota + DRR weight rows; the "__default__" tenant
        # row moves the fleet-wide defaults. Proxies refresh ~5s.
        self.tenant_quotas: Dict[str, Dict] = {}
        # cluster-edge shared fair share (serve/fleet.py
        # QuotaLeaseClient): one lease row per ingress proxy. The epoch
        # bumps on every membership change (join/leave/expire/revoke) so
        # a proxy can tell its rate shares are stale from the renew
        # response alone; burn deltas pushed on the renew cadence feed
        # the per-tenant cluster burn totals. Leases are ephemeral —
        # never snapshotted; proxies re-acquire after a GCS restart.
        self.quota_leases: Dict[str, Dict] = {}
        self.quota_lease_epoch = 1
        self.tenant_burn: Dict[str, int] = {}
        # time-series plane over report_metrics pushes (metrics_ts.py):
        # bounded per-series rings answering windowed queries (rate /
        # percentiles) that the latest-snapshot table cannot
        from ray_tpu_torch._private.metrics_ts import MetricsTimeSeries
        self.metrics_ts = MetricsTimeSeries(
            retention_s=cfg.metrics_ts_retention_s,
            max_samples=cfg.metrics_ts_max_samples,
            max_series=cfg.metrics_ts_max_series)
        # hot-path observability: per-handler latency/inflight, pubsub
        # deliver latency, table sizes (gcs_obs.py); self-ingested into
        # metrics_ts on the _obs_loop cadence as worker "gcs"
        from ray_tpu_torch._private.gcs_obs import GcsObservability
        self.obs = GcsObservability(self)
        self._obs_task: Optional[asyncio.Task] = None
        # in-flight launch table (node managers notify launch_phase):
        # actor_id -> {name, phase, phase_ts, started, node_id} — the
        # `ray_tpu_torch status` control-plane pane reads this; completed
        # launches retire into the _launch_done ring
        self.launches: Dict[str, Dict] = {}
        self._launch_done: List[Dict] = []
        self.server = None

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> str:
        handlers = {
            "kv_put": self.h_kv_put, "kv_get": self.h_kv_get,
            "kv_del": self.h_kv_del, "kv_exists": self.h_kv_exists,
            "kv_keys": self.h_kv_keys,
            "register_node": self.h_register_node,
            "get_system_config": lambda conn: cfg.snapshot(),
            "heartbeat": self.h_heartbeat,
            "drain_node": self.h_drain_node,
            "get_all_nodes": self.h_get_all_nodes,
            "get_cluster_view": self.h_get_cluster_view,
            "get_cluster_view_delta": self.h_get_cluster_view_delta,
            "register_job": self.h_register_job,
            "finish_job": self.h_finish_job,
            "get_all_jobs": self.h_get_all_jobs,
            "create_actor": self.h_create_actor,
            "get_actor_info": self.h_get_actor_info,
            "get_named_actor": self.h_get_named_actor,
            "list_named_actors": self.h_list_named_actors,
            "get_all_actors": self.h_get_all_actors,
            "report_actor_failure": self.h_report_actor_failure,
            "kill_actor": self.h_kill_actor,
            "subscribe": self.h_subscribe,
            "publish": self.h_publish,
            "create_placement_group": self.h_create_placement_group,
            "remove_placement_group": self.h_remove_placement_group,
            "get_placement_group": self.h_get_placement_group,
            "get_all_placement_groups": self.h_get_all_placement_groups,
            "add_task_events": self.h_add_task_events,
            "report_metrics": self.h_report_metrics,
            "get_metrics": self.h_get_metrics,
            "drop_worker_metrics": self.h_drop_worker_metrics,
            "query_metrics": self.h_query_metrics,
            "list_metric_series": self.h_list_metric_series,
            "dump_metric_series": self.h_dump_metric_series,
            "list_task_events": self.h_list_task_events,
            "update_object_ledger": self.h_update_object_ledger,
            "list_object_ledger": self.h_list_object_ledger,
            "ledger_sweep": self.h_ledger_sweep,
            "ledger_stats": self.h_ledger_stats,
            "publish_prefix_summary": self.h_publish_prefix_summary,
            "get_prefix_summaries": self.h_get_prefix_summaries,
            "set_tenant_quota": self.h_set_tenant_quota,
            "get_tenant_quotas": self.h_get_tenant_quotas,
            "quota_lease_acquire": self.h_quota_lease_acquire,
            "quota_lease_renew": self.h_quota_lease_renew,
            "quota_lease_release": self.h_quota_lease_release,
            "quota_lease_revoke": self.h_quota_lease_revoke,
            "quota_lease_status": self.h_quota_lease_status,
            "launch_phase": self.h_launch_phase,
            "control_plane_stats": self.h_control_plane_stats,
            "ping": lambda conn: "pong",
        }
        handlers = self.obs.wrap_handlers(handlers)
        self.server = rpc.Server(handlers, name="gcs")
        self.server.on_disconnect = self._on_disconnect
        self._load_snapshot()
        self._replay_wal()
        self.address = await self.server.listen_tcp("0.0.0.0", self.port)
        if self.store_client is not None:
            # discovery channel: raylets that lose the GCS re-read this
            # before reconnecting, so a restart on a new port/host heals
            # the cluster (reference: raylets re-resolve the GCS address
            # from Redis under GCS-FT)
            try:
                self.store_client.write_address(self.address)
            except Exception:
                logger.exception("address publish failed")
        # restart path: snapshot-restored actors that never reached ALIVE
        # must be (re)scheduled — the client's retried create_actor hits
        # the idempotent early-return and will wait forever otherwise
        # (reference: gcs_actor_manager.cc reconstruct-on-restart)
        for aid, row in self.actors.items():
            if row["state"] in (PENDING_CREATION, RESTARTING,
                                DEPENDENCIES_UNREADY):
                asyncio.ensure_future(self._schedule_actor(aid, delay=1.0))
        self._death_checker = asyncio.ensure_future(self._check_node_deaths())
        if cfg.ledger_sweep_interval_s > 0:
            self._ledger_sweeper = asyncio.ensure_future(
                self._ledger_sweep_loop())
        self._snapshot_task = None
        if self.persist_path:
            self._snapshot_task = asyncio.ensure_future(self._snapshot_loop())
        if cfg.gcs_obs_interval_s > 0:
            self._obs_task = asyncio.ensure_future(self._obs_loop())
        logger.info("GCS listening at %s", self.address)
        return self.address

    # ------------------------------------------------------- persistence
    # File-backed snapshot instead of the reference's Redis store client
    # (reference: RedisStoreClient redis_store_client.h:106, gcs_init_data
    # rebuild on restart). Nodes re-register via their heartbeat reconnect
    # path; KV / jobs / named actors / PGs / actor specs survive.
    def _snapshot_state(self) -> Dict:
        return {
            "kv": {ns: list(t.items()) for ns, t in self.kv.items()},
            "jobs": self.jobs,
            "next_job_id": self._next_job_id,
            "named_actors": [[ns, name, aid] for (ns, name), aid
                             in self.named_actors.items()],
            "actors": {aid: dict(row) for aid, row in self.actors.items()},
            "placement_groups": self.placement_groups,
            "tenant_quotas": self.tenant_quotas,
        }

    def _save_snapshot(self):
        if self.store_client is None:
            return
        import msgpack
        # msgpack, not json: actor specs and KV entries embed raw bytes
        # (function-table ids, pickled args) that json would stringify
        self.store_client.save_snapshot(
            msgpack.packb(self._snapshot_state(), use_bin_type=True))
        # the snapshot covers everything the WAL recorded: start it fresh
        self._wal_actors.clear()
        self.store_client.wal_reset()

    def _log_op(self, op: str, data: Dict):
        """Append one mutation to the write-ahead log. Closes the
        durability window between periodic snapshots: a GCS that dies
        right after registering an actor/PG/KV entry replays it on
        restart (reference: every mutation goes through the Redis store
        client synchronously, redis_store_client.h:106).

        Durability grade: the file store flush()es by default — survives
        a process kill, NOT a host crash (cfg.gcs_wal_fsync upgrades
        that); external URI stores are snapshot-interval only (see
        ExternalStoreClient)."""
        if self.store_client is None or not self.store_client.wal_enabled:
            return
        import msgpack
        try:
            self.store_client.wal_append(
                msgpack.packb([op, data], use_bin_type=True))
        except Exception:
            logger.exception("WAL append failed")

    def _replay_wal(self):
        import msgpack
        if self.store_client is None:
            return
        n = 0
        try:
            for rec in self.store_client.wal_records():
                op, data = msgpack.unpackb(rec, raw=False,
                                           strict_map_key=False)
                self._apply_op(op, data)
                n += 1
        except Exception:
            logger.exception("WAL replay failed at record %d", n)
        if n:
            logger.info("replayed %d WAL records", n)

    def _apply_op(self, op: str, d: Dict):
        if op == "kv_put":
            self.kv.setdefault(d["ns"], {})[d["key"]] = d["value"]
        elif op == "kv_del":
            self.kv.get(d["ns"], {}).pop(d["key"], None)
        elif op == "actor":
            self.actors[d["aid"]] = d["row"]
        elif op == "actor_delta":
            # spec-less transition record; ignore if the full row never
            # made it (snapshot already covers it then)
            if d["aid"] in self.actors:
                self.actors[d["aid"]].update(d["delta"])
        elif op == "named_actor":
            self.named_actors[(d["ns"], d["name"])] = d["aid"]
        elif op == "job":
            self.jobs[int(d["job_id"])] = d["row"]
            self._next_job_id = max(self._next_job_id, int(d["job_id"]) + 1)
        elif op == "pg":
            self.placement_groups[d["pg_id"]] = d["row"]

    def _load_snapshot(self):
        import msgpack
        if self.store_client is None:
            return
        try:
            raw = self.store_client.load_snapshot()
            if raw is None:
                return
            snap = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        except Exception:
            logger.exception("snapshot load failed; starting fresh")
            return
        for ns, pairs in snap.get("kv", {}).items():
            self.kv[ns] = {k: v for k, v in pairs}
        self.jobs = {int(k): v for k, v in snap.get("jobs", {}).items()}
        self._next_job_id = snap.get("next_job_id", 1)
        for ns, name, aid in snap.get("named_actors", []):
            self.named_actors[(ns, name)] = aid
        self.actors.update(snap.get("actors", {}))
        self.placement_groups.update(snap.get("placement_groups", {}))
        self.tenant_quotas.update(snap.get("tenant_quotas", {}))
        logger.info("restored GCS snapshot from %s (%d kv namespaces, "
                    "%d actors)", self.persist_path, len(self.kv),
                    len(self.actors))

    async def _snapshot_loop(self):
        while True:
            await asyncio.sleep(cfg.gcs_snapshot_interval_s)
            try:
                self._save_snapshot()
            except Exception:
                logger.exception("snapshot save failed")

    async def _obs_loop(self):
        """Self-ingest the control plane's own metrics (same pattern as
        the ledger sweep's gauges): the GCS is its own metrics agent,
        pushing as worker 'gcs' with no pusher thread."""
        while True:
            await asyncio.sleep(cfg.gcs_obs_interval_s)
            try:
                self.obs.refresh_config()
                self.h_report_metrics(None, "gcs", self.obs.metric_rows())
            except Exception:
                logger.exception("gcs self-metrics export failed")

    async def stop(self):
        if self._death_checker:
            self._death_checker.cancel()
        if self._ledger_sweeper:
            self._ledger_sweeper.cancel()
        if self._obs_task:
            self._obs_task.cancel()
            self._obs_task = None
        if getattr(self, "_snapshot_task", None):
            self._snapshot_task.cancel()
            self._snapshot_task = None
            try:
                self._save_snapshot()   # final flush of acknowledged state
            except Exception:
                logger.exception("final snapshot failed")
        await self.server.close()

    def _on_disconnect(self, conn: rpc.Connection):
        for subs in self.subscribers.values():
            subs.discard(conn)
        node_id = conn.peer_info.get("node_id")
        if node_id and self.node_conns.get(node_id) is conn:
            # grace: let heartbeat timeout decide (node manager may reconnect)
            info = self.nodes.get(node_id)
            if info is not None:
                info["last_heartbeat"] = min(
                    info["last_heartbeat"],
                    time.monotonic() - cfg.node_death_timeout_s / 2)

    # ------------------------------------------------------------------- kv
    def h_kv_put(self, conn, ns: str, key: bytes, value: bytes,
                 overwrite: bool = True):
        table = self.kv.setdefault(ns, {})
        if not overwrite and key in table:
            return False
        table[key] = value
        self._log_op("kv_put", {"ns": ns, "key": key, "value": value})
        return True

    def h_kv_get(self, conn, ns: str, key: bytes):
        return self.kv.get(ns, {}).get(key)

    def h_kv_del(self, conn, ns: str, key: bytes):
        existed = self.kv.get(ns, {}).pop(key, None) is not None
        if existed:
            self._log_op("kv_del", {"ns": ns, "key": key})
        return existed

    def h_kv_exists(self, conn, ns: str, key: bytes):
        return key in self.kv.get(ns, {})

    def h_kv_keys(self, conn, ns: str, prefix: bytes = b""):
        return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]

    # ---------------------------------------------------------------- nodes
    def h_register_node(self, conn, node_id: str, address: str,
                        object_store_address: str, resources: Dict[str, float],
                        labels: Dict[str, str], node_ip: str,
                        data_plane_address: Optional[str] = None):
        conn.peer_info["node_id"] = node_id
        self.node_conns[node_id] = conn
        self.nodes[node_id] = {
            "node_id": node_id,
            "address": address,
            "object_store_address": object_store_address,
            # raw-stream socket for bulk object chunks; None for nodes
            # that predate (or disabled) the binary data plane — peers
            # then fall back to msgpack chunks on `address`
            "data_plane_address": data_plane_address,
            "node_ip": node_ip,
            "total": dict(resources),
            "available": dict(resources),
            "labels": labels,
            "alive": True,
            "draining": False,
            "last_heartbeat": time.monotonic(),
            "start_time": time.time(),
        }
        self._touch_node(node_id)
        logger.info("node %s registered at %s (%s)", node_id[:12], address, resources)
        self._publish("NODE", node_id, {"state": "ALIVE", **_node_public(self.nodes[node_id])})
        # gcs_ts lets the registering node measure its wall-clock offset
        # vs the GCS (local - gcs, half-RTT error bound) — the black box
        # records it so cross-node stitches can de-skew
        return {"node_id": node_id, "cluster_view": self._cluster_view(),
                "view_version": self._view_version,
                "system_config": cfg.snapshot(),
                "gcs_ts": time.time()}

    def h_heartbeat(self, conn, node_id: str,
                    available: Optional[Dict[str, float]] = None,
                    total: Optional[Dict[str, float]] = None,
                    pending: Optional[List[Dict[str, float]]] = None):
        """available=None is a liveness-only beat: the node's resource view
        is unchanged since its last report, so the payload stays constant
        size under idle (reference: versioned delta gossip instead of full
        resource broadcast, src/ray/common/ray_syncer/ray_syncer.h:88)."""
        info = self.nodes.get(node_id)
        if info is None or not info["alive"]:
            return {"ok": False, "reason": "unknown or dead node"}
        now = time.monotonic()
        # the longest silence the death check has seen from this node
        info["max_heartbeat_gap_s"] = max(
            info.get("max_heartbeat_gap_s", 0.0),
            now - info["last_heartbeat"])
        info["last_heartbeat"] = now
        changed = False
        if available is not None and available != info["available"]:
            info["available"] = available
            changed = True
        if pending is not None and pending != info.get("pending_demand", []):
            info["pending_demand"] = pending
            changed = True
        if total is not None and total != info["total"]:
            info["total"] = total
            changed = True
        if changed:
            self._touch_node(node_id)
        return {"ok": True}

    def h_drain_node(self, conn, node_id: str):
        info = self.nodes.get(node_id)
        if info:
            info["draining"] = True
            self._touch_node(node_id)
        return True

    def h_get_all_nodes(self, conn):
        return [dict(_node_public(n), max_heartbeat_gap_s=n.get(
            "max_heartbeat_gap_s", 0.0)) for n in self.nodes.values()]

    def h_get_cluster_view(self, conn):
        return self._cluster_view()

    def _touch_node(self, node_id: str):
        self._view_version += 1
        info = self.nodes.get(node_id)
        if info is not None:
            info["_ver"] = self._view_version

    def h_get_cluster_view_delta(self, conn, since: Optional[int] = None):
        """Versioned view sync (reference: RaySyncer, ray_syncer.h:88).
        since=None -> full view; otherwise only nodes whose state changed
        after `since`. Payload is empty when nothing changed."""
        if since is None:
            return {"version": self._view_version,
                    "full": self._cluster_view()}
        # build entries only for changed nodes: with N pollers at steady
        # state this handler must be O(changes), not O(nodes)
        delta = {nid: _node_view(n) for nid, n in self.nodes.items()
                 if n.get("_ver", 0) > since}
        return {"version": self._view_version, "delta": delta}

    def _cluster_view(self) -> Dict[str, Dict]:
        return {nid: _node_view(n) for nid, n in self.nodes.items()}

    async def _check_node_deaths(self):
        last = time.monotonic()
        while True:
            await asyncio.sleep(cfg.health_check_interval_s)
            now = time.monotonic()
            late = now - last - cfg.health_check_interval_s
            last = now
            if late > cfg.health_check_interval_s:
                # this loop was held: the heartbeats sent meanwhile are
                # still unread, so the silence is the GCS's own. Judge
                # on the next round, after they are read.
                continue
            for node_id, info in list(self.nodes.items()):
                if info["alive"] and now - info["last_heartbeat"] > cfg.node_death_timeout_s:
                    await self._mark_node_dead(node_id, "heartbeat timeout")

    async def _mark_node_dead(self, node_id: str, reason: str):
        info = self.nodes.get(node_id)
        if info is None or not info["alive"]:
            return
        info["alive"] = False
        self._touch_node(node_id)
        logger.warning("node %s dead: %s", node_id[:12], reason)
        self.node_conns.pop(node_id, None)
        self._drop_node_metrics(node_id)
        self._publish("NODE", node_id, {"state": "DEAD", "reason": reason,
                                        **_node_public(info)})
        # fail/restart actors that lived there
        for actor_id, row in list(self.actors.items()):
            if row.get("node_id") == node_id and row["state"] in (ALIVE, PENDING_CREATION):
                await self._handle_actor_failure(
                    actor_id, f"node {node_id[:12]} died: {reason}")

    # ----------------------------------------------------------------- jobs
    def h_register_job(self, conn, driver_address: str, metadata: Dict):
        job_id = self._next_job_id
        self._next_job_id += 1
        self.jobs[job_id] = {"job_id": job_id, "driver_address": driver_address,
                             "metadata": metadata, "start_time": time.time(),
                             "finished": False}
        self._log_op("job", {"job_id": job_id, "row": self.jobs[job_id]})
        return job_id

    def h_finish_job(self, conn, job_id: int):
        job = self.jobs.get(job_id)
        if job:
            job["finished"] = True
            job["end_time"] = time.time()
            self._log_op("job", {"job_id": job_id, "row": job})
        self._publish("JOB", str(job_id), {"state": "FINISHED"})
        return True

    def h_get_all_jobs(self, conn):
        return list(self.jobs.values())

    # --------------------------------------------------------------- actors
    async def h_create_actor(self, conn, spec: Dict):
        """Register + schedule an actor. spec: actor_id, job_id, name,
        namespace, resources, max_restarts, scheduling (strategy dict),
        owner_address, definition (bytes key into KV function table),
        init_args (serialized), options."""
        actor_id = spec["actor_id"]
        # idempotent on actor_id: clients retry through GCS reconnects, and
        # a retried registration (reply lost, or the actor was already in
        # the restart snapshot) must not double-schedule or trip the
        # named-actor check (reference: GcsActorManager dedupes
        # RegisterActor on actor id, gcs_actor_manager.cc)
        if actor_id in self.actors and self.actors[actor_id]["state"] != DEAD:
            return True
        name = spec.get("name")
        ns = spec.get("namespace", "default")
        if name:
            existing = self.named_actors.get((ns, name))
            if (existing is not None and existing != actor_id
                    and self.actors[existing]["state"] != DEAD):
                raise ValueError(f"actor name {name!r} already taken in namespace {ns!r}")
            self.named_actors[(ns, name)] = actor_id
            self._log_op("named_actor", {"ns": ns, "name": name,
                                         "aid": actor_id})
        row = {
            "actor_id": actor_id, "spec": spec, "state": PENDING_CREATION,
            "name": name, "namespace": ns, "node_id": None, "address": None,
            "restarts_remaining": spec.get("max_restarts", 0),
            "death_cause": None, "num_restarts": 0,
        }
        self.actors[actor_id] = row
        asyncio.ensure_future(self._schedule_actor(actor_id))
        return True

    # ------------------------------------------------- launch attribution
    # One actor.launch root span per launch, decomposed phase-by-phase:
    # the GCS owns placement; the node manager and worker record their
    # phases (resource_wait / worker_obtain / become_actor /
    # callable_init) as children under the trace ctx forwarded with the
    # create_actor call. The in-flight table feeds `ray_tpu_torch status`.
    def _launch_begin(self, actor_id: str, spec: Dict) -> Optional[Dict]:
        if not cfg.launch_trace_enabled:
            return None
        ent = self.launches.get(actor_id)
        if ent is None:
            from ray_tpu_torch._private import events as _events
            now = time.time()
            ent = self.launches[actor_id] = {
                "actor_id": actor_id,
                "name": (spec.get("name")
                         or spec.get("class_name") or "actor"),
                "trace_id": _events.new_trace_id(),
                "root_span_id": _events.new_span_id(),
                "started": now, "phase": "placement", "phase_ts": now,
                "retries": 0, "node_id": None,
            }
        return ent

    def _launch_phase(self, ent: Optional[Dict], phase: str,
                      ts: Optional[float] = None):
        if ent is not None:
            ent["phase"] = phase
            ent["phase_ts"] = time.time() if ts is None else ts

    def _launch_span_row(self, ent: Dict, name: str, start: float,
                         end: float, parent: Optional[str],
                         **attrs) -> None:
        """One launch-phase span row straight into this GCS's own
        task-event ring (category 'launch' -> its own timeline track)."""
        from ray_tpu_torch._private import events as _events
        span_id = _events.new_span_id()
        self.h_add_task_events(None, [{
            "task_id": span_id, "kind": "runtime_event",
            "type": "RUNTIME_EVENT", "event_kind": "span",
            "name": name, "category": "launch",
            "trace_id": ent["trace_id"], "span_id": span_id,
            "parent_span_id": parent, "node_id": ent.get("node_id"),
            "worker_id": "gcs",
            "attrs": {"actor_id": ent["actor_id"],
                      "actor": ent["name"], **attrs},
            "state": "RUNNING", "ts": start,
        }, {"task_id": span_id, "state": "FINISHED", "ts": end}])

    def _launch_finish(self, actor_id: str, ok: bool,
                       error: Optional[str] = None):
        ent = self.launches.pop(actor_id, None)
        if ent is None:
            return
        now = time.time()
        total_ms = (now - ent["started"]) * 1e3
        # the root span row reuses the pre-minted root_span_id so the
        # children recorded remotely already parent under it
        from ray_tpu_torch._private import events as _events  # noqa: F401
        self.h_add_task_events(None, [{
            "task_id": ent["root_span_id"], "kind": "runtime_event",
            "type": "RUNTIME_EVENT", "event_kind": "span",
            "name": "actor.launch", "category": "launch",
            "trace_id": ent["trace_id"], "span_id": ent["root_span_id"],
            "parent_span_id": None, "node_id": ent.get("node_id"),
            "worker_id": "gcs",
            "attrs": {"actor_id": actor_id, "actor": ent["name"],
                      "ok": ok, "retries": ent["retries"],
                      "total_ms": round(total_ms, 3),
                      **({"error": error} if error else {})},
            "state": "RUNNING", "ts": ent["started"],
        }, {"task_id": ent["root_span_id"],
            "state": "FINISHED" if ok else "FAILED", "ts": now}])
        self._launch_done.append({
            "actor_id": actor_id, "actor": ent["name"], "ok": ok,
            "total_ms": round(total_ms, 3), "finished": now})
        del self._launch_done[:-100]

    async def h_launch_phase(self, conn, actor_id: str, phase: str,
                             ts: Optional[float] = None,
                             node_id: Optional[str] = None):
        """Node managers report phase transitions of an in-flight launch
        (resource_wait / worker_obtain / become_actor) so the status
        pane shows WHERE a slow launch currently sits."""
        ent = self.launches.get(actor_id)
        if ent is not None:
            self._launch_phase(ent, phase, ts)
            if node_id:
                ent["node_id"] = node_id
        return True

    def h_control_plane_stats(self, conn, top_n: int = 3):
        """One-call snapshot for the `ray_tpu_torch status` control-plane
        pane: hottest handlers by p99, pubsub backlog, in-flight
        launches with their current phase, black boxes on disk."""
        now = time.time()
        inflight = [{"actor_id": e["actor_id"][:12], "actor": e["name"],
                     "phase": e["phase"],
                     "phase_age_s": round(now - e["phase_ts"], 3),
                     "age_s": round(now - e["started"], 3),
                     "node_id": (e.get("node_id") or "")[:12]}
                    for e in self.launches.values()]
        inflight.sort(key=lambda e: -e["age_s"])
        done = self._launch_done[-20:]
        from ray_tpu_torch._private import blackbox as _bb
        return {
            "handlers": self.obs.top_handlers(top_n),
            "rpc_inflight": self.obs.inflight_total,
            "pubsub": {"backlog": self.obs.pubsub_pending,
                       "delivered": self.obs.pubsub_delivered,
                       "failed": self.obs.pubsub_failed},
            "launches": inflight,
            "launches_done": len(self._launch_done),
            "recent_launch_ms": [d["total_ms"] for d in done],
            "blackboxes": _bb.count_boxes(self._blackbox_dir()),
        }

    def _blackbox_dir(self) -> str:
        return (cfg.blackbox_dir
                or runtime_dir(self.session_name, "blackbox"))

    async def _schedule_actor(self, actor_id: str, delay: float = 0.0):
        if delay:
            await asyncio.sleep(delay)
        row = self.actors.get(actor_id)
        if row is None or row["state"] == DEAD:
            return
        spec = row["spec"]
        launch = self._launch_begin(actor_id, spec)
        attempt_t0 = time.time()
        req = dict(spec.get("resources") or {})
        sched = spec.get("scheduling") or {}
        pg_id = sched.get("placement_group_id")
        target = None
        if pg_id:
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg["state"] != "CREATED":
                row["state"] = DEAD
                row["death_cause"] = f"placement group {pg_id} not ready"
                self._persist_actor(actor_id)
                self._publish("ACTOR", actor_id, _actor_public(row))
                self._launch_finish(actor_id, ok=False,
                                    error="placement group not ready")
                return
            idx = sched.get("placement_group_bundle_index", 0)
            if idx < 0:
                idx = 0
            target = pg["node_ids"][idx]
        else:
            alive = {nid: n for nid, n in self.nodes.items() if n["alive"]
                     and not n["draining"]}
            target = scheduling.pick_node(
                alive, req, strategy=sched.get("strategy", "DEFAULT"),
                strategy_args=sched)
        if target is None:
            # infeasible right now: retry until resources appear
            if launch is not None:
                launch["retries"] += 1
            asyncio.ensure_future(self._schedule_actor(actor_id, delay=0.5))
            return
        node_conn = self.node_conns.get(target)
        if node_conn is None or node_conn.closed:
            if launch is not None:
                launch["retries"] += 1
            asyncio.ensure_future(self._schedule_actor(actor_id, delay=0.2))
            return
        launch_trace = None
        if launch is not None:
            launch["node_id"] = target
            self._launch_span_row(
                launch, "launch.placement", attempt_t0, time.time(),
                launch["root_span_id"], node=target[:12],
                strategy=sched.get("strategy", "DEFAULT"),
                pg=bool(pg_id))
            self._launch_phase(launch, "node_create")
            launch_trace = {"trace_id": launch["trace_id"],
                            "parent_span_id": launch["root_span_id"],
                            "actor_id": actor_id}
        try:
            result = await node_conn.call("create_actor", spec=spec,
                                          pg_id=pg_id,
                                          bundle_index=sched.get(
                                              "placement_group_bundle_index", 0),
                                          launch_trace=launch_trace)
        except (rpc.RpcError, rpc.ConnectionLost) as e:
            logger.warning("actor %s creation on %s failed: %s",
                           actor_id[:12], target[:12], e)
            await self._handle_actor_failure(actor_id,
                                             f"creation failed: {e}",
                                             from_scheduler=True)
            return
        row = self.actors.get(actor_id)
        if row is None or row["state"] == DEAD:
            # killed while it was being created: its worker exists now and
            # holds the actor's resources, so it goes too
            try:
                await node_conn.call("kill_worker",
                                     worker_id=result["worker_id"],
                                     reason="actor killed during creation")
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
            return
        row["state"] = ALIVE
        row["node_id"] = target
        row["address"] = result["worker_address"]
        row["worker_id"] = result["worker_id"]
        self._persist_actor(actor_id)
        self._publish("ACTOR", actor_id, _actor_public(row))
        self._launch_finish(actor_id, ok=True)

    async def _handle_actor_failure(self, actor_id: str, reason: str,
                                    from_scheduler: bool = False):
        row = self.actors.get(actor_id)
        if row is None or row["state"] == DEAD:
            return
        if row["state"] == RESTARTING and not from_scheduler:
            # a restart is already scheduled (kill/death race); the
            # scheduler's own failure reports must pass through or a
            # failed re-creation would strand the actor in RESTARTING
            return
        if row["restarts_remaining"] != 0:
            if row["restarts_remaining"] > 0:
                row["restarts_remaining"] -= 1
            row["num_restarts"] += 1
            row["state"] = RESTARTING
            row["address"] = None
            row["node_id"] = None
            self._persist_actor(actor_id)
            self._publish("ACTOR", actor_id, _actor_public(row))
            asyncio.ensure_future(self._schedule_actor(actor_id))
        else:
            row["state"] = DEAD
            row["death_cause"] = reason
            self._persist_actor(actor_id)
            self._publish("ACTOR", actor_id, _actor_public(row))
            self._launch_finish(actor_id, ok=False, error=reason)

    def h_get_actor_info(self, conn, actor_id: str):
        row = self.actors.get(actor_id)
        return _actor_public(row) if row else None

    def h_get_named_actor(self, conn, name: str, namespace: str = "default"):
        actor_id = self.named_actors.get((namespace, name))
        if actor_id is None:
            return None
        row = self.actors[actor_id]
        if row["state"] == DEAD:
            return None
        return _actor_public(row)

    def h_list_named_actors(self, conn, namespace: Optional[str] = None):
        out = []
        for (ns, name), aid in self.named_actors.items():
            if namespace is not None and ns != namespace:
                continue
            if self.actors.get(aid, {}).get("state") != DEAD:
                out.append({"name": name, "namespace": ns, "actor_id": aid})
        return out

    def h_get_all_actors(self, conn):
        return [_actor_public(r) for r in self.actors.values()]

    async def h_report_actor_failure(self, conn, actor_id: str,
                                     reason: str,
                                     worker_id: Optional[str] = None):
        row = self.actors.get(actor_id)
        if (row is not None and worker_id is not None
                and row.get("worker_id") not in (None, worker_id)):
            # stale report about a PREVIOUS incarnation's worker (e.g. the
            # kill_worker death race): the current instance is healthy
            return True
        await self._handle_actor_failure(actor_id, reason)
        return True

    async def h_kill_actor(self, conn, actor_id: str, no_restart: bool = True):
        """no_restart=False kills the running instance but lets the
        normal restart path bring it back if max_restarts remain
        (reference: ray.kill(no_restart=False) semantics,
        gcs_actor_manager.cc DestroyActor vs RestartActor)."""
        row = self.actors.get(actor_id)
        if row is None:
            return False
        node_conn = self.node_conns.get(row.get("node_id"))
        if no_restart or row["restarts_remaining"] == 0:
            row["restarts_remaining"] = 0
            row["state"] = DEAD
            row["death_cause"] = "ray_tpu_torch.kill"
            if row.get("name"):
                self.named_actors.pop((row["namespace"], row["name"]), None)
            self._persist_actor(actor_id)
            self._publish("ACTOR", actor_id, _actor_public(row))
            self._launch_finish(actor_id, ok=False, error="killed")
        if node_conn is not None and not node_conn.closed:
            try:
                await node_conn.call("kill_worker", worker_id=row.get("worker_id"),
                                     reason="actor killed")
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        # no_restart=False: the worker's death report (incarnation-aware)
        # drives the restart; restarting here directly would double-
        # schedule a PENDING_CREATION actor or one whose kill RPC failed
        return True

    # ---------------------------------------------------------- task events
    def h_add_task_events(self, conn, events: List[Dict]):
        for ev in events:
            tid = ev["task_id"]
            row = self.task_events.get(tid)
            if row is None:
                if len(self.task_events) >= self.max_task_events:
                    # drop oldest (dict preserves insertion order)
                    self.task_events.pop(next(iter(self.task_events)))
                row = self.task_events[tid] = {"task_id": tid,
                                               "state_times": {}}
            order = {"PENDING": 0, "RUNNING": 1, "FINISHED": 2, "FAILED": 2}
            for k, v in ev.items():
                if k == "state":
                    row["state_times"][v] = ev.get("ts", time.time())
                    # events from caller and executor arrive out of order;
                    # state only moves forward
                    if order.get(v, 0) >= order.get(row.get("state"), -1):
                        row["state"] = v
                elif k != "ts":
                    row[k] = v
        return True

    def h_list_task_events(self, conn, limit: int = 1000,
                           job_id: Optional[int] = None,
                           kind: Optional[str] = None,
                           category: Optional[str] = None):
        """kind=None returns everything (the unified timeline);
        kind="task" excludes runtime events; kind="runtime_event"
        returns only the flight recorder's rows, optionally filtered by
        subsystem category ("engine", "store", "data", "serve")."""
        out = []
        for row in reversed(list(self.task_events.values())):
            if job_id is not None and row.get("job_id") != job_id:
                continue
            row_kind = row.get("kind") or "task"
            if kind is not None and row_kind != kind:
                continue
            if category is not None and row.get("category") != category:
                continue
            out.append(row)
            if len(out) >= limit:
                break
        return out

    # -------------------------------------------------------- object ledger
    # Provenance table keyed by object id (reference: `ray memory` joins
    # the plasma store view with per-worker reference tables; the state
    # observability tables keep object rows in the GCS the same way).
    # Writers: worker put/free event deltas (ledger.py ring) and node-
    # manager arena censuses. The census is authoritative for the
    # location set — LRU eviction and crash repair emit no event.
    _LEDGER_ROW_DEFAULTS = {
        "owner": None, "owner_worker": None, "creator_worker": None,
        "creator_task": None, "size": 0, "meta_size": 0,
        "is_span": False, "stripe": None,
        "created_ts": None, "sealed_ts": None, "spilled_ts": None,
        "restored_ts": None, "evicted_ts": None, "freed_ts": None,
        "owner_refs": None, "leaked": False, "leak_ts": None,
        "last_seq": 0, "dropped": 0,
    }

    def _ledger_row(self, oid: str) -> Dict:
        led = self.object_ledger
        row = led.get(oid)
        if row is None:
            if len(led) >= cfg.ledger_max_entries:
                # retire a freed row if one sits near the front; else the
                # oldest row goes (bounded-ring discipline, task-event
                # sink style)
                victim = None
                for n, k in enumerate(led):
                    if led[k].get("freed_ts") is not None:
                        victim = k
                        break
                    if n >= 64:
                        break
                led.pop(victim if victim is not None else next(iter(led)))
            row = led[oid] = {"object_id": oid, "locations": {},
                              **self._LEDGER_ROW_DEFAULTS}
        return row

    def h_update_object_ledger(self, conn, records: Optional[List[Dict]] = None,
                               census: Optional[Dict] = None,
                               node_id: Optional[str] = None,
                               worker_id: Optional[str] = None):
        """Merge per-process lifecycle deltas and/or one node's arena
        census into the object_ledger table. Records apply in seq order
        per object (stale duplicates from a re-flushed batch are
        idempotent); the census reconciles presence + pins for
        `node_id`, including silent removals (LRU eviction)."""
        for rec in records or ():
            self._ledger_apply(rec, node_id, worker_id)
        if census is not None and node_id:
            self._ledger_census(census, node_id)
        return True

    def _ledger_apply(self, rec: Dict, node_id: Optional[str],
                      worker_id: Optional[str]):
        ev = rec.get("event")
        ts = rec.get("ts")
        if ts is None:     # 0.0 is a valid (test-pinned) timestamp
            ts = time.time()
        if ev == "worker_exit":
            wid = rec.get("worker_id") or worker_id
            if wid:
                self._ledger_exited.add(wid)
            return
        oid = rec.get("object_id")
        if not oid:
            return
        row = self._ledger_row(oid)
        row["last_seq"] = max(row["last_seq"], int(rec.get("seq") or 0))
        if rec.get("dropped"):
            row["dropped"] += int(rec["dropped"])
        node = rec.get("node_id") or node_id
        if ev == "created":
            row["size"] = int(rec.get("size") or row["size"])
            row["meta_size"] = int(rec.get("meta_size") or row["meta_size"])
            row["owner"] = rec.get("owner") or row["owner"]
            row["owner_worker"] = (rec.get("owner_worker") or worker_id
                                   or row["owner_worker"])
            row["creator_worker"] = (rec.get("owner_worker") or worker_id
                                     or row["creator_worker"])
            row["creator_task"] = rec.get("task_id") or row["creator_task"]
            if rec.get("is_span"):
                row["is_span"] = True
            row["created_ts"] = row["created_ts"] or ts
            if rec.get("sealed"):
                row["sealed_ts"] = row["sealed_ts"] or ts
            if node:
                row["locations"].setdefault(node, {"pins": 0, "since": ts})
        elif ev == "sealed":
            row["sealed_ts"] = row["sealed_ts"] or ts
        elif ev == "location_add":
            if node:
                row["locations"].setdefault(node, {"pins": 0, "since": ts})
        elif ev == "location_remove":
            if node:
                row["locations"].pop(node, None)
        elif ev == "spilled":
            row["spilled_ts"] = ts
            if node:
                row["locations"].pop(node, None)
                row.setdefault("spilled_on", [])
                if node not in row["spilled_on"]:
                    row["spilled_on"].append(node)
        elif ev == "restored":
            row["restored_ts"] = ts
            if node:
                row["locations"].setdefault(node, {"pins": 0, "since": ts})
                if node in row.get("spilled_on", ()):
                    row["spilled_on"].remove(node)
        elif ev == "evicted":
            row["evicted_ts"] = ts
            if node:
                row["locations"].pop(node, None)
        elif ev == "freed":
            row["freed_ts"] = ts
            row["leaked"] = False
            if node:
                row["locations"].pop(node, None)
        elif ev == "refs":
            row["owner_refs"] = rec.get("refs")

    def _ledger_census(self, census: Dict, node_id: str):
        now = time.time()
        present = census.get("objects") or {}
        for oid, info in present.items():
            row = self._ledger_row(oid)
            loc = row["locations"].setdefault(node_id, {"pins": 0,
                                                        "since": now})
            loc["pins"] = int(info.get("pins") or 0)
            if not row["size"]:
                row["size"] = int(info.get("size") or 0)
            if info.get("is_span"):
                row["is_span"] = True
            if row.get("stripe") is None and info.get("stripe") is not None:
                row["stripe"] = int(info["stripe"])
            if row["sealed_ts"] is None and info.get("sealed", True):
                # pre-ledger or foreign-writer object: census discovers
                # it; age then counts from first sighting, not creation
                row["sealed_ts"] = now - float(info.get("age_s") or 0.0)
        for oid, row in self.object_ledger.items():
            if node_id in row["locations"] and oid not in present:
                row["locations"].pop(node_id, None)
                if row["freed_ts"] is None and row["spilled_ts"] is None:
                    # silent removal: LRU eviction / crash repair
                    row["evicted_ts"] = now
        spilled = census.get("spilled") or ()
        for oid in spilled:
            row = self.object_ledger.get(oid)
            if row is not None:
                row.setdefault("spilled_on", [])
                if node_id not in row["spilled_on"]:
                    row["spilled_on"].append(node_id)

    def h_list_object_ledger(self, conn, limit: int = 1000,
                             node_id: Optional[str] = None,
                             leaked: Optional[bool] = None,
                             live_only: bool = False):
        """Dump provenance rows, newest-first. Filters: node_id (appears
        in the row's location set or spilled_on), leaked=True (flagged
        by the sweep), live_only (resident somewhere, not freed)."""
        out = []
        for row in reversed(list(self.object_ledger.values())):
            if node_id is not None and node_id not in row["locations"] \
                    and node_id not in row.get("spilled_on", ()):
                continue
            if leaked is not None and bool(row.get("leaked")) != leaked:
                continue
            if live_only and (row["freed_ts"] is not None
                              or not row["locations"]):
                continue
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def h_ledger_stats(self, conn):
        leaked = [r for r in self.object_ledger.values() if r.get("leaked")]
        return {"entries": len(self.object_ledger),
                "exited_workers": len(self._ledger_exited),
                "leaked_objects": len(leaked),
                "leaked_bytes": sum(
                    (r.get("size") or 0) * max(1, len(r["locations"]))
                    for r in leaked)}

    async def h_ledger_sweep(self, conn, now: Optional[float] = None):
        """One leak-detector pass: a sealed, resident object with zero
        pins whose owner exited (or reports zero references), older than
        cfg.ledger_leak_after_s, is flagged. Exports store_leaked_bytes /
        store_leaked_objects gauges, emits a `store.leak` runtime-event
        instant per newly flagged object, and sends the holding nodes an
        eviction hint their pressured-stripe sweep consumes first.
        `now` pins the clock for deterministic tests."""
        now = time.time() if now is None else now
        leak_after = cfg.ledger_leak_after_s
        leaked_bytes = 0
        leaked_count = 0
        newly: List[Dict] = []
        for row in self.object_ledger.values():
            if row["freed_ts"] is not None or not row["locations"]:
                row["leaked"] = False
                continue
            sealed = row["sealed_ts"]
            if sealed is None:
                continue   # unsealed orphans are gc_unsealed's problem
            if any(int(l.get("pins") or 0) > 0
                   for l in row["locations"].values()):
                row["leaked"] = False
                continue
            owner_gone = (row.get("owner_worker") in self._ledger_exited
                          if row.get("owner_worker") else False)
            if not owner_gone and row.get("owner_refs") != 0:
                continue
            if now - sealed < leak_after:
                continue
            nbytes = (row.get("size") or 0) * max(1, len(row["locations"]))
            leaked_bytes += nbytes
            leaked_count += 1
            if not row.get("leaked"):
                row["leaked"] = True
                row["leak_ts"] = now
                newly.append(row)
        try:
            from ray_tpu_torch.util.metrics import gauge_snapshot
            self.h_report_metrics(None, "gcs-ledger", [
                gauge_snapshot("store_leaked_bytes", float(leaked_bytes),
                               "bytes held by leaked objects (sealed, "
                               "ownerless, unpinned past "
                               "ledger_leak_after_s)"),
                gauge_snapshot("store_leaked_objects", float(leaked_count),
                               "objects currently flagged as leaked"),
            ], ts=now)
        except Exception:
            logger.exception("leak gauge export failed")
        hints: Dict[str, List[str]] = {}
        for row in newly:
            import os as _os
            self.h_add_task_events(None, [{
                "task_id": f"leak-{row['object_id'][:16]}-{int(now)}",
                "kind": "runtime_event", "event_kind": "instant",
                "type": "RUNTIME_EVENT", "name": "store.leak",
                "category": "store", "state": "RUNNING", "ts": now,
                "trace_id": _os.urandom(16).hex(),
                "span_id": _os.urandom(8).hex(), "parent_span_id": None,
                "node_id": next(iter(row["locations"]), None),
                "worker_id": "gcs-ledger",
                "attrs": {"object_id": row["object_id"],
                          "bytes": row.get("size") or 0,
                          "owner": row.get("owner"),
                          "owner_worker": row.get("owner_worker"),
                          "age_s": round(now - row["sealed_ts"], 3),
                          "nodes": list(row["locations"])}}])
            for node in row["locations"]:
                hints.setdefault(node, []).append(row["object_id"])
        for node, oids in hints.items():
            node_conn = self.node_conns.get(node)
            if node_conn is not None and not node_conn.closed:
                asyncio.ensure_future(
                    self._safe_evict_hint(node_conn, oids))
        return {"leaked_objects": leaked_count,
                "leaked_bytes": leaked_bytes,
                "newly_flagged": [r["object_id"] for r in newly]}

    async def _safe_evict_hint(self, conn, oids: List[str]):
        try:
            await conn.notify("ledger_evict_hint", oids=oids)
        except Exception:
            logger.debug("evict hint to node failed", exc_info=True)

    async def _ledger_sweep_loop(self):
        while True:
            await asyncio.sleep(cfg.ledger_sweep_interval_s)
            if not self.object_ledger:
                continue
            try:
                await self.h_ledger_sweep(None)
            except Exception:
                logger.exception("ledger sweep failed")

    # ------------------------------------------------- prefix summaries
    def h_publish_prefix_summary(self, conn, replica_id: str, fps: list,
                                 chunk: int, blocks: Optional[int] = None,
                                 deployment: Optional[str] = None):
        """One serving replica's trie summary (serve/disagg.py): top-K
        path fingerprints of its radix prefix cache. Last write wins per
        replica; rows expire at read time after cfg.prefix_summary_ttl_s
        so a dead replica stops attracting routes within one TTL. The
        table is bounded: past 1024 replicas the stalest rows retire."""
        if not replica_id:
            return False
        self.prefix_summaries[replica_id] = {
            "replica_id": replica_id,
            "fps": [int(f) for f in (fps or [])][:cfg.prefix_summary_top_k],
            "chunk": int(chunk), "blocks": blocks,
            "deployment": deployment, "ts": time.time()}
        if len(self.prefix_summaries) > 1024:
            for rid in sorted(self.prefix_summaries,
                              key=lambda r:
                              self.prefix_summaries[r]["ts"])[:64]:
                self.prefix_summaries.pop(rid, None)
        return True

    def h_get_prefix_summaries(self, conn, ids: Optional[list] = None,
                               deployment: Optional[str] = None):
        """Live (non-expired) summary rows, optionally filtered to the
        replica ids a router currently routes to. Expired rows are
        pruned here — publication is the only other write path."""
        now = time.time()
        ttl = cfg.prefix_summary_ttl_s
        for rid in [r for r, row in self.prefix_summaries.items()
                    if now - row["ts"] > ttl]:
            self.prefix_summaries.pop(rid, None)
        rows = list(self.prefix_summaries.values())
        if ids is not None:
            want = set(ids)
            rows = [r for r in rows if r["replica_id"] in want]
        if deployment:
            rows = [r for r in rows if r.get("deployment") == deployment]
        return rows

    # ------------------------------------------------- tenant quotas
    def h_set_tenant_quota(self, conn, tenant: str,
                           quota: Optional[int] = None,
                           weight: Optional[float] = None,
                           rate: Optional[float] = None,
                           burst: Optional[float] = None):
        """One tenant's fair-share admission row (serve/fleet.py):
        `quota` caps concurrent in-flight requests at the serve ingress
        (<= 0 = unlimited), `weight` sets the tenant's DRR share while
        queued, `rate` is the tenant's CLUSTER-WIDE admission rate
        (requests/s, <= 0 = unlimited) that the quota-lease layer splits
        across proxies, and `burst` the token-bucket depth backing that
        rate. Partial updates merge; the "__default__" tenant moves the
        fleet-wide defaults. Bounded at 4096 tenants (stalest rows
        retire — same discipline as prefix_summaries). A rate change
        bumps the lease epoch so every proxy re-splits within one renew
        interval."""
        if not tenant:
            return False
        row = self.tenant_quotas.setdefault(tenant, {"tenant": tenant})
        if quota is not None:
            row["quota"] = int(quota)
        if weight is not None:
            row["weight"] = float(weight)
        if rate is not None:
            row["rate"] = float(rate)
            self.quota_lease_epoch += 1
        if burst is not None:
            row["burst"] = float(burst)
            self.quota_lease_epoch += 1
        row["ts"] = time.time()
        if len(self.tenant_quotas) > 4096:
            for t in sorted(self.tenant_quotas,
                            key=lambda t: self.tenant_quotas[t]["ts"])[:64]:
                self.tenant_quotas.pop(t, None)
        return True

    def h_get_tenant_quotas(self, conn):
        return list(self.tenant_quotas.values())

    # ------------------------------------------------- quota leases
    # Shared tenant fair share across N ingress proxies (ROADMAP item
    # 2a): the GCS owns each tenant's cluster-wide token-bucket RATE
    # (tenant_quotas rows) and leases every proxy a share of it. The
    # epoch bumps on any membership or rate change, so a renew response
    # carrying a newer epoch tells the proxy to adopt the re-split
    # shares atomically. A REVOKED proxy's share is escrowed — held out
    # of the live split until the lease expires or re-acquires — so the
    # revoked proxy's conservative local admission (a fraction of its
    # old share, serve/fleet.py) can never combine with the survivors'
    # shares into cluster-wide over-admission.
    def _prune_quota_leases(self):
        now = time.time()
        ttl = cfg.quota_lease_ttl_s
        dead = [p for p, row in self.quota_leases.items()
                if now - row["ts"] > ttl]
        for p in dead:
            self.quota_leases.pop(p, None)
        if dead:
            self.quota_lease_epoch += 1

    def _quota_shares(self, proxy_id: str) -> Dict[str, Dict]:
        """This proxy's per-tenant bucket parameters under the current
        split: every live (non-revoked, non-expired) proxy gets an equal
        proportional share of each rated tenant's cluster rate; escrowed
        (revoked) proxies still count in the denominator."""
        n = max(1, len(self.quota_leases))
        shares = {}
        for t, row in self.tenant_quotas.items():
            rate = float(row.get("rate") or 0.0)
            if rate <= 0:
                continue
            burst = float(row.get("burst") or max(1.0, rate))
            shares[t] = {"rate": rate / n, "burst": max(1.0, burst / n),
                         "cluster_rate": rate}
        return shares

    def h_quota_lease_acquire(self, conn, proxy_id: str):
        """Join (or re-join after revocation) the proxy membership.
        Bumps the epoch — every other proxy picks up its smaller share
        at its next renew — and returns this proxy's split."""
        if not proxy_id:
            return None
        self._prune_quota_leases()
        row = self.quota_leases.get(proxy_id)
        if row is None or row.get("revoked"):
            self.quota_lease_epoch += 1
        self.quota_leases[proxy_id] = {
            "proxy_id": proxy_id, "ts": time.time(), "revoked": False}
        return {"epoch": self.quota_lease_epoch,
                "n_proxies": len(self.quota_leases),
                "shares": self._quota_shares(proxy_id),
                "quotas": list(self.tenant_quotas.values())}

    def h_quota_lease_renew(self, conn, proxy_id: str, epoch: int,
                            burn: Optional[Dict[str, int]] = None):
        """Heartbeat + burn-delta push on the metrics cadence. Burn
        deltas aggregate into per-tenant cluster totals (the edge bench
        and per-tenant SLO read them); a stale epoch gets the fresh
        split back; a revoked/unknown lease gets {revoked: True} so the
        proxy degrades to its conservative local quota and re-acquires."""
        self._prune_quota_leases()
        for t, n in (burn or {}).items():
            self.tenant_burn[t] = self.tenant_burn.get(t, 0) + int(n)
        row = self.quota_leases.get(proxy_id)
        if row is None or row.get("revoked"):
            return {"revoked": True, "epoch": self.quota_lease_epoch}
        row["ts"] = time.time()
        out = {"revoked": False, "epoch": self.quota_lease_epoch}
        if int(epoch) != self.quota_lease_epoch:
            out["shares"] = self._quota_shares(proxy_id)
            out["quotas"] = list(self.tenant_quotas.values())
        return out

    def h_quota_lease_release(self, conn, proxy_id: str):
        if self.quota_leases.pop(proxy_id, None) is not None:
            self.quota_lease_epoch += 1
        return True

    def h_quota_lease_revoke(self, conn, proxy_id: str):
        """Chaos/test hook (util/chaos.py QuotaLeaseRevoker): mark the
        lease revoked WITHOUT re-splitting its share — the share stays
        escrowed (the revoked proxy still counts in the split
        denominator) until the lease TTLs out or re-acquires, which is
        what makes conservative local admission provably safe."""
        row = self.quota_leases.get(proxy_id)
        if row is None:
            return False
        row["revoked"] = True
        self.quota_lease_epoch += 1
        return True

    def h_quota_lease_status(self, conn):
        self._prune_quota_leases()
        return {"epoch": self.quota_lease_epoch,
                "leases": [dict(r) for r in self.quota_leases.values()],
                "tenant_burn": dict(self.tenant_burn)}

    # --------------------------------------------------------------- pubsub
    def h_report_metrics(self, conn, worker_id: str, metrics: list,
                         node_id: Optional[str] = None,
                         ts: Optional[float] = None):
        """Per-process metric snapshots (reference: the per-node metrics
        agent collecting OpenCensus exports, metrics_agent.py:483).
        node_id tags the snapshot's host so a node death can retire it
        — a dead worker's gauges would otherwise sit in /metrics
        forever. Counters flushed by a CLEAN worker shutdown survive
        (the node is still alive then). Each push also feeds the
        time-series plane (ts overrides the sample timestamp — tests
        drive deterministic windows with it)."""
        if not hasattr(self, "metrics"):
            self.metrics = {}
            self.metrics_node: Dict[str, Optional[str]] = {}
        self.metrics[worker_id] = metrics
        self.metrics_node[worker_id] = node_id
        try:
            self.metrics_ts.ingest(worker_id, metrics, ts=ts)
        except Exception:
            logger.exception("metrics time-series ingest failed")
        return True

    def h_get_metrics(self, conn):
        return getattr(self, "metrics", {})

    def h_query_metrics(self, conn, name: str, window: float = 60.0,
                        agg: str = "avg",
                        tags: Optional[Dict[str, str]] = None,
                        threshold: Optional[float] = None,
                        now: Optional[float] = None):
        """Windowed aggregate over the time-series plane. agg: rate /
        sum / avg / max / min / latest, p50 / p90 / p95 / p99 /
        frac_over (histograms, reconstructed from bucket deltas),
        buckets (raw merged window), series (raw samples)."""
        return self.metrics_ts.query(name, window_s=window, agg=agg,
                                     tags=tags, threshold=threshold,
                                     now=now)

    def h_list_metric_series(self, conn):
        return self.metrics_ts.list_series()

    def h_dump_metric_series(self, conn, window: float = 600.0,
                             names: Optional[List[str]] = None,
                             kinds: Optional[List[str]] = None,
                             now: Optional[float] = None):
        return self.metrics_ts.dump_series(window_s=window, names=names,
                                           kinds=kinds, now=now)

    def _drop_node_metrics(self, node_id: str):
        node_of = getattr(self, "metrics_node", {})
        for wid in [w for w, n in node_of.items() if n == node_id]:
            getattr(self, "metrics", {}).pop(wid, None)
            node_of.pop(wid, None)
            self.metrics_ts.drop_worker(wid)
            # objects owned by this node's workers just lost their owner
            # — the ledger sweep treats them as leak candidates
            self._ledger_exited.add(wid)

    def h_drop_worker_metrics(self, conn, worker_id: str):
        """Node managers report crashed/killed workers here so their
        gauges don't sit in /metrics forever. Clean DRIVER shutdowns
        never route through this — their final counter flush persists.
        The worker's time-series HISTORY stays (it is history; retention
        ages it out) but its delta baselines go, so a reused worker id
        can't fake a counter reset."""
        getattr(self, "metrics", {}).pop(worker_id, None)
        getattr(self, "metrics_node", {}).pop(worker_id, None)
        self.metrics_ts.drop_worker(worker_id)
        # crashed/killed worker: its owned-table died with it, so its
        # sealed objects have zero owner references by definition
        self._ledger_exited.add(worker_id)
        return True

    def h_subscribe(self, conn, channel: str):
        self.subscribers.setdefault(channel, set()).add(conn)
        return True

    def h_publish(self, conn, channel: str, key: str, payload: Any):
        self._publish(channel, key, payload)
        return True

    def _persist_actor(self, actor_id: str):
        """Full row (incl. pickled spec) only on the first WAL record per
        actor per WAL generation; state transitions afterwards log a
        spec-less delta so churny actors can't balloon the WAL between
        snapshots."""
        row = self.actors.get(actor_id)
        if row is None:
            return
        if actor_id not in self._wal_actors:
            self._wal_actors.add(actor_id)
            self._log_op("actor", {"aid": actor_id, "row": row})
        else:
            delta = {k: v for k, v in row.items() if k != "spec"}
            self._log_op("actor_delta", {"aid": actor_id, "delta": delta})

    def _persist_pg(self, pg_id: str):
        row = self.placement_groups.get(pg_id)
        if row is not None:
            self._log_op("pg", {"pg_id": pg_id, "row": row})

    def _publish(self, channel: str, key: str, payload: Any):
        for sub in list(self.subscribers.get(channel, ())):
            if sub.closed:
                self.subscribers[channel].discard(sub)
                continue
            # t0 stamped at accept: deliver latency includes event-loop
            # queueing, which is the signal (a backed-up GCS loop shows
            # up here before anywhere else)
            asyncio.ensure_future(self._safe_notify(
                sub, channel, key, payload, self.obs.note_publish()))

    async def _safe_notify(self, conn, channel, key, payload, t0=None):
        try:
            await conn.notify("pubsub", channel=channel, key=key, payload=payload)
        except Exception:
            self.subscribers.get(channel, set()).discard(conn)
            if t0 is not None:
                self.obs.note_deliver(t0, ok=False)
            return
        if t0 is not None:
            self.obs.note_deliver(t0, ok=True)

    # ----------------------------------------------------- placement groups
    async def h_create_placement_group(self, conn, pg_id: str,
                                       bundles: List[Dict[str, float]],
                                       strategy: str = "PACK",
                                       name: str = ""):
        """Two-phase bundle reservation (reference:
        gcs_placement_group_scheduler Prepare/Commit)."""
        alive = {nid: n for nid, n in self.nodes.items()
                 if n["alive"] and not n["draining"]}
        placement = scheduling.schedule_bundles(alive, bundles, strategy)
        row = {"pg_id": pg_id, "bundles": bundles, "strategy": strategy,
               "name": name, "state": "PENDING", "node_ids": None}
        self.placement_groups[pg_id] = row
        self._persist_pg(pg_id)
        if placement is None:
            row["state"] = "PENDING"   # infeasible now; retried by caller wait
            return {"state": "PENDING"}
        # phase 1: prepare on every node
        prepared = []
        ok = True
        for idx, (nid, bundle) in enumerate(zip(placement, bundles)):
            node_conn = self.node_conns.get(nid)
            if node_conn is None or node_conn.closed:
                ok = False
                break
            try:
                good = await node_conn.call("prepare_bundle", pg_id=pg_id,
                                            bundle_index=idx, resources=bundle)
            except (rpc.RpcError, rpc.ConnectionLost):
                good = False
            if not good:
                ok = False
                break
            prepared.append((nid, idx))
        if not ok:
            for nid, idx in prepared:
                node_conn = self.node_conns.get(nid)
                if node_conn and not node_conn.closed:
                    try:
                        await node_conn.call("return_bundle", pg_id=pg_id,
                                             bundle_index=idx)
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
            return {"state": "PENDING"}
        # phase 2: commit
        for nid, idx in prepared:
            node_conn = self.node_conns.get(nid)
            try:
                await node_conn.call("commit_bundle", pg_id=pg_id, bundle_index=idx)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        row["state"] = "CREATED"
        row["node_ids"] = placement
        self._persist_pg(pg_id)
        self._publish("PG", pg_id, {"state": "CREATED", "node_ids": placement})
        return {"state": "CREATED", "node_ids": placement}

    async def h_remove_placement_group(self, conn, pg_id: str):
        row = self.placement_groups.get(pg_id)
        if row is None:
            return False
        if row.get("node_ids"):
            for idx, nid in enumerate(row["node_ids"]):
                node_conn = self.node_conns.get(nid)
                if node_conn and not node_conn.closed:
                    try:
                        await node_conn.call("return_bundle", pg_id=pg_id,
                                             bundle_index=idx)
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
        row["state"] = "REMOVED"
        self._publish("PG", pg_id, {"state": "REMOVED"})
        return True

    def h_get_placement_group(self, conn, pg_id: str):
        row = self.placement_groups.get(pg_id)
        if row is None:
            return None
        return {k: row[k] for k in ("pg_id", "bundles", "strategy", "name",
                                    "state", "node_ids")}

    def h_get_all_placement_groups(self, conn):
        return [self.h_get_placement_group(conn, pid)
                for pid in self.placement_groups]


def _node_view(n: Dict) -> Dict:
    """One node's entry in the cluster resource view."""
    return {"total": n["total"], "available": n["available"],
            "alive": n["alive"], "draining": n["draining"],
            "address": n["address"],
            "object_store_address": n["object_store_address"],
            "data_plane_address": n.get("data_plane_address"),
            "node_ip": n["node_ip"], "labels": n["labels"]}


def _node_public(n: Dict) -> Dict:
    out = {k: n[k] for k in ("node_id", "address", "object_store_address",
                             "node_ip", "total", "available", "labels",
                             "alive")}
    out["data_plane_address"] = n.get("data_plane_address")
    out["pending_demand"] = n.get("pending_demand", [])
    return out


def _actor_public(row: Dict) -> Dict:
    return {"actor_id": row["actor_id"], "state": row["state"],
            "name": row.get("name"), "namespace": row.get("namespace"),
            "node_id": row.get("node_id"), "address": row.get("address"),
            "death_cause": row.get("death_cause"),
            "num_restarts": row.get("num_restarts", 0),
            "method_names": (row.get("spec") or {}).get("method_names") or [],
            "resources": (row.get("spec") or {}).get("resources") or {}}


def main():
    import argparse
    import sys
    from ray_tpu_torch._private.proc_util import set_pdeathsig_from_env
    set_pdeathsig_from_env()
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--session-name", default="session")
    parser.add_argument("--persist-path", default=None)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[gcs] %(asctime)s %(levelname)s %(message)s")

    async def run():
        from ray_tpu_torch._private import loop_watch
        from ray_tpu_torch.util import sanitizers
        sanitizers.maybe_install()
        loop_watch.install("gcs")
        gcs = GcsServer(port=args.port, session_name=args.session_name,
                        persist_path=args.persist_path)
        addr = await gcs.start()
        # crash black box: continuous event/metrics mirror + seal on
        # SIGTERM / clean exit (SIGKILL leaves the continuous appends)
        from ray_tpu_torch._private import blackbox as _bb
        _bb.configure(gcs._blackbox_dir(), "gcs",
                      worker_id="gcs")
        import signal

        def _on_term(signum, frame):
            _bb.seal(f"signal_{signum}")
            raise SystemExit(0)

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            pass
        # announce the bound address on stdout for the supervisor
        print(f"GCS_ADDRESS={addr}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
