"""Node manager — the per-node daemon (raylet equivalent).

Re-design of the reference's raylet (reference: src/ray/raylet/node_manager.h:119,
worker_pool.h:174, local_task_manager.cc, object_manager/object_manager.h:117).
Owns the node's resource accounting, the worker pool, lease grants for task
execution, placement-group bundle reservations, and node-to-node object
transfer against the shared-memory arena (object_store.py). Differences:

- Scheduling is lease-granting only: callers push tasks directly to leased
  workers; the node manager never sees task payloads (the reference routes
  the lease the same way but also manages arg-dependency pulls — here the
  executing worker pulls its own args through this daemon's pull_object).
- Spillback is an explicit redirect reply carrying the chosen node's
  address (reference: spillback in local_task_manager.cc).
- Object transfer negotiates over control RPCs (request_push/push_begin)
  but chunk bytes move on a dedicated binary data plane — a second raw
  socket per node manager (data_plane.py) that streams pinned-arena
  memoryviews into recv_into() regions, striped across
  cfg.transfer_streams connections, with a msgpack-chunk fallback for
  peers that advertise no data plane. The store arena is mapped by every
  local process so serving bytes is a zero-copy read (reference: chunked
  gRPC Push/Pull distinct from control RPCs, pull_manager.h:52,
  push_manager.h:30).
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import ledger, rpc, scheduling
from ray_tpu_torch._private.config import cfg
from ray_tpu_torch._private.object_store import ObjectStoreClient, parallel_write
from ray_tpu_torch._private.proc_util import runtime_dir

logger = logging.getLogger(__name__)

# how long a copy restored from spill for a reader stays resident before
# the spill sweep may drop it again (the reader pins it when it reads it)
RESTORE_GRACE_S = 30.0

# tunables live in config.py (transfer_chunk_bytes, heartbeat_interval_s,
# view_refresh_s, lease_wait_timeout_s, ...)


class WorkerProc:
    __slots__ = ("worker_id", "address", "pid", "conn", "proc", "state",
                 "actor_id", "lease_id", "registered", "env_hash",
                 "gpu_mask", "idle_since")

    def __init__(self, proc=None):
        self.worker_id = None
        self.address = None
        self.pid = None
        self.conn: Optional[rpc.Connection] = None
        self.proc: Optional[subprocess.Popen] = proc
        self.state = "starting"        # starting | idle | leased | actor | dead
        self.actor_id: Optional[str] = None
        self.lease_id: Optional[str] = None
        self.registered = asyncio.Event()
        # runtime-env pool key: once a worker materializes a pip env it
        # serves ONLY that env (reference: per-env worker pools,
        # worker_pool.h:174)
        self.env_hash: Optional[str] = None
        # CUDA_VISIBLE_DEVICES the process was SPAWNED with (None: the
        # node manager's own). CUDA reads the variable once, at its
        # first use in a process, so a worker only ever serves the mask
        # it started with: a GPU task or actor gets a worker spawned
        # with its ids, and a worker that holds a mask never serves a
        # task with another (or none)
        self.gpu_mask: Optional[str] = None
        self.idle_since: float = 0.0


class NodeManager:
    def __init__(self, gcs_address: str, node_id: Optional[str] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 session_name: str = "session",
                 store_bytes: int = 0, port: int = 0,
                 store_path: Optional[str] = None,
                 gcs_address_source: Optional[str] = None):
        self.gcs_address = gcs_address
        # discovery channel for GCS-FT: a restarted GCS (possibly on a
        # new port/host) publishes its address through its store client;
        # the heartbeat reconnect path re-reads it (reference: raylets
        # re-resolve the GCS address from Redis)
        self.gcs_address_source = gcs_address_source
        self.node_id = node_id or os.urandom(16).hex()
        self.session_name = session_name
        self.labels = labels or {}
        self.port = port
        ncpu = os.cpu_count() or 1
        self.total = dict(resources or {})
        self.total.setdefault("CPU", float(ncpu))
        # auto-detect accelerators (GPUs) unless the caller pinned them
        # explicitly (tests use fake resources)
        explicit_gpu = "GPU" in self.total
        if not explicit_gpu:
            try:
                from ray_tpu_torch._private.accelerators import \
                    detect_node_accelerators
                for k, v in detect_node_accelerators().items():
                    self.total.setdefault(k, v)
            except Exception:
                logger.exception("accelerator detection failed")
        # GPU ids are the REAL ids (CUDA_VISIBLE_DEVICES-aware), not
        # range(n)
        try:
            from ray_tpu_torch._private.accelerators import detect_gpu_ids
            ids = detect_gpu_ids()
        except Exception:
            ids = []
        n = int(self.total.get("GPU", 0))
        if len(ids) != n:   # explicitly-configured (fake) GPU counts
            ids = [str(i) for i in range(n)]
        from ray_tpu_torch._private.accelerators import GpuIdPool
        self._gpus = GpuIdPool(ids)
        self.total.setdefault("memory", float(2 * 1024**3))
        self.total.setdefault("object_store_memory",
                              float(store_bytes or 512 * 1024**2))
        self.available = dict(self.total)
        self.store_path = store_path or \
            f"/dev/shm/raytpu_torch_{session_name}_{self.node_id[:12]}"
        self.store_bytes = int(store_bytes or self.total["object_store_memory"])

        self.gcs: Optional[rpc.Connection] = None
        self.server: Optional[rpc.Server] = None
        self.address: Optional[str] = None
        self.unix_address: Optional[str] = None
        self.store: Optional[ObjectStoreClient] = None
        self.pool = rpc.ConnectionPool(name=f"nm-{self.node_id[:8]}")
        # binary data plane (data_plane.py): second raw-stream socket for
        # bulk object chunks, advertised next to the RPC address
        self.data_plane_address: Optional[str] = None
        self._data_server = None
        self._data_client = None

        self.workers: Dict[str, WorkerProc] = {}
        self._idle: List[WorkerProc] = []
        self._spawning = 0
        self._lease_waiters: List[asyncio.Future] = []
        self._leases: Dict[str, Dict] = {}
        self._lease_seq = 0
        self.bundles: Dict[tuple, Dict] = {}   # (pg_id, idx) -> {resources, available, committed}
        self.cluster_view: Dict[str, Dict] = {}
        self._view_version: Optional[int] = None
        self._view_debits: Dict[str, List] = {}   # unconfirmed spill debits
        self._tasks: List[asyncio.Task] = []
        self._draining = False
        self._pulls_inflight: Dict[bytes, asyncio.Future] = {}
        self._pull_bytes_inflight = 0
        self._pull_waiters: "deque" = __import__("collections").deque()
        self._receiving: Dict[bytes, Dict] = {}
        self._recv_done: Dict[bytes, asyncio.Future] = {}
        # queued lease demand, reported in heartbeats for the autoscaler
        self._pending_demand: List[Dict[str, float]] = []
        self._spill_mutex = threading.Lock()
        # one restore at a time: a second reader of an object being
        # restored waits for its seal instead of finding it unsealed (or
        # failing its own create of the same id)
        self._restore_mutex = threading.Lock()
        # leaked objects the GCS ledger sweep told us to reclaim under
        # pressure (consumed first by the spill pass — deleting a leaked
        # object frees bytes without disk IO). Mutated from the owner
        # loop (hint handler) and read from the spill executor thread;
        # individual set ops are GIL-atomic and the hints are advisory.
        self._evict_hints: set = set()
        # pid -> [(path, stream_name, offset), ...] for the log monitor
        self._log_files: Dict[int, list] = {}
        # compiled-DAG channel mirrors this daemon writes into
        self._dag_channels: Dict[str, object] = {}
        # launch critical-path attribution: last-observed duration per
        # launch phase on this node (resource_wait / worker_obtain /
        # become_actor) -> runtime_launch_phase_ms{phase} gauges
        self._launch_phase_ms: Dict[str, float] = {}
        self._launches_total = 0
        self._clock_offset_s = 0.0   # local wall clock minus GCS clock
        # thread_checker.h analog: no-op unless RAY_TPU_TORCH_LOOP_SANITIZER
        from ray_tpu_torch.util.sanitizers import SingleLoopChecker
        self._loop_checker = SingleLoopChecker("NodeManager")

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> str:
        self.store = ObjectStoreClient(self.store_path, create=True,
                                       size=self.store_bytes,
                                       stripes=cfg.arena_stripes)
        handlers = {
            "register_worker": self.h_register_worker,
            "request_lease": self.h_request_lease,
            "return_lease": self.h_return_lease,
            "create_actor": self.h_create_actor,
            "kill_worker": self.h_kill_worker,
            "prepare_bundle": self.h_prepare_bundle,
            "commit_bundle": self.h_commit_bundle,
            "return_bundle": self.h_return_bundle,
            "pull_object": self.h_pull_object,
            "fetch_object": self.h_fetch_object,
            "request_push": self.h_request_push,
            "push_begin": self.h_push_begin,
            "push_chunk": self.h_push_chunk,
            "push_abort": self.h_push_abort,
            "broadcast_object": self.h_broadcast_object,
            "has_object": self.h_has_object,
            "restore_object": self.h_restore_object,
            "spill_now": self.h_spill_now,
            "free_object": self.h_free_object,
            "free_remote_object": self.h_free_remote_object,
            "get_node_info": self.h_get_node_info,
            "ledger_evict_hint": self.h_ledger_evict_hint,
            "channel_push": self.h_channel_push,
            "channel_publish": self.h_channel_publish,
            "channel_close": self.h_channel_close,
            "dump_stacks": self.h_dump_stacks,
            "ping": lambda conn: "pong",
        }
        self.server = rpc.Server(handlers, name=f"nm-{self.node_id[:8]}")
        self.server.on_disconnect = self._on_disconnect
        self.address = await self.server.listen_tcp("0.0.0.0", self.port)
        sock = runtime_dir(self.session_name, f"nm_{self.node_id[:12]}.sock")
        # a socket's path holds at most 107 bytes: under a long TMPDIR
        # the workers reach their node manager over TCP
        self.unix_address = (await self.server.listen_unix(sock)
                             if len(sock.encode()) < 100 else self.address)
        if cfg.data_plane_enabled:
            from ray_tpu_torch._private.data_plane import (DataPlaneClient,
                                                     DataPlaneServer)
            self._data_server = DataPlaneServer(self)
            self.data_plane_address = await self._data_server.start("0.0.0.0")
            self._data_client = DataPlaneClient(
                name=f"nm-{self.node_id[:8]}")
        self.gcs = await rpc.connect(
            self.gcs_address, handlers={
                "create_actor": self.h_create_actor,
                "kill_worker": self.h_kill_worker,
                "prepare_bundle": self.h_prepare_bundle,
                "commit_bundle": self.h_commit_bundle,
                "return_bundle": self.h_return_bundle,
                "ledger_evict_hint": self.h_ledger_evict_hint,
                "pubsub": self.h_pubsub,
            }, name="nm->gcs", retries=20)
        resp = await self.gcs.call(
            "register_node", node_id=self.node_id, address=self.address,
            object_store_address=self.store_path,
            data_plane_address=self.data_plane_address,
            resources=self.total, labels=self.labels,
            node_ip=rpc.node_ip_address())
        self.cluster_view = resp["cluster_view"]
        self._view_version = resp.get("view_version")
        # one head-side config governs the cluster (reference:
        # GetSystemConfig handshake, node_manager.proto:432)
        cfg.apply(resp.get("system_config") or {})
        if resp.get("gcs_ts"):
            # local minus GCS clock (half-RTT error bound) — recorded in
            # the black box header so cross-node stitches de-skew
            self._clock_offset_s = time.time() - float(resp["gcs_ts"])
        await self.gcs.call("subscribe", channel="NODE")
        # spill target: node-local dir by default, any fsspec URI when
        # cfg.spill_uri is set (gs:// on real pods; memory:// in tests)
        if cfg.spill_uri:
            from ray_tpu_torch.util import storage as _storage
            _storage.validate_root(cfg.spill_uri, "spill")
            self.spill_dir = _storage.join(
                cfg.spill_uri, self.session_name,
                f"spill_{self.node_id[:8]}")
            self._spill_remote = _storage.is_remote(self.spill_dir)
        else:
            self.spill_dir = runtime_dir(self.session_name,
                                         f"spill_{self.node_id[:8]}")
            self._spill_remote = False
        self.spilled: Dict[bytes, str] = {}
        # when each spilled object was last restored for a reader
        self._restored_at: Dict[bytes, float] = {}
        # lifetime counts of the spill plane (get_node_info's store view)
        self._spill_counts = {"spilled": 0, "spilled_bytes": 0,
                              "dropped": 0, "restored": 0,
                              "restored_bytes": 0, "restored_inline": 0}
        # flight-recorder sink: this daemon is not a worker, so its
        # spill/restore/transfer spans ship over the node manager's own
        # GCS connection (resolved at call time — it is replaced on GCS
        # reconnect)
        from ray_tpu_torch._private import events as _events
        _loop = asyncio.get_event_loop()

        def _ship_events(batch):
            gcs = self.gcs
            if gcs is None or gcs.closed:
                raise ConnectionError("gcs connection down")
            asyncio.run_coroutine_threadsafe(
                gcs.notify("add_task_events", events=batch), _loop)

        _events.set_identity(node_id=self.node_id,
                             worker_id=f"nm-{self.node_id[:12]}")
        _events.set_sink(_ship_events)

        # crash black box: continuous on-disk mirror of this daemon's
        # event ring + metrics snapshots (sealed on the GCS-disconnect
        # death path and on clean exit; a SIGKILL keeps the appends)
        from ray_tpu_torch._private import blackbox as _blackbox
        bb = _blackbox.configure(
            cfg.blackbox_dir or runtime_dir(self.session_name, "blackbox"),
            f"nm-{self.node_id[:12]}", node_id=self.node_id,
            worker_id=f"nm-{self.node_id[:12]}")
        if bb is not None and self._clock_offset_s:
            bb.set_clock_offset(self._clock_offset_s)

        # object-lifetime ledger: same daemon-sink pattern — this
        # process's spill/restore/evict/arrival deltas ship over the
        # node manager's own GCS connection
        def _ship_ledger(batch):
            gcs = self.gcs
            if gcs is None or gcs.closed:
                raise ConnectionError("gcs connection down")
            asyncio.run_coroutine_threadsafe(
                gcs.notify("update_object_ledger", records=batch,
                           node_id=self.node_id,
                           worker_id=f"nm-{self.node_id[:12]}"), _loop)

        ledger.set_enabled(cfg.ledger_enabled)
        ledger.set_identity(node_id=self.node_id,
                            worker_id=f"nm-{self.node_id[:12]}")
        ledger.set_sink(_ship_ledger)
        self._tasks = [
            asyncio.ensure_future(self._log_monitor_loop()),
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._view_refresh_loop()),
            asyncio.ensure_future(self._reap_children_loop()),
            asyncio.ensure_future(self._memory_monitor_loop()),
            asyncio.ensure_future(self._spill_loop()),
            asyncio.ensure_future(self._metrics_push_loop()),
            asyncio.ensure_future(self._ledger_census_loop()),
        ]
        logger.info("node manager %s at %s (store %s, %s)",
                    self.node_id[:12], self.address, self.store_path,
                    {k: v for k, v in self.total.items() if v})
        return self.address

    async def stop(self):
        for t in self._tasks:
            t.cancel()
        for w in self.workers.values():
            self._kill_proc(w)
        await self.server.close()
        if self._data_server is not None:
            await self._data_server.close()
        if self._data_client is not None:
            self._data_client.close()
        if self.gcs:
            await self.gcs.close()
        await self.pool.close()
        if self.store:
            self.store.close()
        try:
            os.unlink(self.store_path)
        except OSError:
            pass

    def _kill_proc(self, w: WorkerProc):
        # workers are session leaders (start_new_session): kill the whole
        # group so user tasks' own subprocesses don't outlive the worker
        if w.proc is not None and w.proc.poll() is None:
            from ray_tpu_torch._private.proc_util import kill_process_group
            kill_process_group(w.proc)

    async def _heartbeat_loop(self):
        # the resource payload rides the heartbeat only when it CHANGED
        # since the last acked beat; idle beats are constant-size liveness
        # pings (reference: versioned deltas over bidi streams instead of
        # full resource broadcast, ray_syncer.h:88)
        last_sent = None
        down_since = None   # monotonic stamp of first failed contact
        while True:
            avail = self._reported_available()
            pending = list(self._pending_demand)
            payload = (avail, pending)
            # explicit timeout: a silently-blackholed GCS connection
            # (half-open TCP) must count toward the reconnect deadline
            # the same as an erroring one
            beat_timeout = max(10.0, cfg.heartbeat_interval_s * 10)
            try:
                if payload == last_sent:
                    await self.gcs.call("heartbeat", node_id=self.node_id,
                                        timeout=beat_timeout)
                else:
                    await self.gcs.call("heartbeat", node_id=self.node_id,
                                        available=avail, pending=pending,
                                        timeout=beat_timeout)
                    last_sent = payload
                down_since = None
            except (rpc.RpcError, rpc.ConnectionLost, asyncio.TimeoutError):
                now = time.monotonic()
                if down_since is None:
                    down_since = now
                elif now - down_since > cfg.gcs_reconnect_timeout_s:
                    # bounded retry, then die cleanly instead of spinning
                    # forever as an orphan (reference: raylet exits after
                    # gcs_rpc_server_reconnect_timeout_s, main.cc:123)
                    logger.error(
                        "GCS %s unreachable for %.0fs "
                        "(> gcs_reconnect_timeout_s=%.0fs); shutting down",
                        self.gcs_address, now - down_since,
                        cfg.gcs_reconnect_timeout_s)
                    for w in list(self.workers.values()):
                        self._kill_proc(w)
                    from ray_tpu_torch._private import blackbox as _blackbox
                    _blackbox.record("marker", event="gcs_disconnect",
                                     gcs=self.gcs_address,
                                     down_s=round(now - down_since, 1))
                    _blackbox.seal("gcs_disconnect")
                    os._exit(1)
                logger.warning("heartbeat failed; reconnecting to GCS")
                last_sent = None
                if self.gcs_address_source:
                    fresh = self._read_gcs_address()
                    if fresh and fresh != self.gcs_address:
                        logger.info("GCS moved: %s -> %s",
                                    self.gcs_address, fresh)
                        self.gcs_address = fresh
                # bound the WHOLE reconnect attempt (dial + re-register
                # + resubscribe) by the remaining exit deadline: a
                # 20-retry backoff chain alone runs ~30s, and an
                # accepted-but-unresponsive GCS would hang the untimed
                # register call forever — either way the death check
                # above must get control back in time
                remaining = max(
                    0.5, down_since + cfg.gcs_reconnect_timeout_s
                    - time.monotonic())

                async def _redial():
                    conn = await rpc.connect(
                        self.gcs_address, handlers=self.gcs.handlers,
                        name="nm->gcs", retries=20)
                    try:
                        await conn.call(
                            "register_node", node_id=self.node_id,
                            address=self.address,
                            object_store_address=self.store_path,
                            data_plane_address=self.data_plane_address,
                            resources=self.total, labels=self.labels,
                            node_ip=rpc.node_ip_address())
                        await conn.call("subscribe", channel="NODE")
                        return conn
                    except BaseException:
                        # incl. the deadline's CancelledError: never
                        # leak a half-registered connection
                        try:
                            await conn.close()
                        except Exception:
                            pass
                        raise

                try:
                    conn = await asyncio.wait_for(_redial(),
                                                  timeout=remaining)
                    old = self.gcs
                    self.gcs = conn
                    # a half-open predecessor holds a socket + a parked
                    # reader task: close it or every reconnect cycle
                    # leaks one of each
                    try:
                        await old.close()
                    # rtlint: disable=RT004 — the replaced half-open conn
                    # is already dead; close is purely hygiene
                    except Exception:
                        pass
                except Exception:
                    # redial failed — log at debug (every heartbeat tick
                    # retries; an error-level line per tick would flood)
                    logger.debug("GCS redial failed; retrying next "
                                 "heartbeat", exc_info=True)
            await asyncio.sleep(cfg.heartbeat_interval_s)

    def _read_gcs_address(self) -> Optional[str]:
        try:
            from ray_tpu_torch._private.store_client import store_client_for
            return store_client_for(self.gcs_address_source).read_address()
        except Exception:
            return None

    def _reported_available(self) -> Dict[str, float]:
        avail = dict(self.available)
        if self.store is not None:
            st = self.store.stats()
            avail["object_store_memory"] = max(
                0.0, float(self.store_bytes - st["bytes_in_use"]))
        return avail

    def _observability_metrics(self) -> list:
        """The node manager's own registry-shaped snapshots. Data-plane
        byte/chunk/connection counters were only visible via
        get_node_info; exporting them here lands them in /metrics AND
        the GCS time-series plane (so `query_metrics(
        "data_plane_bytes_in_total", 30, "rate")` reads live transfer
        bandwidth). Counters are cumulative — the TS ingest diffs them."""
        from ray_tpu_torch.util.metrics import counter_snapshot, gauge_snapshot
        tags = {"node": self.node_id[:12]}
        rows = [gauge_snapshot("node_workers", len(self.workers),
                               "live worker processes", tags)]
        for phase, ms in self._launch_phase_ms.items():
            rows.append(gauge_snapshot(
                "runtime_launch_phase_ms", ms,
                "most recent actor-launch phase duration on this node "
                "(ms)", {**tags, "phase": phase}))
        if self._launches_total:
            rows.append(counter_snapshot(
                "node_actor_launches_total", self._launches_total,
                "actors launched on this node", tags))
        if self.store is not None:
            try:
                st = self.store.stats()
                rows.append(gauge_snapshot(
                    "store_bytes_in_use", st["bytes_in_use"],
                    "shared-memory arena bytes in use", tags))
                rows.append(gauge_snapshot(
                    "store_capacity_bytes", st["capacity"],
                    "shared-memory arena capacity", tags))
                rows.append(gauge_snapshot(
                    "store_objects", st["num_objects"],
                    "live objects in the arena", tags))
                # span residency + worst-stripe occupancy/fragmentation:
                # the `ray_tpu_torch status --watch` memory pane reads these
                # from the TS plane (they previously reached only
                # get_node_info)
                sp = self.store.span_stats()
                rows.append(gauge_snapshot(
                    "store_live_spans", sp["live_spans"],
                    "live spanning (multi-stripe) objects", tags))
                rows.append(gauge_snapshot(
                    "store_span_bytes", sp["span_bytes"],
                    "bytes held by spanning objects", tags))
                rows.append(gauge_snapshot(
                    "store_stripes_claimed", sp["stripes_claimed"],
                    "stripes claimed whole by spanning objects", tags))
                util_max, hole_max = 0.0, 0
                for i in range(self.store.num_stripes()):
                    ss = self.store.stripe_stats(i)
                    if ss["capacity"]:
                        util_max = max(util_max,
                                       ss["bytes_in_use"] / ss["capacity"])
                    fr = self.store.stripe_frag(i)
                    hole_max = max(hole_max, fr["largest_hole"])
                rows.append(gauge_snapshot(
                    "store_stripe_max_utilization", round(util_max, 4),
                    "occupancy fraction of the fullest stripe", tags))
                rows.append(gauge_snapshot(
                    "store_largest_hole_bytes", hole_max,
                    "largest single free block across stripes", tags))
            except Exception:
                pass
        if self._data_server is not None:
            ds, dc = self._data_server, self._data_client
            rows += [
                counter_snapshot("data_plane_bytes_in_total", ds.bytes_in,
                                 "data-plane payload bytes received",
                                 tags),
                counter_snapshot("data_plane_chunks_in_total",
                                 ds.chunks_in,
                                 "data-plane chunks received", tags),
                counter_snapshot("data_plane_bytes_out_total",
                                 dc.bytes_out,
                                 "data-plane payload bytes sent", tags),
                counter_snapshot("data_plane_chunks_out_total",
                                 dc.chunks_out,
                                 "data-plane chunks sent", tags),
                gauge_snapshot("data_plane_active_conns", ds.active_conns,
                               "live inbound data-plane connections",
                               tags),
                gauge_snapshot("data_plane_receiving",
                               len(self._receiving),
                               "objects with an in-progress receive",
                               tags),
            ]
        return rows

    async def _metrics_push_loop(self):
        """The node manager is a daemon, not a worker — the registry
        pusher in util/metrics.py can't carry its counters. Push them
        through its own GCS connection on the same jittered cadence."""
        import random
        while True:
            await asyncio.sleep(
                cfg.metrics_push_interval_s * random.uniform(0.75, 1.25))
            try:
                await self.gcs.notify(
                    "report_metrics",
                    worker_id=f"nm:{self.node_id[:12]}",
                    node_id=self.node_id,
                    metrics=self._observability_metrics())
            # rtlint: disable=RT004 — best-effort push on a jittered
            # cadence; the heartbeat loop owns reconnect and the next
            # tick re-reports cumulative counters (no data loss)
            except Exception:
                pass

    async def _view_refresh_loop(self):
        # versioned delta pull with a periodic full resync as drift guard;
        # steady-state refreshes carry an empty delta (O(changes), not
        # O(nodes) — reference: ray_syncer.h:88)
        n = 0
        while True:
            await asyncio.sleep(cfg.view_refresh_s)
            try:
                since = None if (self._view_version is None
                                 or n % 30 == 29) else self._view_version
                resp = await self.gcs.call("get_cluster_view_delta",
                                           since=since)
                self._view_version = resp["version"]
                if "full" in resp:
                    self.cluster_view = resp["full"]
                    self._view_debits.clear()
                elif resp["delta"]:
                    self.cluster_view.update(resp["delta"])
                    for nid in resp["delta"]:
                        self._view_debits.pop(nid, None)
                n += 1
            except rpc.ConnectionLost:
                self._view_version = None     # resync after reconnect
            except rpc.RpcError:
                # older GCS without the delta handler: fall back to full
                try:
                    self.cluster_view = await self.gcs.call(
                        "get_cluster_view")
                except Exception:
                    logger.debug("cluster-view full resync failed; "
                                 "retrying next refresh", exc_info=True)
            self._expire_view_debits()
            # reap half-received transfers whose pusher died mid-stream
            # (their unsealed buffers would otherwise pin arena space)
            now = time.monotonic()
            for oid, rst in list(self._receiving.items()):
                if now - rst["t"] > 60.0:
                    if rst.get("writers"):
                        # a data-plane handler is parked inside a
                        # recv_into on this object (half-open pusher):
                        # never store.abort under an active writer — the
                        # arena region could be re-allocated while stale
                        # bytes still land in it. Close the feeding
                        # sockets instead; the woken handler aborts.
                        rst["aborted"] = True
                        for s in list(rst.get("conns") or ()):
                            try:
                                s.close()
                            except OSError:
                                pass
                        continue
                    # fail pulls parked on this receive so they retry
                    # immediately instead of waiting out their 300s cap
                    self._abort_receive(
                        oid, "stalled >60s (pusher died?); receive aborted")

    async def _reap_children_loop(self):
        while True:
            await asyncio.sleep(1.0)
            for w in list(self.workers.values()):
                if w.proc is not None and w.proc.poll() is not None \
                        and w.state != "dead":
                    await self._on_worker_death(w, f"exit code {w.proc.returncode}")
            # env-tagged workers serve exactly one pip env: evict them
            # after sitting idle so cycling through many envs can't pin
            # a process per env forever
            now = time.monotonic()
            for w in list(self._idle):
                if (w.state == "idle" and w.env_hash is not None
                        and w.idle_since
                        and now - w.idle_since
                        > cfg.pip_worker_idle_timeout_s):
                    self._idle.remove(w)
                    await self._on_worker_death(
                        w, "idle pip-env worker evicted")

    # ------------------------------------------------------ memory monitor
    @staticmethod
    def _system_memory_fraction() -> float:
        """Used fraction of system memory from /proc/meminfo (the
        reference samples the same source: src/ray/common/memory_monitor.h,
        GetLinuxMemoryBytes)."""
        total = avail = None
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1])
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1])
                    if total is not None and avail is not None:
                        break
        except OSError:
            return 0.0
        if not total or avail is None:
            return 0.0
        return 1.0 - avail / total

    @staticmethod
    def _proc_rss_bytes(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            return 0

    async def _memory_monitor_loop(self):
        """OOM defense: when system memory crosses the usage threshold,
        kill the worker with the largest RSS, preferring retriable task
        workers over actors (reference: memory_monitor.h:52 + raylet
        worker killing policies — retriable-first, group-by-owner). The
        owner sees a worker death and retries; without this the kernel
        OOM-killer may take down the whole node manager instead."""
        while True:
            interval = cfg.memory_monitor_interval_s
            if interval <= 0:
                await asyncio.sleep(5.0)
                continue
            await asyncio.sleep(interval)
            try:
                frac = self._system_memory_fraction()
                if frac < cfg.memory_usage_threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                logger.warning(
                    "memory pressure %.1f%% > %.1f%%: killing worker %s "
                    "(state=%s, rss=%dMB)", frac * 100,
                    cfg.memory_usage_threshold * 100,
                    victim.worker_id and victim.worker_id[:12],
                    victim.state, self._proc_rss_bytes(victim.pid) >> 20)
                await self._on_worker_death(
                    victim, f"killed by memory monitor at {frac:.0%} usage")
            except Exception:
                logger.exception("memory monitor pass failed")

    def _pick_oom_victim(self) -> Optional["WorkerProc"]:
        # leased task workers first (their tasks retry); actors only if
        # nothing else is killable; never idle workers (tiny RSS, and
        # killing them frees nothing the pool won't re-create)
        for states in (("leased",), ("actor",)):
            candidates = [w for w in self.workers.values()
                          if w.state in states and w.pid]
            if candidates:
                return max(candidates, key=lambda w: self._proc_rss_bytes(w.pid))
        return None

    # ------------------------------------------- compiled-DAG channels
    # Cross-node mutable-object push (reference: raylet PushMutableObject,
    # node_manager.proto:442 + experimental_mutable_object_provider.h:30):
    # the writer's node manager fans a published version out to reader
    # nodes, whose node managers write it into a local mirror channel that
    # local readers mmap. Only refs-to-bytes travel the wire; readers stay
    # zero-copy against their node-local shm.
    def _dag_channel(self, path: str, num_readers: int, max_size: int):
        from ray_tpu_torch.experimental.channel import (Channel,
                                                        node_local_path)
        local = node_local_path(path, self.node_id)
        ch = self._dag_channels.get(local)
        if ch is None:
            import os as _os
            if _os.path.exists(local):
                ch = Channel(local)
            else:
                ch = Channel(local, max_size=max_size,
                             num_readers=num_readers, create=True)
            self._dag_channels[local] = ch
        return ch

    async def h_channel_push(self, conn, path: str, payload: bytes,
                             num_readers: int = 1,
                             max_size: int = 1 << 20,
                             write_timeout_s: float = 60.0):
        ch = self._dag_channel(path, num_readers, max_size)
        loop = asyncio.get_event_loop()
        # blocking writer-semaphore wait must not stall the daemon loop
        await loop.run_in_executor(None, ch.write_bytes, payload,
                                   write_timeout_s)
        return True

    async def h_channel_publish(self, conn, path: str, payload: bytes,
                                targets: Dict[str, int],
                                max_size: int = 1 << 20,
                                write_timeout_s: float = 60.0):
        """Fan one published version out to the target nodes' mirrors;
        ``targets`` maps node id -> that node's local reader count (each
        mirror is created with its own node's count). All pushes run to
        completion before any failure is raised, so mirrors don't end up
        at divergent versions behind a detached coroutine."""
        async def push(nid, readers):
            view = self.cluster_view.get(nid)
            if view is None or not view.get("alive", True):
                raise rpc.RpcError(f"channel target node {nid[:12]} gone")
            nm = await self.pool.get(view["address"])
            await nm.call("channel_push", path=path, payload=payload,
                          num_readers=readers, max_size=max_size,
                          write_timeout_s=write_timeout_s,
                          timeout=write_timeout_s + 60.0)

        nids = list(targets)
        results = await asyncio.gather(
            *(push(n, targets[n]) for n in nids),
            return_exceptions=True)
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            # partial success leaves mirrors one version ahead of failed
            # targets; a writer retry would then double-publish to the
            # survivors. Close the edge instead: every reader sees
            # ChannelClosed deterministically rather than diverging
            ok = [n for n, r in zip(nids, results)
                  if not isinstance(r, BaseException)]
            if ok:
                try:
                    await self.h_channel_close(conn, path=path, targets=ok)
                except Exception:
                    pass
            raise errs[0]
        return True

    async def h_channel_close(self, conn, path: str,
                              targets: Optional[List[str]] = None):
        """Close the local mirror (readers see ChannelClosed) and
        propagate to target nodes."""
        from ray_tpu_torch.experimental.channel import (Channel,
                                                        node_local_path)
        local = node_local_path(path, self.node_id)
        ch = self._dag_channels.pop(local, None)
        if ch is None:
            import os as _os
            if _os.path.exists(local):
                try:
                    ch = Channel(local)
                except OSError:
                    ch = None
        if ch is not None:
            try:
                ch.close()
                ch.destroy()   # drop the shm-backed file too
            except Exception:
                pass
        for nid in targets or []:
            view = self.cluster_view.get(nid)
            if view is None:
                continue
            try:
                nm = await self.pool.get(view["address"])
                await nm.call("channel_close", path=path)
            # rtlint: disable=RT004 — close fan-out to peers that may
            # already be dead; a dead peer's channel needs no close
            except Exception:
                pass
        return True

    def h_pubsub(self, conn, channel, key, payload):
        if channel == "NODE":
            if payload.get("state") == "DEAD":
                view = self.cluster_view.get(key)
                if view:
                    view["alive"] = False
            elif payload.get("state") == "ALIVE":
                self.cluster_view[key] = {
                    "total": payload["total"],
                    "available": payload["available"],
                    "alive": True, "address": payload["address"],
                    "object_store_address": payload["object_store_address"],
                    "data_plane_address": payload.get("data_plane_address"),
                    "node_ip": payload["node_ip"],
                    "labels": payload.get("labels", {})}
                self._wake_lease_waiters()

    @staticmethod
    def _tail_chunk(path: str, off: int) -> bytes:
        """Blocking file read of one log tail; runs in the default
        executor — disk IO on the owner loop would stall heartbeats and
        lease grants behind a slow volume."""
        with open(path, "rb") as f:
            f.seek(off)
            return f.read(256 * 1024)

    async def _log_monitor_loop(self):
        """Tail per-worker log files and publish new lines to the LOGS
        pubsub channel so drivers can echo them (reference: LogMonitor
        python/ray/_private/log_monitor.py:103 magic-prefix routing)."""
        loop = asyncio.get_event_loop()
        while True:
            await asyncio.sleep(cfg.log_tail_interval_s)
            for pid, files in list(self._log_files.items()):
                for i, (path, stream, off) in enumerate(files):
                    try:
                        chunk = await loop.run_in_executor(
                            None, self._tail_chunk, path, off)
                    except OSError:
                        continue
                    if not chunk:
                        continue
                    nl = chunk.rfind(b"\n")
                    if nl < 0:
                        continue
                    chunk = chunk[:nl + 1]
                    files[i] = (path, stream, off + len(chunk))
                    lines = chunk.decode("utf-8", "replace").splitlines()
                    try:
                        await self.gcs.call(
                            "publish", channel="LOGS", key=self.node_id,
                            payload={"pid": pid, "stream": stream,
                                     "ip": rpc.node_ip_address(),
                                     "lines": lines[:200]})
                    # rtlint: disable=RT004 — LOGS fan-out is best-effort
                    # by contract; the file offset already advanced, and
                    # re-publishing stale lines would duplicate output
                    except Exception:
                        pass

    # ------------------------------------------------------------ worker pool
    def _spawn_worker(self, proc_env: Optional[Dict] = None,
                      env_hash: Optional[str] = None,
                      gpu_mask: Optional[str] = None) -> WorkerProc:
        env = dict(os.environ)
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id
        if gpu_mask is not None:
            env["CUDA_VISIBLE_DEVICES"] = gpu_mask
        # a worker never outlives its node manager, detached cluster or
        # not: arm parent-death SIGTERM regardless of how WE were started
        from ray_tpu_torch._private.proc_util import child_env
        env = child_env(env)
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.worker_main",
               "--node-address", self.unix_address,
               "--gcs-address", self.gcs_address,
               "--store-path", self.store_path,
               "--node-id", self.node_id,
               "--session-name", self.session_name]
        if proc_env and proc_env.get("container"):
            # process-scope runtime env: the worker itself runs inside
            # the container image (reference: runtime_env/image_uri.py —
            # worker command under podman run; the runtime dir's bind-mount +
            # host network keep it on the node's data plane)
            from ray_tpu_torch._private.runtime_env_plugins import \
                container_command
            cmd = container_command(proc_env, cmd, env)
        # detach stdio so workers never hold a driver/pytest pipe open;
        # per-worker log files under the session dir are tailed by
        # _log_monitor_loop and published to the driver (reference:
        # python/ray/_private/log_monitor.py:103 -> GCS pubsub -> driver)
        log_dir = runtime_dir(self.session_name, "logs")
        os.makedirs(log_dir, exist_ok=True)
        self._worker_seq = getattr(self, "_worker_seq", 0) + 1
        base = os.path.join(log_dir,
                            f"worker-{self.node_id[:8]}-{self._worker_seq}")
        outf = open(base + ".out", "ab")
        errf = open(base + ".err", "ab")
        proc = subprocess.Popen(cmd, env=env, stdin=subprocess.DEVNULL,
                                stdout=outf, stderr=errf,
                                start_new_session=True)
        outf.close()
        errf.close()
        self._log_files[proc.pid] = [(base + ".out", "stdout", 0),
                                     (base + ".err", "stderr", 0)]
        w = WorkerProc(proc)
        # tag at SPAWN, not grant: a container worker that registers
        # into the idle pool before its requester resumes must never be
        # adoptable as a plain "untagged" worker (and vice versa)
        w.env_hash = env_hash
        w.gpu_mask = gpu_mask
        self._spawning += 1
        return w

    def h_register_worker(self, conn, worker_id: str, address: str, pid: int,
                          mode: str):
        w = None
        # match a spawned-but-unregistered proc by pid
        for cand in self.workers.values():
            if cand.proc is not None and cand.proc.pid == pid:
                w = cand
                break
        if w is None:
            w = WorkerProc()
            if mode == "worker":
                pass
        w.worker_id = worker_id
        w.address = address
        w.pid = pid
        w.conn = conn
        conn.peer_info["worker_id"] = worker_id
        self.workers[worker_id] = w
        if mode == "driver":
            w.state = "driver"
        elif w.state == "starting":
            self._spawning = max(0, self._spawning - 1)
            w.state = "idle"
            self._idle.append(w)
            self._wake_lease_waiters()
        w.registered.set()
        return {"node_id": self.node_id}

    def _on_disconnect(self, conn: rpc.Connection):
        # a pusher node that died mid-transfer drops its control
        # connection: reap every receive it was feeding right away so
        # parked pulls fail over to a surviving holder (the 60s idle
        # sweep only backstops silent stalls)
        for oid, st in list(self._receiving.items()):
            if st.get("ctrl") is conn:
                st["aborted"] = True
                if not st.get("writers"):
                    self._abort_receive(
                        oid, "pusher control connection lost mid-stream")
        wid = conn.peer_info.get("worker_id")
        if wid is None:
            return
        w = self.workers.get(wid)
        if w is not None and w.state not in ("dead", "driver"):
            asyncio.ensure_future(self._on_worker_death(w, "connection lost"))
        elif w is None or w.state == "driver":
            if w is not None:
                self.workers.pop(wid, None)
            # a submitter (driver, or a remote worker that leased here via
            # spillback) vanished: release every lease it owned, or its
            # workers stay "leased" forever and the node's resources leak
            # (reference: raylet treats client-socket disconnect as death
            # and cleans up its leases, node_manager.cc DisconnectClient)
            self._release_owned_leases(wid)

    def _release_owned_leases(self, wid: str):
        """Reclaim leases whose submitter `wid` is gone. The leased worker
        may still be EXECUTING the dead submitter's task — re-idling it
        would double-assign the process (and its GPUs) while the orphan
        task runs, so kill it and let the pool respawn fresh (reference:
        raylet destroys workers of a disconnected owner,
        node_manager.cc DisconnectClient). Clean shutdowns return leases
        before disconnecting, so this only costs a respawn on crashes."""
        for lid, info in list(self._leases.items()):
            if info.get("owner") == wid:
                asyncio.ensure_future(self._on_worker_death(
                    info["worker"], f"lease owner {wid[:8]} disconnected"))

    async def _on_worker_death(self, w: WorkerProc, reason: str):
        prev_state = w.state
        w.state = "dead"
        if w in self._idle:
            self._idle.remove(w)
        self.workers.pop(w.worker_id, None)
        self._kill_proc(w)
        if w.worker_id and self.gcs and not self.gcs.closed:
            # retire the dead worker's metric snapshot: its gauges
            # (queue depths, occupancy) would otherwise read as live
            # forever in the /metrics aggregate
            try:
                await self.gcs.notify("drop_worker_metrics",
                                      worker_id=w.worker_id)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        if w.lease_id is not None:
            self._release_lease(w.lease_id, worker_dead=True)
        if w.worker_id:
            # leases this worker OWNED as a nested-task submitter
            self._release_owned_leases(w.worker_id)
        if prev_state == "actor" and w.actor_id is not None:
            try:
                await self.gcs.call("report_actor_failure", actor_id=w.actor_id,
                                    reason=f"worker died: {reason}",
                                    worker_id=w.worker_id)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass

    async def _obtain_worker(self, timeout: float = 60.0,
                             env_hash: Optional[str] = None,
                             proc_env: Optional[Dict] = None,
                             gpu_mask: Optional[str] = None) -> WorkerProc:
        """Pop an idle worker compatible with the requested runtime env
        (matching env, or a fresh untagged worker that becomes tagged)
        and spawned with the requested GPU mask, spawning a new process
        if none fits. Process-scope envs (container) can never adopt an
        untagged worker — the process was not started inside the image —
        so they match exactly or spawn."""
        while True:
            picked = fallback = None
            for w in list(self._idle):
                if w.state != "idle":
                    self._idle.remove(w)
                    continue
                if w.gpu_mask != gpu_mask:
                    continue
                if w.env_hash == env_hash:
                    picked = w          # exact env match wins
                    break
                if w.env_hash is None and fallback is None \
                        and proc_env is None:
                    fallback = w        # untagged: taggable if no match
            picked = picked or fallback
            if picked is not None:
                self._idle.remove(picked)
                picked.env_hash = env_hash or picked.env_hash
                return picked
            w = self._spawn_worker(proc_env, env_hash, gpu_mask)
            # temporary key until registration rebinds by worker_id
            self.workers[f"spawn-{w.proc.pid}"] = w
            try:
                await asyncio.wait_for(w.registered.wait(), timeout)
            except asyncio.TimeoutError:
                self._kill_proc(w)
                raise RuntimeError("worker failed to start in time")
            self.workers.pop(f"spawn-{w.proc.pid}", None)
            if w.state == "idle" and w in self._idle:
                self._idle.remove(w)
                w.env_hash = env_hash
                return w
            # else someone else grabbed it; loop

    def _wake_lease_waiters(self):
        for fut in self._lease_waiters:
            if not fut.done():
                fut.set_result(None)
        self._lease_waiters.clear()

    # ---------------------------------------------------------------- leases
    def _bundle_pool(self, scheduling_opts: Dict) -> Optional[Dict]:
        pg_id = scheduling_opts.get("placement_group_id")
        if not pg_id:
            return None
        idx = scheduling_opts.get("placement_group_bundle_index", 0)
        return self.bundles.get((pg_id, idx))

    async def h_request_lease(self, conn, resources: Dict[str, float],
                              scheduling: Dict, worker_id: str,
                              env_hash: Optional[str] = None,
                              proc_env: Optional[Dict] = None,
                              spilled: bool = False):
        """Grant a worker lease, queue, or redirect (spillback). A request
        that has already been redirected once is grant-or-queue here — never
        redirected again (the reference's grant_or_reject spillback rule,
        preventing ping-pong on stale cluster views)."""
        self._loop_checker.check()
        deadline = time.monotonic() + cfg.lease_wait_timeout_s
        strategy = scheduling.get("strategy", "DEFAULT")
        infeasible_since = None
        while True:
            # Zombie guard: the submitter may be long gone while this
            # handler sits in the wait loop (its RPC was abandoned at
            # disconnect). Granting to a dead conn leaks the lease
            # forever — the owner-reclaim at disconnect already ran.
            if conn.closed:
                return {"status": "error", "reason": "requester gone"}
            bundle = self._bundle_pool(scheduling)
            pool_avail = bundle["available"] if bundle else self.available
            if scheduling.get("placement_group_id") and bundle is None:
                # bundle lives on another node: redirect the caller there
                spill = await self._bundle_node_address(scheduling)
                if spill is not None:
                    return {"status": "spill", "spill_to": spill}
                return {"status": "error",
                        "reason": "placement group bundle not found"}
            if bundle is None and not spilled \
                    and strategy in ("NODE_AFFINITY", "SPREAD"):
                # strategy decides the node even when we fit locally
                view = self._live_view()
                target = scheduling_pick(view, resources, scheduling,
                                         self.node_id)
                if target is None:
                    if strategy == "NODE_AFFINITY" and not scheduling.get("soft"):
                        return {"status": "error",
                                "reason": "affinity node unavailable"}
                elif target != self.node_id:
                    self._debit_view(target, resources)
                    return {"status": "spill",
                            "spill_to": view[target]["address"]}
            if scheduling_fits(pool_avail, resources) \
                    and self._gpus_fit(resources):
                # GPUs must be claimed atomically with the float
                # accounting: _obtain_worker suspends, and a concurrent
                # request could drain the pool between check and allocate
                scheduling_sub(pool_avail, resources)
                gpus = self._allocate_gpus(resources)
                try:
                    w = await self._obtain_worker(
                        env_hash=env_hash, proc_env=proc_env,
                        gpu_mask=self._gpu_mask(gpus))
                except RuntimeError as e:
                    self._gpus.release(gpus)
                    scheduling_addback(pool_avail, resources)
                    return {"status": "error", "reason": str(e)}
                except BaseException:
                    # OSError from spawn, CancelledError from a dropped
                    # caller, ... — never leak the claimed GPUs/resources
                    self._gpus.release(gpus)
                    scheduling_addback(pool_avail, resources)
                    raise
                if conn.closed:
                    # requester died while we were obtaining the worker:
                    # the grant reply is undeliverable — roll back
                    self._gpus.release(gpus)
                    scheduling_addback(pool_avail, resources)
                    w.state = "idle"
                    w.idle_since = time.monotonic()
                    self._idle.append(w)
                    self._wake_lease_waiters()
                    return {"status": "error", "reason": "requester gone"}
                self._lease_seq += 1
                lease_id = f"{self.node_id[:8]}-{self._lease_seq}"
                w.state = "leased"
                w.lease_id = lease_id
                # "owner" = the submitter that requested this lease — a
                # driver or a worker running nested tasks. A submitter
                # that dies (or disconnects without returning its idle
                # leases) must not leak the resources forever.
                self._leases[lease_id] = {"worker": w, "resources": resources,
                                          "bundle": bundle, "gpus": gpus,
                                          "owner": worker_id}
                # spilled requests arrive over an anonymous pool conn;
                # stamping the submitter id here lets _on_disconnect
                # reclaim its leases when that conn drops
                conn.peer_info.setdefault("worker_id", worker_id)
                return {"status": "ok", "lease_id": lease_id,
                        "worker_address": w.address,
                        "node_address": self.address,
                        "node_id": self.node_id,
                        "resource_ids": ({"GPU": self._gpus.ids_of(gpus)}
                                         if gpus else {})}
            if bundle is None and not spilled:
                # consider spillback using the cluster view
                view = self._live_view()
                target = scheduling_pick(view, resources, scheduling, self.node_id)
                if target is not None and target != self.node_id:
                    self._debit_view(target, resources)
                    return {"status": "spill",
                            "spill_to": view[target]["address"]}
                if target is None and not scheduling_feasible_anywhere(
                        view, resources, self.total):
                    # Infeasible in the current view. Keep the request queued
                    # (a node may join — the reference keeps infeasible tasks
                    # pending and surfaces them as autoscaler demand), but
                    # fail after a sustained infeasibility window.
                    if infeasible_since is None:
                        infeasible_since = time.monotonic()
                    elif (time.monotonic() - infeasible_since
                            > cfg.infeasible_grace_s):
                        return {"status": "error",
                                "reason": f"resources {resources} "
                                          f"unschedulable anywhere"}
                else:
                    infeasible_since = None
            # wait for resources to free up locally
            if time.monotonic() > deadline:
                return {"status": "error", "reason": "lease wait timed out"}
            fut = asyncio.get_event_loop().create_future()
            self._lease_waiters.append(fut)
            self._pending_demand.append(dict(resources))
            try:
                await asyncio.wait_for(fut, timeout=1.0)
            except asyncio.TimeoutError:
                pass
            finally:
                try:
                    self._pending_demand.remove(resources)
                except ValueError:
                    pass

    def _debit_view(self, target: str, resources: Dict[str, float]):
        """Optimistically debit a remote node's availability in the local
        view after deciding to spill there: a burst of lease requests
        must not all pick the same (stale-view) target before the next
        sync corrects it (reference: ClusterResourceScheduler's local
        resource-view adjustment on spillback decisions). Debits expire:
        if the spilled lease fails the GCS entry never changes, so under
        delta sync the understated availability would persist until the
        next full resync — a TTL sweep restores unconfirmed debits."""
        v = self.cluster_view.get(target)
        if v is None:
            return
        avail = dict(v.get("available") or {})
        for k, amt in (resources or {}).items():
            if k in avail:
                avail[k] = avail[k] - amt
        self.cluster_view[target] = {**v, "available": avail}
        self._view_debits.setdefault(target, []).append(
            (time.monotonic(), dict(resources or {})))

    def _expire_view_debits(self, ttl: float = 10.0):
        """Credit back optimistic debits never confirmed by a view update
        (confirmed ones are dropped when their node appears in a delta)."""
        now = time.monotonic()
        for target, recs in list(self._view_debits.items()):
            keep = []
            for t, res in recs:
                if now - t < ttl:
                    keep.append((t, res))
                    continue
                v = self.cluster_view.get(target)
                if v is not None:
                    avail = dict(v.get("available") or {})
                    for k, amt in res.items():
                        if k in avail:
                            avail[k] = avail[k] + amt
                    self.cluster_view[target] = {**v, "available": avail}
            if keep:
                self._view_debits[target] = keep
            else:
                self._view_debits.pop(target, None)

    def _live_view(self) -> Dict[str, Dict]:
        # draining nodes take no NEW work (reference: node draining in
        # cluster_task_manager — schedulable set excludes draining)
        view = {nid: v for nid, v in self.cluster_view.items()
                if v.get("alive", True) and not v.get("draining", False)}
        if self.node_id in view:
            view[self.node_id] = {**view[self.node_id],
                                  "available": self._reported_available(),
                                  "total": self.total}
        return view

    async def _bundle_node_address(self, sched: Dict) -> Optional[str]:
        pg_id = sched.get("placement_group_id")
        idx = sched.get("placement_group_bundle_index", 0)
        try:
            info = await self.gcs.call("get_placement_group", pg_id=pg_id)
        except (rpc.RpcError, rpc.ConnectionLost):
            return None
        if not info or info.get("state") != "CREATED":
            return None
        node_ids = info.get("node_ids") or []
        if idx < 0 or idx >= len(node_ids):
            return None
        target = node_ids[idx]
        if target == self.node_id:
            return None   # bundle claims to be here but isn't (race)
        view = self.cluster_view.get(target)
        return view["address"] if view and view.get("alive", True) else None

    def h_return_lease(self, conn, lease_id: str, worker_dead: bool = False):
        self._release_lease(lease_id, worker_dead)
        return True

    def _gpus_fit(self, resources: Dict[str, float]) -> bool:
        return self._gpus.fits(float(resources.get("GPU", 0)))

    def _allocate_gpus(self, resources: Dict[str, float]):
        return self._gpus.allocate(float(resources.get("GPU", 0)))

    @staticmethod
    def _gpu_mask(gpus) -> Optional[str]:
        """CUDA_VISIBLE_DEVICES for a worker holding this claim, or None
        (no GPU: the worker keeps the node manager's visibility)."""
        return ",".join(i for i, _ in gpus) if gpus else None

    def _release_lease(self, lease_id: str, worker_dead: bool):
        info = self._leases.pop(lease_id, None)
        if info is None:
            return
        self._gpus.release(info.get("gpus"))
        pool_avail = info["bundle"]["available"] if info["bundle"] else self.available
        scheduling_addback(pool_avail, info["resources"])
        w = info["worker"]
        w.lease_id = None
        if not worker_dead and w.state == "leased":
            w.state = "idle"
            w.idle_since = time.monotonic()
            self._idle.append(w)
        self._wake_lease_waiters()

    # ---------------------------------------------------------------- actors
    # ------------------------------------------------- launch attribution
    # The node-manager slice of the actor.launch critical path: each
    # phase records a child span under the trace ctx the GCS forwarded,
    # updates the runtime_launch_phase_ms{phase} gauge, and reports the
    # phase transition so `ray_tpu_torch status` shows where an in-flight
    # launch currently sits.
    def _launch_enter(self, lt: Optional[Dict], phase: str) -> float:
        if lt is not None:
            async def _notify():
                try:
                    await self.gcs.notify(
                        "launch_phase", actor_id=lt.get("actor_id"),
                        phase=phase, node_id=self.node_id)
                except Exception:
                    pass
            try:
                asyncio.ensure_future(_notify())
            except Exception:
                pass
        return time.time()

    def _launch_exit(self, lt: Optional[Dict], phase: str, t0: float,
                     **attrs) -> None:
        end = time.time()
        self._launch_phase_ms[phase] = round((end - t0) * 1e3, 3)
        if lt is not None:
            from ray_tpu_torch._private import events as _events
            _events.record_complete(
                f"launch.{phase}", t0, end, category="launch",
                trace_id=lt.get("trace_id"),
                parent_span_id=lt.get("parent_span_id"),
                actor_id=lt.get("actor_id"), **attrs)

    async def h_create_actor(self, conn, spec: Dict, pg_id=None, bundle_index=0,
                             launch_trace: Optional[Dict] = None):
        lt = launch_trace if cfg.launch_trace_enabled else None
        resources = dict(spec.get("resources") or {})
        bundle = self.bundles.get((pg_id, bundle_index)) if pg_id else None
        pool_avail = bundle["available"] if bundle else self.available
        # queue for resources (leases drain within their idle timeout)
        t_phase = self._launch_enter(lt, "resource_wait")
        waited = False
        deadline = time.monotonic() + cfg.actor_resource_wait_s
        while not (scheduling_fits(pool_avail, resources)
                   and self._gpus_fit(resources)):
            if conn is not None and conn.closed:
                raise RuntimeError("actor requester gone")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"insufficient resources for actor: {resources}")
            waited = True
            fut = asyncio.get_event_loop().create_future()
            self._lease_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, timeout=0.5)
            except asyncio.TimeoutError:
                pass
        self._launch_exit(lt, "resource_wait", t_phase, waited=waited)
        # claim GPUs atomically with the float accounting (see h_lease)
        scheduling_sub(pool_avail, resources)
        gpus = self._allocate_gpus(resources)
        # process-scope env (container): the actor's worker process must
        # be spawned inside the image — never adopt a plain pooled worker
        from ray_tpu_torch._private.runtime_env_plugins import (proc_env_of,
                                                          runtime_env_hash)
        proc_env = proc_env_of(spec.get("runtime_env"))
        # same hash scheme as the task-lease path: a pip-only actor can
        # still adopt (and tag) an untagged worker, a containered one
        # matches exactly or spawns inside the image
        env_hash = runtime_env_hash(spec.get("runtime_env"))
        t_phase = self._launch_enter(lt, "worker_obtain")
        try:
            w = await self._obtain_worker(env_hash=env_hash,
                                          proc_env=proc_env,
                                          gpu_mask=self._gpu_mask(gpus))
        except BaseException:
            self._gpus.release(gpus)
            scheduling_addback(pool_avail, resources)
            raise
        self._launch_exit(lt, "worker_obtain", t_phase,
                          worker=w.worker_id[:12])
        w.state = "actor"
        w.actor_id = spec["actor_id"]
        # register the reservation as a lease keyed off the worker so
        # _on_worker_death releases the resources on crash
        lease_id = f"actor-{spec['actor_id']}-{w.worker_id[:8]}"
        w.lease_id = lease_id
        self._leases[lease_id] = {"worker": w, "resources": resources,
                                  "bundle": bundle, "gpus": gpus}
        if gpus:
            spec = {**spec,
                    "accelerator_ids": {"GPU": self._gpus.ids_of(gpus)}}
        if lt is not None:
            # the worker records launch.callable_init under this ctx
            spec = {**spec, "_launch_trace": {
                "trace_id": lt.get("trace_id"),
                "parent_span_id": lt.get("parent_span_id")}}
        t_phase = self._launch_enter(lt, "become_actor")
        try:
            await w.conn.call("become_actor", spec=spec)
        except (rpc.RpcError, rpc.ConnectionLost) as e:
            await self._on_worker_death(w, f"actor init failed: {e}")
            raise RuntimeError(f"actor __init__ failed: {e}")
        self._launch_exit(lt, "become_actor", t_phase)
        self._launches_total += 1
        return {"worker_address": w.address, "worker_id": w.worker_id}

    async def h_dump_stacks(self, conn):
        """This node's live Python stacks: the node manager's own
        threads plus every connected worker's (the `ray_tpu_torch stack` fan-
        out point; reference: `ray stack` py-spy over local PIDs)."""
        from ray_tpu_torch._private.proc_util import format_thread_stacks
        from ray_tpu_torch.util import sanitizers
        out = {"node_manager": {"pid": os.getpid(),
                                "stacks": format_thread_stacks(),
                                "loop_stats": sanitizers.stats_snapshot()},
               "workers": {}}
        for wid, w in list(self.workers.items()):
            if w.conn is None or w.conn.closed or w.state == "dead":
                continue
            try:
                out["workers"][wid] = await asyncio.wait_for(
                    w.conn.call("dump_stacks"), 5.0)
            except Exception as e:
                out["workers"][wid] = {"error":
                                       f"{type(e).__name__}: {e}"}
        return out

    async def h_kill_worker(self, conn, worker_id: str, reason: str = ""):
        w = self.workers.get(worker_id)
        if w is None:
            return False
        w.state = "dead"
        if w.lease_id is not None:
            # releases the actor's resource reservation (lease id is the
            # actor-scoped key set in h_create_actor)
            self._release_lease(w.lease_id, worker_dead=True)
            w.lease_id = None
        if w.conn is not None and not w.conn.closed:
            try:
                await w.conn.call("exit", reason=reason, timeout=1.0)
            except Exception:
                pass
        await asyncio.sleep(0.1)
        self._kill_proc(w)
        self.workers.pop(worker_id, None)
        # leases this worker OWNED as a submitter (an actor that ran tasks,
        # such as a Data split coordinator): nobody returns them now
        self._release_owned_leases(worker_id)
        if w.actor_id is not None:
            # this handler removes the worker before the reaper can see
            # it die, so the actor-failure report (which drives restart
            # when max_restarts remain) must come from here
            try:
                await self.gcs.call("report_actor_failure",
                                    actor_id=w.actor_id,
                                    reason=f"worker killed: {reason}",
                                    worker_id=w.worker_id)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        return True

    # --------------------------------------------------------------- bundles
    def h_prepare_bundle(self, conn, pg_id: str, bundle_index: int,
                         resources: Dict[str, float]):
        if not scheduling_fits(self.available, resources):
            return False
        scheduling_sub(self.available, resources)
        self.bundles[(pg_id, bundle_index)] = {
            "resources": dict(resources), "available": dict(resources),
            "committed": False}
        return True

    def h_commit_bundle(self, conn, pg_id: str, bundle_index: int):
        b = self.bundles.get((pg_id, bundle_index))
        if b is not None:
            b["committed"] = True
        return True

    def h_return_bundle(self, conn, pg_id: str, bundle_index: int):
        b = self.bundles.pop((pg_id, bundle_index), None)
        if b is not None:
            scheduling_addback(self.available, b["resources"])
            self._wake_lease_waiters()
        return True

    # ------------------------------------------------------- object transfer
    # Push-based, reference-shaped (pull_manager.h:52, push_manager.h:30):
    # a "pull" is a request for the holder to PUSH — chunks stream one-way
    # with a bounded in-flight window instead of a request/response round
    # trip per chunk, and inbound transfers pass a node-wide byte-budget
    # admission gate so gang arg feeding can't blow out store memory.

    async def _node_addr(self, node_id: str) -> str:
        view = self.cluster_view.get(node_id)
        if view is None:
            self.cluster_view = await self.gcs.call("get_cluster_view")
            view = self.cluster_view.get(node_id)
        if view is None:
            raise RuntimeError(f"unknown node {node_id}")
        return view["address"]

    async def _pull_admit(self, size: int):
        cap = max(cfg.pull_inflight_bytes, size)   # one pull always fits
        while self._pull_bytes_inflight > 0 and \
                self._pull_bytes_inflight + size > cap:
            ev = asyncio.Event()
            self._pull_waiters.append(ev)
            await ev.wait()
        self._pull_bytes_inflight += size

    def _pull_release(self, size: int):
        self._pull_bytes_inflight -= size
        while self._pull_waiters:
            self._pull_waiters.popleft().set()

    async def h_pull_object(self, conn, oid: bytes, node_id: str):
        """Ensure `oid` is in the local store, requesting a push from the
        holder node (deduplicated; admission-controlled)."""
        if self.store.contains(oid):
            return True
        inflight = self._pulls_inflight.get(oid)
        if inflight is not None:
            return await asyncio.shield(inflight)
        fut = asyncio.get_event_loop().create_future()
        self._pulls_inflight[oid] = fut
        admitted = 0
        try:
            addr = await self._node_addr(node_id)
            meta = await self.pool.call(addr, "fetch_object", oid=oid,
                                        part="meta")
            if meta is None:
                raise RuntimeError(
                    f"{oid.hex()[:16]} not on node {node_id[:12]}")
            size = meta["data_size"]
            await self._pull_admit(size)
            admitted = size
            for attempt in (0, 1):    # one retry after a reaped receive
                if self.store.contains(oid):    # re-check post-admission
                    break
                done = asyncio.get_event_loop().create_future()
                self._recv_done[oid] = done
                try:
                    await self.pool.call(addr, "request_push", oid=oid,
                                         to_node=self.node_id)
                    if not self.store.contains(oid):
                        await asyncio.wait_for(done, timeout=300)
                    break
                except Exception:
                    if attempt:
                        raise
                finally:
                    self._recv_done.pop(oid, None)
            fut.set_result(True)
            return True
        except Exception as e:
            # do NOT abort the receive state here: a concurrent broadcast
            # may own it (push_begin "have" path); stale half-received
            # buffers are reaped by the idle sweep in _view_refresh_loop
            fut.set_exception(e)
            raise
        finally:
            if admitted:
                self._pull_release(admitted)
            self._pulls_inflight.pop(oid, None)
            if not fut.done():
                fut.cancel()

    async def h_request_push(self, conn, oid: bytes, to_node: str,
                             relay: Optional[List[str]] = None,
                             bcast: bool = False):
        """Holder side: stream `oid` to `to_node` with a bounded chunk
        window. `relay` rides along for tree broadcast — the receiver
        re-broadcasts to its half of the target list after sealing;
        `bcast` tags the transfer as part of a broadcast so arrival
        instrumentation fires on every node of the tree.

        Control plane (`push_begin`) negotiates over the RPC connection;
        chunk bytes move on the binary data plane when the peer
        advertises one (striped across the adaptive stream count — see
        data_plane.adaptive_streams), falling back to msgpack chunks on
        the RPC connection for peers that predate the data-plane
        advertisement."""
        if relay:
            # chaos: a relay node dying mid-subtree (the broadcast
            # root's await must surface this and retry via survivors)
            rpc._maybe_inject_failure("relay_push")
        buf = self.store.get(oid)
        if buf is None and oid in self.spilled:
            await self.h_restore_object(conn, oid)
            buf = self.store.get(oid)
        if buf is None:
            raise RuntimeError(f"{oid.hex()[:16]} not on this node")
        try:
            addr = await self._node_addr(to_node)
            view = self.cluster_view.get(to_node) or {}
            dp_addr = view.get("data_plane_address")
            peer = await self.pool.get(addr)
            size = len(buf.data)
            status = await peer.call("push_begin", oid=oid, data_size=size,
                                     meta=bytes(buf.metadata),
                                     relay=relay or [], bcast=bcast)
            if status == "full":
                raise RuntimeError(
                    f"receiver {to_node[:12]} has no room for "
                    f"{oid.hex()[:16]} ({size} bytes)")
            if status != "ok":
                return True     # receiver already has it (or is receiving)
            use_dp = (self._data_client is not None and dp_addr
                      and cfg.data_plane_enabled and size > 0)
            from ray_tpu_torch._private import events
            from ray_tpu_torch._private.data_plane import (DataPlaneError,
                                                     DataPlaneUnavailable)
            with events.record_span(
                    "store.transfer", category="store",
                    object_id=oid.hex()[:16], bytes=size,
                    to_node=to_node[:12], relay=len(relay or [])) as span:
                if use_dp:
                    try:
                        stripes = await self._data_client.push(
                            dp_addr, oid, buf.data, size)
                        span.set(path="data_plane", streams=len(stripes),
                                 stripe_bytes=stripes)
                        return True
                    except DataPlaneUnavailable as e:
                        # nothing moved; the negotiated receive state is
                        # still clean — downgrade to the msgpack path
                        logger.warning(
                            "data plane to %s unavailable (%s); falling "
                            "back to msgpack chunks", to_node[:12], e)
                        use_dp = False
                    except DataPlaneError:
                        # half-delivered: tell the receiver to reap its
                        # poisoned state NOW so parked pulls retry fast
                        try:
                            await peer.notify("push_abort", oid=oid)
                        except (rpc.ConnectionLost, rpc.RpcError):
                            pass
                        raise
                span.set(path="msgpack", streams=1, stripe_bytes=[size])
                await self._push_msgpack(peer, oid, buf, size, to_node)
            return True
        finally:
            buf.close()

    async def _push_msgpack(self, peer, oid: bytes, buf, size: int,
                            to_node: str):
        """Legacy chunk path: msgpack-framed chunks on the control-plane
        RPC connection (kept as the negotiation fallback for peers that
        advertise no data plane)."""
        chunk = cfg.transfer_chunk_bytes
        window = __import__("collections").deque()
        off = 0

        def _check(accepted):
            if accepted is False:
                raise RuntimeError(
                    f"receiver {to_node[:12]} aborted transfer of "
                    f"{oid.hex()[:16]} mid-stream")

        while off < size:
            n = min(chunk, size - off)
            f = peer.call_start_nowait(
                "push_chunk", {"oid": oid, "offset": off,
                               "data": bytes(buf.data[off:off + n])})
            window.append(f)
            off += n
            if len(window) >= cfg.push_window_chunks:
                _check(await window.popleft())
        for f in window:
            _check(await f)

    def h_push_begin(self, conn, oid: bytes, data_size: int, meta: bytes,
                     relay: Optional[List[str]] = None,
                     bcast: bool = False):
        """Receiver side: allocate the arena region for an incoming push.
        Status: "ok" (send chunks), "have" (already present/receiving),
        "full" (no arena room — the pusher must error, not silently skip).

        A weight-sized incoming object lands in a SPANNING arena
        allocation transparently (store.create routes by size), so the
        data plane's recv_into writes straight into the multi-stripe
        region — zero staging copies end to end."""
        if self.store.contains(oid) or oid in self._receiving:
            return "have"
        try:
            bufs = self.store.create(oid, data_size, len(meta))
        except MemoryError:
            # arena (or span window) exhausted even after eviction: the
            # documented "full" status, not a raw remote error
            return "full"
        if bufs is None:
            return "full"
        data, meta_view = bufs
        meta_view[:] = meta
        # `ctrl` is the pusher's control connection: if the pusher node
        # dies mid-stream, its disconnect reaps this receive immediately
        # (the 60s idle sweep stays as the backstop for silent stalls)
        self._receiving[oid] = {"data": data, "remaining": data_size,
                                "relay": list(relay or []),
                                "bcast": bool(bcast), "size": data_size,
                                "t0": time.monotonic(),
                                "ctrl": conn, "t": time.monotonic()}
        if data_size == 0:
            self._finish_receive(oid)
        return "ok"

    def h_push_chunk(self, conn, oid: bytes, offset: int, data: bytes):
        st = self._receiving.get(oid)
        if st is None or st.get("aborted"):
            return False
        st["t"] = time.monotonic()
        view = st["data"][offset:offset + len(data)]
        # big chunks land through the GIL-free native copy pool
        # (RAY_TPU_TORCH_PUT_COPY_THREADS) instead of a GIL-held slice assign
        if len(data) < (1 << 20) or not parallel_write(view,
                                                       memoryview(data)):
            view[:] = data
        st["remaining"] -= len(data)
        if st["remaining"] <= 0:
            # the LAST chunk's response resolves only after this node's
            # relay subtree completes — the broadcast root's await covers
            # the whole tree, and a subtree failure surfaces at the root
            return self._finish_receive(oid)
        return True

    def h_push_abort(self, conn, oid: bytes):
        """Pusher-initiated abort (its data-plane stream died half-way):
        reap the poisoned receive state so parked pulls retry at once."""
        st = self._receiving.get(oid)
        if st is None:
            return True
        st["aborted"] = True
        if not st.get("writers"):
            self._abort_receive(oid, "pusher aborted transfer mid-stream")
        return True

    def _abort_receive(self, oid: bytes, reason: str):
        """Drop a half-received object: free its unsealed arena buffer
        and fail pulls parked on it so they retry immediately."""
        self._receiving.pop(oid, None)
        try:
            self.store.abort(oid)
        except Exception:
            pass
        done = self._recv_done.get(oid)
        if done is not None and not done.done():
            done.set_exception(RuntimeError(
                f"push of {oid.hex()[:16]} failed: {reason}"))

    def _finish_receive(self, oid: bytes):
        st = self._receiving.pop(oid)
        self.store.seal(oid)
        # a transfer arrival extends the object's location set (size and
        # placement reconcile via the census; this makes the new copy
        # visible to `ray_tpu_torch memory` within a flush, not a census tick)
        ledger.record(oid, "location_add", node_id=self.node_id,
                      size=st.get("size", 0))
        if st.get("bcast"):
            # per-node arrival instrumentation: one instant per tree
            # node, carrying bytes + the relay fan-out it now owns
            try:
                from ray_tpu_torch._private import events
                dt = time.monotonic() - st.get("t0", st["t"])
                size = st.get("size", 0)
                events.record_instant(
                    "store.broadcast.arrival", category="store",
                    object_id=oid.hex()[:16], bytes=size,
                    recv_s=round(dt, 6),
                    gb_per_s=round(size / dt / 1e9, 3) if dt > 0 else None,
                    relay_targets=len(st["relay"]))
            except Exception:
                pass
        done = self._recv_done.get(oid)
        if done is not None and not done.done():
            done.set_result(True)
        if st["relay"]:
            relay_task = asyncio.ensure_future(
                self.h_broadcast_object(None, oid, st["relay"],
                                        bcast=st.get("bcast", False)))
            self._tasks.append(relay_task)
            relay_task.add_done_callback(
                lambda t: self._tasks.remove(t)
                if t in self._tasks else None)
            return relay_task
        return True

    async def h_broadcast_object(self, conn, oid: bytes,
                                 targets: List[str], bcast: bool = True):
        """Binomial-tree broadcast: push to the head of each half with the
        rest of that half delegated as `relay` — the source sends
        O(log n) copies instead of n (reference pattern:
        release object_store broadcast benchmarks; reference core is
        point-to-point only). A relay failure anywhere in the subtree
        propagates to this await (the completing chunk's ack defers past
        the subtree), so the broadcast root observes partial delivery
        and can retry via the surviving holders."""
        from ray_tpu_torch._private.data_plane import binomial_split
        targets = [t for t in targets if t != self.node_id]
        pushes = [self.h_request_push(None, oid, head, relay=rest,
                                      bcast=bcast)
                  for head, rest in binomial_split(targets)]
        results = await asyncio.gather(*pushes, return_exceptions=True)
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            raise errs[0]
        return True

    def h_has_object(self, conn, oid: bytes):
        """Cheap holder probe (no restore side effects): does this node
        hold `oid` sealed in its arena, or spilled on its disk? The
        broadcast retry path uses it to census survivors after a relay
        death."""
        return {"in_store": self.store.contains(oid),
                "spilled": oid in self.spilled}

    async def h_fetch_object(self, conn, oid: bytes, part: str = "meta",
                             offset: int = 0, length: int = 0):
        buf = self.store.get(oid)
        if buf is None and oid in self.spilled:
            await self.h_restore_object(conn, oid)
            buf = self.store.get(oid)
        if buf is None:
            return None
        try:
            if part == "meta":
                return {"data_size": len(buf.data), "meta": buf.metadata}
            return bytes(buf.data[offset:offset + length])
        finally:
            buf.close()

    # -------------------------------------------------------- object ledger
    def _ledger_census_payload(self) -> Optional[Dict]:
        """One arena census for the GCS object ledger: every sealed
        resident object's pins, size, and stripe/span placement, plus
        the spilled set. Runs on an executor thread (object_info takes
        one stripe lock per object). The census is the ledger's
        authority for the location set — LRU eviction and crash repair
        reclaim objects without any event firing, and this reconciles
        them."""
        if self.store is None:
            return None
        now = self.store.now_sec()
        objects = {}
        for oid in self.store.list_objects():
            info = self.store.object_info(oid)
            if info is None or not info["sealed"]:
                continue
            objects[oid.hex()] = {
                "pins": info["pins"],
                "size": info["data_size"] + info["meta_size"],
                "is_span": info["is_span"], "stripe": info["stripe"],
                "age_s": max(0, now - info["ctime_sec"])}
        return {"objects": objects,
                "spilled": [o.hex() for o in self.spilled]}

    async def _ledger_census_loop(self):
        loop = asyncio.get_event_loop()
        while True:
            interval = cfg.ledger_report_interval_s
            if interval <= 0 or not ledger.enabled():
                await asyncio.sleep(5.0)
                continue
            await asyncio.sleep(interval)
            try:
                census = await loop.run_in_executor(
                    None, self._ledger_census_payload)
                if census is not None:
                    await self.gcs.notify(
                        "update_object_ledger", census=census,
                        node_id=self.node_id)
            # rtlint: disable=RT004 — best-effort census on a fixed
            # cadence; the next tick re-reports the full arena state
            # (no data loss) and the heartbeat loop owns GCS reconnect
            except Exception:
                pass

    def h_ledger_evict_hint(self, conn, oids):
        """GCS leak sweep → this node: `oids` (hex) are leaked objects
        resident here. They are NOT reclaimed eagerly — the pressured-
        stripe spill pass consumes them first, so a false positive
        costs nothing unless the arena is actually short on bytes."""
        for o in oids or ():
            try:
                self._evict_hints.add(bytes.fromhex(o))
            except ValueError:
                pass
        return True

    def _consume_evict_hints(self, pressured: set, global_hot: bool) -> int:
        """Reclaim leaked objects from pressured stripes before spilling
        healthy ones: deleting a leaked object frees bytes with no disk
        IO, and nobody can read it again (owner gone, zero pins — the
        sweep re-verifies pins here in case it was re-pinned since
        flagging). Returns bytes freed."""
        if not self._evict_hints:
            return 0
        freed = 0
        for oid in list(self._evict_hints):
            try:
                info = self.store.object_info(oid)
            except OSError:   # store closed under shutdown race
                return freed
            if info is None:
                self._evict_hints.discard(oid)   # already gone
                continue
            if info["pins"]:
                continue
            if not global_hot and not info["is_span"] \
                    and info["stripe"] not in pressured:
                continue   # the hint waits for ITS stripe's pressure
            try:
                self.store.delete(oid)
            except Exception:
                continue
            self._evict_hints.discard(oid)
            nbytes = info["data_size"] + info["meta_size"]
            freed += nbytes
            ledger.record(oid, "evicted", node_id=self.node_id,
                          reason="leak_hint", size=nbytes)
        return freed

    # --------------------------------------------------------------- spilling
    async def _spill_loop(self):
        """The node-manager arena sweep: spill LRU sealed objects to disk
        under memory pressure (reference: LocalObjectManager spill through
        IO workers, src/ray/raylet/local_object_manager.h:110; here the
        daemon itself writes — the store is directly mapped, a read is a
        memcpy) and reap orphaned never-sealed creations. Pressure is
        tracked PER STRIPE via the lock-free stripe snapshots, so one hot
        stripe gets relieved before client creates are forced into inline
        eviction — the sweep contends only with that stripe's clients."""
        loop = asyncio.get_event_loop()
        while True:
            await asyncio.sleep(cfg.spill_check_interval_s)
            try:
                # disk writes run in a thread: a multi-hundred-MB pass must
                # not stall heartbeats (reference: dedicated IO workers,
                # local_object_manager.h)
                await loop.run_in_executor(
                    None, self._spill_pass,
                    cfg.spill_high_watermark, cfg.spill_low_watermark)
                await loop.run_in_executor(
                    None, self.store.gc_unsealed)
            except Exception:
                logger.exception("spill iteration failed")

    def _spill_pass(self, trigger_frac: float = 0.8,
                    target_frac: float = 0.6) -> int:
        """One spill pass (runs on an executor thread): write sealed
        objects to disk and delete them from the store until usage drops
        below target_frac. Returns the number of objects spilled."""
        with self._spill_mutex:
            return self._spill_pass_locked(trigger_frac, target_frac)

    def _spill_pass_locked(self, trigger_frac: float,
                           target_frac: float) -> int:
        import os as _os
        self._release_restored()
        st = self.store.stats()
        cap = st["capacity"] or 1
        nstripes = int(st.get("num_stripes") or 1)
        # Per-stripe accounting (lock-free snapshots): a single full
        # stripe must be relieved even while aggregate usage looks
        # healthy, or its clients' creates degrade into inline eviction.
        global_hot = st["bytes_in_use"] >= trigger_frac * cap
        if global_hot:
            pressured = list(range(nstripes))
        else:
            pressured = []
            for i in range(nstripes):
                ss = self.store.stripe_stats(i)
                if ss["bytes_in_use"] >= trigger_frac * (ss["capacity"] or 1):
                    pressured.append(i)
        if not pressured:
            return 0
        if not self._spill_remote:
            _os.makedirs(self.spill_dir, exist_ok=True)
        n = 0
        spilled_bytes = 0
        t0 = time.time()
        # leak hints first: reclaimed leaked bytes may relieve the
        # pressure before any healthy object pays disk IO
        hint_freed = self._consume_evict_hints(set(pressured), global_hot)
        # idle spanning objects next (ROADMAP item 4 leftover): spans
        # live outside every stripe's entry segment, so the per-stripe
        # walk below can NEVER reach them — before this pass a multi-GB
        # idle blob sat unspillable while its claimed stripes read as
        # 100% full forever. One span spill frees whole stripes at once,
        # so run it before any healthy per-stripe object pays disk IO.
        span_n = 0
        if global_hot:
            span_n, span_bytes = self._spill_idle_spans(
                _os, target_frac * cap)
            n += span_n
            spilled_bytes += span_bytes
            if span_n:
                st = self.store.stats()
                if st["bytes_in_use"] < target_frac * cap:
                    self._record_spill_span(t0, n, spilled_bytes, cap,
                                            len(pressured), hint_freed,
                                            span_n)
                    return n
        for si in pressured:
            for oid in self.store.list_stripe(si):
                freed = self._spill_one(oid, _os)
                if freed is None:
                    continue
                n += 1
                spilled_bytes += freed
                ss = self.store.stripe_stats(si)
                if ss["bytes_in_use"] < target_frac * (ss["capacity"] or 1):
                    break
            if global_hot:
                st = self.store.stats()
                if st["bytes_in_use"] < target_frac * cap:
                    break
        if n:
            self._record_spill_span(t0, n, spilled_bytes, cap,
                                    len(pressured), hint_freed, span_n)
        return n

    def _release_restored(self):
        """A copy restored from disk is created not-evictable, so that no
        create evicts it before its reader has read it. Once its
        RESTORE_GRACE_S has passed it is a droppable copy of an object
        already on disk: mark it evictable."""
        now = time.monotonic()
        for oid, t in list(self._restored_at.items()):
            if now - t < RESTORE_GRACE_S:
                continue
            self._restored_at.pop(oid, None)
            try:
                self.store.set_evictable(oid, True)
            except OSError:     # store closed under shutdown race
                return

    def _spill_for_create(self, need: int) -> int:
        """A create of ``need`` bytes found no hole and nothing it may
        evict: the store evicts only droppable copies, never a primary
        that was not spilled. Spill so that it can fit. The watermark pass
        runs first; when it frees nothing (a fragmented stripe below the
        watermark), spill sealed objects from the fullest stripe on until
        ``need`` bytes have left one stripe, idle or not. An object larger
        than a stripe needs whole stripes, so spanning objects go first.
        Returns the bytes freed; 0 means spilling frees nothing (what is
        left is pinned by readers) and the create fails."""
        import os as _os

        def in_use(si=None):
            st = self.store.stats() if si is None \
                else self.store.stripe_stats(si)
            return st["bytes_in_use"]
        with self._spill_mutex:
            before = in_use()
            self._spill_pass_locked(0.7, 0.5)
            if in_use() < before:
                return before - in_use()
            if not self._spill_remote:
                _os.makedirs(self.spill_dir, exist_ok=True)
            if need > self.store.max_alloc_bytes():
                self._spill_idle_spans(_os, min_idle_s=0.0)
                if in_use() < before:
                    return before - in_use()
            nstripes = int(self.store.stats().get("num_stripes") or 1)
            for used, si in sorted(((in_use(i), i) for i in range(nstripes)),
                                   reverse=True):
                for oid in self.store.list_stripe(si):
                    if self._spill_one(oid, _os) is not None and \
                            used - in_use(si) >= need:
                        break
                if in_use() < before:
                    break
            return max(0, before - in_use())

    def _record_spill_span(self, t0, n, spilled_bytes, cap, stripes,
                           hint_freed, span_n):
        # the span is recorded only for passes that moved something
        # — the 1s poll's no-op passes would be pure timeline noise
        from ray_tpu_torch._private import events
        st = self.store.stats()
        events.record_complete(
            "store.spill", t0, time.time(), category="store",
            objects=n, bytes=spilled_bytes,
            bytes_in_use=st["bytes_in_use"], capacity=cap,
            stripes=stripes, leak_hint_bytes=hint_freed,
            spans=span_n)

    def _spill_idle_spans(self, _os, target_bytes: float = 0.0,
                          min_idle_s: Optional[float] = None):
        """Spill idle spanning objects under GLOBAL pressure: sealed,
        zero pins, older than cfg.span_spill_min_idle_s. Global-only on
        purpose — a span's claimed stripes always read as full, so
        per-stripe pressure would spill every idle span on every sweep
        even in an otherwise empty arena; global bytes_in_use (which
        counts claimed stripes whole) is the signal that the normal
        allocator actually needs those stripes back. Whole-span delete
        frees every member stripe atomically; restore reloads through
        the ordinary size-aware create (spanning route included)."""
        n = freed = 0
        try:
            spans = self.store.list_spans()
        except OSError:
            return 0, 0
        if not spans:
            return 0, 0
        rows = []
        now = self.store.now_sec()
        for oid in spans:
            info = self.store.object_info(oid)
            if info is None or not info["sealed"] or info["pins"]:
                continue
            age = now - info["ctime_sec"]
            if age < (cfg.span_spill_min_idle_s if min_idle_s is None
                      else min_idle_s):
                continue
            rows.append((age, oid))
        rows.sort(reverse=True)           # oldest (idlest) first
        for _age, oid in rows:
            b = self._spill_one(oid, _os)
            if b is None:
                continue
            n += 1
            freed += b
            if target_bytes and \
                    self.store.stats()["bytes_in_use"] < target_bytes:
                break
        return n, freed

    def _spill_one(self, oid: bytes, _os) -> Optional[int]:
        """Spill one sealed object (or drop the resident copy of an
        already-spilled one). Returns bytes newly written to disk, or
        None if the object was skipped."""
        if oid in self.spilled:
            # already on disk (a restored copy) — just drop the resident
            # copy; the native store defers the delete if clients pin it.
            # A copy restored moments ago stays: its reader has not read
            # (pinned) it yet, and dropping it now loses the object for
            # that reader
            if time.monotonic() - self._restored_at.get(oid, -1e18) \
                    < RESTORE_GRACE_S:
                return None
            self._restored_at.pop(oid, None)
            self.store.delete(oid)
            self._spill_counts["dropped"] += 1
            ledger.record(oid, "location_remove", node_id=self.node_id,
                          reason="spill_drop")
            return 0
        buf = self.store.get(oid)
        if buf is None:
            return None
        try:
            meta = bytes(buf.metadata)
            nbytes = len(buf.data) + len(meta)
            if self._spill_remote:
                from ray_tpu_torch.util import storage as _storage
                path = _storage.join(self.spill_dir, oid.hex())
                _storage.write_bytes(
                    path, len(meta).to_bytes(8, "little") + meta
                    + bytes(buf.data))
            else:
                path = _os.path.join(self.spill_dir, oid.hex())
                with open(path, "wb") as f:
                    f.write(len(meta).to_bytes(8, "little"))
                    f.write(meta)
                    f.write(buf.data)
        finally:
            buf.close()
        self.spilled[oid] = path
        self.store.delete(oid)
        self._spill_counts["spilled"] += 1
        self._spill_counts["spilled_bytes"] += nbytes
        ledger.record(oid, "spilled", node_id=self.node_id, size=nbytes)
        return nbytes

    async def h_spill_now(self, conn, need: int = 0):
        """Spill under client-side memory pressure: a worker about to
        create a large object calls this so sealed LRU objects move to
        disk instead of being evicted (reference: plasma's
        CreateRequestQueue blocks creates while LocalObjectManager spills,
        create_request_queue.h). With ``need``, a create of that many
        bytes has failed: spill until it can fit (``_spill_for_create``).
        Returns the objects spilled."""
        if need:
            return await asyncio.get_event_loop().run_in_executor(
                None, self._spill_for_create, need)
        return await asyncio.get_event_loop().run_in_executor(
            None, self._spill_pass, 0.7, 0.5)

    async def h_restore_object(self, conn, oid: bytes):
        """Restore a spilled object into the store (reference:
        spilled_object_reader.cc restore path). File IO runs on an
        executor thread. An object the store cannot take (what is
        resident is pinned by readers, so spilling frees nothing) comes
        back to the reader as ``{"data", "meta"}`` instead: the
        counterpart of plasma's fallback allocation outside the arena."""
        return await asyncio.get_event_loop().run_in_executor(
            None, self._restore_sync, oid)

    def _restore_sync(self, oid: bytes):
        with self._restore_mutex:
            return self._restore_locked(oid)

    def _restore_locked(self, oid: bytes):
        if self.store.contains(oid):
            return True
        path = self.spilled.get(oid)
        if path is None:
            return False
        from ray_tpu_torch._private import events
        rspan = events.start_span("store.restore", category="store",
                                  object_id=oid.hex()[:16])
        try:
            if self._spill_remote:
                from ray_tpu_torch.util import storage as _storage
                raw = _storage.read_bytes(path)
                mlen = int.from_bytes(raw[:8], "little")
                meta, data = raw[8:8 + mlen], raw[8 + mlen:]
            else:
                with open(path, "rb") as f:
                    mlen = int.from_bytes(f.read(8), "little")
                    meta = f.read(mlen)
                    data = f.read()
            # make room by spilling, not by evicting un-spilled objects.
            # The copy is created not-evictable: no create may drop it
            # before its reader has read it (``_release_restored``)
            self._spill_pass(trigger_frac=0.7, target_frac=0.5)
            while True:
                try:
                    bufs = self.store.create(oid, len(data), len(meta),
                                             evictable=False)
                    break
                except MemoryError:
                    if self._spill_for_create(len(data) + len(meta)):
                        continue
                    self._spill_counts["restored_inline"] += 1
                    rspan.end(ok=True, bytes=len(data) + len(meta),
                              inline=True)
                    ledger.record(oid, "restored", node_id=self.node_id,
                                  size=len(data) + len(meta), inline=True)
                    return {"data": bytes(data), "meta": bytes(meta)}
            if bufs is None:
                rspan.end(ok=False, bytes=0)
                return False
            dview, mview = bufs
            import numpy as np
            np.frombuffer(dview, np.uint8)[:] = np.frombuffer(
                data, np.uint8)
            if meta:
                mview[:] = meta
            self.store.seal(oid)
            self._restored_at[oid] = time.monotonic()
            self._spill_counts["restored"] += 1
            self._spill_counts["restored_bytes"] += len(data) + len(meta)
            rspan.end(ok=True, bytes=len(data) + len(meta))
            ledger.record(oid, "restored", node_id=self.node_id,
                          size=len(data) + len(meta))
            return True
        except Exception:
            logger.exception("restore of %s failed", oid.hex()[:16])
            rspan.end(ok=False, error="restore_failed")
            return False

    def h_free_object(self, conn, oid: bytes):
        try:
            self.store.delete(oid)
        except Exception:
            pass
        path = self.spilled.pop(oid, None)
        self._restored_at.pop(oid, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass
        ledger.record(oid, "freed", node_id=self.node_id)
        self._evict_hints.discard(oid)
        return True

    async def h_free_remote_object(self, conn, oid: bytes, node_id: str):
        if node_id == self.node_id:
            return self.h_free_object(conn, oid)
        view = self.cluster_view.get(node_id)
        if view is not None and view.get("alive", True):
            try:
                await self.pool.call(view["address"], "free_object", oid=oid)
            except Exception:
                pass
        return True

    def h_get_node_info(self, conn):
        info = {"node_id": self.node_id, "address": self.address,
                "store_path": self.store_path, "total": self.total,
                "available": self._reported_available(),
                "num_workers": len(self.workers)}
        if self.store is not None:
            st = self.store.stats()
            info["store"] = {"bytes_in_use": st["bytes_in_use"],
                             "num_objects": st.get("num_objects"),
                             "capacity": st.get("capacity"),
                             "num_stripes": st.get("num_stripes"),
                             "num_spans": st.get("num_spans"),
                             "spilled_objects": len(self.spilled),
                             "evict_hints": len(self._evict_hints),
                             "num_evictions": st.get("num_evictions"),
                             "bytes_evicted": st.get("bytes_evicted"),
                             **self._spill_counts}
            # per-stripe live/free/largest-hole + span residency: the
            # machine-readable occupancy view (`ray_tpu_torch memory --nodes`,
            # dashboard /api/memory)
            try:
                info["store"]["fragmentation"] = self.store.fragmentation()
            except Exception:
                pass
        if self._data_server is not None:
            info["data_plane"] = {
                "address": self.data_plane_address,
                "bytes_in": self._data_server.bytes_in,
                "chunks_in": self._data_server.chunks_in,
                "bytes_out": self._data_client.bytes_out,
                "chunks_out": self._data_client.chunks_out,
                "active_conns": self._data_server.active_conns,
                "receiving": len(self._receiving)}
        return info


# thin aliases so the handler bodies read clearly
scheduling_fits = scheduling.fits
scheduling_sub = scheduling.subtract
scheduling_addback = scheduling.add_back


def scheduling_pick(view, resources, sched_opts, self_node_id):
    return scheduling.pick_node(view, resources,
                                strategy=sched_opts.get("strategy", "DEFAULT"),
                                preferred_node=self_node_id,
                                strategy_args=sched_opts)


def scheduling_feasible_anywhere(view, resources, self_total):
    if scheduling.feasible(self_total, resources):
        return True
    return any(scheduling.feasible(v["total"], resources)
               for v in view.values() if v.get("alive", True))


def main():
    import argparse
    import json
    from ray_tpu_torch._private.proc_util import set_pdeathsig_from_env
    set_pdeathsig_from_env()
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--session-name", default="session")
    parser.add_argument("--store-bytes", type=int, default=0)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--gcs-address-source", default=None,
                        help="GCS persist path/URI whose published "
                             "address is re-read on reconnect (GCS-FT)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[node] %(asctime)s %(levelname)s %(message)s")

    async def run():
        from ray_tpu_torch._private import loop_watch
        from ray_tpu_torch.util import sanitizers
        sanitizers.maybe_install()
        loop_watch.install("node manager")
        nm = NodeManager(gcs_address=args.gcs_address, node_id=args.node_id,
                         resources=json.loads(args.resources),
                         labels=json.loads(args.labels),
                         session_name=args.session_name,
                         store_bytes=args.store_bytes, port=args.port,
                         gcs_address_source=args.gcs_address_source)
        addr = await nm.start()
        print(f"NODE_ADDRESS={addr}", flush=True)
        print(f"NODE_ID={nm.node_id}", flush=True)
        print(f"STORE_PATH={nm.store_path}", flush=True)
        # a terminated node manager must reap its workers (a default
        # SIGTERM kills the nm mid-flight, orphaning the pool)
        stop_evt = asyncio.Event()
        loop = asyncio.get_running_loop()
        import signal as _signal
        for s in (_signal.SIGTERM, _signal.SIGINT):
            try:
                loop.add_signal_handler(s, stop_evt.set)
            except (NotImplementedError, OSError):
                pass
        await stop_evt.wait()
        from ray_tpu_torch._private import blackbox as _blackbox
        _blackbox.seal("sigterm")
        await asyncio.wait_for(nm.stop(), timeout=5)

    try:
        asyncio.run(run())
    except (KeyboardInterrupt, asyncio.TimeoutError):
        pass


if __name__ == "__main__":
    main()
