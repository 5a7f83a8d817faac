"""CoreWorker — the in-process runtime linked into every driver and worker.

Re-design of the reference's CoreWorker (reference:
src/ray/core_worker/core_worker.h:271, core_worker.cc — Put :1245, Get :1550,
SubmitTask :2165, SubmitActorTask :2488) and its transport layer
(transport/normal_task_submitter.h:75, actor_task_submitter.h:75,
task_receiver.h:51). Differences, deliberately:

- One asyncio loop per process is the only event engine (the reference runs
  multiple dedicated C++ io_services + a fiber layer). Sync user code runs in
  executor threads; the public API bridges with run_coroutine_threadsafe.
- Worker↔worker task push is a plain RPC *call* whose response carries the
  task's results, so pipelining = concurrent calls on one ordered connection
  (the reference needs explicit seq-nos + reply callbacks).
- The lease protocol is kept (amortizes scheduling like the reference's
  NormalTaskSubmitter lease cache) but leases are granted by the node
  manager over the caller's persistent connection, and spillback is a
  redirect reply rather than a raylet-internal hop.
- Objects: small values live in the owner's memory store and are served to
  borrowers over owner RPC; large values are sealed into the node-local shm
  arena (object_store.py) and fetched node-to-node via the node managers.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import hashlib
import heapq
import itertools
import logging
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import ids, ledger, rpc, serialization
from ray_tpu_torch._private.config import cfg
from ray_tpu_torch._private.markers import off_loop
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import ObjectStoreClient
from ray_tpu_torch._private.proc_util import runtime_dir
from ray_tpu_torch._private.serialization import (ActorDiedError, ObjectLostError,
                                            TaskCancelledError, TaskError,
                                            WorkerCrashedError)

logger = logging.getLogger(__name__)

DRIVER = "driver"
WORKER = "worker"

# tunables live in config.py (lease_idle_timeout_s, task_max_retries,
# max_dispatchers_per_sig, actor_restart_probe_s)


def _import_ref(ref: str):
    """Resolve a cross-language "module:attr" reference."""
    import importlib
    mod_name, sep, attr = ref.partition(":")
    if not sep or not attr:
        raise ValueError(f"bad cross-language ref {ref!r}; "
                         f"expected 'module:attr'")
    target = importlib.import_module(mod_name)
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def _chaos_env_changed(keys):
    """A runtime env set or restored these variables: where one is a
    fault-injection spec (``RAY_TPU_TORCH_TESTING_*``), the RPC layer,
    which parses its spec once per process, parses it anew at its next
    check, so a spec that reaches an actor through its runtime_env arms
    that actor's process."""
    if any(k.startswith("RAY_TPU_TORCH_TESTING_") for k in keys):
        rpc._CHAOS_SPEC = None


def _encode_arg(arg, ref_hook, core=None) -> list:
    if isinstance(arg, ObjectRef):
        if ref_hook is not None:
            ref_hook(arg)
        return ["r", arg.id, arg.owner_address]
    s = serialization.serialize(arg, ref_hook=ref_hook)
    if core is not None and core.store is not None and not s.is_inline():
        # Large argument: seal it into the local shm arena on THIS thread
        # and pass by reference (the reference promotes >100KB args to
        # plasma the same way, put_arg path). The payload stays out of
        # every RPC frame it would otherwise ride — GCS actor specs,
        # per-retry task pushes — and its copy never occupies the owner
        # loop. The implicit ref is pinned like any explicit ref arg for
        # the task's duration via ref_hook.
        core._spill_pressure_sync(s)
        ref = core._put_serialized(s)
        if ref_hook is not None:
            ref_hook(ref)
        return ["r", ref.id, ref.owner_address]
    kind, pkl, bufs = s.to_wire()
    return ["v", kind, pkl, bufs]


class _InlineBridgeError(BaseException):
    """Raised when inline-executed task code calls a blocking sync API
    (which bridges onto the event loop it is already running on).
    BaseException so user-level `except Exception` can't swallow it and
    complete the task with wrong results."""


# execution-thread context: which method is running (bridge-use tracking)
_exec_tls = threading.local()

# (trace_id, span_id) of the task running on the current loop context —
# async actor methods execute as coroutines, where a contextvar is the
# per-task store; sync methods run on executor threads and use _exec_tls
_trace_ctx: "contextvars.ContextVar" = __import__(
    "contextvars").ContextVar("ray_tpu_trace", default=None)


class PendingTask:
    __slots__ = ("spec", "return_ids", "retries_left", "arg_refs", "done",
                 "cancelled", "current_worker", "seq")

    def __init__(self, spec, return_ids, retries_left, arg_refs):
        self.spec = spec
        self.return_ids = return_ids
        self.retries_left = retries_left
        self.arg_refs = arg_refs
        self.done = False
        self.cancelled = False
        self.current_worker = None
        self.seq = 0          # per-actor submission order (actor tasks)


class Lease:
    __slots__ = ("lease_id", "worker_address", "node_address", "signature",
                 "last_used", "resource_ids")

    def __init__(self, lease_id, worker_address, node_address, signature,
                 resource_ids=None):
        self.lease_id = lease_id
        self.worker_address = worker_address
        self.node_address = node_address
        self.signature = signature
        self.last_used = time.monotonic()
        self.resource_ids = resource_ids or {}


class ActorHandleState:
    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.state = "PENDING_CREATION"
        self.address: Optional[str] = None
        self.ready = asyncio.Event()
        self.death_cause: Optional[str] = None
        # submission-ordered pipeline: fresh sends carry a sequence
        # number; retries of in-flight calls that died with a connection
        # re-enter by seq AHEAD of later submissions (the reference keeps
        # the same guarantee with explicit seq-nos,
        # sequential_actor_submit_queue.cc)
        self.pending = __import__("collections").deque()
        self.retry: list = []          # heap of (seq, PendingTask)
        self.work = asyncio.Event()
        self.seq_counter = 0
        self.sender: Optional[asyncio.Task] = None
        # refs to the creation arguments this process put into the store
        # (large ones): held until the actor is dead, since __init__ reads
        # them at creation and again at every restart
        self.init_arg_refs: list = []


class CoreWorker:
    """Async runtime. All methods ending in _async run on self.loop."""

    def __init__(self, mode: str, gcs_address: str, node_address: str,
                 store_path: str, node_id: str, job_id: int = 0,
                 namespace: str = "default", worker_id: Optional[str] = None):
        self.mode = mode
        self.gcs_address = gcs_address
        self.node_address = node_address
        self.node_id = node_id
        self.job_id = job_id
        self.namespace = namespace
        self.worker_id = worker_id or os.urandom(16).hex()
        self.store = ObjectStoreClient(store_path) if store_path else None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.address: Optional[str] = None

        # Amortized spill-pressure probe state: capacity is cached at
        # attach, bytes_in_use is refreshed every spill_probe_interval_puts
        # puts (or on MemoryError); between refreshes this worker accounts
        # its own put bytes locally so a burst of large puts still trips
        # the check. Avoids a per-put cross-process store.stats() call.
        self._spill_capacity: Optional[int] = None
        self._spill_bytes_in_use = 0
        self._spill_local_bytes = 0
        self._spill_probe_left = 0

        self.gcs: Optional[rpc.Connection] = None
        self.node_conn: Optional[rpc.Connection] = None
        self.pool = rpc.ConnectionPool(name=f"w-{self.worker_id[:8]}")
        self.server: Optional[rpc.Server] = None

        # object state
        self.memory_store: Dict[bytes, tuple] = {}   # oid -> ("wire",k,p,b)|("loc",node_id)|("shm",)
        self.object_events: Dict[bytes, asyncio.Event] = {}
        self.owned: Dict[bytes, Dict] = {}
        self.borrowed_counts: Dict[bytes, int] = {}
        self._local_refs: Dict[bytes, int] = {}
        self._pending_unrefs: List[bytes] = []
        # put ids are drawn on the CALLING thread (off-loop put path);
        # itertools.count is a single C-level op, safe under the GIL
        self._put_counter = itertools.count(1)
        # guards read-modify-write of _local_refs / borrowed_counts —
        # ObjectRef hooks fire from user threads, executor threads and
        # the loop alike
        self._ref_lock = threading.Lock()

        # tasks
        self.pending_tasks: Dict[bytes, PendingTask] = {}
        # streaming generators: owner-side live generators by task id;
        # executor-side flow-control windows by task id (+ tombstones for
        # closes that raced ahead of execution)
        self._generators: Dict[bytes, object] = {}
        self._gen_flow: Dict[bytes, Dict] = {}
        self._gen_tombstones: set = set()
        # LRU of live function objects (closures can capture large
        # arrays; evicted entries reload from _func_blobs / GCS KV)
        self._func_cache = __import__("collections").OrderedDict()
        self._func_cache_cap = 512
        # byte-capped LRU of shipped function pickles (served to executors
        # if the GCS KV copy is lost to a restart; eviction only risks the
        # rare restart-from-stale-snapshot window, while an unbounded dict
        # would grow with every distinct closure a long-lived driver ships)
        self._func_blobs: "__import__('collections').OrderedDict" = \
            __import__("collections").OrderedDict()
        self._func_blob_bytes = 0
        self._func_blob_cap = 256 * 1024 * 1024

        # leases
        self._idle_leases: Dict[tuple, List[Lease]] = {}
        self._lease_reaper: Optional[asyncio.Task] = None
        self._sig_queues: Dict[tuple, Dict] = {}   # per-signature dispatch

        # actor handles (submission side)
        self.actor_handles: Dict[str, ActorHandleState] = {}

        # execution side
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec")
        self._exec_queue: Optional[asyncio.Queue] = None
        self._consumers: List[asyncio.Task] = []
        self._group_queues: Dict[str, asyncio.Queue] = {}
        self._method_groups: Dict[str, str] = {}
        self.actor_instance = None
        self.actor_id: Optional[str] = None
        self.actor_spec: Optional[Dict] = None
        self.current_task_name: Optional[str] = None
        self.current_task_id: Optional[bytes] = None
        # trace root (reference: tracing_helper.py:34 — spans wrap
        # remote calls with the context riding in task metadata). The
        # ACTIVE context lives in _exec_tls / _trace_ctx, not here:
        # multi-consumer workers run tasks concurrently and instance
        # attributes would cross-contaminate their traces
        self._root_trace_id = os.urandom(8).hex()
        self._orig_visible: Dict[str, Optional[str]] = {}
        self._visible_dirty: set = set()
        self._cancelled_tasks: set = set()
        self._exec_ema: Dict[str, float] = {}   # method -> avg duration
        self._exec_streak: Dict[str, int] = {}  # consecutive fast runs
        self._inline_ok = True    # off for max_concurrency>1 actors
        self._inline_unsafe: set = set()   # methods seen using sync APIs
        self._loop_thread_ident: Optional[int] = None
        self._shutdown = False
        # every fire-and-forget coroutine is tracked here so stop_async can
        # cancel-and-await it — shutdown must leave zero pending tasks
        # (the asyncio analogue of the reference's tsan-clean shutdown)
        self._bg: set = set()
        # submissions from user threads coalesce here: N bursts become one
        # loop wakeup instead of N call_soon_threadsafe socketpair writes
        self._submit_buf: List[tuple] = []
        self._submit_scheduled = False
        self._submit_lock = threading.Lock()

    @off_loop(lock="_submit_lock")
    def _enqueue_submit(self, fn, *args):
        with self._submit_lock:
            self._submit_buf.append((fn, args))
            if self._submit_scheduled:
                return
            self._submit_scheduled = True
        try:
            self.loop.call_soon_threadsafe(self._drain_submits)
        except BaseException:
            # loop closing: reset so later submits fail loudly here
            # instead of queueing behind a flag nobody will drain
            with self._submit_lock:
                self._submit_scheduled = False
            raise

    def _drain_submits(self):
        while True:
            with self._submit_lock:
                buf, self._submit_buf = self._submit_buf, []
                if not buf:
                    self._submit_scheduled = False
                    return
            for fn, args in buf:
                try:
                    fn(*args)
                except Exception:
                    logger.exception("deferred submit failed")

    def _spawn(self, coro) -> "asyncio.Task":
        t = asyncio.ensure_future(coro)
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)
        return t

    # -------------------------------------------------------------- startup
    async def start_async(self):
        handlers = {
            "push_task": self.h_push_task,
            "push_tasks": self.h_push_tasks,
            "push_task_streaming": self.h_push_task_streaming,
            "generator_ack": self.h_generator_ack,
            "generator_close": self.h_generator_close,
            "become_actor": self.h_become_actor,
            "wait_object": self.h_wait_object,
            "cancel_task": self.h_cancel_task,
            "add_borrow": self.h_add_borrow,
            "fetch_function": self.h_fetch_function,
            "remove_borrow": self.h_remove_borrow,
            "object_located": self.h_object_located,
            "exit": self.h_exit,
            "dump_stacks": self.h_dump_stacks,
            "ping": lambda conn: "pong",
        }
        self.loop = asyncio.get_event_loop()
        self._loop_thread_ident = threading.get_ident()
        self.server = rpc.Server(handlers, name=f"worker-{self.worker_id[:8]}")
        self.address = await self.server.listen_tcp("0.0.0.0", 0)
        self.gcs = await rpc.connect(self.gcs_address,
                                     handlers={"pubsub": self.h_pubsub},
                                     name="->gcs", retries=10)
        try:
            cfg.apply(await self.gcs.call("get_system_config") or {})
        except rpc.RpcError:
            pass   # older GCS without the handler
        # one head-side ledger_enabled governs the cluster; identity is
        # pinned so flushes from executor threads never guess it
        ledger.set_enabled(cfg.ledger_enabled)
        ledger.set_identity(node_id=self.node_id, worker_id=self.worker_id)
        if self.node_address:
            self.node_conn = await rpc.connect(
                self.node_address, handlers={
                    "pubsub": self.h_pubsub,
                    "free_object": self.h_free_object,
                    "become_actor": self.h_become_actor,
                    "exit": self.h_exit,
                    "dump_stacks": self.h_dump_stacks,
                }, name="->node", retries=10)
            await self.node_conn.call(
                "register_worker", worker_id=self.worker_id,
                address=self.address, pid=os.getpid(), mode=self.mode)
            if self.mode == WORKER:
                # fate-sharing with the node manager (reference: workers die
                # when their raylet dies)
                def _nm_lost(_conn):
                    logger.warning("node manager connection lost; exiting")
                    os._exit(1)
                self.node_conn.on_close = _nm_lost
        self._exec_queue = asyncio.Queue()
        self._consumers = [self._spawn(self._exec_consumer())]
        self._lease_reaper = self._spawn(self._reap_leases())
        self._task_events: List[Dict] = []
        self._task_events_dropped = 0
        self._ev_window_t0 = 0.0
        self._ev_window_n = 0
        self._ev_budget = 10**9   # refreshed from cfg each window
        self._event_flusher = self._spawn(self._flush_task_events())
        self._install_ref_hooks()
        self._subscribed_actor_channel = False
        self._subscribed_channels = set()
        self._gcs_reconnect_lock = None   # created lazily on the loop
        if (self.mode == DRIVER
                and os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0"):
            self._subscribed_channels.add("LOGS")
            await self.gcs.call("subscribe", channel="LOGS")

    def _install_ref_hooks(self):
        loop = self.loop

        def local_ref(ref: ObjectRef):
            # fires from any thread (refs are created on caller threads)
            with self._ref_lock:
                self._local_refs[ref.id] = self._local_refs.get(ref.id, 0) + 1

        def local_unref(ref: ObjectRef):
            # may fire from any thread / late interpreter shutdown
            try:
                loop.call_soon_threadsafe(self._dec_local_ref, ref.id,
                                          ref.owner_address)
            except Exception:
                pass

        def deser_hook(ref: ObjectRef):
            with self._ref_lock:
                self._local_refs[ref.id] = self._local_refs.get(ref.id, 0) + 1
                first_borrow = False
                if ref.owner_address and ref.owner_address != self.address:
                    cnt = self.borrowed_counts.get(ref.id, 0)
                    first_borrow = cnt == 0
                    self.borrowed_counts[ref.id] = cnt + 1
            if first_borrow:
                asyncio.run_coroutine_threadsafe(self._send_borrow(ref), loop)

        ObjectRef._local_ref_hook = staticmethod(local_ref)
        ObjectRef._local_unref_hook = staticmethod(local_unref)
        ObjectRef._deserialization_hook = staticmethod(deser_hook)

    async def _send_borrow(self, ref: ObjectRef):
        try:
            await self.pool.call(ref.owner_address, "add_borrow",
                                 oid=ref.id, borrower=self.address)
        except Exception:
            pass

    def _dec_local_ref(self, oid: bytes, owner_address: str):
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
        if oid in self.owned:
            self._maybe_free(oid)
        elif owner_address and owner_address != self.address:
            with self._ref_lock:
                cnt = self.borrowed_counts.pop(oid, 0)
            if cnt > 0:
                self._spawn(self._send_remove_borrow(oid, owner_address))
            self.memory_store.pop(oid, None)

    async def _send_remove_borrow(self, oid, owner_address):
        try:
            await self.pool.call(owner_address, "remove_borrow",
                                 oid=oid, borrower=self.address)
        except Exception:
            pass

    def _maybe_free(self, oid: bytes):
        entry = self.owned.get(oid)
        if entry is None:
            return
        if (self._local_refs.get(oid, 0) == 0 and not entry["borrowers"]
                and entry.get("submitted", 0) == 0 and entry.get("complete", True)):
            self.owned.pop(oid, None)
            self.memory_store.pop(oid, None)
            self.object_events.pop(oid, None)
            entry.pop("contained", None)  # drops nested refs -> their unrefs
            loc = entry.get("location")
            if ledger.enabled() and entry.get("complete"):
                # the owner released its last reference: close the
                # object's provenance row (leak sweep skips freed rows)
                ledger.record(oid, "freed", node_id=loc)
            if loc == self.node_id and self.store is not None:
                try:
                    self.store.delete(oid)
                except Exception:
                    pass
            elif loc is not None:
                self._spawn(self._free_remote(oid, loc))

    async def _free_remote(self, oid: bytes, node_id: str):
        try:
            await self.node_conn.notify("free_remote_object", oid=oid,
                                        node_id=node_id)
        except Exception:
            pass

    # ------------------------------------------------------------ task events
    def _record_task_event(self, task_id: bytes, state: str, **extra):
        """Buffered task state transitions, flushed to the GCS task-event
        sink. Bounded two ways: a size cap (old events drop rather than
        letting the buffer grow without limit — reference:
        TaskEventBuffer max size + dropped counter,
        task_event_buffer.h:220) and a RATE budget — past
        cfg.task_events_per_s the recorder keeps only a deterministic
        1-in-8 sample keyed by task id, so every process samples the
        SAME tasks and sampled rows still get all their states (the
        timeline stays representative instead of eating ~3 events/call
        of control-plane CPU at full throughput)."""
        now = time.monotonic()
        if now - self._ev_window_t0 >= 1.0:
            self._ev_window_t0 = now
            self._ev_window_n = 0
            self._ev_budget = cfg.task_events_per_s
        self._ev_window_n += 1
        if self._ev_window_n > self._ev_budget and task_id[-1] & 7:
            self._task_events_dropped += 1
            return
        ev = self._task_events
        if len(ev) >= 10000:
            del ev[:5000]
            self._task_events_dropped += 5000
        ev.append({"task_id": task_id.hex(), "state": state,
                   "ts": time.time(), **extra})

    async def _flush_task_events(self):
        while not self._shutdown:
            await asyncio.sleep(1.0)
            if not self._task_events or self.gcs is None or self.gcs.closed:
                continue
            batch, self._task_events = self._task_events, []
            try:
                await self.gcs.notify("add_task_events", events=batch)
            except Exception:
                # the batch is gone — account it so the observability
                # plane shows the gap instead of looking quietly healthy
                self._task_events_dropped += len(batch)


    async def _reconnect_gcs(self):
        """Re-establish the GCS connection after a GCS restart and
        re-subscribe (reference: NotifyGCSRestart + client reconnection,
        node_manager.proto:383, gcs_client_reconnection_test.cc).
        Serialized: concurrent failed callers piggyback on one reconnect
        instead of racing N connections (and N pubsub registrations)."""
        if self._gcs_reconnect_lock is None:
            self._gcs_reconnect_lock = asyncio.Lock()
        async with self._gcs_reconnect_lock:
            if self.gcs is not None and not self.gcs.closed:
                return   # a concurrent caller already reconnected
            if self._shutdown:
                raise rpc.ConnectionLost("worker is shutting down")
            logger.warning("GCS connection lost; reconnecting")
            self.gcs = await rpc.connect(self.gcs_address,
                                         handlers={"pubsub": self.h_pubsub},
                                         name="->gcs", retries=30)
            for ch in sorted(self._subscribed_channels):
                try:
                    await self.gcs.call("subscribe", channel=ch)
                except Exception:
                    logger.exception("resubscribe %s failed", ch)

    async def gcs_call_async(self, method, **kw):
        """GCS call that survives one GCS restart (drivers buffer through
        a restart instead of failing)."""
        try:
            return await self.gcs.call(method, **kw)
        except (rpc.ConnectionLost, ConnectionError):
            await self._reconnect_gcs()
            return await self.gcs.call(method, **kw)

    # -------------------------------------------------- ownership bookkeeping
    @off_loop(lock="_ref_lock")
    def _register_owned(self, oid: bytes, lineage=None, complete=False,
                        contained=None):
        """Publish a fully-built owned entry in ONE dict store. Callers run
        on user threads as well as the loop (off-loop puts, threadsafe task
        submission); a single assignment is atomic under the GIL, so
        loop-side readers never observe a half-initialized entry."""
        entry = {"borrowers": set(), "submitted": 0,
                 "lineage": lineage, "location": None,
                 "complete": complete}
        if contained is not None:
            entry["contained"] = contained
        # rtlint: disable=RT003 — single GIL-atomic publish of a fully
        # built entry (see docstring); taking _ref_lock here would put a
        # lock on every put's hot path for no added safety
        self.owned[oid] = entry
        return entry

    def h_add_borrow(self, conn, oid: bytes, borrower: str):
        entry = self.owned.get(oid)
        if entry is not None:
            entry["borrowers"].add(borrower)
        return True

    def h_remove_borrow(self, conn, oid: bytes, borrower: str):
        entry = self.owned.get(oid)
        if entry is not None:
            entry["borrowers"].discard(borrower)
            self._maybe_free(oid)
        return True

    def h_object_located(self, conn, oid: bytes, node_id: str):
        entry = self.owned.get(oid)
        if entry is not None:
            entry["location"] = node_id
        return True

    # ----------------------------------------------------------------- put
    # The put hot path runs ENTIRELY on the calling thread (reference:
    # plasma writes happen on the caller with pickle-5 out-of-band buffers,
    # ray paper §4.2): cloudpickle serialization, the spill-pressure check,
    # store.create, the (GIL-free, chunked) arena copy and seal never touch
    # the owner event loop. The loop is only involved for the rare blocking
    # spill RPC and for waking any asyncio waiters on the object event.
    @off_loop(lock="_ref_lock")
    def put_local(self, value) -> ObjectRef:
        """Synchronous put (callable from user threads AND from task code
        executing inline on the loop — nothing here blocks on the loop)."""
        s = serialization.serialize(value)
        self._spill_pressure_sync(s)
        return self._put_serialized(s)

    async def put_async(self, value) -> ObjectRef:
        s = serialization.serialize(value)
        await self._spill_pressure_async(s)
        return self._put_serialized(s)

    @off_loop(lock="_ref_lock")
    def _put_serialized(self, s: serialization.SerializedObject) -> ObjectRef:
        task_id = ids.new_task_id(ids.job_id_from_int(self.job_id))
        oid = ids.object_id_for_put(task_id, next(self._put_counter))
        # pin objects referenced from inside the stored value for the stored
        # value's lifetime (the reference pins nested refs the same way,
        # reference_count.h AddNestedObjectIds)
        self._register_owned(oid, complete=True,
                             contained=list(s.contained_refs))
        self._store_serialized(oid, s)
        return ObjectRef(oid, self.address)

    @off_loop(lock="_ref_lock")
    def _refresh_spill_probe(self) -> None:  # rtlint: disable=RT003 — amortized probe: a racing refresh only re-reads store stats; fields are advisory
        """Re-read store usage for the spill-pressure check (the native
        read is a lock-free seqlock snapshot, but even the ctypes hop is
        too much per put — so it runs every N puts, not every put)."""
        st = self.store.stats()
        self._spill_capacity = st["capacity"]
        self._spill_bytes_in_use = st["bytes_in_use"]
        self._spill_local_bytes = 0
        self._spill_probe_left = cfg.spill_probe_interval_puts

    @off_loop(lock="_ref_lock")
    def _needs_spill(self, s: serialization.SerializedObject) -> bool:
        """Under memory pressure, spill sealed objects to disk before this
        create LRU-evicts them irrecoverably (reference: plasma creates
        wait on spilling, create_request_queue.h). The probe is amortized:
        capacity is cached at first use and bytes_in_use refreshed every
        spill_probe_interval_puts puts, with this worker's own put bytes
        accounted locally in between."""
        if s.is_inline() or self.store is None or self.node_conn is None:
            return False
        try:
            size = s.data_size()
            cap = self._spill_capacity
            if cap is None or self._spill_probe_left <= 0 or \
                    self._spill_local_bytes > 0.1 * (cap or 1):
                self._refresh_spill_probe()
                cap = self._spill_capacity
            self._spill_probe_left -= 1
            self._spill_local_bytes += size
            est = self._spill_bytes_in_use + self._spill_local_bytes
            return bool(cap) and est + size > 0.7 * cap
        except Exception:
            return False

    def _spill_pressure_sync(self, s: serialization.SerializedObject):
        if not self._needs_spill(s):
            return
        try:
            if threading.get_ident() == self._loop_thread_ident:
                # on the loop (inline-executed task code): blocking on our
                # own loop would deadlock — kick the spill and let this
                # create ride LRU eviction if it still can't fit
                self._spawn(self.node_conn.call("spill_now"))
            else:
                asyncio.run_coroutine_threadsafe(
                    self.node_conn.call("spill_now"), self.loop).result()
        except Exception:
            pass

    async def _spill_pressure_async(self, s: serialization.SerializedObject):
        if not self._needs_spill(s):
            return
        try:
            await self.node_conn.call("spill_now")
        except Exception:
            pass

    def _create_with_spill_retry(self, oid: bytes, data_size: int,
                                 meta_size: int):
        """store.create of a primary copy, with spilling as the way to
        room: the copy is created not-evictable (the store's in-create
        eviction drops only secondary copies and copies already on disk,
        never a primary that was not spilled), and an arena-full
        MemoryError asks the node manager to spill until this create fits
        (``spill_now(need=)``), then retries. The create fails only when
        spilling frees nothing, so workloads larger than the object store
        (streaming shuffle sub-blocks) land via spill instead of falling
        back to unbounded worker-heap copies."""
        need = data_size + meta_size
        for _ in range(64):
            try:
                return self.store.create(oid, data_size, meta_size,
                                         evictable=False)
            except MemoryError:
                # arena full: the cached pressure snapshot is clearly stale
                try:
                    self._refresh_spill_probe()
                except Exception:
                    pass
                if self.node_conn is None:
                    raise
                if threading.get_ident() == self._loop_thread_ident:
                    # executing ON the loop: blocking would deadlock —
                    # kick the spill and retry once
                    self._spawn(self.node_conn.call("spill_now", need=need))
                    return self.store.create(oid, data_size, meta_size,
                                             evictable=False)
                freed = asyncio.run_coroutine_threadsafe(
                    self.node_conn.call("spill_now", need=need),
                    self.loop).result(timeout=120)
                if not freed:
                    raise
        return self.store.create(oid, data_size, meta_size, evictable=False)

    @off_loop(lock="_ref_lock")
    def _store_serialized(self, oid: bytes, s: serialization.SerializedObject):
        # memory_store publishes below are single GIL-atomic dict stores of
        # fully built tuples — loop-side readers see old-or-new, never torn
        if s.is_inline() or self.store is None:
            # rtlint: disable=RT003 — GIL-atomic publish (see above)
            self.memory_store[oid] = ("wire",) + s.to_wire()
        else:
            try:
                meta = s.store_meta()
                bufs = self._create_with_spill_retry(oid, s.data_size(),
                                                     len(meta))
                if bufs is not None:
                    try:
                        data, meta_view = bufs
                        s.write_to(data)
                        meta_view[:] = meta
                    except BaseException:
                        # never leave a CREATED-but-unsealed object behind
                        # for gc_unsealed to find minutes later
                        self.store.abort(oid)
                        raise
                    self.store.seal(oid)
                # rtlint: disable=RT003 — GIL-atomic publish (see above)
                self.memory_store[oid] = ("shm",)
                entry = self.owned.get(oid)
                if entry is not None:
                    entry["location"] = self.node_id
                if ledger.enabled() and bufs is not None:
                    # provenance for the object-lifetime ledger: one
                    # record covers create+seal (current_task_id is a
                    # loop-side field read advisorily from put threads).
                    # A failure here must never trip the wire fallback
                    # below — the shm put already succeeded.
                    try:
                        span = self.store.is_span(oid)
                    except OSError:
                        span = False
                    tid = self.current_task_id
                    ledger.record_put(
                        oid, size=s.data_size(), meta_size=len(meta),
                        owner=self.address, owner_worker=self.worker_id,
                        node_id=self.node_id,
                        task_id=tid.hex() if tid else None,
                        is_span=span)
            except Exception:
                logger.exception("shm put failed; falling back to memory store")
                # rtlint: disable=RT003 — GIL-atomic publish (see above)
                self.memory_store[oid] = ("wire",) + s.to_wire()
        ev = self.object_events.pop(oid, None)
        if ev is not None:
            # asyncio.Event is not thread-safe: waiters park on the loop
            if threading.get_ident() == self._loop_thread_ident:
                ev.set()
            else:
                try:
                    self.loop.call_soon_threadsafe(ev.set)
                except RuntimeError:
                    pass   # loop closing during shutdown

    # ----------------------------------------------------------------- get
    def get_local(self, refs, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(
            self.get_many_async(refs, timeout), self.loop).result()

    async def get_many_async(self, refs: List[ObjectRef],
                             timeout: Optional[float] = None):
        # OWNED refs COMPLETE passively (executors push results/locations
        # to the owner; waiting just parks on a completion event), so
        # completion is awaited sequentially instead of gather's
        # one-asyncio.Task-per-ref — measurable at bench throughput
        # (200-ref batches). Anything needing ACTIVE work — a borrowed
        # ref's remote fetch, or an owned result that completed onto
        # ANOTHER node's store — gets an eager task so transfers overlap
        # instead of serializing one pull at a time.
        async def _all():
            n = len(refs)
            out = [None] * n
            tasks: Dict[int, "asyncio.Future"] = {}
            try:
                for i, r in enumerate(refs):
                    if r.id not in self.owned:
                        tasks[i] = asyncio.ensure_future(self.get_async(r))
                for i, r in enumerate(refs):
                    if i in tasks:
                        continue
                    entry = self.owned.get(r.id)
                    while entry is not None and not entry.get("complete"):
                        ev = self.object_events.setdefault(
                            r.id, asyncio.Event())
                        await ev.wait()
                        entry = self.owned.get(r.id)
                    loc = self.memory_store.get(r.id)
                    if loc is not None and loc[0] == "loc" \
                            and loc[1] != self.node_id:
                        tasks[i] = asyncio.ensure_future(self.get_async(r))
                    else:
                        out[i] = await self.get_async(r)
                for i, t in list(tasks.items()):
                    out[i] = await t
                    del tasks[i]
            finally:
                # an early error/cancellation (incl. wait_for timeout)
                # must not orphan in-flight fetch tasks
                for t in tasks.values():
                    t.cancel()
            return out
        if timeout is None:
            return await _all()
        return await asyncio.wait_for(_all(), timeout)

    async def get_async(self, ref: ObjectRef):
        val, is_exc = await self._resolve(ref)
        if is_exc:
            raise val
        return val

    # ------------------------------------------------- lineage reconstruction
    async def _node_is_dead(self, node_id: str) -> bool:
        """GCS-verified liveness (authoritative node table)."""
        try:
            nodes = await self.gcs_call_async("get_all_nodes")
        except (rpc.RpcError, rpc.ConnectionLost, ConnectionError):
            return False   # can't verify -> don't destroy state
        for n in nodes:
            if n.get("node_id") == node_id:
                return not n.get("alive", False)
        return True        # unknown to the GCS: gone

    async def _recover_object(self, oid: bytes) -> bool:
        """Re-execute the creating task of a lost object (reference:
        ObjectRecoveryManager::RecoverObject, object_recovery_manager.h:41).
        Returns True if a reconstruction attempt was started (caller should
        re-wait on the object), False if the object is unrecoverable."""
        entry = self.owned.get(oid)
        if entry is None:
            return False
        lineage = entry.get("lineage")
        if not lineage:
            return False
        fut = entry.get("recovering")
        if fut is not None:
            # another getter already triggered reconstruction — piggyback
            await fut
            return True
        if lineage["attempts"] >= cfg.lineage_max_depth:
            logger.warning("object %s exceeded %d reconstruction attempts",
                           oid.hex()[:16], cfg.lineage_max_depth)
            return False
        lineage["attempts"] += 1
        spec = lineage["spec"]
        task_id = spec["task_id"]
        logger.info("reconstructing %s via task %s (attempt %d)",
                    oid.hex()[:16], spec["name"], lineage["attempts"])
        fut = self.loop.create_future()
        return_ids = spec["return_ids"]
        for rid in return_ids:
            e = self.owned.get(rid)
            if e is not None:
                e["complete"] = False
                e["location"] = None
                e["recovering"] = fut
            self.memory_store.pop(rid, None)
        self._record_task_event(task_id, "PENDING", name=spec["name"],
                                job_id=self.job_id, type="NORMAL_TASK",
                                reconstruction=True)
        pt = PendingTask(spec, return_ids, lineage["max_retries"],
                         list(lineage["arg_refs"]))
        for r in pt.arg_refs:
            e = self.owned.get(r.id)
            if e is not None:
                e["submitted"] = e.get("submitted", 0) + 1
        self.pending_tasks[task_id] = pt
        self._enqueue_task(pt, lineage["resources"], lineage["scheduling"])

        def _done(_fut=fut, _ids=return_ids):
            for rid in _ids:
                e = self.owned.get(rid)
                if e is not None and e.get("recovering") is _fut:
                    e.pop("recovering", None)
            if not _fut.done():
                _fut.set_result(None)

        # resolve the recovery future when the task completes (or fails):
        # _complete_task/_fail_task repopulate memory_store and set+pop the
        # object events, so poll presence with an event-assisted wait (a
        # bare event wait would race a completion that happened before we
        # registered)
        async def _watch():
            # no wall deadline: clearing the recovering marker while the
            # resubmitted task is still queued would allow a duplicate
            # concurrent reconstruction of the same task_id. The task is
            # finished once its result lands in memory_store or its
            # pending entry is gone (dispatchers always _complete_task or
            # _fail_task, and failed dispatchers respawn).
            rid0 = return_ids[0]
            while (rid0 not in self.memory_store
                   and task_id in self.pending_tasks):
                ev = self.object_events.setdefault(rid0, asyncio.Event())
                try:
                    await asyncio.wait_for(ev.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
            _done()

        self._spawn(_watch())
        await fut
        return True

    async def _resolve(self, ref: ObjectRef) -> Tuple[Any, bool]:
        """Returns (value, is_exception)."""
        oid = ref.id
        tried_restore = False
        restores = 0
        while True:
            entry = self.memory_store.get(oid)
            if entry is not None:
                kind = entry[0]
                if kind == "wire":
                    return self._deser_wire(entry[1], entry[2], entry[3])
                if kind == "shm":
                    val, is_exc = self._deser_shm(oid)
                    if tried_restore and not is_exc:
                        # the copy restored for this read is pinned by the
                        # value now: once the value lets go, the copy (of
                        # an object already on disk) may be dropped to
                        # make room, as any other droppable copy
                        try:
                            self.store.set_evictable(oid, True)
                        except OSError:
                            pass
                    if (is_exc and isinstance(val, ObjectLostError)
                            and restores < 2
                            and self.node_conn is not None):
                        # evicted locally — maybe spilled to disk by the
                        # node manager; restore and retry. Twice: another
                        # reader of the same restored copy may have read
                        # it and let a create evict it before this read
                        tried_restore = True
                        restores += 1
                        try:
                            ok = await self.node_conn.call(
                                "restore_object", oid=oid)
                        except Exception:
                            ok = False
                        if isinstance(ok, dict):
                            # no room in the arena, even after spilling:
                            # the bytes came back to this reader alone
                            return self._deser_bytes(memoryview(ok["data"]),
                                                     ok["meta"])
                        if ok:
                            self.memory_store[oid] = ("shm",)
                            continue
                    if (is_exc and isinstance(val, ObjectLostError)
                            and await self._recover_object(oid)):
                        tried_restore = False
                        continue
                    return val, is_exc
                if kind == "loc":
                    node_id = entry[1]
                    if node_id == self.node_id:
                        self.memory_store[oid] = ("shm",)
                        continue
                    try:
                        await self._pull_to_local(oid, node_id)
                    except Exception as e:
                        # holding node gone. Owner: re-execute the
                        # creating task from lineage. Borrower: report
                        # the loss to the owner, who reconstructs and
                        # replies with a fresh status.
                        self.memory_store.pop(oid, None)
                        if oid in self.owned:
                            if await self._recover_object(oid):
                                continue
                            return ObjectLostError(
                                f"{oid.hex()[:16]} lost with node "
                                f"{node_id[:12]}: {e}"), True
                        owner = ref.owner_address
                        if owner and owner != self.address:
                            try:
                                resp = await self.pool.call(
                                    owner, "wait_object", oid=oid,
                                    lost_on=node_id)
                            except (rpc.RpcError, rpc.ConnectionLost,
                                    ConnectionError) as e2:
                                return ObjectLostError(
                                    f"owner unreachable during recovery: "
                                    f"{e2}"), True
                            err = self._apply_wait_object_resp(oid, resp)
                            if err is not None:
                                return err
                            continue
                        return ObjectLostError(
                            f"{oid.hex()[:16]} lost with node "
                            f"{node_id[:12]}: {e}"), True
                    self.memory_store[oid] = ("shm",)
                    continue
            if self.store is not None and self.store.contains(oid):
                self.memory_store[oid] = ("shm",)
                continue
            if oid in self.owned:
                # we own it but it's not complete yet: wait for task completion
                ev = self.object_events.setdefault(oid, asyncio.Event())
                await ev.wait()
                continue
            # borrowed: ask the owner
            owner = ref.owner_address
            if not owner or owner == self.address:
                ev = self.object_events.setdefault(oid, asyncio.Event())
                await ev.wait()
                continue
            try:
                resp = await self.pool.call(owner, "wait_object", oid=oid)
            except (rpc.RpcError, rpc.ConnectionLost, ConnectionError) as e:
                return ObjectLostError(
                    f"owner {owner} unreachable for {oid.hex()[:16]}: {e}"), True
            err = self._apply_wait_object_resp(oid, resp)
            if err is not None:
                return err

    def _apply_wait_object_resp(self, oid: bytes, resp: Dict):
        """Record a wait_object reply into the local memory store; returns
        an (error, True) tuple for a lost object, else None."""
        status = resp["status"]
        if status == "inline":
            self.memory_store[oid] = ("wire", resp["kind"], resp["pkl"],
                                      resp["bufs"])
            return None
        if status == "location":
            self.memory_store[oid] = ("loc", resp["node_id"])
            return None
        return ObjectLostError(resp.get("reason", "object lost")), True

    def _deser_wire(self, kind, pkl, bufs):
        try:
            return serialization.deserialize_wire(kind, pkl, bufs), False
        except TaskError as e:
            return e.cause if isinstance(e.cause, BaseException) else e, True
        except BaseException as e:
            return e, True

    def _deser_bytes(self, data: memoryview, meta: bytes):
        try:
            return serialization.deserialize_from_store(data, meta), False
        except TaskError as e:
            return e.cause if isinstance(e.cause, BaseException) else e, True
        except BaseException as e:
            return e, True

    def _deser_shm(self, oid):
        buf = self.store.get(oid)
        if buf is None:
            self.memory_store.pop(oid, None)
            return ObjectLostError(f"{oid.hex()[:16]} evicted"), True
        # Zero-copy views embedded in the value keep the store pin alive
        # through the buffer-protocol chain (see _PinnedRegion): the pin is
        # released when the last derived view is collected, so dropping the
        # value frees arena space even while the ObjectRef is still held —
        # a later re-get re-reads or restores from spill.
        try:
            return self._deser_bytes(buf.data, buf.metadata)
        finally:
            buf.close()

    async def _pull_to_local(self, oid: bytes, node_id: str):
        for attempt in range(5):
            try:
                await self.node_conn.call("pull_object", oid=oid,
                                          node_id=node_id)
                return
            except rpc.RpcError:
                await asyncio.sleep(0.05 * (attempt + 1))
        await self.node_conn.call("pull_object", oid=oid, node_id=node_id)

    async def h_wait_object(self, conn, oid: bytes, lost_on: str = None):
        """Owner-side: serve value or location to a borrower (reference:
        core_worker GetObjectStatus / future_resolver.h). ``lost_on`` is a
        borrower reporting that the named node no longer serves the
        object — if our view still points there, reconstruct from lineage
        before answering (reference: ObjectRecoveryManager pinning-or-
        reconstruct on owner, object_recovery_manager.h:41)."""
        if lost_on is not None:
            entry = self.memory_store.get(oid)
            owned = self.owned.get(oid)
            stale = ((entry is not None and entry[0] == "loc"
                      and entry[1] == lost_on)
                     or (owned is not None
                         and owned.get("location") == lost_on))
            if stale and await self._node_is_dead(lost_on):
                # verified against the GCS node table — a transient pull
                # failure from a healthy node must NOT destroy the only
                # location record (the borrower just retries)
                self.memory_store.pop(oid, None)
                if owned is not None:
                    owned["location"] = None
                if not await self._recover_object(oid):
                    return {"status": "lost",
                            "reason": f"copy on {lost_on[:12]} lost and "
                                      "not reconstructable"}
        while True:
            entry = self.memory_store.get(oid)
            if entry is not None:
                if entry[0] == "wire":
                    return {"status": "inline", "kind": entry[1],
                            "pkl": entry[2], "bufs": entry[3]}
                if entry[0] == "shm":
                    return {"status": "location", "node_id": self.node_id}
                if entry[0] == "loc":
                    return {"status": "location", "node_id": entry[1]}
            owned = self.owned.get(oid)
            if owned is not None and owned.get("location"):
                return {"status": "location", "node_id": owned["location"]}
            if owned is None:
                return {"status": "lost", "reason": "not owned / already freed"}
            ev = self.object_events.setdefault(oid, asyncio.Event())
            await ev.wait()

    def h_free_object(self, conn, oid: bytes):
        self.memory_store.pop(oid, None)
        return True

    # ---------------------------------------------------------------- wait
    async def wait_async(self, refs: List[ObjectRef], num_returns: int,
                         timeout: Optional[float]):
        # mirror the reference's contract: duplicates are rejected rather
        # than silently collapsed (ray.wait raises on duplicate refs)
        if len({r.id for r in refs}) != len(refs):
            raise ValueError("wait() expects a list of distinct ObjectRefs")
        # fast path: a LOCALLY-materialized entry ("wire" bytes in
        # memory / "shm" in the local store) means wait's fetch-local
        # contract is already satisfied — no resolve coroutine per ref,
        # which at wait([1000 ready refs]) is the whole cost (one task
        # spawn + value deserialization each). "loc" entries (value
        # lives on ANOTHER node) still go through resolve: declaring
        # them ready would skip the local fetch (and any lineage
        # reconstruction if that node died) that ray.wait's default
        # fetch_local=True promises.
        def _local(entry):
            return entry is not None and entry[0] in ("wire", "shm")

        ready_ids = {r.id for r in refs
                     if _local(self.memory_store.get(r.id))}
        if len(ready_ids) >= num_returns or len(ready_ids) == len(refs):
            ready_in_order = [r for r in refs
                              if r.id in ready_ids][:num_returns]
            taken = {r.id for r in ready_in_order}
            return (ready_in_order,
                    [r for r in refs if r.id not in taken])
        pending = {self._spawn(self._resolve(r)): r for r in refs
                   if r.id not in ready_ids}
        deadline = None if timeout is None else time.monotonic() + timeout
        while pending and len(ready_ids) < num_returns:
            tmo = None if deadline is None else max(0, deadline - time.monotonic())
            done, _ = await asyncio.wait(pending.keys(), timeout=tmo,
                                         return_when=asyncio.FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                ready_ids.add(pending.pop(fut).id)
        for fut in pending:
            fut.cancel()
        ready_in_order = [r for r in refs if r.id in ready_ids][:num_returns]
        taken = {r.id for r in ready_in_order}
        rest = [r for r in refs if r.id not in taken]
        return ready_in_order, rest

    # ---------------------------------------------------- function shipping
    def _function_key(self, pickled: bytes) -> bytes:
        return hashlib.sha1(pickled).digest()

    def _ship_function_nowait(self, func) -> bytes:
        """Register the function and start the GCS KV upload without
        awaiting it: keeping this non-blocking preserves submission order
        across tasks (an await here would let later same-function
        submissions overtake the first one in the dispatch queue).
        Executors that race the upload fetch the blob from us directly
        (h_fetch_function)."""
        pickled = getattr(func, "_rt_pickled", None)
        if pickled is None:
            pickled = cloudpickle.dumps(func)
            try:
                func._rt_pickled = pickled
            except (AttributeError, TypeError):
                pass
        fid = self._function_key(pickled)
        if fid not in self._func_blobs:
            # blob retained so executors can re-fetch from us if the GCS
            # KV copy is lost (GCS restart from a pre-ship snapshot);
            # presence doubles as the shipped-marker
            self._func_blobs[fid] = pickled
            self._func_blob_bytes += len(pickled)
            while (self._func_blob_bytes > self._func_blob_cap
                   and len(self._func_blobs) > 1):
                _, old_blob = self._func_blobs.popitem(last=False)
                self._func_blob_bytes -= len(old_blob)
            self._spawn(self.gcs_call_async(
                "kv_put", ns="funcs", key=fid, value=pickled,
                overwrite=False))
        else:
            self._func_blobs.move_to_end(fid)
        self._cache_function(fid, func)
        return fid

    def _cache_function(self, fid: bytes, func) -> None:
        cache = self._func_cache
        cache[fid] = func
        cache.move_to_end(fid)
        while len(cache) > self._func_cache_cap:
            cache.popitem(last=False)

    async def _ship_function(self, func) -> bytes:
        return self._ship_function_nowait(func)

    def h_fetch_function(self, conn, fid: bytes):
        return self._func_blobs.get(fid)

    async def _load_function_any(self, spec: Dict):
        """func_id -> cloudpickled function from GCS KV; func_ref ->
        "module:attr" import (cross-language callers name functions
        instead of shipping pickles, reference: cross_language function
        descriptors)."""
        ref = spec.get("func_ref")
        if ref:
            return _import_ref(ref)
        return await self._load_function(spec["func_id"],
                                         spec.get("owner_address"))

    async def _load_function(self, fid: bytes, owner_address: str = None):
        fn = self._func_cache.get(fid)
        if fn is not None:
            return fn
        pickled = await self.gcs_call_async("kv_get", ns="funcs", key=fid)
        if pickled is None and owner_address:
            # GCS KV lost the blob (restart from a pre-ship snapshot):
            # the owner retains every function it shipped — fetch from it
            # and repair the table for other executors
            try:
                pickled = await self.pool.call(owner_address,
                                               "fetch_function", fid=fid)
            except (rpc.RpcError, rpc.ConnectionLost, ConnectionError):
                pickled = None
            if pickled is not None:
                try:
                    await self.gcs_call_async("kv_put", ns="funcs", key=fid,
                                              value=pickled, overwrite=False)
                except Exception:
                    pass
        if pickled is None:
            raise RuntimeError(f"function {fid.hex()[:12]} not in GCS KV")
        fn = cloudpickle.loads(pickled)
        self._cache_function(fid, fn)
        return fn

    # ------------------------------------------------------ task submission
    def submit_task(self, func, args, kwargs, num_returns=1, resources=None,
                    max_retries=None, scheduling=None,
                    name=None, runtime_env=None) -> List[ObjectRef]:
        return asyncio.run_coroutine_threadsafe(
            self.submit_task_async(func, args, kwargs, num_returns, resources,
                                   max_retries, scheduling, name, runtime_env),
            self.loop).result()

    def _trace_fields(self) -> Dict[str, Optional[str]]:
        """New span chained under the caller's context: a task submitted
        from inside another task inherits its trace id and points its
        parent at the enclosing task's span. The enclosing context comes
        from the executing thread (sync methods) or the coroutine's
        contextvar (async methods) — never shared instance state."""
        ctx = getattr(_exec_tls, "trace", None) or _trace_ctx.get()
        trace_id, parent = ctx if ctx else (None, None)
        return {"trace_id": trace_id or self._root_trace_id,
                "span_id": ids.span_id(),
                "parent_span_id": parent}

    def _build_task_spec(self, func, args, kwargs, num_returns, name):
        """Caller-thread-safe part of task submission: ids + arg encoding
        (ids are urandom-based; serialization touches no loop state)."""
        task_id = ids.new_task_id(ids.job_id_from_int(self.job_id))
        return_ids = [ids.object_id_for_return(task_id, i)
                      for i in range(1, num_returns + 1)]
        arg_refs: List[ObjectRef] = []
        spec = {
            "task_id": task_id, "job_id": self.job_id,
            "name": name or getattr(func, "__name__", "task"),
            "args": [_encode_arg(a, arg_refs.append, self) for a in args],
            "kwargs": {k: _encode_arg(v, arg_refs.append, self)
                       for k, v in (kwargs or {}).items()},
            "return_ids": return_ids, "owner_address": self.address,
            "owner_node": self.node_id,
            **self._trace_fields(),
        }
        refs = [ObjectRef(rid, self.address) for rid in return_ids]
        return spec, return_ids, arg_refs, refs

    def submit_task_threadsafe(self, func, args, kwargs, num_returns=1,
                               resources=None, max_retries=None,
                               scheduling=None, name=None,
                               runtime_env=None) -> List[ObjectRef]:
        """Fire-and-forget submission from a user thread: the refs come
        back without a loop round trip (submission is local-fast like the
        reference's SubmitTask; errors surface through the refs)."""
        spec, return_ids, arg_refs, refs = self._build_task_spec(
            func, args, kwargs, num_returns, name)

        self._enqueue_submit(
            self._kickoff_task_submit, func, spec, return_ids, arg_refs,
            resources, max_retries, scheduling, runtime_env)
        return refs

    def _kickoff_task_submit(self, func, spec, return_ids, arg_refs,
                             resources, max_retries, scheduling, runtime_env):
        self._spawn(self._finish_task_submit(
            func, spec, return_ids, arg_refs, resources, max_retries,
            scheduling, runtime_env))

    async def submit_task_async(self, func, args, kwargs, num_returns=1,
                                resources=None, max_retries=None,
                                scheduling=None, name=None,
                                runtime_env=None) -> List[ObjectRef]:
        spec, return_ids, arg_refs, refs = self._build_task_spec(
            func, args, kwargs, num_returns, name)
        await self._finish_task_submit(func, spec, return_ids, arg_refs,
                                       resources, max_retries, scheduling,
                                       runtime_env)
        return refs

    async def _finish_task_submit(self, func, spec, return_ids, arg_refs,
                                  resources, max_retries, scheduling,
                                  runtime_env):
        """Loop-side completion of a task submission. Failures surface on
        the return refs (the submitting thread has already moved on)."""
        resources = dict(resources or {})
        if not resources:
            resources = {"CPU": 1.0}
        if max_retries is None:
            max_retries = cfg.task_max_retries
        # Lineage: retain the creating task so a lost shm copy can be
        # re-executed (reference: ObjectRecoveryManager
        # object_recovery_manager.h:41; spec retained by TaskManager,
        # task_manager.h:208). Holding arg_refs in the lineage keeps the
        # argument objects' owned entries alive for as long as any return
        # ref might need reconstruction (lineage pinning,
        # reference_count.h:64).
        lineage = {"spec": spec, "resources": dict(resources),
                   "scheduling": dict(scheduling or {}),
                   "max_retries": max_retries, "arg_refs": list(arg_refs),
                   "attempts": 0}
        for rid in return_ids:
            self._register_owned(rid, lineage=lineage, complete=False)
        pt = PendingTask(spec, return_ids, max_retries, arg_refs)
        # pin args for the task's duration
        for r in arg_refs:
            e = self.owned.get(r.id)
            if e is not None:
                e["submitted"] = e.get("submitted", 0) + 1
        self.pending_tasks[spec["task_id"]] = pt
        self._record_task_event(spec["task_id"], "PENDING",
                                name=spec["name"], job_id=self.job_id,
                                type="NORMAL_TASK")
        try:
            spec["func_id"] = self._ship_function_nowait(func)
            if runtime_env:
                spec["runtime_env"] = await self._package_runtime_env(
                    runtime_env)
            await self._resolve_dependencies(arg_refs)
        except Exception as e:
            self._fail_task(pt, RuntimeError(f"task submission failed: {e}"))
            self.pending_tasks.pop(spec["task_id"], None)
            return
        self._enqueue_task(pt, resources, scheduling or {})

    # Per-signature dispatch: tasks queue by (resources, scheduling)
    # signature and a bounded set of dispatchers each hold ONE lease and
    # run queued tasks on it serially (reference: NormalTaskSubmitter —
    # bounded in-flight lease requests + task pipelining onto granted
    # workers, normal_task_submitter.cc). Without this, N concurrent
    # submissions issue N simultaneous lease requests and the node
    # manager's waiter queue becomes the bottleneck.

    async def _resolve_dependencies(self, arg_refs: List[ObjectRef]):
        """Wait until every argument object is complete BEFORE the task
        occupies a lease (reference: DependencyResolver in
        NormalTaskSubmitter, transport/dependency_resolver.h — args
        resolve owner-side so leased workers never block on upstream
        tasks; without this, dependent tasks can exhaust the lease pool
        and deadlock behind their own dependencies)."""
        for r in arg_refs:
            entry = self.owned.get(r.id)
            if entry is not None:
                while not entry.get("complete"):
                    ev = self.object_events.setdefault(r.id, asyncio.Event())
                    await ev.wait()
                    entry = self.owned.get(r.id)
                    if entry is None:
                        break
            elif r.owner_address and r.owner_address != self.address:
                try:
                    await self.pool.call(r.owner_address, "wait_object",
                                         oid=r.id)
                except (rpc.RpcError, rpc.ConnectionLost, ConnectionError):
                    pass   # the executor surfaces the fetch error

    def _enqueue_task(self, pt: PendingTask, resources, scheduling):
        from ray_tpu_torch._private.runtime_env_plugins import proc_env_of
        renv = pt.spec.get("runtime_env")
        env_hash = self._runtime_env_hash(renv)
        sig = self._lease_sig(resources, scheduling, env_hash)
        st = self._sig_queues.get(sig)
        if st is None:
            st = {"queue": __import__("collections").deque(),
                  "dispatchers": 0, "busy": 0, "grants": 0,
                  "resources": resources,
                  "scheduling": scheduling, "env_hash": env_hash,
                  "proc_env": proc_env_of(renv)}
            self._sig_queues[sig] = st
        st["queue"].append(pt)
        self._maybe_spawn_dispatcher(sig, st)

    def _maybe_spawn_dispatcher(self, sig, st):
        # Spawn when queued tasks outnumber FREE dispatchers (dispatchers
        # whose current task is in flight count as busy — a running task
        # may block on a queued task's result, so leaving work behind a
        # busy dispatcher can deadlock a dependency chain), and always
        # when an idle lease can serve the task immediately — otherwise a
        # dispatcher blocked in a server-side lease wait would serialize
        # fresh submissions behind grant latency.
        free = st["dispatchers"] - st["busy"]
        if (st["dispatchers"] < cfg.max_dispatchers_per_sig
                and (len(st["queue"]) > free
                     or self._idle_leases.get(sig))):
            st["dispatchers"] += 1
            self._spawn(self._dispatch_loop(sig, st))

    async def _dispatch_loop(self, sig, st):
        my_grants = -1
        cur_batch = 1
        try:
            while st["queue"]:
                try:
                    lease = await self._acquire_lease(
                        st["resources"], st["scheduling"],
                        st.get("env_hash"), st.get("proc_env"))
                    st["grants"] += 1
                except Exception as e:
                    if st["queue"]:
                        pt = st["queue"].popleft()
                        self._fail_task(pt, RuntimeError(
                            f"lease failed: {e}"))
                        self.pending_tasks.pop(pt.spec["task_id"], None)
                    continue
                lease_ok = True
                while st["queue"] and lease_ok:
                    # adaptive frame batching: serialize queued tasks
                    # behind THIS lease only when there is evidence no
                    # other lease is coming — i.e. no grant has landed
                    # for this signature since our last round (the
                    # 1-worker case: parked dispatchers stay parked, so
                    # the batch doubles toward task_push_batch). Any
                    # fresh grant or an idle lease resets to single-task
                    # frames so work spreads across workers/nodes
                    # (spillback, spread). Acks stream back per-task
                    if (st["grants"] != my_grants
                            or self._idle_leases.get(sig)):
                        cur_batch = 1
                    else:
                        cur_batch = min(cur_batch * 2,
                                        cfg.task_push_batch)
                    my_grants = st["grants"]
                    batch = [st["queue"].popleft()]
                    # streaming tasks own their frame: the PARTIAL slots
                    # of push_task_streaming carry items, not batch acks
                    if not batch[0].spec.get("streaming"):
                        while (st["queue"] and len(batch) < cur_batch
                               and not st["queue"][0].spec.get("streaming")):
                            batch.append(st["queue"].popleft())
                    st["busy"] += 1
                    # work remains behind us: make sure it isn't stuck
                    # waiting for this (possibly dependent) task
                    if st["queue"]:
                        self._maybe_spawn_dispatcher(sig, st)
                    try:
                        lease_ok = await self._run_on_lease(batch, lease,
                                                            st)
                    except Exception as e:
                        # unexpected failure must not strand the queue:
                        # fail these tasks, drop the (suspect) lease, keep
                        # draining with a fresh one
                        logger.exception("dispatcher error running %s",
                                         batch[0].spec.get("name"))
                        for pt in batch:
                            self._fail_task(pt, RuntimeError(
                                f"dispatch failed: {e}"))
                            self.pending_tasks.pop(pt.spec["task_id"],
                                                   None)
                        await self._drop_lease(lease, dead=True)
                        lease_ok = False
                    finally:
                        st["busy"] -= 1
                if lease_ok:
                    try:
                        await self._return_lease(lease)
                    except Exception:
                        logger.exception("lease return failed")
        finally:
            st["dispatchers"] -= 1
            if st["queue"] and st["dispatchers"] == 0 and not self._shutdown:
                # we were the last dispatcher and tasks remain (e.g. an
                # exception escaped above): respawn so callers never hang
                # (never during shutdown: a task spawned while stop_async
                # is cancelling would escape its victim snapshot)
                st["dispatchers"] += 1
                self._spawn(self._dispatch_loop(sig, st))
            elif not st["queue"] and st["dispatchers"] == 0:
                self._sig_queues.pop(sig, None)

    async def _run_on_lease(self, pts: List[PendingTask], lease, st) -> bool:
        """Run a batch of tasks on a held lease (one frame, serial
        execution on the worker). Returns False if the lease died (caller
        must stop using it). Each pending_tasks entry stays alive only
        while its task can still run (requeued for retry)."""
        run = []
        for pt in pts:
            if pt.cancelled:
                self._fail_task(pt, TaskCancelledError(pt.spec["name"]))
                self.pending_tasks.pop(pt.spec["task_id"], None)
            else:
                run.append(pt)
        if not run:
            return True

        def on_part(idx, ok, payload):
            pt = run[idx]
            if pt.done:
                return
            if ok:
                self._complete_task(pt, payload)
            else:
                self._fail_task(pt, RuntimeError(
                    f"{payload[0]}: {payload[1]}"
                    if isinstance(payload, list) else str(payload)))
            self.pending_tasks.pop(pt.spec["task_id"], None)

        try:
            for pt in run:
                if lease.resource_ids:
                    pt.spec["accelerator_ids"] = lease.resource_ids
                pt.current_worker = lease.worker_address
            conn = await self.pool.get(lease.worker_address)
            if len(run) == 1 and run[0].spec.get("streaming"):
                # streaming generator: PARTIALs are items; the lease is
                # held (task running) until the final response
                pt = run[0]
                gen = self._generators.get(pt.spec["task_id"])
                if gen is None:
                    # closed before dispatch: don't run it at all
                    self._fail_task(pt, TaskCancelledError(
                        pt.spec.get("name", "stream")))
                    self.pending_tasks.pop(pt.spec["task_id"], None)
                    return True
                gen._worker_address = lease.worker_address
                resp = await conn.call_start_parts(
                    "push_task_streaming", {"spec": pt.spec},
                    functools.partial(self._on_gen_part, pt))
                self._complete_task(pt, resp)
                if gen is not None:
                    gen._finish()
                self._generators.pop(pt.spec["task_id"], None)
                self.pending_tasks.pop(pt.spec["task_id"], None)
            elif len(run) == 1:
                resp = await conn.call("push_task", spec=run[0].spec)
                self._complete_task(run[0], resp)
                self.pending_tasks.pop(run[0].spec["task_id"], None)
            else:
                # one frame out; per-task acks stream back as PARTIALs
                # (a fast task completes the moment IT finishes, and a
                # worker death only retries unacked tasks)
                await conn.call_start_parts(
                    "push_tasks", {"specs": [p.spec for p in run]},
                    on_part)
        except (rpc.ConnectionLost, ConnectionError, rpc.RpcError) as e:
            await self._drop_lease(lease, dead=True)
            stragglers = [pt for pt in run if not pt.done]
            if isinstance(e, rpc.RpcError):
                for pt in stragglers:
                    self._fail_task(pt, RuntimeError(f"push failed: {e}"))
                    self.pending_tasks.pop(pt.spec["task_id"], None)
                return False
            retried = 0
            for pt in reversed(stragglers):   # keep submission order
                if pt.retries_left > 0:
                    pt.retries_left -= 1
                    st["queue"].appendleft(pt)   # keep pending for retry
                    retried += 1
                else:
                    self._fail_task(pt, WorkerCrashedError(
                        f"worker died running {pt.spec['name']}"))
                    self.pending_tasks.pop(pt.spec["task_id"], None)
            if retried:
                logger.warning("worker died; retrying %d task(s)", retried)
            return False
        return True

    def _complete_task(self, pt: PendingTask, resp: Dict):
        self._record_task_event(pt.spec["task_id"], "FINISHED")
        for rid, ret in zip(pt.return_ids, resp["returns"]):
            entry = self.owned.get(rid)
            if ret[0] == "wire":
                self.memory_store[rid] = ("wire", ret[1], ret[2], ret[3])
            else:  # ["shm", node_id]
                self.memory_store[rid] = ("loc", ret[1])
                if entry is not None:
                    entry["location"] = ret[1]
            if entry is not None:
                entry["complete"] = True
            ev = self.object_events.pop(rid, None)
            if ev is not None:
                ev.set()
        self._unpin_args(pt)

    # ------------------------------------------------ streaming generators
    # (owner side: each PARTIAL from push_task_streaming materializes one
    # brand-new owned object; consumption acks open the executor's window)

    def _on_gen_part(self, pt: PendingTask, idx: int, ok: bool, payload):
        gen = self._generators.get(pt.spec["task_id"])
        if not ok:
            if gen is not None:
                gen._fail(RuntimeError(
                    f"{payload[0]}: {payload[1]}"
                    if isinstance(payload, list) else str(payload)))
            return
        if gen is None:
            # stream closed while this item was in flight: registering
            # it would leak an owned entry no ref can ever free
            return
        rid = ids.object_id_for_return(pt.spec["task_id"], 2 + idx)
        self._register_owned(rid, complete=True)
        entry = self.owned.get(rid)
        if payload[0] == "wire":
            self.memory_store[rid] = ("wire", payload[1], payload[2],
                                      payload[3])
        else:   # ["shm", node_id]
            self.memory_store[rid] = ("loc", payload[1])
            if entry is not None:
                entry["location"] = payload[1]
        if gen is not None:
            gen._push(ObjectRef(rid, self.address))

    def _gen_send_ack(self, gen) -> None:
        """Consumption ack (loop side): opens the executor's in-flight
        window. Fire-and-forget — a lost ack only delays the window until
        the next one."""
        if gen._worker_address is None or gen._done:
            return
        self._spawn(self._gen_ack_async(gen._worker_address,
                                        gen._task_id, gen._consumed))

    async def _gen_ack_async(self, address: str, task_id: bytes,
                             consumed: int):
        try:
            conn = await self.pool.get(address)
            conn.call_start_nowait("generator_ack",
                                   {"task_id": task_id,
                                    "consumed": consumed})
        except Exception:
            pass

    async def _gen_close_async(self, gen):
        """Consumer walked away: stop the producer, drop unconsumed
        items (their owned entries free via normal refcounting once the
        local refs die with the deque)."""
        gen._finish()
        gen._items.clear()
        self._generators.pop(gen._task_id, None)
        if gen._worker_address:
            try:
                conn = await self.pool.get(gen._worker_address)
                conn.call_start_nowait("generator_close",
                                       {"task_id": gen._task_id})
            except Exception:
                pass
        else:
            # not dispatched yet: cancel it in the queue (the dispatch
            # paths also skip tasks whose generator is gone)
            try:
                await self.cancel_task_async(gen._completed_ref)
            except Exception:
                pass

    def submit_streaming_task_threadsafe(
            self, func, args, kwargs, resources=None, scheduling=None,
            name=None, runtime_env=None, backpressure=None):
        """num_returns='streaming' submission: returns an
        ObjectRefGenerator instead of refs. Streaming tasks never retry
        (stated divergence — see generator.py docstring)."""
        from ray_tpu_torch._private.generator import ObjectRefGenerator
        spec, return_ids, arg_refs, refs = self._build_task_spec(
            func, args, kwargs, 1, name)
        spec["streaming"] = True
        if backpressure:
            spec["backpressure"] = int(backpressure)
        gen = ObjectRefGenerator(self, spec["task_id"], refs[0])
        self._generators[spec["task_id"]] = gen
        self._enqueue_submit(
            self._kickoff_task_submit, func, spec, return_ids, arg_refs,
            resources, 0, scheduling, runtime_env)
        return gen

    def submit_streaming_actor_task_threadsafe(
            self, actor_id: str, method: str, args, kwargs,
            concurrency_group=None, backpressure=None):
        from ray_tpu_torch._private.generator import ObjectRefGenerator
        spec, return_ids, arg_refs, refs = self._build_actor_task_spec(
            actor_id, method, args, kwargs, 1, concurrency_group)
        spec["streaming"] = True
        if backpressure:
            spec["backpressure"] = int(backpressure)
        gen = ObjectRefGenerator(self, spec["task_id"], refs[0])
        self._generators[spec["task_id"]] = gen
        self._enqueue_submit(self._finish_actor_submit, spec, return_ids,
                             arg_refs, 0)
        return gen

    def _fail_task(self, pt: PendingTask, exc: BaseException):
        self._record_task_event(pt.spec["task_id"], "FAILED",
                                error=f"{type(exc).__name__}: {exc}")
        gen = self._generators.pop(pt.spec["task_id"], None)
        if gen is not None:
            gen._fail(exc)
        s = serialization.serialize_error(exc)
        kind, pkl, bufs = s.to_wire()
        for rid in pt.return_ids:
            self.memory_store[rid] = ("wire", kind, pkl, bufs)
            entry = self.owned.get(rid)
            if entry is not None:
                entry["complete"] = True
            ev = self.object_events.pop(rid, None)
            if ev is not None:
                ev.set()
        self._unpin_args(pt)

    def _unpin_args(self, pt: PendingTask):
        if pt.done:
            return
        pt.done = True
        for r in pt.arg_refs:
            e = self.owned.get(r.id)
            if e is not None:
                e["submitted"] = max(0, e.get("submitted", 0) - 1)
                self._maybe_free(r.id)

    async def broadcast_async(self, ref: ObjectRef, node_ids: List[str]):
        """Owner-directed broadcast: fan a shm-resident object out to
        `node_ids` through the node managers' binomial push tree (gang arg
        feeding / weight distribution; reference has point-to-point
        Push/Pull only, object_manager.h:117)."""
        entry = self.owned.get(ref.id)
        loc = entry.get("location") if entry is not None else None
        if loc is None and self.store is not None \
                and self.store.contains(ref.id):
            loc = self.node_id
        if loc is None:
            raise ValueError(
                "broadcast requires a sealed shm object (inline objects "
                "travel with their task specs)")
        targets = [n for n in node_ids if n != loc]
        if not targets:
            return
        if loc == self.node_id:
            await self.node_conn.call("broadcast_object", oid=ref.id,
                                      targets=targets)
        else:
            view = await self.gcs_call_async("get_cluster_view")
            holder = view.get(loc)
            if holder is None:
                raise RuntimeError(f"holder node {loc[:12]} unknown")
            await self.pool.call(holder["address"], "broadcast_object",
                                 oid=ref.id, targets=targets)

    def _broadcast_holder_node(self, ref: ObjectRef) -> Optional[str]:
        entry = self.owned.get(ref.id)
        loc = entry.get("location") if entry is not None else None
        if loc is None and self.store is not None \
                and self.store.contains(ref.id):
            loc = self.node_id
        return loc

    async def broadcast_weights_async(self, ref: ObjectRef,
                                      node_ids: Optional[List[str]] = None,
                                      max_retries: int = 2) -> Dict:
        """Weight-distribution plane: fan `ref`'s sealed (possibly
        multi-GB spanning) object out to the target nodes through the
        node managers' binomial relay tree over the striped data plane —
        one source put, log-depth fan-out, receivers recv_into their own
        (spanning) arena allocations, zero staging copies end to end.

        A relay node dying mid-subtree surfaces at the root's await
        (the completing chunk's ack defers past the subtree); the retry
        then takes a census of who actually holds the object and
        re-broadcasts the missing shard from EVERY surviving holder in
        parallel — the tree heals around the dead relay instead of
        restarting from the single source. Nodes that left the cluster
        are dropped (membership is the GCS's problem, not the
        broadcast's). Returns {"delivered", "skipped", "retries"}.
        """
        from ray_tpu_torch._private import events
        from ray_tpu_torch._private.data_plane import plan_rebroadcast
        loc = self._broadcast_holder_node(ref)
        if loc is None:
            raise ValueError(
                "broadcast_weights requires a sealed shm object (inline "
                "objects travel with their task specs)")
        view = await self.gcs_call_async("get_cluster_view")
        if node_ids is None:
            node_ids = list(view)
        targets = [n for n in node_ids if n != loc and n in view]
        skipped = [n for n in node_ids if n != loc and n not in view]
        nbytes = None
        if self.store is not None and self.store.contains(ref.id):
            buf = self.store.get(ref.id)
            if buf is not None:
                nbytes = len(buf.data)
                buf.close()

        async def _census(nodes):
            """(have, missing, gone) among `nodes` right now."""
            have, missing, gone = [], [], []
            async def probe(n):
                try:
                    r = await self.pool.call(view[n]["address"],
                                             "has_object", oid=ref.id)
                    (have if (r or {}).get("in_store") or
                     (r or {}).get("spilled") else missing).append(n)
                except Exception:
                    gone.append(n)
            await asyncio.gather(*[probe(n) for n in nodes])
            return have, missing, gone

        async def _bcast_from(holder_node, tgts):
            if holder_node == self.node_id:
                await self.node_conn.call("broadcast_object", oid=ref.id,
                                          targets=tgts)
            else:
                await self.pool.call(view[holder_node]["address"],
                                     "broadcast_object", oid=ref.id,
                                     targets=tgts)

        with events.record_span(
                "store.broadcast", category="store",
                object_id=ref.id.hex()[:16], bytes=nbytes,
                peers=len(targets)) as span:
            retries = 0
            last_err: Optional[BaseException] = None
            remaining = list(targets)
            for attempt in range(max_retries + 1):
                if not remaining:
                    break
                try:
                    if attempt == 0:
                        await self._bcast_via_holder(ref, loc, remaining,
                                                     view)
                        remaining = []
                        break
                    retries += 1
                    have, missing, gone = await _census(remaining)
                    skipped.extend(gone)
                    remaining = missing
                    if not remaining:
                        break
                    plan = plan_rebroadcast(remaining, [loc] + have)
                    await asyncio.gather(*[
                        _bcast_from(h, tgts) for h, tgts in plan])
                    remaining = []
                except Exception as e:      # noqa: BLE001 — retried below
                    last_err = e
                    logger.warning(
                        "broadcast of %s attempt %d failed (%s); "
                        "retrying via surviving holders",
                        ref.id.hex()[:16], attempt, e)
            if remaining:
                raise RuntimeError(
                    f"broadcast_weights of {ref.id.hex()[:16]} could not "
                    f"reach {len(remaining)} node(s) after {retries} "
                    f"retries") from last_err
            delivered = [n for n in targets if n not in skipped]
            span.set(delivered=len(delivered), skipped=len(skipped),
                     retries=retries)
        return {"delivered": delivered, "skipped": skipped,
                "retries": retries}

    async def _bcast_via_holder(self, ref: ObjectRef, loc: str,
                                targets: List[str], view: Dict):
        if loc == self.node_id:
            await self.node_conn.call("broadcast_object", oid=ref.id,
                                      targets=targets)
        else:
            holder = view.get(loc)
            if holder is None:
                raise RuntimeError(f"holder node {loc[:12]} unknown")
            await self.pool.call(holder["address"], "broadcast_object",
                                 oid=ref.id, targets=targets)

    async def cancel_task_async(self, ref: ObjectRef, force: bool = False):
        task_id = ids.task_id_of_object(ref.id)
        pt = self.pending_tasks.get(task_id)
        if pt is None:
            return False       # already finished (or not ours)
        pt.cancelled = True
        if pt.current_worker:
            try:
                await self.pool.call(pt.current_worker, "cancel_task",
                                     task_id=task_id, force=force)
            except Exception:
                pass
        return True

    # ---------------------------------------------------------------- leases
    def _lease_sig(self, resources: Dict, scheduling: Dict,
                   env_hash: Optional[str] = None) -> tuple:
        return (tuple(sorted(resources.items())),
                tuple(sorted((k, str(v)) for k, v in scheduling.items())),
                env_hash)

    @staticmethod
    def _runtime_env_hash(renv) -> Optional[str]:
        """Worker-pool key (shared scheme with the actor path — see
        runtime_env_plugins.runtime_env_hash)."""
        from ray_tpu_torch._private.runtime_env_plugins import runtime_env_hash
        return runtime_env_hash(renv)

    async def _acquire_lease(self, resources: Dict, scheduling: Dict,
                             env_hash: Optional[str] = None,
                             proc_env: Optional[Dict] = None) -> Lease:
        sig = self._lease_sig(resources, scheduling, env_hash)
        pool = self._idle_leases.get(sig)
        while pool:
            lease = pool.pop()
            return lease
        target_conn = self.node_conn
        addr_chain = 0
        attempts = 0
        while True:
            try:
                resp = await target_conn.call(
                    "request_lease", resources=resources,
                    scheduling=scheduling, worker_id=self.worker_id,
                    env_hash=env_hash, proc_env=proc_env,
                    spilled=addr_chain > 0)
            except (rpc.RpcError, rpc.ConnectionLost) as e:
                # transient control-plane failure (or injected chaos):
                # back off and retry (reference: retryable lease clients,
                # normal_task_submitter.cc retry-on-raylet-unavailable)
                attempts += 1
                if attempts > 5:
                    raise
                await asyncio.sleep(0.05 * attempts)
                if target_conn is not self.node_conn and target_conn.closed:
                    target_conn = self.node_conn
                    addr_chain = 0
                continue
            if resp["status"] == "ok":
                return Lease(resp["lease_id"], resp["worker_address"],
                             resp["node_address"], sig,
                             resp.get("resource_ids"))
            if resp["status"] == "spill":
                addr_chain += 1
                if addr_chain > 8:
                    raise RuntimeError("lease spillback loop")
                target_conn = await self.pool.get(resp["spill_to"])
                continue
            raise RuntimeError(resp.get("reason", "lease denied"))

    async def _return_lease(self, lease: Lease):
        lease.last_used = time.monotonic()
        self._idle_leases.setdefault(lease.signature, []).append(lease)

    async def _drop_lease(self, lease: Lease, dead: bool = False):
        if dead:
            self.pool.invalidate(lease.worker_address)
        try:
            conn = (self.node_conn if lease.node_address == self.node_address
                    else await self.pool.get(lease.node_address))
            await conn.call("return_lease", lease_id=lease.lease_id,
                            worker_dead=dead)
        except Exception:
            pass

    async def _reap_leases(self):
        while not self._shutdown:
            await asyncio.sleep(cfg.lease_idle_timeout_s / 2)
            now = time.monotonic()
            for sig, pool in list(self._idle_leases.items()):
                keep = []
                for lease in pool:
                    if now - lease.last_used > cfg.lease_idle_timeout_s:
                        self._spawn(self._drop_lease(lease))
                    else:
                        keep.append(lease)
                self._idle_leases[sig] = keep

    # ------------------------------------------------------------ actor API
    async def create_actor_async(self, cls, init_args, init_kwargs, *,
                                 num_returns=1, resources=None, name=None,
                                 namespace=None, max_restarts=0,
                                 max_concurrency=1, scheduling=None,
                                 lifetime=None, method_names=None,
                                 runtime_env=None, concurrency_groups=None,
                                 method_groups=None) -> str:
        actor_id = ids.new_actor_id(ids.job_id_from_int(self.job_id)).hex()
        cid = await self._ship_function(cls)
        arg_refs: List[ObjectRef] = []
        spec = {
            "actor_id": actor_id, "job_id": self.job_id,
            "class_id": cid, "name": name,
            "namespace": namespace or self.namespace,
            "init_args": [_encode_arg(a, arg_refs.append, self)
                          for a in init_args],
            "init_kwargs": {k: _encode_arg(v, arg_refs.append, self)
                            for k, v in (init_kwargs or {}).items()},
            "resources": dict(resources or {"CPU": 1.0}),
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "scheduling": scheduling or {},
            "owner_address": self.address,
            "lifetime": lifetime,
            "method_names": list(method_names or []),
            "concurrency_groups": dict(concurrency_groups or {}),
            "method_groups": dict(method_groups or {}),
        }
        if runtime_env:
            spec["runtime_env"] = await self._package_runtime_env(
                runtime_env)
        st = ActorHandleState(actor_id)
        st.init_arg_refs = arg_refs
        self.actor_handles[actor_id] = st
        await self._ensure_actor_subscription()
        await self.gcs_call_async("create_actor", spec=spec)
        return actor_id

    async def _ensure_actor_subscription(self):
        if getattr(self, "_subscribed_actor_channel", False):
            return
        self._subscribed_actor_channel = True
        self._subscribed_channels.add("ACTOR")
        await self.gcs_call_async("subscribe", channel="ACTOR")

    def h_pubsub(self, conn, channel: str, key: str, payload: Any):
        if channel == "LOGS":
            # worker log lines -> driver stdout with a routing prefix
            # (reference: log_monitor pubsub -> driver magic-prefix print)
            import sys
            prefix = f"({payload.get('pid')}, ip={payload.get('ip')})"
            out = sys.stderr if payload.get("stream") == "stderr" \
                else sys.stdout
            for line in payload.get("lines", []):
                print(f"{prefix} {line}", file=out)
            return None
        if channel == "ACTOR":
            st = self.actor_handles.get(key)
            if st is None:
                return
            st.state = payload["state"]
            st.death_cause = payload.get("death_cause")
            if payload["state"] == "ALIVE":
                st.address = payload["address"]
                st.ready.set()
            elif payload["state"] in ("RESTARTING", "PENDING_CREATION"):
                st.address = None
                st.ready.clear()
            elif payload["state"] == "DEAD":
                st.address = None
                st.init_arg_refs = []
                st.ready.set()
        return None

    async def _actor_state(self, actor_id: str) -> ActorHandleState:
        st = self.actor_handles.get(actor_id)
        probe = st is None or not st.ready.is_set()
        if st is None:
            st = ActorHandleState(actor_id)
            self.actor_handles[actor_id] = st
        if probe:
            await self._ensure_actor_subscription()
            info = await self.gcs_call_async("get_actor_info", actor_id=actor_id)
            if info is not None:
                # don't regress a fresher pubsub update that raced us
                if not st.ready.is_set():
                    st.state = info["state"]
                    st.death_cause = info.get("death_cause")
                    if info["state"] == "ALIVE":
                        st.address = info["address"]
                        st.ready.set()
                    elif info["state"] == "DEAD":
                        st.ready.set()
        return st

    def _build_actor_task_spec(self, actor_id, method, args, kwargs,
                               num_returns, concurrency_group=None):
        task_id = ids.new_task_id(ids.job_id_from_int(self.job_id))
        return_ids = [ids.object_id_for_return(task_id, i)
                      for i in range(1, num_returns + 1)]
        arg_refs: List[ObjectRef] = []
        spec = {
            "task_id": task_id, "job_id": self.job_id, "name": method,
            "actor_id": actor_id, "method": method,
            "args": [_encode_arg(a, arg_refs.append, self) for a in args],
            "kwargs": {k: _encode_arg(v, arg_refs.append, self)
                       for k, v in (kwargs or {}).items()},
            "return_ids": return_ids, "owner_address": self.address,
            "owner_node": self.node_id,
            **self._trace_fields(),
        }
        if concurrency_group:
            spec["concurrency_group"] = concurrency_group
        refs = [ObjectRef(rid, self.address) for rid in return_ids]
        return spec, return_ids, arg_refs, refs

    def submit_actor_task_threadsafe(self, actor_id: str, method: str,
                                     args, kwargs, num_returns=1,
                                     max_task_retries=0,
                                     concurrency_group=None
                                     ) -> List[ObjectRef]:
        """Fire-and-forget actor submission from a user thread — no loop
        round trip per call. Ordering: the submit buffer is FIFO and
        _finish_actor_submit enqueues synchronously, so calls from one
        thread start in submission order (the reference's
        SequentialActorSubmitQueue guarantee)."""
        spec, return_ids, arg_refs, refs = self._build_actor_task_spec(
            actor_id, method, args, kwargs, num_returns, concurrency_group)
        self._enqueue_submit(self._finish_actor_submit, spec, return_ids,
                             arg_refs, max_task_retries)
        return refs

    async def submit_actor_task_async(self, actor_id: str, method: str,
                                      args, kwargs, num_returns=1,
                                      max_task_retries=0,
                                      concurrency_group=None
                                      ) -> List[ObjectRef]:
        spec, return_ids, arg_refs, refs = self._build_actor_task_spec(
            actor_id, method, args, kwargs, num_returns, concurrency_group)
        self._finish_actor_submit(spec, return_ids, arg_refs,
                                  max_task_retries)
        return refs

    def _finish_actor_submit(self, spec, return_ids, arg_refs,
                             max_task_retries):
        actor_id = spec["actor_id"]
        for rid in return_ids:
            self._register_owned(rid, complete=False)
        pt = PendingTask(spec, return_ids, max_task_retries, arg_refs)
        for r in arg_refs:
            e = self.owned.get(r.id)
            if e is not None:
                e["submitted"] = e.get("submitted", 0) + 1
        self._record_task_event(spec["task_id"], "PENDING",
                                name=spec["method"], job_id=self.job_id,
                                type="ACTOR_TASK", actor_id=actor_id)
        st = self.actor_handles.get(actor_id)
        if st is None:
            # borrowed handle's first use: create the state synchronously
            # so later calls enqueue behind this one in order, and kick an
            # async GCS probe to resolve the address (the sender loop
            # blocks on st.ready until it lands)
            st = ActorHandleState(actor_id)
            self.actor_handles[actor_id] = st
            self._spawn(self._actor_state(actor_id))
        if st.sender is None:
            st.sender = self._spawn(
                self._actor_sender(actor_id, st))
        pt.seq = st.seq_counter
        st.seq_counter += 1
        st.pending.append(pt)
        st.work.set()

    async def _actor_sender(self, actor_id: str, st: ActorHandleState):
        """Per-actor ordered submission pipeline: sends are serialized (so
        method calls start in submission order, the reference's
        SequentialActorSubmitQueue guarantee); responses are awaited
        concurrently so calls pipeline. Retries of calls that died with a
        connection re-enter by sequence number ahead of later fresh
        submissions."""
        while True:
            while not st.retry and not st.pending:
                st.work.clear()
                await st.work.wait()
            if st.retry:
                _, pt = heapq.heappop(st.retry)
            else:
                pt = st.pending.popleft()
            await self._resolve_dependencies(pt.arg_refs)
            while True:
                await st.ready.wait()
                if st.retry and st.retry[0][0] < pt.seq:
                    # while we were blocked, earlier in-flight calls
                    # failed into the retry heap: they must go first
                    heapq.heappush(st.retry, (pt.seq, pt))
                    _, pt = heapq.heappop(st.retry)
                if st.state == "DEAD":
                    self._fail_task(pt, ActorDiedError(
                        f"actor {actor_id[:12]} is dead: {st.death_cause}"))
                    break
                address = st.address
                try:
                    conn = await self.pool.get(address)
                except (rpc.ConnectionLost, ConnectionError) as e:
                    if not self._note_actor_conn_loss(st, address):
                        continue
                    if pt.retries_left != 0:
                        if pt.retries_left > 0:
                            pt.retries_left -= 1
                        continue
                    self._fail_task(pt, ActorDiedError(
                        f"actor {actor_id[:12]} connection lost: {e}"))
                    break
                if st.retry and st.retry[0][0] < pt.seq:
                    # pool.get suspended (fresh connection): earlier
                    # in-flight calls may have failed into the retry heap
                    # meanwhile — they must go first
                    heapq.heappush(st.retry, (pt.seq, pt))
                    _, pt = heapq.heappop(st.retry)
                    continue
                # coalesce immediately-sendable successors into one frame
                # (order preserved; only when no retry is waiting and the
                # next calls' deps are already satisfied). Per-call acks
                # stream back as PARTIALs, so batching never delays or
                # coarsens completion
                batch = [pt]
                while (not st.retry and st.pending
                       and not pt.spec.get("streaming")
                       and not st.pending[0].spec.get("streaming")
                       and len(batch) < cfg.actor_push_batch
                       and self._deps_ready(st.pending[0])):
                    batch.append(st.pending.popleft())
                if pt.spec.get("streaming") \
                        and pt.spec["task_id"] not in self._generators:
                    # closed before dispatch: skip execution entirely
                    self._fail_task(pt, TaskCancelledError(
                        pt.spec.get("name", "stream")))
                    break
                try:
                    if pt.spec.get("streaming"):
                        gen = self._generators.get(pt.spec["task_id"])
                        gen._worker_address = address
                        fut = conn.call_start_parts(
                            "push_task_streaming", {"spec": pt.spec},
                            functools.partial(self._on_gen_part, pt))
                    elif len(batch) == 1:
                        fut = conn.call_start_nowait("push_task",
                                                     {"spec": pt.spec})
                    else:
                        fut = conn.call_start_parts(
                            "push_tasks",
                            {"specs": [p.spec for p in batch]},
                            functools.partial(self._on_actor_part, batch))
                except (rpc.ConnectionLost, ConnectionError) as e:
                    if not self._note_actor_conn_loss(st, address):
                        continue
                    requeued = False
                    for p in batch:
                        if p.retries_left != 0:
                            if p.retries_left > 0:
                                p.retries_left -= 1
                            heapq.heappush(st.retry, (p.seq, p))
                            requeued = True
                        else:
                            self._fail_task(p, ActorDiedError(
                                f"actor {actor_id[:12]} connection lost:"
                                f" {e}"))
                    if requeued:
                        st.work.set()
                        continue
                    break
                # completion rides the response future's callback — no
                # task per in-flight call (reference pipelines the same
                # way, actor_task_submitter.h:75)
                fut.add_done_callback(
                    functools.partial(self._on_actor_reply, batch,
                                      actor_id, st, address))
                try:
                    await conn.maybe_drain()   # backpressure: slow peer
                except (rpc.ConnectionLost, ConnectionError):
                    pass   # the reply callback handles the failure
                break

    def _deps_ready(self, pt: "PendingTask") -> bool:
        """True when every arg ref is locally known-complete (the batch
        fast path; anything else goes through _resolve_dependencies)."""
        for r in pt.arg_refs:
            e = self.owned.get(r.id)
            if e is not None:
                if not e.get("complete"):
                    return False
            elif r.owner_address and r.owner_address != self.address:
                return False
        return True

    def _note_actor_conn_loss(self, st: ActorHandleState, address) -> bool:
        """Mark the actor's address suspect after a connection failure.
        Returns True if the caller should count this against retries."""
        self.pool.invalidate(address)
        if st.address == address and st.ready.is_set():
            st.ready.clear()
            st.state = "RESTARTING?"
        self._spawn(self._probe_actor(st.actor_id))
        return True

    def _on_actor_part(self, batch: List[PendingTask], idx: int, ok: bool,
                       payload):
        """Streamed per-call ack from a batched frame."""
        pt = batch[idx]
        if pt.done:
            return
        if ok:
            self._complete_task(pt, payload)
        else:
            self._fail_task(pt, RuntimeError(
                f"{payload[0]}: {payload[1]}" if isinstance(payload, list)
                else str(payload)))

    def _on_actor_reply(self, batch: List[PendingTask], actor_id: str,
                        st: ActorHandleState, address: str, fut):
        """Final-response callback for one frame (1..N coalesced calls):
        completes (single-call frames) or fails/requeues stragglers whose
        per-call ack never arrived."""
        exc = (asyncio.CancelledError("connection closed")
               if fut.cancelled() else fut.exception())
        if exc is None:
            if len(batch) == 1 and not batch[0].done:
                self._complete_task(batch[0], fut.result())
                gen = self._generators.pop(batch[0].spec["task_id"], None)
                if gen is not None:
                    gen._finish()
            return   # batched calls completed via their PARTIALs
        pending = [pt for pt in batch if not pt.done]
        if not pending:
            return
        if isinstance(exc, (rpc.ConnectionLost, ConnectionError,
                            asyncio.CancelledError)):
            self._note_actor_conn_loss(st, address)
            requeued = False
            for pt in pending:
                if pt.retries_left != 0:
                    if pt.retries_left > 0:
                        pt.retries_left -= 1
                    # re-run after restart IN SUBMISSION ORDER: a dying
                    # connection fails a pipeline of in-flight calls in
                    # arbitrary completion order; the seq heap restores
                    # it and jumps ahead of later fresh submissions.
                    # Calls acked by a PARTIAL never re-run.
                    heapq.heappush(st.retry, (pt.seq, pt))
                    requeued = True
                else:
                    self._fail_task(pt, ActorDiedError(
                        f"actor {actor_id[:12]} died mid-call: {exc}"))
            if requeued:
                st.work.set()
            return
        for pt in pending:
            if isinstance(exc, rpc.RpcError):
                self._fail_task(pt, RuntimeError(str(exc)))
            else:
                self._fail_task(pt, exc if isinstance(exc, Exception)
                                else RuntimeError(repr(exc)))

    async def _probe_actor(self, actor_id: str):
        """Refresh actor state from GCS after a connection loss."""
        await asyncio.sleep(cfg.actor_restart_probe_s)
        st = self.actor_handles.get(actor_id)
        if st is None or st.ready.is_set():
            return
        info = await self.gcs_call_async("get_actor_info", actor_id=actor_id)
        if info and info["state"] == "ALIVE" and info["address"]:
            st.state = "ALIVE"
            st.address = info["address"]
            st.ready.set()
        elif info and info["state"] == "DEAD":
            st.state = "DEAD"
            st.death_cause = info.get("death_cause")
            st.ready.set()

    async def kill_actor_async(self, actor_id: str, no_restart=True):
        await self.gcs_call_async("kill_actor", actor_id=actor_id,
                            no_restart=no_restart)

    # --------------------------------------------------------- execution side
    def h_push_task(self, conn, spec: Dict):
        # sync handler returning a Future: the rpc layer responds from the
        # future's done-callback, so the hot execution path spawns no
        # per-call dispatch task
        fut = self.loop.create_future()
        self._queue_for(spec).put_nowait((spec, fut))
        return fut

    def h_push_tasks(self, conn, seq, specs: List[Dict]):
        """Batched push with STREAMED acks: one frame in, a PARTIAL out
        per task as it completes (so a fast task's ack never waits for a
        slow one sharing its frame, and a worker death mid-batch only
        loses unacked tasks), then a final response."""
        state = {"remaining": len(specs)}

        def make_cb(idx):
            def cb(fut):
                if fut.cancelled():
                    conn.send_partial(seq, idx, False,
                                      ("CancelledError", "cancelled", ""))
                else:
                    exc = fut.exception()
                    if exc is not None:
                        conn.send_partial(
                            seq, idx, False,
                            (type(exc).__name__, str(exc), ""))
                    else:
                        conn.send_partial(seq, idx, True, fut.result())
                state["remaining"] -= 1
                if state["remaining"] == 0:
                    conn.send_final(seq, len(specs))
            return cb

        for idx, spec in enumerate(specs):
            fut = self.loop.create_future()
            fut.add_done_callback(make_cb(idx))
            self._queue_for(spec).put_nowait((spec, fut))

    h_push_tasks.streaming = True

    # ------------------------------------------------ streaming generators
    # (executor side; reference: ReportGeneratorItemReturns,
    # core_worker.proto:400 — here each yielded item is one PARTIAL frame
    # on the push_task_streaming RPC itself)

    def h_push_task_streaming(self, conn, seq, spec: Dict):
        """Streaming task push: items flow back as PARTIALs as the
        generator yields; the final RESPONSE carries the completion
        sentinel for return_ids[0]."""
        spec["_stream_out"] = (conn, seq)
        fut = self.loop.create_future()

        def done(f):
            if f.cancelled():
                conn._respond(seq, False, ("CancelledError", "cancelled", ""))
            elif f.exception() is not None:
                e = f.exception()
                conn._respond(seq, False, (type(e).__name__, str(e), ""))
            else:
                conn.send_final(seq, f.result())
        fut.add_done_callback(done)
        self._queue_for(spec).put_nowait((spec, fut))

    h_push_task_streaming.streaming = True

    def h_generator_ack(self, conn, task_id: bytes, consumed: int):
        st = self._gen_flow.get(task_id)
        if st is not None:
            st["acked"] = max(st["acked"], consumed)
            st["event"].set()

    def h_generator_close(self, conn, task_id: bytes):
        st = self._gen_flow.get(task_id)
        if st is not None:
            st["closed"] = True
            st["event"].set()
        else:
            # close raced ahead of execution (task still queued here):
            # leave a tombstone so _execute_streaming exits immediately
            # instead of producing into a window nobody will ever open
            self._gen_tombstones.add(task_id)
            while len(self._gen_tombstones) > 4096:
                self._gen_tombstones.pop()
        return True

    async def _execute_streaming(self, spec: Dict, fn, args, kwargs) -> Dict:
        """Drive a (sync or async) generator function, shipping each item
        as its own owner-visible return object with bounded in-flight
        items. Returns the final-response payload (the completion
        sentinel: the item count)."""
        conn, seq = spec.pop("_stream_out")
        task_id = spec["task_id"]
        limit = int(spec.get("backpressure")
                    or cfg.streaming_backpressure)
        closed_early = task_id in self._gen_tombstones
        self._gen_tombstones.discard(task_id)
        flow = {"acked": 0, "closed": closed_early,
                "event": asyncio.Event()}
        self._gen_flow[task_id] = flow
        sent = 0
        agen = sgen = None
        # streaming bodies run outside _execute's sync/async trace-setting
        # paths (each resumption lands on whatever executor thread is
        # free), so the task's propagated trace context is re-established
        # around every resumption — runtime spans recorded inside a
        # streaming generator (engine phases) parent under this task
        trace_pair = (spec.get("trace_id"), spec.get("span_id"))
        trace_tok = _trace_ctx.set(trace_pair)
        try:
            out = fn(*args, **kwargs)
            if hasattr(out, "__anext__"):
                agen = out
            elif hasattr(out, "__next__"):
                sgen = out
            else:
                raise TypeError(
                    f"num_returns='streaming' task {spec.get('name')} "
                    f"returned {type(out).__name__}, not a generator")
            _SENTINEL = object()

            def _next_sync():
                prev_trace = getattr(_exec_tls, "trace", None)
                _exec_tls.trace = trace_pair
                try:
                    return next(sgen)
                except StopIteration:
                    return _SENTINEL
                finally:
                    _exec_tls.trace = prev_trace

            while True:
                # bounded in-flight window: wait for consumption acks
                # (poll the connection so a dead consumer can't wedge
                # this executor forever)
                while (sent - flow["acked"] >= limit
                       and not flow["closed"] and not conn.closed):
                    flow["event"].clear()
                    try:
                        await asyncio.wait_for(flow["event"].wait(), 1.0)
                    except asyncio.TimeoutError:
                        pass
                if flow["closed"] or conn.closed:
                    break
                if agen is not None:
                    try:
                        value = await agen.__anext__()
                    except StopAsyncIteration:
                        break
                else:
                    value = await self.loop.run_in_executor(
                        self.executor, _next_sync)
                    if value is _SENTINEL:
                        break
                rid = ids.object_id_for_return(task_id, 2 + sent)
                conn.send_partial(seq, sent, True,
                                  self._encode_return(rid, value))
                sent += 1
        except Exception as e:
            # the error IS the next item: consumers hit it in stream
            # order via get(ref) (reference: generator errors surface on
            # the failing index's ref)
            if not conn.closed:
                s = serialization.serialize_error(e)
                conn.send_partial(seq, sent, True,
                                  ["wire"] + list(s.to_wire()))
                sent += 1
        finally:
            _trace_ctx.reset(trace_tok)
            self._gen_flow.pop(task_id, None)
            for g in (agen, sgen):
                if g is not None:
                    try:
                        closer = getattr(g, "aclose", None) \
                            or getattr(g, "close", None)
                        res = closer() if closer else None
                        if asyncio.iscoroutine(res):
                            await res
                    # rtlint: disable=RT004 — best-effort close of a user
                    # generator whose task already finished/errored; its
                    # close-time exception has nowhere useful to go
                    except Exception:
                        pass
            self.current_task_name = None
            self.current_task_id = None
        return {"returns": [self._encode_return(spec["return_ids"][0],
                                                sent)],
                "n_items": sent}

    def h_cancel_task(self, conn, task_id: bytes, force: bool = False):
        """Cancel a queued (not yet started) task on this worker
        (reference: CoreWorker::CancelTask — queued tasks are dropped;
        force-cancel of running tasks kills the worker)."""
        self._cancelled_tasks.add(task_id)
        # force-kill only if the task being cancelled is the one running —
        # never take down an unrelated task sharing this worker
        if force and self.current_task_id == task_id:
            asyncio.get_event_loop().call_later(0.05, os._exit, 1)
        return True

    def _queue_for(self, spec: Dict) -> "asyncio.Queue":
        """Route a task to its concurrency group's queue (per-call option
        wins over the method's declared group; default queue otherwise)."""
        gq = getattr(self, "_group_queues", None)
        if not gq:
            return self._exec_queue
        group = spec.get("concurrency_group") \
            or self._method_groups.get(spec.get("method"))
        return gq.get(group, self._exec_queue)

    async def _exec_consumer(self, queue: Optional["asyncio.Queue"] = None):
        queue = queue if queue is not None else self._exec_queue
        while not self._shutdown:
            spec, fut = await queue.get()
            if spec["task_id"] in self._cancelled_tasks:
                self._cancelled_tasks.discard(spec["task_id"])
                result = self._encode_error(
                    spec, TaskCancelledError(spec.get("name", "task")))
                if not fut.done():
                    fut.set_result(result)
                continue
            try:
                result = await self._execute(spec)
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                result = self._encode_error(spec, e)
            if not fut.done():
                fut.set_result(result)

    def _apply_accelerator_ids(self, spec: Dict):
        ids = spec.get("accelerator_ids")
        # what get_gpu_ids() reports for the running task or actor
        self.accelerator_ids = dict(ids or {})
        try:
            from ray_tpu_torch._private.accelerators import (all_accelerator_managers,
                                                       get_accelerator_manager)
            if not ids:
                # restore the process's original visibility so a reused
                # worker doesn't leak a previous task's chip mask
                for res, mgr in all_accelerator_managers().items():
                    orig = self._orig_visible.get(res)
                    var = mgr.get_visible_accelerator_ids_env_var()
                    if res in self._visible_dirty:
                        if orig is None:
                            os.environ.pop(var, None)
                        else:
                            os.environ[var] = orig
                        self._visible_dirty.discard(res)
                return
            for res, chip_ids in ids.items():
                mgr = get_accelerator_manager(res)
                if mgr is not None:
                    var = mgr.get_visible_accelerator_ids_env_var()
                    self._orig_visible.setdefault(res, os.environ.get(var))
                    self._visible_dirty.add(res)
                    mgr.set_current_process_visible_accelerator_ids(
                        [str(c) for c in chip_ids])
        except Exception:
            logger.exception("failed to set accelerator visibility")

    async def _package_runtime_env(self, renv: Dict) -> Dict:
        """Submission side: zip local working_dir / py_modules dirs into
        content-addressed GCS KV packages (reference: runtime-env
        packaging python/ray/_private/runtime_env/packaging.py — GCS URI
        zips; URI-cached so identical dirs upload once)."""
        import hashlib
        import io
        import zipfile
        out = dict(renv)

        async def pack_dir(path: str) -> str:
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                for root, dirs, files in os.walk(path):
                    dirs[:] = [d for d in dirs if d != "__pycache__"]
                    for fname in sorted(files):
                        full = os.path.join(root, fname)
                        z.write(full, os.path.relpath(full, path))
            data = buf.getvalue()
            uri = hashlib.sha1(data).hexdigest()
            existing = await self.gcs_call_async("kv_get", ns="runtime_env",
                                           key=uri.encode())
            if existing is None:
                await self.gcs_call_async("kv_put", ns="runtime_env",
                                    key=uri.encode(), value=data)
            return uri

        wd = out.get("working_dir")
        if wd and os.path.isdir(wd):
            out["working_dir_uri"] = await pack_dir(wd)
            out["working_dir_base"] = os.path.basename(
                os.path.abspath(wd))
            del out["working_dir"]
        uris = []
        for m in out.get("py_modules") or []:
            if os.path.isdir(m):
                uris.append([await pack_dir(m),
                             os.path.basename(os.path.abspath(m))])
        if uris:
            out["py_modules_uris"] = uris
            out.pop("py_modules", None)
        return out

    def _materialize_uri(self, uri: str, base: str = "") -> str:
        """Worker side: fetch + extract a packaged dir (content-addressed
        cache shared by all workers on the node; reference: uri_cache.py)."""
        import zipfile
        dest = runtime_dir("runtime_envs", uri)
        mod_root = os.path.join(dest, base) if base else dest
        if os.path.isdir(dest):
            return mod_root
        data = asyncio.run_coroutine_threadsafe(
            self.gcs_call_async("kv_get", ns="runtime_env", key=uri.encode()),
            self.loop).result(120)
        if data is None:
            raise RuntimeError(f"runtime_env package {uri} missing")
        tmp = dest + ".tmp" + os.urandom(4).hex()
        extract_to = os.path.join(tmp, base) if base else tmp
        os.makedirs(extract_to, exist_ok=True)
        import io
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            z.extractall(extract_to)
        try:
            os.rename(tmp, dest)
        except OSError:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)   # raced another worker
        return mod_root

    _PIP_ENV_ROOT = runtime_dir("runtime_envs")

    def _ensure_pip_env(self, packages: List[str]) -> str:
        """Materialize a cached package dir for a pip runtime env and
        return it (reference: _private/runtime_env/pip.py — hashed-spec
        isolated installs; here `pip install --target` into a per-spec
        dir layered onto sys.path, which composes with the base install
        the way the reference's --system-site-packages venv does and
        works when the interpreter itself lives in a venv). A file lock
        serializes concurrent workers; the dir is only marked ready once
        the install succeeded."""
        import hashlib
        import subprocess
        import sys

        key = hashlib.sha1("\n".join(sorted(packages)).encode()).hexdigest()
        env_dir = os.path.join(self._PIP_ENV_ROOT, f"pip_{key[:16]}")
        ready = os.path.join(env_dir, ".ready")
        site = os.path.join(env_dir, "pkgs")
        if os.path.exists(ready):
            return site
        os.makedirs(self._PIP_ENV_ROOT, exist_ok=True)
        import fcntl
        with open(os.path.join(self._PIP_ENV_ROOT,
                               f".lock_{key[:16]}"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(ready):
                return site
            proc = subprocess.run(
                [sys.executable, "-m", "pip", "install",
                 "--no-build-isolation", "--target", site, *packages],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip runtime env install failed: {proc.stderr[-2000:]}")
            with open(ready, "w") as f:
                f.write("ok")
        return site

    def _apply_runtime_env(self, spec: Dict):
        """Worker-scope runtime env for this execution, dispatched
        through the plugin protocol (reference:
        python/ray/_private/runtime_env/plugin.py — env_vars /
        working_dir / py_modules / pip are built-in plugins; user
        plugins register via RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS; container is
        process-scope and was applied by the node manager at spawn).
        Runs on the executor thread, so blocking KV fetches and pip
        installs are safe."""
        import sys

        from ray_tpu_torch._private.runtime_env_plugins import \
            apply_worker_plugins
        renv = spec.get("runtime_env")
        if not renv:
            return None
        ctx = apply_worker_plugins(renv, self)
        saved: Dict[str, Optional[str]] = {}
        for k, v in ctx.env_vars.items():
            saved[k] = os.environ.get(k)
            os.environ[k] = v
        _chaos_env_changed(k for k, v in ctx.env_vars.items()
                           if saved[k] != v)
        saved_cwd = None
        if ctx.cwd:
            saved_cwd = os.getcwd()
            os.chdir(ctx.cwd)
        added_paths: List[str] = []
        for p in ctx.py_paths:
            sys.path.insert(0, p)
            added_paths.append(p)
        for p in ctx.permanent_py_paths:
            # pip site: permanent for this worker's life — the node
            # manager only ever reuses it for the same env hash
            # (reference: per-env worker pools)
            if p not in sys.path:
                sys.path.insert(0, p)
        return (saved, saved_cwd, added_paths)

    def _restore_runtime_env(self, token):
        import sys
        if token is None:
            return
        saved, saved_cwd, added_paths = token
        _chaos_env_changed(k for k, v in saved.items()
                           if os.environ.get(k) != v)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if saved_cwd is not None:
            os.chdir(saved_cwd)
        for p in added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass

    async def _execute(self, spec: Dict) -> Dict:
        self._record_task_event(
            spec["task_id"], "RUNNING", name=spec.get("name"),
            job_id=spec.get("job_id"), node_id=self.node_id,
            worker_id=self.worker_id,
            trace_id=spec.get("trace_id"), span_id=spec.get("span_id"),
            parent_span_id=spec.get("parent_span_id"),
            type="ACTOR_TASK" if spec.get("actor_id") else "NORMAL_TASK")
        trace_pair = (spec.get("trace_id"), spec.get("span_id"))
        if not spec.get("actor_id"):
            # actor workers keep the mask set at become_actor for life
            self._apply_accelerator_ids(spec)
        args, kwargs = await self._resolve_args(spec)
        if spec.get("actor_id"):
            if self.actor_instance is None:
                raise RuntimeError("actor task on non-actor worker")
            if spec["method"] == "__rt_dag_loop__":
                # compiled-DAG execution loop (ray_tpu_torch.dag.compiled)
                from ray_tpu_torch.dag.compiled import _dag_actor_loop
                import functools
                fn = functools.partial(_dag_actor_loop, self.actor_instance)
            else:
                fn = getattr(self.actor_instance, spec["method"])
        else:
            fn = await self._load_function_any(spec)
        self.current_task_name = spec["name"]
        self.current_task_id = spec["task_id"]
        if spec.get("streaming"):
            return await self._execute_streaming(spec, fn, args, kwargs)
        if asyncio.iscoroutinefunction(getattr(fn, "__call__", fn)) or \
                asyncio.iscoroutinefunction(fn):
            tok = _trace_ctx.set(trace_pair)
            try:
                value = await fn(*args, **kwargs)
            finally:
                _trace_ctx.reset(tok)
        else:
            key = spec.get("method") or spec.get("func_id")

            def _call():
                token = self._apply_runtime_env(spec)
                prev = getattr(_exec_tls, "method_key", None)
                prev_trace = getattr(_exec_tls, "trace", None)
                _exec_tls.method_key = key
                _exec_tls.trace = trace_pair
                try:
                    return fn(*args, **kwargs)
                finally:
                    _exec_tls.method_key = prev
                    _exec_tls.trace = prev_trace
                    self._restore_runtime_env(token)
            # adaptive inline execution: methods with a sub-threshold
            # running-average duration skip the thread-pool round trip
            # (two loop wakeups + condvar, ~100us on a busy box). A method
            # that turns slow migrates back to the pool on the next call.
            # Inline code CANNOT use blocking sync APIs (they bridge onto
            # this very loop), so a method OBSERVED using the bridge
            # during its pool runs is marked inline-unsafe for good; the
            # rare first-ever bridge call while inline fail-fasts into a
            # clean task error (never a silent re-run — side effects must
            # not double, reference retry semantics are opt-in)
            # Inlining requires EVIDENCE, not one lucky sample: the EMA
            # is an average (a data-dependent slow call would block the
            # whole loop), so demand >=3 consecutive sub-threshold runs
            # before inlining, and a single run over threshold demotes
            # the method back to the pool until it re-earns the streak.
            ema = self._exec_ema.get(key)
            streak = self._exec_streak.get(key, 0)
            t0 = time.perf_counter()
            if (ema is not None and streak >= 3 and self._inline_ok
                    and key not in self._inline_unsafe
                    and ema < cfg.inline_exec_threshold_s):
                try:
                    value = _call()
                except _InlineBridgeError:
                    self._inline_unsafe.add(key)
                    raise RuntimeError(
                        f"{spec.get('name')}: blocking ray_tpu_torch API call "
                        "from inline execution; the method is now marked "
                        "for thread-pool execution — retry the call")
            else:
                value = await self.loop.run_in_executor(self.executor,
                                                        _call)
            dt = time.perf_counter() - t0
            if key is not None:
                self._exec_ema[key] = dt if ema is None \
                    else 0.8 * ema + 0.2 * dt
                self._exec_streak[key] = streak + 1 \
                    if dt < cfg.inline_exec_threshold_s else 0
        self.current_task_name = None
        self.current_task_id = None
        nret = len(spec["return_ids"])
        if nret == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != nret:
                raise ValueError(
                    f"task returned {len(values)} values, expected {nret}")
        if spec.get("xlang"):
            return {"returns": [self._encode_return(rid, v, xlang=True)
                                for rid, v in zip(spec["return_ids"],
                                                  values)]}
        pairs = [(rid, serialization.serialize(v))
                 for rid, v in zip(spec["return_ids"], values)]

        def store_all():
            return [self._store_return(rid, s) for rid, s in pairs]
        if self.store is None or all(s.is_inline() for _, s in pairs):
            return {"returns": store_all()}
        # a large return's copy into the arena (seconds for a GB-sized
        # checkpoint) runs on the executor, not on the loop, which keeps
        # receiving and starting this worker's other tasks meanwhile
        return {"returns": await self.loop.run_in_executor(self.executor,
                                                           store_all)}

    def _encode_return(self, rid: bytes, value, xlang: bool = False) -> list:
        if xlang:
            # cross-language caller: msgpack result inline on the wire
            import msgpack as _mp
            payload = _mp.packb(value, use_bin_type=True, default=str)
            return ["wire", serialization.KIND_MSGPACK, b"", [payload]]
        return self._store_return(rid, serialization.serialize(value))

    def _store_return(self, rid: bytes,
                      s: serialization.SerializedObject) -> list:
        if s.is_inline() or self.store is None:
            return ["wire"] + list(s.to_wire())
        try:
            meta = s.store_meta()
            bufs = self._create_with_spill_retry(rid, s.data_size(),
                                                 len(meta))
            if bufs is not None:
                data, meta_view = bufs
                s.write_to(data)
                meta_view[:] = meta
                self.store.seal(rid)
            return ["shm", self.node_id]
        except Exception:
            logger.exception("shm return failed; inlining")
            return ["wire"] + list(s.to_wire())

    def _encode_error(self, spec, exc: BaseException) -> Dict:
        if not isinstance(exc, TaskError):
            logger.debug("task %s raised", spec.get("name"),
                         exc_info=exc)
        if spec.get("xlang"):
            # cross-language callers can't unpickle Python exceptions:
            # ship the message as msgpack text (kind 1 marks an error)
            import msgpack
            cause = exc.cause if isinstance(exc, TaskError) and \
                getattr(exc, "cause", None) else exc
            payload = msgpack.packb(
                f"{type(cause).__name__}: {cause}", use_bin_type=True)
            ret = ["wire", 1, b"", [payload]]
            return {"returns": [ret for _ in spec["return_ids"]]}
        s = serialization.serialize_error(exc)
        ret = ["wire"] + list(s.to_wire())
        return {"returns": [ret for _ in spec["return_ids"]]}

    async def _resolve_args(self, spec):
        async def dec(enc):
            if enc[0] == "v":
                return serialization.deserialize_wire(enc[1], enc[2], enc[3])
            ref = ObjectRef(enc[1], enc[2], _register=False)
            val, is_exc = await self._resolve(ref)
            if is_exc:
                raise TaskError(val) if not isinstance(val, TaskError) else val
            return val
        args = [await dec(a) for a in spec["args"]]
        kwargs = {k: await dec(v) for k, v in spec["kwargs"].items()}
        return args, kwargs

    async def h_become_actor(self, conn, spec: Dict):
        self._apply_accelerator_ids(spec)
        self._apply_runtime_env(spec)   # permanent for the actor's life
        if spec.get("class_ref"):
            # cross-language actor: importable "module:Class" instead of
            # a shipped pickle (reference: cross-language actor class
            # descriptors, java/cpp frontends)
            cls = _import_ref(spec["class_ref"])
        else:
            cls = await self._load_function(spec["class_id"],
                                            spec.get("owner_address"))
        args, kwargs = await self._resolve_args(
            {"args": spec["init_args"], "kwargs": spec["init_kwargs"]})
        self.actor_id = spec["actor_id"]
        self.actor_spec = spec
        maxc = spec.get("max_concurrency", 1)
        groups = spec.get("concurrency_groups") or {}
        self._method_groups = spec.get("method_groups") or {}
        extra = sum(groups.values())
        if maxc > 1 or groups:
            self._inline_ok = False    # parallel methods need real threads
            self.executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=maxc + extra, thread_name_prefix="actor-exec")
            for _ in range(maxc - 1):
                self._consumers.append(
                    self._spawn(self._exec_consumer()))
        # concurrency groups: per-group FIFO queue with its own consumer
        # pool, so e.g. an "io" group keeps serving while the default
        # group is busy (reference: ConcurrencyGroupManager + fibers,
        # core_worker/transport/concurrency_group_manager.h — threads
        # here, the asyncio loop plays the fiber scheduler)
        self._group_queues: Dict[str, asyncio.Queue] = {}
        for gname, limit in groups.items():
            q: asyncio.Queue = asyncio.Queue()
            self._group_queues[gname] = q
            for _ in range(max(1, int(limit))):
                self._consumers.append(
                    self._spawn(self._exec_consumer(q)))
        inner = cls.__ray_tpu_actual_class__ if hasattr(
            cls, "__ray_tpu_actual_class__") else cls
        # launch attribution: the callable-init phase (user __init__ —
        # model build, checkpoint load) records as a child of the
        # actor.launch trace the node manager forwarded in the spec
        lt = spec.get("_launch_trace") or {}
        t_init = time.time()
        instance = await self.loop.run_in_executor(
            self.executor, lambda: inner(*args, **kwargs))
        init_ms = (time.time() - t_init) * 1e3
        try:
            from ray_tpu_torch._private import events as _events
            _events.record_complete(
                "launch.callable_init", t_init, time.time(),
                category="launch", trace_id=lt.get("trace_id"),
                parent_span_id=lt.get("parent_span_id"),
                actor_id=spec["actor_id"])
            from ray_tpu_torch.util.metrics import Gauge
            if not hasattr(self, "_launch_phase_gauge"):
                self._launch_phase_gauge = Gauge(
                    "runtime_launch_phase_ms",
                    "most recent actor-launch phase duration (ms)")
            self._launch_phase_gauge.set(round(init_ms, 3),
                                         tags={"phase": "callable_init"})
        except Exception:
            pass
        self.actor_instance = instance
        return {"ok": True}

    async def h_exit(self, conn, reason: str = ""):
        asyncio.get_event_loop().call_later(0.05, os._exit, 0)
        return True

    def object_locations(self, refs) -> List[Optional[str]]:
        """Best-effort node ids for locally-known objects: owned refs
        carry the executor-reported primary location; store-resident
        objects are here. None = unknown (no cluster query — this is the
        cheap path locality-aware dealing needs, reference:
        RefBundle.get_cached_location)."""
        out: List[Optional[str]] = []
        for r in refs:
            entry = self.owned.get(r.id)
            if entry is not None and entry.get("location"):
                out.append(entry["location"])
            elif self.store is not None and self.store.contains(r.id):
                out.append(self.node_id)
            else:
                out.append(None)
        return out

    def h_dump_stacks(self, conn):
        """Live Python stacks of every thread in this worker (the
        `ray_tpu_torch stack` data plane; reference: `ray stack` via py-spy —
        here each process serves its own frames, no ptrace)."""
        from ray_tpu_torch._private.proc_util import format_thread_stacks
        from ray_tpu_torch.util import sanitizers
        return {"pid": os.getpid(), "mode": self.mode,
                "stacks": format_thread_stacks(),
                "loop_stats": sanitizers.stats_snapshot()}

    async def dump_cluster_stacks_async(self) -> Dict[str, Any]:
        """node_id -> {node_manager: ..., workers: {worker_id: ...}} for
        every alive node (fans out through each node manager)."""
        out: Dict[str, Any] = {}
        nodes = await self.gcs_call_async("get_all_nodes")
        for n in nodes:
            if not n.get("alive"):
                continue
            try:
                out[n["node_id"]] = await asyncio.wait_for(
                    self.pool.call(n["address"], "dump_stacks"), 15.0)
            except Exception as e:
                out[n["node_id"]] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # ------------------------------------------------------------- utilities
    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(self.get_async(ref), self.loop)

    async def stop_async(self, private_loop: bool = True):
        self._shutdown = True
        # return held idle leases so the node manager can re-grant the
        # workers NOW — other drivers may be queued on them (the server
        # also reclaims by owner on disconnect, but an explicit return
        # frees the resources before the TCP teardown races the next
        # lease wait poll)
        leases = [l for pool in self._idle_leases.values() for l in pool]
        self._idle_leases.clear()
        if leases:
            try:
                await asyncio.wait_for(
                    asyncio.gather(*(self._drop_lease(l) for l in leases),
                                   return_exceptions=True), 2.0)
            except Exception:
                pass
        # flush buffered task events so the GCS timeline isn't truncated
        if self._task_events and self.gcs is not None and not self.gcs.closed:
            batch, self._task_events = self._task_events, []
            try:
                await asyncio.wait_for(
                    self.gcs.notify("add_task_events", events=batch), 1.0)
            except Exception:
                pass
        if self.gcs is not None and not self.gcs.closed:
            # flight-recorder spans buffered in this process ride the same
            # sink — a short-lived worker's runtime events must not die
            # with its 1s flusher cadence
            try:
                from ray_tpu_torch._private import events as _events
                ev_rows = _events.drain()
                if ev_rows:
                    await asyncio.wait_for(
                        self.gcs.notify("add_task_events", events=ev_rows),
                        1.0)
            except Exception:
                pass
            # ledger: announce this worker's exit (its owned-table dies
            # with it — sealed objects it leaves behind become leak
            # candidates) and ship any buffered provenance records
            try:
                if ledger.enabled():
                    ledger.record(b"", "worker_exit",
                                  worker_id=self.worker_id)
                batch = ledger.drain()
                if batch:
                    await asyncio.wait_for(
                        self.gcs.notify("update_object_ledger",
                                        records=batch,
                                        node_id=self.node_id,
                                        worker_id=self.worker_id), 1.0)
            except Exception:
                pass
            # final metrics push (mirror of the task-event flush above):
            # counters from workers shorter-lived than the 2s push cadence
            # land in the GCS aggregate instead of vanishing
            try:
                from ray_tpu_torch.util.metrics import registry_snapshot
                payload = registry_snapshot()
                if payload:
                    await asyncio.wait_for(
                        self.gcs.notify("report_metrics",
                                        worker_id=self.worker_id,
                                        node_id=self.node_id,
                                        metrics=payload), 1.0)
            except Exception:
                pass
        # retire the registry pusher thread — a stopped worker must not
        # leave it spinning on is_initialized() forever
        try:
            from ray_tpu_torch.util import metrics as _metrics
            _metrics.stop_pusher()
        except Exception:
            pass
        # seal the crash black box: final metrics snapshot + seal record
        # (atexit would also fire, but a clean stop should seal while the
        # ring is already drained, marking this box as a graceful exit)
        try:
            from ray_tpu_torch._private import blackbox as _blackbox
            _blackbox.seal("clean_exit")
        except Exception:
            pass
        # cancel-and-await every background task (senders, dispatchers,
        # flushers, probes) BEFORE closing connections: nothing may outlive
        # shutdown (no "Task was destroyed but it is pending!")
        me = asyncio.current_task()
        # drain in rounds: a task cancelled mid-cleanup may spawn another
        # (it lands in _bg and is caught by the next round)
        for _ in range(10):
            victims = [t for t in self._bg if t is not me and not t.done()]
            if not victims:
                break
            for t in victims:
                t.cancel()
            await asyncio.gather(*victims, return_exceptions=True)
        if self.server:
            await self.server.close()
        if self.gcs:
            await self.gcs.close()
        if self.node_conn:
            await self.node_conn.close()
        await self.pool.close()
        if self.store is not None:
            self.store.close()
        # surface anything that escaped tracking (test hook: must be empty).
        # on a private loop every task belongs to this worker, so check the
        # whole loop (catches rpc-layer escapes too); on a shared loop
        # (owns_loop=False) only our tracked tasks are ours to judge
        pool = asyncio.all_tasks() if private_loop else self._bg
        leaked = [t for t in pool if t is not me and not t.done()]
        names = [f"{t.get_name()}:{getattr(t.get_coro(), '__qualname__', t.get_coro())}"
                 for t in leaked]
        if leaked:
            logger.warning("shutdown leaked %d pending tasks: %s",
                           len(leaked), names[:8])
        return names


global_worker: Optional["Worker"] = None


class Worker:
    """Sync facade over CoreWorker: runs the asyncio loop on a daemon thread
    and bridges public API calls with run_coroutine_threadsafe (the role the
    reference's Cython binding plays over its C++ event loops,
    reference: python/ray/_raylet.pyx:3282)."""

    def __init__(self, core: CoreWorker, owns_loop: bool = True):
        self.core = core
        self.owns_loop = owns_loop
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def start(cls, **kw) -> "Worker":
        core = CoreWorker(**kw)
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(core.start_async())
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, name="ray-tpu-loop", daemon=True)
        t.start()
        if not started.wait(timeout=30):
            raise TimeoutError("core worker failed to start")
        w = cls(core)
        w._thread = t
        return w

    def _run(self, coro, timeout=None):
        key = getattr(_exec_tls, "method_key", None)
        if key is not None:
            # task code used a blocking sync API on a pool thread: this
            # method must never migrate to inline execution
            self.core._inline_unsafe.add(key)
        if threading.get_ident() == self.core._loop_thread_ident:
            # inline-executed task code blocking on its own loop would
            # deadlock; fail fast (converted to a task error by _execute)
            coro.close()
            raise _InlineBridgeError(
                "blocking sync API called from inline task execution")
        return asyncio.run_coroutine_threadsafe(
            coro, self.core.loop).result(timeout)

    # public-api operations
    def put(self, value) -> ObjectRef:
        # no loop bridge: serialization + arena copy + seal run right here
        # on the calling thread (also makes put safe from inline-executed
        # task code — it no longer blocks on the loop it runs on)
        return self.core.put_local(value)

    def get(self, refs, timeout=None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        vals = self._run(self.core.get_many_async(refs, timeout))
        return vals[0] if single else vals

    def get_async(self, ref):
        return self.core.get_async(ref)

    def as_future(self, ref):
        return self.core.as_future(ref)

    def wait(self, refs, num_returns=1, timeout=None):
        return self._run(self.core.wait_async(refs, num_returns, timeout))

    def submit(self, func, args, kwargs, **opts) -> List[ObjectRef]:
        return self.core.submit_task_threadsafe(func, args, kwargs, **opts)

    def submit_streaming(self, func, args, kwargs, **opts):
        return self.core.submit_streaming_task_threadsafe(
            func, args, kwargs, **opts)

    def submit_actor_streaming(self, actor_id, method, args, kwargs,
                               **opts):
        return self.core.submit_streaming_actor_task_threadsafe(
            actor_id, method, args, kwargs, **opts)

    def create_actor(self, cls, args, kwargs, **opts) -> str:
        return self._run(self.core.create_actor_async(cls, args, kwargs, **opts))

    def submit_actor_task(self, actor_id, method, args, kwargs, **opts):
        return self.core.submit_actor_task_threadsafe(
            actor_id, method, args, kwargs, **opts)

    def kill_actor(self, actor_id, no_restart=True):
        return self._run(self.core.kill_actor_async(actor_id, no_restart))

    def broadcast(self, ref, node_ids):
        return self._run(self.core.broadcast_async(ref, node_ids))

    def broadcast_weights(self, ref, node_ids=None, max_retries=2):
        return self._run(self.core.broadcast_weights_async(
            ref, node_ids, max_retries=max_retries))

    def cancel(self, ref, force=False):
        return self._run(self.core.cancel_task_async(ref, force))

    def gcs_call(self, method, **kw):
        return self._run(self.core.gcs_call_async(method, **kw))

    def node_call(self, method, **kw):
        return self._run(self.core.node_conn.call(method, **kw))

    def stop(self):
        self.leaked_tasks: Optional[list] = None
        try:
            self.leaked_tasks = self._run(
                self.core.stop_async(private_loop=self.owns_loop), timeout=5)
        except Exception:
            pass
        if self.owns_loop and self.core.loop is not None:
            self.core.loop.call_soon_threadsafe(self.core.loop.stop)
