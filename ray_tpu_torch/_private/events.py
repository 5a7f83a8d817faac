"""Flight recorder: per-process runtime-event spans.

The task-event plane (worker.py `_record_task_event` -> GCS
`add_task_events`) sees task *boundaries*; everything inside a task —
an engine decode step, a spill pass, a shuffle reduce window — is
invisible to it. This module records those interior phases as spans and
instants and ships them into the SAME GCS sink as a distinct
``kind="runtime_event"`` row, so the existing read side (``ray_tpu_torch
timeline``, OTLP export, the dashboard) renders runtime phases and
tasks on one merged timeline (reference: Ray keeps lineage/event
metadata in the GCS for exactly this kind of post-hoc debugging,
PAPERS.md arxiv 1712.05889 §4.2; chrome-trace export via
python/ray/_private/state.py).

Design constraints, in order:

1. **Hot-path cost**: a disabled recorder is one global-flag read; an
   enabled one is two clock reads plus a locked list append. No
   serialization, no RPC, no allocation beyond the record dict. The
   acceptance bench (`bench.py observability_overhead`) holds the enabled
   recorder under 5% on the put and decode-step paths.
2. **Bounded memory with deterministic drop accounting**: the ring
   keeps the NEWEST `capacity` records; every overwrite increments a
   counter that is reported in-band (an ``events.dropped`` instant
   rides each flush that lost records), so a truncated timeline says
   so on the timeline itself.
3. **No hard runtime coupling**: the recorder works in a bare process
   (engine unit tests, probes) — records just rotate in the ring. A
   flusher thread starts lazily and ships batches only once a sink
   exists (the connected worker, or an explicit `set_sink` as used by
   the node manager).

Trace context: spans parent under the enclosing task's propagated
(trace_id, span_id) — read from worker.py's executing-task context —
so one Serve request renders proxy -> replica -> engine-slot ->
first-token as a single trace. `trace_context()` lets non-task threads
(the HTTP proxy, tests) establish a context explicitly.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "record_span", "record_instant", "record_complete", "start_span",
    "Span", "current_context", "trace_context", "new_trace_id",
    "new_span_id", "enabled", "set_enabled", "flush", "drain", "stats",
    "configure", "set_sink", "set_identity", "set_tap", "peek",
]

_lock = threading.Lock()
_buf: List[Dict] = []
_dropped_total = 0            # lifetime drops (never reset)
_dropped_unreported = 0       # drops since the last flushed batch
_capacity = int(os.environ.get("RAY_TPU_TORCH_RUNTIME_EVENT_BUFFER", "8192"))
_enabled = os.environ.get("RAY_TPU_TORCH_FLIGHT_RECORDER", "1") != "0"
_sink: Optional[Callable[[List[Dict]], None]] = None
_tap: Optional[Callable[[Dict], None]] = None
_identity: Dict[str, str] = {}
_flusher_started = False
_tls = threading.local()


# --------------------------------------------------------------------- ids
# span ids are the recorder's per-record hot cost: a counter mixed with
# a per-process random salt (splitmix64-style) is ~5x cheaper than an
# os.urandom syscall per span and still collision-safe across processes
# (64 random salt bits under multiplicative diffusion). Trace ids are
# minted rarely (once per root) and stay fully random.
_id_salt = int.from_bytes(os.urandom(8), "little")
_id_counter = __import__("itertools").count(1)
_MASK64 = (1 << 64) - 1


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    n = (next(_id_counter) * 0x9E3779B97F4A7C15 + _id_salt) & _MASK64
    n ^= n >> 31
    return format((n * 0xBF58476D1CE4E5B9) & _MASK64, "016x")


# ----------------------------------------------------------------- context
def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the innermost active context: an explicit
    `trace_context()` on this thread wins, else the executing task's
    propagated context (worker.py sets it per execution thread /
    coroutine). None outside any traced scope."""
    ctx = getattr(_tls, "trace", None)
    if ctx and ctx[0]:
        return ctx
    w = sys.modules.get("ray_tpu_torch._private.worker")
    if w is not None:
        ctx = getattr(w._exec_tls, "trace", None) or w._trace_ctx.get()
        if ctx and ctx[0]:
            return ctx
    return None


@contextlib.contextmanager
def trace_context(trace_id: Optional[str], span_id: Optional[str]):
    """Establish (trace_id, span_id) as the current thread's trace
    context. Also mirrored into worker.py's execution TLS so task
    submissions made inside the block chain their spans under it (the
    proxy wraps each routed handle call this way)."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = (trace_id, span_id)
    w = sys.modules.get("ray_tpu_torch._private.worker")
    w_prev = None
    if w is not None:
        w_prev = getattr(w._exec_tls, "trace", None)
        w._exec_tls.trace = (trace_id, span_id)
    try:
        yield
    finally:
        _tls.trace = prev
        if w is not None:
            w._exec_tls.trace = w_prev


# ------------------------------------------------------------------- spans
class Span:
    """One in-flight runtime span. `end()` commits it to the ring;
    a span never ended is never recorded (use `cancel()` to make that
    explicit). Safe to end from a different thread than start."""

    __slots__ = ("name", "category", "trace_id", "span_id",
                 "parent_span_id", "start", "attrs", "_done")

    def __init__(self, name: str, category: str,
                 trace_id: Optional[str], parent_span_id: Optional[str],
                 start: Optional[float], attrs: Dict):
        self.name = name
        self.category = category
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_span_id = parent_span_id
        self.start = time.time() if start is None else start
        self.attrs = attrs
        self._done = False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def end(self, end: Optional[float] = None, **attrs):
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        _append({"kind": "span", "name": self.name,
                 "category": self.category, "trace_id": self.trace_id,
                 "span_id": self.span_id,
                 "parent_span_id": self.parent_span_id,
                 "start": self.start,
                 "end": time.time() if end is None else end,
                 "attrs": self.attrs})

    def cancel(self):
        self._done = True


class _NullSpan:
    """Recorder disabled: every operation is a no-op attribute hit."""

    __slots__ = ()
    name = category = trace_id = span_id = parent_span_id = None
    start = 0.0
    attrs: Dict = {}

    def set(self, **attrs):
        return self

    def end(self, end=None, **attrs):
        pass

    def cancel(self):
        pass


_NULL_SPAN = _NullSpan()


def start_span(name: str, category: str = "runtime",
               trace_id: Optional[str] = None,
               parent_span_id: Optional[str] = None,
               start: Optional[float] = None, **attrs):
    """Open a span. With no explicit trace_id/parent, it chains under
    `current_context()`; with neither, it roots a fresh trace."""
    if not _enabled:
        return _NULL_SPAN
    if trace_id is None and parent_span_id is None:
        ctx = current_context()
        if ctx is not None:
            trace_id, parent_span_id = ctx
    return Span(name, category, trace_id, parent_span_id, start, attrs)


@contextlib.contextmanager
def record_span(name: str, category: str = "runtime",
                trace_id: Optional[str] = None,
                parent_span_id: Optional[str] = None, **attrs):
    """Context-manager sugar over start_span/end. An exception inside
    the block is recorded on the span (`error` attr) and re-raised."""
    sp = start_span(name, category, trace_id=trace_id,
                    parent_span_id=parent_span_id, **attrs)
    try:
        yield sp
    except BaseException as e:
        sp.end(error=type(e).__name__)
        raise
    else:
        sp.end()


def record_instant(name: str, category: str = "runtime",
                   trace_id: Optional[str] = None,
                   parent_span_id: Optional[str] = None,
                   ts: Optional[float] = None, **attrs) -> None:
    """A zero-duration event (compile tick, eviction, drop marker)."""
    if not _enabled:
        return
    if trace_id is None and parent_span_id is None:
        ctx = current_context()
        if ctx is not None:
            trace_id, parent_span_id = ctx
    now = time.time() if ts is None else ts
    _append({"kind": "instant", "name": name, "category": category,
             "trace_id": trace_id or new_trace_id(),
             "span_id": new_span_id(), "parent_span_id": parent_span_id,
             "start": now, "end": now, "attrs": attrs})


def record_complete(name: str, start: float, end: float,
                    category: str = "runtime",
                    trace_id: Optional[str] = None,
                    parent_span_id: Optional[str] = None, **attrs) -> None:
    """Record an already-measured window (for call sites that decide
    AFTER the fact whether the window is worth recording, e.g. a spill
    pass that moved zero bytes)."""
    if not _enabled:
        return
    if trace_id is None and parent_span_id is None:
        ctx = current_context()
        if ctx is not None:
            trace_id, parent_span_id = ctx
    _append({"kind": "span", "name": name, "category": category,
             "trace_id": trace_id or new_trace_id(),
             "span_id": new_span_id(), "parent_span_id": parent_span_id,
             "start": start, "end": max(end, start), "attrs": attrs})


# -------------------------------------------------------------- ring + flush
def _append(rec: Dict) -> None:
    global _dropped_total, _dropped_unreported
    with _lock:
        if len(_buf) >= _capacity:
            # drop OLDEST: the newest records are the ones a post-mortem
            # needs; every drop is counted and reported in-band
            del _buf[0]
            _dropped_total += 1
            _dropped_unreported += 1
        _buf.append(rec)
    if _tap is not None:
        try:
            _tap(rec)
        except Exception:
            pass
    if not _flusher_started:
        _ensure_flusher()


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


def configure(capacity: Optional[int] = None) -> None:
    """Test/tuning hook; shrinking the capacity drops oldest records
    immediately (counted, like any overflow)."""
    global _capacity, _dropped_total, _dropped_unreported
    if capacity is not None:
        with _lock:
            _capacity = max(1, int(capacity))
            while len(_buf) > _capacity:
                del _buf[0]
                _dropped_total += 1
                _dropped_unreported += 1


def stats() -> Dict[str, int]:
    with _lock:
        return {"buffered": len(_buf), "capacity": _capacity,
                "dropped_total": _dropped_total,
                "dropped_unreported": _dropped_unreported}


def set_sink(fn: Optional[Callable[[List[Dict]], None]]) -> None:
    """Install an explicit flush target (a callable taking a batch of
    GCS task-event rows). Daemons that are not workers (the node
    manager) use this to ship through their own GCS connection."""
    global _sink
    _sink = fn


def set_tap(fn: Optional[Callable[[Dict], None]]) -> None:
    """Install a copy-tap: called with every ring record as it is
    appended, WITHOUT consuming it (flush/drain still ship normally).
    The crash black box uses this to mirror the flight recorder to disk
    continuously, so a SIGKILL'd process still leaves its last records
    behind. Must be cheap and must not raise (exceptions are swallowed
    to protect the recording hot path)."""
    global _tap
    _tap = fn


def peek(max_records: Optional[int] = None) -> List[Dict]:
    """Copy (do NOT consume) the newest buffered records — the black
    box seals with these so a final flush and a post-mortem snapshot
    can both see the same tail."""
    with _lock:
        if max_records is None:
            return list(_buf)
        return list(_buf[-max_records:])


def set_identity(node_id: Optional[str] = None,
                 worker_id: Optional[str] = None) -> None:
    if node_id:
        _identity["node_id"] = node_id
    if worker_id:
        _identity["worker_id"] = worker_id


def _process_identity() -> Tuple[str, str]:
    node_id = _identity.get("node_id")
    worker_id = _identity.get("worker_id")
    if node_id and worker_id:
        return node_id, worker_id
    w = sys.modules.get("ray_tpu_torch._private.worker")
    core = getattr(getattr(w, "global_worker", None), "core", None) \
        if w is not None else None
    if core is not None:
        return (node_id or getattr(core, "node_id", None)
                or f"pid-{os.getpid()}",
                worker_id or getattr(core, "worker_id", None)
                or f"pid-{os.getpid()}")
    pid = f"pid-{os.getpid()}"
    return node_id or pid, worker_id or pid


def _rows_for(rec: Dict, node_id: str, worker_id: str) -> List[Dict]:
    """One ring record -> GCS task-event rows. The span id doubles as
    the row's task_id so the GCS merge (keyed on task_id) folds the
    RUNNING/FINISHED pair into one row with both state times."""
    base = {
        "task_id": rec["span_id"], "kind": "runtime_event",
        "name": rec["name"], "category": rec["category"],
        "type": "RUNTIME_EVENT", "event_kind": rec["kind"],
        "trace_id": rec["trace_id"], "span_id": rec["span_id"],
        "parent_span_id": rec["parent_span_id"],
        "node_id": node_id, "worker_id": worker_id,
        "attrs": rec["attrs"],
        "state": "RUNNING", "ts": rec["start"],
    }
    if rec["kind"] == "instant":
        return [base]
    return [base, {"task_id": rec["span_id"], "state": "FINISHED",
                   "ts": rec["end"]}]


def drain(max_records: Optional[int] = None) -> List[Dict]:
    """Pop buffered records and render them as GCS task-event rows,
    feeding the built-in runtime metrics as a side effect. When records
    were dropped since the last drain, the batch carries an
    ``events.dropped`` instant with the exact count."""
    global _dropped_unreported
    with _lock:
        n = len(_buf) if max_records is None else min(max_records,
                                                      len(_buf))
        batch, dropped = _buf[:n], _dropped_unreported
        del _buf[:n]
        if batch:
            _dropped_unreported = 0
    if not batch:
        return []
    node_id, worker_id = _process_identity()
    rows: List[Dict] = []
    for rec in batch:
        _observe_builtin_metrics(rec)
        rows.extend(_rows_for(rec, node_id, worker_id))
    if dropped:
        marker = {"kind": "instant", "name": "events.dropped",
                  "category": "recorder", "trace_id": new_trace_id(),
                  "span_id": new_span_id(), "parent_span_id": None,
                  "start": time.time(), "end": time.time(),
                  "attrs": {"count": dropped}}
        _observe_builtin_metrics(marker)
        rows.extend(_rows_for(marker, node_id, worker_id))
    return rows


def _default_sink() -> Optional[Callable[[List[Dict]], None]]:
    if _sink is not None:
        return _sink
    try:
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            return None
        w = ray_tpu_torch._get_worker()
        return lambda batch: w.gcs_call("add_task_events", events=batch)
    except Exception:
        return None


def flush() -> int:
    """Synchronous flush (shutdown paths, tests). Returns the number of
    rows shipped; 0 when no sink is reachable (records stay buffered)."""
    sink = _default_sink()
    if sink is None:
        return 0
    rows = drain()
    if not rows:
        return 0
    try:
        sink(rows)
    except Exception:
        return 0
    return len(rows)


_flush_err_logged = False


def _flush_loop():
    global _flush_err_logged
    while True:
        time.sleep(1.0)
        try:
            flush()
        except Exception:
            # flush() already swallows sink errors; reaching here means
            # the recorder itself broke — say so once, don't spam a
            # 1 Hz daemon log
            if not _flush_err_logged:
                _flush_err_logged = True
                logging.getLogger(__name__).warning(
                    "event flush loop error (logged once)", exc_info=True)


def _ensure_flusher():
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, name="events-flush",
                     daemon=True).start()


# ------------------------------------------------------- built-in metrics
# Runtime metrics derived from spans, auto-registered on the existing
# /metrics plane the first time their span fires (engine step
# duration, spill bytes, scheduler queue latency). Observation happens
# at drain time — the flusher thread, never the recording hot path.
_builtin: Optional[Dict[str, Any]] = None
_builtin_lock = threading.Lock()


def _get_builtin() -> Dict[str, Any]:
    global _builtin
    if _builtin is None:
        with _builtin_lock:
            if _builtin is None:
                from ray_tpu_torch.util.metrics import Counter, Histogram
                ms = [0.1, 0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0]
                _builtin = {
                    "engine_step_ms": Histogram(
                        "runtime_engine_step_ms",
                        "inference engine decode-step duration (ms)",
                        boundaries=ms),
                    "queue_latency_ms": Histogram(
                        "runtime_scheduler_queue_latency_ms",
                        "request wait from submit to slot admission (ms)",
                        boundaries=ms),
                    "spill_bytes": Counter(
                        "runtime_spill_bytes_total",
                        "object-store bytes spilled to external storage"),
                    "restore_bytes": Counter(
                        "runtime_restore_bytes_total",
                        "object-store bytes restored from external "
                        "storage"),
                    "events_dropped": Counter(
                        "runtime_events_dropped_total",
                        "flight-recorder ring overwrites"),
                }
    return _builtin


def _observe_builtin_metrics(rec: Dict) -> None:
    name = rec["name"]
    try:
        if name == "engine.decode":
            _get_builtin()["engine_step_ms"].observe(
                (rec["end"] - rec["start"]) * 1e3)
        elif name == "engine.slot":
            wait = rec["attrs"].get("queue_wait_ms")
            if wait is not None:
                _get_builtin()["queue_latency_ms"].observe(float(wait))
        elif name == "store.spill":
            _get_builtin()["spill_bytes"].inc(
                float(rec["attrs"].get("bytes", 0) or 0))
        elif name == "store.restore":
            _get_builtin()["restore_bytes"].inc(
                float(rec["attrs"].get("bytes", 0) or 0))
        elif name == "events.dropped":
            _get_builtin()["events_dropped"].inc(
                float(rec["attrs"].get("count", 0) or 0))
    except Exception:
        pass
