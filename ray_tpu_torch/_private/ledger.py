"""Object-lifetime ledger: per-process provenance deltas for the store.

The arena is the system's center of gravity (striped sub-heaps, spanning
allocations, zero-copy transfers), yet nothing answered "what is in the
store, who owns it, why won't it evict, where did the bytes go" without
gdb. This module is the WRITE side of that answer: every object-lifecycle
edge a process observes — create+seal (with creator worker/task, owner,
size, placement), transfer arrival, spill/restore, eviction, free — is
recorded as a small delta and lazily flushed into the GCS
``object_ledger`` table, which merges per-node deltas into one provenance
row per object id (read side: ``util/state.list_objects`` joins these
rows with live arena truth; ``ray_tpu_torch memory`` renders them).

The ring reuses the flight-recorder discipline (events.py), in
order of importance:

1. **Hot-path cost**: a disabled ledger is one global-flag read; an
   enabled one is a dict build plus a locked list append. No
   serialization, no RPC, no native calls beyond what the caller already
   paid. The acceptance bench (`bench.py observability_overhead`) holds
   the enabled put path under the same 5% guard as the recorder.
2. **Bounded memory with deterministic drop accounting**: the ring keeps
   the NEWEST `capacity` records; overwrites are counted and shipped
   in-band as a ``dropped`` field on the next flushed batch, so a
   truncated provenance trail says so in the table itself.
3. **No hard runtime coupling**: records just rotate in a bare process;
   the flusher thread starts lazily and ships batches only once a sink
   exists (the connected worker, or the node manager's `set_sink`).

Ordering: each record carries a per-process monotonically increasing
``seq`` so the GCS merge can ignore stale duplicates from one process
without trusting wall clocks across processes.

Node managers additionally push a periodic arena CENSUS (presence, pin
counts, placement) through the same GCS handler — the census, not the
event stream, is the authority for "current location set", because LRU
eviction and crash repair reclaim objects without any event firing.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "record", "record_put", "enabled", "set_enabled", "configure",
    "stats", "drain", "flush", "set_sink", "set_identity",
]

_lock = threading.Lock()
_buf: List[Dict] = []
_dropped_total = 0
_dropped_unreported = 0
_capacity = int(os.environ.get("RAY_TPU_TORCH_LEDGER_BUFFER", "4096"))
_enabled = os.environ.get("RAY_TPU_TORCH_OBJECT_LEDGER", "1") != "0"
_sink: Optional[Callable[[List[Dict]], None]] = None
_identity: Dict[str, str] = {}
_flusher_started = False
_seq = itertools.count(1)


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Flip the ledger (worker connect applies cfg.ledger_enabled here
    after the head's config snapshot lands, so one head-side setting
    governs the cluster; tests and the overhead bench flip it too)."""
    global _enabled
    _enabled = bool(value)


def configure(capacity: Optional[int] = None) -> None:
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
    ledger records). The node manager ships through its own GCS
    connection this way; workers use the default worker sink."""
    global _sink
    _sink = fn


def set_identity(node_id: Optional[str] = None,
                 worker_id: Optional[str] = None) -> None:
    if node_id:
        _identity["node_id"] = node_id
    if worker_id:
        _identity["worker_id"] = worker_id


def _process_identity():
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


# --------------------------------------------------------------- recording
def record(object_id: bytes, event: str, ts: Optional[float] = None,
           **fields) -> None:
    """Append one lifecycle delta. `event` is one of: created, sealed,
    location_add, location_remove, spilled, restored, evicted, freed,
    refs, worker_exit (object_id ignored for worker_exit). Extra fields
    ride verbatim into the GCS row merge."""
    if not _enabled:
        return
    rec = {"object_id": object_id.hex() if isinstance(object_id, bytes)
           else object_id,
           "event": event, "ts": time.time() if ts is None else ts,
           "seq": next(_seq)}
    if fields:
        rec.update(fields)
    _append(rec)


def record_put(object_id: bytes, size: int, meta_size: int = 0,
               owner: Optional[str] = None,
               owner_worker: Optional[str] = None,
               node_id: Optional[str] = None,
               task_id: Optional[str] = None,
               is_span: bool = False,
               sealed: bool = True) -> None:
    """One-record create+seal provenance for the put fast path (two
    separate records would double the hot-path append for an edge pair
    that is atomic from the caller's perspective)."""
    if not _enabled:
        return
    now = time.time()
    _append({"object_id": object_id.hex(), "event": "created", "ts": now,
             "seq": next(_seq), "size": int(size),
             "meta_size": int(meta_size), "owner": owner,
             "owner_worker": owner_worker, "node_id": node_id,
             "task_id": task_id, "is_span": bool(is_span),
             "sealed": bool(sealed)})


def _append(rec: Dict) -> None:
    global _dropped_total, _dropped_unreported
    with _lock:
        if len(_buf) >= _capacity:
            # drop OLDEST: censuses reconcile lost presence deltas, and
            # the newest provenance is what a post-mortem needs
            del _buf[0]
            _dropped_total += 1
            _dropped_unreported += 1
        _buf.append(rec)
    if not _flusher_started:
        _ensure_flusher()


# ------------------------------------------------------------ flush plumbing
def drain(max_records: Optional[int] = None) -> List[Dict]:
    """Pop buffered records (the flusher and shutdown paths ship the
    result through the sink). The unreported-drop counter resets only
    when a non-empty batch leaves, so drops are always reported."""
    global _dropped_unreported
    with _lock:
        n = len(_buf) if max_records is None else min(max_records,
                                                      len(_buf))
        batch, dropped = _buf[:n], _dropped_unreported
        del _buf[:n]
        if batch:
            _dropped_unreported = 0
    if batch and dropped:
        batch[0] = dict(batch[0], dropped=dropped)
    return batch


def _default_sink() -> Optional[Callable[[List[Dict]], None]]:
    if _sink is not None:
        return _sink
    try:
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            return None
        w = ray_tpu_torch._get_worker()
        node_id, worker_id = _process_identity()
        return lambda batch: w.gcs_call(
            "update_object_ledger", records=batch, node_id=node_id,
            worker_id=worker_id)
    except Exception:
        return None


def flush() -> int:
    """Synchronous flush (shutdown paths, tests). Returns records
    shipped; 0 when no sink is reachable (records stay buffered)."""
    sink = _default_sink()
    if sink is None:
        return 0
    batch = drain()
    if not batch:
        return 0
    try:
        sink(batch)
    except Exception:
        return 0
    return len(batch)


_flush_err_logged = False


def _flush_loop():
    global _flush_err_logged
    while True:
        time.sleep(1.0)
        try:
            flush()
        except Exception:
            # flush() swallows sink errors; reaching here means the
            # ledger itself broke — say so once, don't spam a 1 Hz log
            if not _flush_err_logged:
                _flush_err_logged = True
                logging.getLogger(__name__).warning(
                    "ledger flush loop error (logged once)", exc_info=True)


def _ensure_flusher():
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, name="ledger-flush",
                     daemon=True).start()
