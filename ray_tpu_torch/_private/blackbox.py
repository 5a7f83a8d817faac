"""Crash black boxes: bounded on-disk NDJSON mirrors of each process's
flight-recorder ring + last metrics snapshot.

The flight recorder (events.py) and the metrics pusher both ship state
to the GCS — which is exactly the component that is gone in the
failures worth debugging (GCS death, node-manager SIGKILL, a worker
OOM-killed mid-launch). The black box is the local, durable complement:
every daemon continuously appends its event records and periodic
metrics snapshots to a size-bounded NDJSON file, so whatever survives
on disk after a crash IS the post-mortem. `ray_tpu_torch blackbox` stitches
the surviving boxes of a session into one cross-node timeline
(clock-skew adjusted via the GCS clock offset each process learns at
registration).

Survivability model, in order of violence:

- **SIGKILL / OOM-kill / power loss**: nothing runs at death. The box
  is written *continuously* (every event record is appended as it is
  recorded, via events.set_tap), so the file already holds everything
  up to the last append. The final line may be torn; the reader skips
  unparseable lines.
- **Fatal-but-catchable (SIGTERM, GCS-disconnect suicide, unhandled
  exit)**: `seal(reason)` writes a final metrics snapshot, any ring
  records the tap never saw, and a terminal ``seal`` record, then
  fsyncs. A box without a seal record therefore died hard — the
  stitcher labels it so.
- **Clean exit**: same seal path via atexit, reason="clean_exit".

Bounded-size discipline mirrors the in-memory ring: the live segment
rotates to a single ``.1`` segment at max_bytes/2, so live+rotated stay
under max_bytes and always hold the NEWEST records.

File format: one JSON object per line. Every record carries ``ts``
(wall clock), ``seq`` (per-box monotonic counter — total order within
a box even when wall clocks step), and ``kind``:

- ``header`` — process identity, pid, clock_offset_s, opened-at; first
  line of every segment.
- ``event`` — one flight-recorder record (name/category/span ids/
  start/end/attrs), mirrored as recorded.
- ``metrics`` — a registry snapshot (same shape as report_metrics
  payloads).
- ``marker`` — process-lifecycle breadcrumbs (startup, gcs_disconnect,
  signal received, ...).
- ``seal`` — terminal record with the seal reason.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "BlackBox", "configure", "get", "record", "seal", "reset",
    "scan_boxes", "read_box", "stitch", "count_boxes", "box_path",
]

_SUFFIX = ".bbox.ndjson"

_lock = threading.Lock()
_box: Optional["BlackBox"] = None


def box_path(directory: str, process: str, pid: Optional[int] = None) -> str:
    pid = os.getpid() if pid is None else pid
    return os.path.join(directory, f"{process}-{pid}{_SUFFIX}")


class BlackBox:
    """One process's black box. Thread-safe; every write appends one
    NDJSON line and rotates at the size bound. Writes are line-buffered
    through a plain file object — an append is two syscalls, cheap
    enough to ride the event tap."""

    def __init__(self, path: str, max_bytes: int = 4 * 1024 * 1024,
                 process: str = "proc", node_id: str = "",
                 worker_id: str = "", clock_offset_s: float = 0.0):
        self.path = path
        self.max_bytes = max(int(max_bytes), 4096)
        self.process = process
        self.node_id = node_id
        self.worker_id = worker_id
        self.clock_offset_s = float(clock_offset_s)
        self._seq = 0
        self._size = 0
        self._sealed = False
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._size = self._f.tell()
        self._write_header()

    # ------------------------------------------------------------- writes
    def _write_header(self) -> None:
        self._write({"kind": "header", "process": self.process,
                     "pid": os.getpid(), "node_id": self.node_id,
                     "worker_id": self.worker_id,
                     "clock_offset_s": self.clock_offset_s})

    def set_clock_offset(self, offset_s: float) -> None:
        """Update the local-minus-GCS clock offset once it is measured
        (registration happens after the box opens). Re-headers so the
        reader sees the freshest offset regardless of segment."""
        self.clock_offset_s = float(offset_s)
        self._write_header()

    def _write(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if self._sealed:
                return
            self._seq += 1
            rec.setdefault("ts", time.time())
            rec["seq"] = self._seq
            try:
                line = json.dumps(rec, default=str) + "\n"
            except Exception:
                return
            try:
                if self._size + len(line) > self.max_bytes // 2:
                    self._rotate()
                self._f.write(line)
                self._f.flush()
                self._size += len(line)
            except Exception:
                pass

    def _rotate(self) -> None:
        # live -> .1 (replacing any prior .1): live+rotated <= max_bytes,
        # and the newest max_bytes/2 of history always survives.
        self._f.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = self._f.tell()
        # re-header the fresh segment inline (already under _lock):
        self._seq += 1
        hdr = {"kind": "header", "process": self.process,
               "pid": os.getpid(), "node_id": self.node_id,
               "worker_id": self.worker_id,
               "clock_offset_s": self.clock_offset_s,
               "ts": time.time(), "seq": self._seq, "rotated": True}
        line = json.dumps(hdr) + "\n"
        self._f.write(line)
        self._f.flush()
        self._size += len(line)

    def on_event(self, rec: Dict[str, Any]) -> None:
        """events.set_tap target: mirror one ring record."""
        self._write({"kind": "event", "name": rec.get("name"),
                     "category": rec.get("category"),
                     "event_kind": rec.get("kind"),
                     "trace_id": rec.get("trace_id"),
                     "span_id": rec.get("span_id"),
                     "parent_span_id": rec.get("parent_span_id"),
                     "start": rec.get("start"), "end": rec.get("end"),
                     "attrs": rec.get("attrs") or {},
                     "ts": rec.get("end") or rec.get("start")})

    def record(self, kind: str, **fields) -> None:
        """Lifecycle breadcrumb (kind='marker' unless caller overrides
        via a recognized kind like 'metrics')."""
        rec = {"kind": kind}
        rec.update(fields)
        self._write(rec)

    def snapshot_metrics(self) -> None:
        try:
            from ray_tpu_torch.util.metrics import registry_snapshot
            rows = registry_snapshot()
        except Exception:
            rows = []
        if rows:
            self._write({"kind": "metrics", "metrics": rows})

    def seal(self, reason: str) -> None:
        """Terminal flush: final metrics snapshot, any ring records the
        tap missed (recorded before configure()), the seal record, then
        fsync. Idempotent — first reason wins."""
        with self._lock:
            if self._sealed:
                return
        self.snapshot_metrics()
        try:
            from ray_tpu_torch._private import events as _events
            for rec in _events.peek():
                if not rec.get("_bb_seen"):
                    self.on_event(rec)
        except Exception:
            pass
        self._write({"kind": "seal", "reason": reason})
        with self._lock:
            self._sealed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except Exception:
                pass

    def close(self) -> None:
        with self._lock:
            self._sealed = True
            try:
                self._f.close()
            except Exception:
                pass


# ----------------------------------------------------------- process wiring
def configure(directory: str, process: str, node_id: str = "",
              worker_id: str = "", max_bytes: Optional[int] = None,
              metrics_interval_s: Optional[float] = None,
              tap_events: bool = True) -> Optional[BlackBox]:
    """Open (or return) this process's black box and wire it in:
    events-recorder tap, periodic metrics snapshots, atexit seal.
    Returns None when disabled via cfg.blackbox_enabled. SIGTERM
    handling stays with the caller (daemons own their signal policy);
    they call `seal()` on their death paths."""
    global _box
    from ray_tpu_torch._private.config import cfg
    if not cfg.blackbox_enabled:
        return None
    with _lock:
        if _box is not None:
            return _box
        box = BlackBox(
            box_path(directory, process),
            max_bytes=int(max_bytes if max_bytes is not None
                          else cfg.blackbox_max_bytes),
            process=process, node_id=node_id, worker_id=worker_id)
        _box = box
    box.record("marker", event="startup", argv=" ".join(sys.argv[:3]))
    if tap_events:
        from ray_tpu_torch._private import events as _events

        def _tap(rec, _box=box):
            rec["_bb_seen"] = True
            _box.on_event(rec)

        _events.set_tap(_tap)
        # backfill anything recorded before the tap existed
        for rec in _events.peek():
            if not rec.get("_bb_seen"):
                rec["_bb_seen"] = True
                box.on_event(rec)
    interval = (cfg.blackbox_metrics_interval_s
                if metrics_interval_s is None else metrics_interval_s)
    if interval and interval > 0:
        def _loop(_box=box, _dt=float(interval)):
            while not _box._sealed:
                time.sleep(_dt)
                try:
                    _box.snapshot_metrics()
                except Exception:
                    logging.getLogger(__name__).debug(
                        "blackbox metrics snapshot failed", exc_info=True)
        threading.Thread(target=_loop, name="blackbox-metrics",
                         daemon=True).start()
    atexit.register(lambda: box.seal("clean_exit"))
    return box


def get() -> Optional[BlackBox]:
    return _box


def record(kind: str, **fields) -> None:
    if _box is not None:
        _box.record(kind, **fields)


def seal(reason: str) -> None:
    if _box is not None:
        _box.seal(reason)


def reset() -> None:
    """Test hook: drop the process singleton (and its events tap)."""
    global _box
    with _lock:
        if _box is not None:
            _box.close()
        _box = None
    try:
        from ray_tpu_torch._private import events as _events
        _events.set_tap(None)
    except Exception:
        pass


# ------------------------------------------------------------------ readers
def scan_boxes(directory: str) -> List[str]:
    """Live-segment paths of every box under `directory` (rotated .1
    segments are folded into their box by read_box)."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names
            if n.endswith(_SUFFIX)]


def count_boxes(directory: str) -> int:
    return len(scan_boxes(directory))


def read_box(path: str) -> List[Dict[str, Any]]:
    """All parseable records of one box, rotated segment first, in
    write order. Torn trailing lines (a SIGKILL mid-append) and any
    other garbage lines are skipped, not fatal."""
    records: List[Dict[str, Any]] = []
    for seg in (path + ".1", path):
        try:
            with open(seg, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except Exception:
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
        except OSError:
            continue
    return records


def stitch(paths: List[str],
           max_skew_s: float = 0.0) -> Dict[str, Any]:
    """Merge multiple boxes into one cross-node timeline.

    Each box's records are ordered by their per-box ``seq`` (immune to
    wall-clock steps within a process), then k-way merged on the
    skew-adjusted timestamp ``ts - clock_offset_s`` (every box's clock
    mapped onto the GCS clock). Ties break deterministically on
    (adjusted_ts, box_index, seq). `max_skew_s` > 0 additionally clamps
    implausible offsets to 0 (a box that claims hours of skew keeps its
    internal order but is not allowed to reorder everyone else).

    Returns {"boxes": [per-box summaries], "records": merged rows with
    box/process/adjusted ts annotations}.
    """
    boxes: List[Dict[str, Any]] = []
    merged: List[Dict[str, Any]] = []
    for idx, path in enumerate(paths):
        recs = read_box(path)
        offset = 0.0
        process = os.path.basename(path)[:-len(_SUFFIX)]
        node_id = worker_id = ""
        sealed_reason = None
        for r in recs:
            if r.get("kind") == "header":
                try:
                    offset = float(r.get("clock_offset_s") or 0.0)
                except (TypeError, ValueError):
                    offset = 0.0
                process = r.get("process") or process
                node_id = r.get("node_id") or node_id
                worker_id = r.get("worker_id") or worker_id
            elif r.get("kind") == "seal":
                sealed_reason = r.get("reason") or "sealed"
        if max_skew_s and abs(offset) > max_skew_s:
            offset = 0.0
        recs.sort(key=lambda r: r.get("seq", 0))
        for r in recs:
            try:
                ts = float(r.get("ts") or 0.0)
            except (TypeError, ValueError):
                ts = 0.0
            merged.append({"adj_ts": ts - offset, "box": idx,
                           "seq": r.get("seq", 0), "process": process,
                           "node_id": node_id, "rec": r})
        boxes.append({"path": path, "process": process,
                      "node_id": node_id, "worker_id": worker_id,
                      "clock_offset_s": offset, "records": len(recs),
                      "sealed": sealed_reason is not None,
                      "seal_reason": sealed_reason or "none (died hard)"})
    merged.sort(key=lambda m: (m["adj_ts"], m["box"], m["seq"]))
    return {"boxes": boxes, "records": merged}
