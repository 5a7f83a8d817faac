"""User-defined metrics: Counter / Gauge / Histogram
(reference: python/ray/util/metrics.py feeding the per-node agent's
MetricsAgent, python/ray/_private/metrics_agent.py:483, re-exported to
Prometheus). Here every process pushes its registry to the GCS on a 2s
cadence and the dashboard renders the aggregate at /metrics in
Prometheus text format.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_registry: Dict[str, "Metric"] = {}
_registry_lock = threading.Lock()
_pusher_started = False
_pusher_stop = threading.Event()
_push_failures = 0
# The snapshot of the most recent FAILED push, kept as (capture_ts,
# payload). Counters are cumulative so a dropped push loses nothing
# locally — but a GCS restart wipes the time-series delta baselines,
# and the first post-restart push would then land the entire cumulative
# history as one giant delta in the current window. Replaying the
# buffered pre-outage snapshot (at its original capture time) first
# re-establishes the baseline, so the current push's delta collapses to
# just the activity since the failure. metrics_ts reset-detection
# tolerates the replay even when the "failed" push actually landed.
_failed_push: Optional[Tuple[float, List[Dict]]] = None


def _ensure_pusher():
    global _pusher_started
    with _registry_lock:
        if _pusher_started:
            return
        _pusher_started = True
        _pusher_stop.clear()
    t = threading.Thread(target=_push_loop, name="metrics-push", daemon=True)
    t.start()


def resume_pusher():
    """Restart the pusher after a stop_pusher() (ray_tpu_torch re-init in the
    same process): metrics registered before the shutdown would
    otherwise never push again. No-op with an empty registry — a
    metric-less process doesn't deserve a thread."""
    with _registry_lock:
        if not _registry:
            return
    _ensure_pusher()


def stop_pusher():
    """Worker shutdown: wake the pusher and let it exit instead of
    spinning forever on is_initialized(). The final snapshot flush is
    the worker's own stop path (worker.py stop_async) — this only
    retires the thread."""
    global _pusher_started
    _pusher_stop.set()
    with _registry_lock:
        _pusher_started = False


def registry_snapshot() -> List[Dict]:
    """Snapshot every registered metric (the push payload). Shared by
    the 2s pusher and the worker's shutdown flush."""
    with _registry_lock:
        return [m._snapshot() for m in _registry.values()]


def _push_interval() -> float:
    """Base cadence jittered +/-25% so a fleet of workers spreads its
    pushes over the control plane instead of synchronizing on it."""
    try:
        from ray_tpu_torch._private.config import cfg
        base = float(cfg.metrics_push_interval_s)
    except Exception:
        base = 2.0
    return base * random.uniform(0.75, 1.25)


def push_once() -> bool:
    """One registry push through the connected worker. Returns True on
    success; the FIRST failure per process logs (at most one line — a
    dead GCS must not spam), later ones stay silent. A failed push
    buffers its snapshot and re-merges it (original capture time) ahead
    of the next successful push — see _failed_push."""
    global _push_failures, _failed_push
    payload: Optional[List[Dict]] = None
    capture_ts = time.time()
    try:
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            return False
        payload = registry_snapshot()
        if not payload:
            return True
        w = ray_tpu_torch._get_worker()
        core = w.core
        node_id = getattr(core, "node_id", None)
        if _failed_push is not None:
            buf_ts, buf_payload = _failed_push
            w.gcs_call("report_metrics", worker_id=core.worker_id,
                       node_id=node_id, metrics=buf_payload, ts=buf_ts)
            _failed_push = None
        w.gcs_call("report_metrics", worker_id=core.worker_id,
                   node_id=node_id, metrics=payload)
        _push_failures = 0
        return True
    except Exception as e:
        if payload is not None:
            # keep only the newest failed snapshot: it is cumulative, so
            # it subsumes every earlier one (bounded buffer by design)
            _failed_push = (capture_ts, payload)
        if _push_failures == 0:
            logger.warning(
                "metrics push to GCS failed (%s: %s); snapshot buffered "
                "for replay, further failures suppressed until one "
                "succeeds", type(e).__name__, e)
        _push_failures += 1
        return False


def _push_loop():
    while True:
        if _pusher_stop.wait(timeout=_push_interval()):
            return      # clean exit on worker shutdown (stop_pusher)
        try:
            push_once()
        except Exception:
            pass


class Metric:
    _type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[name] = self
        _ensure_pusher()

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]):
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def _snapshot(self) -> Dict:
        with self._lock:
            return {"name": self._name, "type": self._type,
                    "help": self._description,
                    "samples": [[list(k), v]
                                for k, v in self._values.items()]}


class Counter(Metric):
    _type = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    _type = "gauge"

    def set(self, value: float, tags: Optional[Dict] = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Optional[Tuple[str, ...]] = None):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.01, 0.1, 1.0, 10.0, 100.0])
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float, tags: Optional[Dict] = None):
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def _snapshot(self) -> Dict:
        with self._lock:
            return {"name": self._name, "type": self._type,
                    "help": self._description,
                    "boundaries": self.boundaries,
                    "samples": [[list(k), self._counts[k],
                                 self._sums.get(k, 0.0)]
                                for k in self._counts]}


def counter_snapshot(name: str, value: float, help: str = "",
                     tags: Optional[Dict[str, str]] = None) -> Dict:
    """A registry-shaped counter snapshot built from an externally-held
    cumulative value (daemons like the node manager own their counters
    as plain ints and push them directly — no Metric object needed).
    Compatible with render_prometheus and the GCS time-series ingest."""
    return {"name": name, "type": "counter", "help": help,
            "samples": [[sorted((tags or {}).items()), float(value)]]}


def gauge_snapshot(name: str, value: float, help: str = "",
                   tags: Optional[Dict[str, str]] = None) -> Dict:
    return {"name": name, "type": "gauge", "help": help,
            "samples": [[sorted((tags or {}).items()), float(value)]]}


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: inside double quotes,
    backslash, the quote itself and newlines must be escaped — a raw
    tag value like 'us-central1\\n' would otherwise emit unparsable
    exposition text (reference: prometheus text_format spec; the
    reference escapes in its OpenCensus->Prometheus exporter)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (no quotes involved)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _format_tags(key: Tuple) -> str:
    """(k, v) pairs -> escaped label body. The formatter variable is
    deliberately NOT named `v` — earlier revisions shadowed the
    enclosing sample-value loop variable here, emitting the tag value
    where the sample value belonged."""
    return ",".join(f'{k}="{_escape_label_value(tv)}"' for k, tv in key)


def render_prometheus(all_metrics: Dict[str, List[Dict]]) -> str:
    """GCS-aggregated {worker_id: [snapshots]} -> Prometheus text."""
    by_name: Dict[str, List[Dict]] = {}
    for snaps in all_metrics.values():
        for m in snaps:
            by_name.setdefault(m["name"], []).append(m)
    out = []
    for name, ms in sorted(by_name.items()):
        m0 = ms[0]
        if m0.get("help"):
            out.append(f"# HELP {name} {_escape_help(m0['help'])}")
        out.append(f"# TYPE {name} {m0['type']}")
        if m0["type"] == "histogram":
            agg: Dict[Tuple, List] = {}
            for m in ms:
                for tags, counts, total in m["samples"]:
                    key = tuple(map(tuple, tags))
                    if key in agg:
                        agg[key][0] = [a + b for a, b in
                                       zip(agg[key][0], counts)]
                        agg[key][1] += total
                    else:
                        agg[key] = [list(counts), total]
            for key, (counts, total) in agg.items():
                tag_s = _format_tags(key)
                cum = 0
                for b, c in zip(m0["boundaries"], counts):
                    cum += c
                    le = (tag_s + "," if tag_s else "") + f'le="{b}"'
                    out.append(f"{name}_bucket{{{le}}} {cum}")
                cum += counts[-1]
                le = (tag_s + "," if tag_s else "") + 'le="+Inf"'
                out.append(f"{name}_bucket{{{le}}} {cum}")
                brace = f"{{{tag_s}}}" if tag_s else ""
                out.append(f"{name}_count{brace} {cum}")
                out.append(f"{name}_sum{brace} {total}")
        else:
            agg2: Dict[Tuple, float] = {}
            for m in ms:
                for tags, v in m["samples"]:
                    key = tuple(map(tuple, tags))
                    agg2[key] = agg2.get(key, 0.0) + v \
                        if m["type"] == "counter" else v
            for key, v in agg2.items():
                tag_s = _format_tags(key)
                brace = f"{{{tag_s}}}" if tag_s else ""
                out.append(f"{name}{brace} {v}")
    return "\n".join(out) + "\n"
