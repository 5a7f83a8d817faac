"""GCS hot-path observability: per-handler RPC histograms, slow-handler
spans, pubsub publish->deliver latency, table-size gauges.

The GCS is the component every other plane reports INTO — so it cannot
report through them the normal way (a util.metrics Metric would start a
pusher thread that needs a connected worker; the global flight recorder
would hijack the driver's ring when a GcsServer is embedded in-process
by tests). Instead this module keeps plain-dict accounting and exports
registry-SHAPED snapshot rows that the GCS self-ingests through its own
``h_report_metrics(None, "gcs", rows)`` — the exact pattern the ledger
sweep already uses — so `gcs_rpc_ms{handler=...}` lands on the same
time-series plane as every worker metric, queryable via
``query_metrics("gcs_rpc_ms", agg="p99")``.

Span policy (the runtime-event track side): every handler call
slower than ``cfg.gcs_slow_rpc_ms`` writes a ``gcs.rpc`` span row
straight into the GCS task-event ring (no RPC — the ring lives in this
process); sub-threshold calls are sampled 1-in-``cfg.gcs_rpc_sample_n``
per handler so a healthy control plane still leaves a trace breadcrumb
trail without flooding the ring.

Reference: Ray's GCS treats control-plane metadata throughput as the
scaling bottleneck (PAPERS.md arxiv 1712.05889 §4) and exports
per-handler gRPC latency for exactly this reason
(src/ray/gcs/gcs_server/gcs_server_metrics defs).

Chaos: ``RAY_TPU_TORCH_TESTING_GCS_RPC_DELAY="gcs_rpc=handler:ms[,...]"``
injects a deterministic asyncio sleep into the named handler — the
tested path for slow-handler spans and the status pane's p99 column
(util/chaos.py GcsRpcDelayer owns the spec format).
"""

from __future__ import annotations

import asyncio
import inspect
import os
import time
from typing import Any, Awaitable, Dict, List, Optional

from ray_tpu_torch._private.config import cfg

__all__ = ["GcsObservability", "RPC_MS_BOUNDARIES", "delay_for",
           "DELAY_ENV"]

# sub-ms floor to multi-second ceiling: a healthy handler sits in the
# first two buckets, a snapshot-save stall or a delayed chaos handler
# is still resolvable at the top
RPC_MS_BOUNDARIES = [0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                     50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0]

DELAY_ENV = "RAY_TPU_TORCH_TESTING_GCS_RPC_DELAY"
_DELAY_SPEC: Optional[Dict[str, float]] = None

# Result types a handler can return that are definitely NOT awaitable —
# lets the wrapper skip the Future/coroutine/Awaitable isinstance ladder
# on the overwhelmingly common sync path.
_PLAIN_RESULTS = frozenset(
    (dict, list, tuple, set, str, bytes, int, float, bool))


def _parse_delay_spec() -> Dict[str, float]:
    """``gcs_rpc=handler:ms[,gcs_rpc=handler2:ms]`` -> {handler: ms}.
    Cached after first parse; chaos arm_local resets the cache."""
    out: Dict[str, float] = {}
    raw = os.environ.get(DELAY_ENV, "")
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, val = part.split("=", 1)
        if key.strip() != "gcs_rpc" or ":" not in val:
            continue
        handler, ms = val.rsplit(":", 1)
        try:
            out[handler.strip()] = float(ms)
        except ValueError:
            continue
    return out


def delay_for(handler: str) -> float:
    global _DELAY_SPEC
    if _DELAY_SPEC is None:
        _DELAY_SPEC = _parse_delay_spec()
    return _DELAY_SPEC.get(handler, 0.0)


class _HandlerStats:
    """Cumulative per-handler accounting (plain dict arithmetic — the
    wrapper adds two clock reads and a few int ops per call)."""

    __slots__ = ("calls", "errors", "slow", "inflight", "counts", "sum",
                 "_since_sample")

    def __init__(self):
        self.calls = 0
        self.errors = 0
        self.slow = 0
        self.inflight = 0
        self.counts = [0] * (len(RPC_MS_BOUNDARIES) + 1)
        self.sum = 0.0
        self._since_sample = 0

    def observe(self, ms: float):
        self.calls += 1
        self.sum += ms
        i = 0
        b = RPC_MS_BOUNDARIES
        while i < len(b) and ms > b[i]:
            i += 1
        self.counts[i] += 1

    def p_quantile(self, q: float) -> float:
        """Approximate quantile from the cumulative bucket counts (upper
        boundary of the bucket holding the q-th call)."""
        total = sum(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return (RPC_MS_BOUNDARIES[i]
                        if i < len(RPC_MS_BOUNDARIES)
                        else RPC_MS_BOUNDARIES[-1] * 2)
        return RPC_MS_BOUNDARIES[-1] * 2


class GcsObservability:
    """Owns handler instrumentation + pubsub accounting for one
    GcsServer. ``wrap_handlers`` must run before rpc.Server is built."""

    def __init__(self, gcs):
        self.gcs = gcs
        self.handlers: Dict[str, _HandlerStats] = {}
        self.inflight_total = 0
        # cfg attribute resolution walks the env on every read (~2us) —
        # far too hot for a per-RPC path, so the thresholds are cached
        # here and refreshed from the obs loop each interval.
        self._slow_ms = 0.0
        self._sample_n = 0
        self.refresh_config()
        # pubsub: publish->deliver latency + currently-pending notifies
        self.pubsub_pending = 0
        self.pubsub_delivered = 0
        self.pubsub_failed = 0
        self.pubsub_counts = [0] * (len(RPC_MS_BOUNDARIES) + 1)
        self.pubsub_sum = 0.0

    def refresh_config(self) -> None:
        self._slow_ms = float(cfg.gcs_slow_rpc_ms)
        self._sample_n = int(cfg.gcs_rpc_sample_n)

    # ------------------------------------------------------ handler wrap
    def wrap_handlers(self, handlers: Dict[str, Any]) -> Dict[str, Any]:
        self.refresh_config()
        wrapped = {}
        for name, fn in handlers.items():
            if getattr(fn, "streaming", False):
                wrapped[name] = fn       # different calling convention
                continue
            wrapped[name] = self._wrap(name, fn)
        return wrapped

    def _wrap(self, name: str, fn):
        stats = self.handlers[name] = _HandlerStats()

        # Hot path: every GCS RPC funnels through here, so globals and
        # attributes are pre-bound as defaults (LOAD_FAST) and the
        # common sync-return case touches nothing slower than counter
        # bumps — see reports/trace_probe.py's gcs_rpc_wrap_us guard.
        def call(conn, _fn=fn, _stats=stats, _name=name,
                 _perf=time.perf_counter, _delay=delay_for,
                 _finish=self._finish, _Future=asyncio.Future,
                 _iscoro=inspect.iscoroutine, **kwargs):
            delay_ms = _delay(_name)
            _stats.inflight += 1
            self.inflight_total += 1
            t0 = _perf()
            if delay_ms > 0:
                return self._delayed(_name, _stats, _fn, conn, t0,
                                     delay_ms, kwargs)
            try:
                result = _fn(conn, **kwargs)
            except BaseException as e:
                _finish(_name, _stats, t0, error=type(e).__name__)
                raise
            if result is None or result.__class__ in _PLAIN_RESULTS:
                _finish(_name, _stats, t0)
                return result
            if isinstance(result, _Future):
                result.add_done_callback(
                    lambda f: _finish(
                        _name, _stats, t0,
                        error=(type(f.exception()).__name__
                               if not f.cancelled() and f.exception()
                               else None)))
                return result
            if _iscoro(result) or isinstance(result, Awaitable):
                return self._awaited(_name, _stats, t0, result)
            _finish(_name, _stats, t0)
            return result

        call.__name__ = f"obs_{name}"
        return call

    async def _awaited(self, name, stats, t0, coro):
        try:
            result = await coro
        except BaseException as e:
            self._finish(name, stats, t0, error=type(e).__name__)
            raise
        self._finish(name, stats, t0)
        return result

    async def _delayed(self, name, stats, fn, conn, t0, delay_ms,
                       kwargs):
        await asyncio.sleep(delay_ms / 1000.0)
        try:
            result = fn(conn, **kwargs)
            if isinstance(result, asyncio.Future):
                result = await result
            elif inspect.iscoroutine(result) or isinstance(result,
                                                           Awaitable):
                result = await result
        except BaseException as e:
            self._finish(name, stats, t0, error=type(e).__name__)
            raise
        self._finish(name, stats, t0)
        return result

    def _finish(self, name: str, stats: _HandlerStats, t0: float,
                error: Optional[str] = None,
                _perf=time.perf_counter, _bounds=RPC_MS_BOUNDARIES,
                _nb=len(RPC_MS_BOUNDARIES)):
        ms = (_perf() - t0) * 1e3
        stats.inflight -= 1
        self.inflight_total -= 1
        # _HandlerStats.observe inlined — a call frame per RPC is real
        # money at this depth
        stats.calls += 1
        stats.sum += ms
        i = 0
        while i < _nb and ms > _bounds[i]:
            i += 1
        stats.counts[i] += 1
        if error:
            stats.errors += 1
        slow_ms = self._slow_ms
        emit = False
        if slow_ms and ms >= slow_ms:
            stats.slow += 1
            emit = True
        elif slow_ms and self._sample_n > 0:
            stats._since_sample += 1
            if stats._since_sample >= self._sample_n:
                stats._since_sample = 0
                emit = True
        if emit:
            self._emit_span(name, ms, error)

    def _emit_span(self, name: str, ms: float, error: Optional[str]):
        """One gcs.rpc span row, written straight into this GCS's own
        task-event ring (category 'gcs' renders as its own runtime
        track in `ray_tpu_torch timeline`)."""
        try:
            from ray_tpu_torch._private import events as _events
            now = time.time()
            span_id = _events.new_span_id()
            attrs = {"handler": name, "ms": round(ms, 3)}
            if error:
                attrs["error"] = error
            self.gcs.h_add_task_events(None, [{
                "task_id": span_id, "kind": "runtime_event",
                "type": "RUNTIME_EVENT", "event_kind": "span",
                "name": "gcs.rpc", "category": "gcs",
                "trace_id": _events.new_trace_id(), "span_id": span_id,
                "parent_span_id": None, "node_id": "gcs",
                "worker_id": "gcs", "attrs": attrs,
                "state": "RUNNING", "ts": now - ms / 1e3,
            }, {"task_id": span_id, "state": "FINISHED", "ts": now}])
        except Exception:
            pass

    # ----------------------------------------------------------- pubsub
    def note_publish(self) -> float:
        self.pubsub_pending += 1
        return time.perf_counter()

    def note_deliver(self, t0: float, ok: bool):
        self.pubsub_pending -= 1
        if not ok:
            self.pubsub_failed += 1
            return
        self.pubsub_delivered += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.pubsub_sum += ms
        i = 0
        b = RPC_MS_BOUNDARIES
        while i < len(b) and ms > b[i]:
            i += 1
        self.pubsub_counts[i] += 1

    # ---------------------------------------------------------- exports
    def metric_rows(self) -> List[Dict]:
        """Registry-shaped snapshot rows (cumulative, so the TS plane's
        delta ingest works exactly as for a pushing worker)."""
        from ray_tpu_torch.util.metrics import counter_snapshot, gauge_snapshot
        hist_samples = []
        calls_samples = []
        errors_samples = []
        inflight_samples = []
        for name, st in sorted(self.handlers.items()):
            if st.calls == 0 and st.inflight == 0:
                continue
            tags = [["handler", name]]
            hist_samples.append([tags, list(st.counts), st.sum])
            calls_samples.append([tags, float(st.calls)])
            if st.errors:
                errors_samples.append([tags, float(st.errors)])
            inflight_samples.append([tags, float(st.inflight)])
        rows: List[Dict] = [
            {"name": "gcs_rpc_ms", "type": "histogram",
             "help": "GCS handler latency (ms) by handler",
             "boundaries": RPC_MS_BOUNDARIES, "samples": hist_samples},
            {"name": "gcs_rpc_calls_total", "type": "counter",
             "help": "GCS handler calls by handler",
             "samples": calls_samples},
            {"name": "gcs_rpc_inflight", "type": "gauge",
             "help": "GCS handler calls currently executing",
             "samples": ([[[], float(self.inflight_total)]]
                         + inflight_samples)},
            {"name": "gcs_pubsub_deliver_ms", "type": "histogram",
             "help": "pubsub publish->deliver latency (ms)",
             "boundaries": RPC_MS_BOUNDARIES,
             "samples": [[[], list(self.pubsub_counts),
                          self.pubsub_sum]]},
            gauge_snapshot("gcs_pubsub_backlog",
                           float(self.pubsub_pending),
                           "pubsub notifies accepted but not yet "
                           "delivered"),
            counter_snapshot("gcs_pubsub_delivered_total",
                             float(self.pubsub_delivered),
                             "pubsub notifies delivered"),
            counter_snapshot("gcs_pubsub_failed_total",
                             float(self.pubsub_failed),
                             "pubsub notifies dropped (dead subscriber)"),
        ]
        if errors_samples:
            rows.append({"name": "gcs_rpc_errors_total",
                         "type": "counter",
                         "help": "GCS handler errors by handler",
                         "samples": errors_samples})
        rows.extend(self._table_rows())
        return rows

    def _table_rows(self) -> List[Dict]:
        from ray_tpu_torch.util.metrics import gauge_snapshot
        g = self.gcs
        kv_keys = sum(len(t) for t in g.kv.values())
        return [
            gauge_snapshot("gcs_kv_keys", float(kv_keys),
                           "keys across all GCS KV namespaces"),
            gauge_snapshot("gcs_table_rows", float(len(g.nodes)),
                           "GCS table sizes", tags={"table": "nodes"}),
            gauge_snapshot("gcs_table_rows", float(len(g.actors)),
                           "", tags={"table": "actors"}),
            gauge_snapshot("gcs_table_rows", float(len(g.task_events)),
                           "", tags={"table": "task_events"}),
            gauge_snapshot("gcs_table_rows",
                           float(len(g.object_ledger)),
                           "", tags={"table": "object_ledger"}),
            gauge_snapshot("gcs_table_rows",
                           float(len(g.placement_groups)),
                           "", tags={"table": "placement_groups"}),
            gauge_snapshot("gcs_table_rows",
                           float(len(getattr(g, "metrics", {}) or {})),
                           "", tags={"table": "metric_workers"}),
        ]

    def top_handlers(self, n: int = 3) -> List[Dict]:
        """Top-N handlers by approximate p99 — the status pane rows."""
        scored = []
        for name, st in self.handlers.items():
            if st.calls == 0:
                continue
            scored.append({"handler": name, "calls": st.calls,
                           "errors": st.errors, "slow": st.slow,
                           "inflight": st.inflight,
                           "p50_ms": round(st.p_quantile(0.50), 3),
                           "p99_ms": round(st.p_quantile(0.99), 3),
                           "avg_ms": round(st.sum / st.calls, 3)})
        scored.sort(key=lambda r: (-r["p99_ms"], -r["calls"]))
        return scored[:n]
