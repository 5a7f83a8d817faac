"""OpenTelemetry interop for the built-in tracing plane (counterpart of
``ray_tpu/util/tracing.py``; reference:
python/ray/util/tracing/tracing_helper.py:34 — the reference hooks
opentelemetry-sdk exporters; here the span store is the GCS task-event
table and this module renders/ships it in the OTLP JSON wire format, so
any OTLP/HTTP collector (Jaeger, Tempo, Grafana) ingests it without an
opentelemetry dependency in the runtime).

Span mapping: one span per task execution; trace_id/span_id come from
the propagated trace context (worker.py spec fields), state transitions
become the span window, task metadata becomes attributes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


def _hex_id(value: Optional[str], nbytes: int) -> str:
    """Normalize an internal id to OTLP's fixed-width lowercase hex
    (16-byte trace ids, 8-byte span ids)."""
    h = (value or "").replace("-", "").lower()
    h = "".join(c for c in h if c in "0123456789abcdef")
    want = nbytes * 2
    return (h[:want]).rjust(want, "0") if h else "0" * want


def _attr(key: str, value) -> Dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def task_events_to_otlp(rows: List[Dict],
                        service_name: str = "ray_tpu_torch") -> Dict:
    """GCS task-event rows -> one OTLP/JSON ExportTraceServiceRequest.

    Both row kinds export: task rows become one span per execution;
    flight-recorder rows (``kind == "runtime_event"``) become child
    spans with their recorded parent links intact, so an engine-slot
    span nests under its Serve request span in Jaeger/Tempo. Runtime
    attrs ride as ``ray_tpu_torch.attr.*`` attributes."""
    spans = []
    for row in rows:
        times = row.get("state_times", {})
        start = times.get("RUNNING")
        if start is None:
            continue
        end = times.get("FINISHED") or times.get("FAILED") or start
        end = max(end, start)
        failed = "FAILED" in times
        runtime = row.get("kind") == "runtime_event"
        attributes = [
            _attr("ray_tpu_torch.task_id", row.get("task_id")),
            _attr("ray_tpu_torch.type", row.get("type")),
            _attr("ray_tpu_torch.node_id", row.get("node_id")),
            _attr("ray_tpu_torch.worker_id", row.get("worker_id")),
            _attr("ray_tpu_torch.state", row.get("state")),
        ]
        if runtime:
            attributes.append(_attr("ray_tpu_torch.category",
                                    row.get("category")))
            attributes.append(_attr("ray_tpu_torch.event_kind",
                                    row.get("event_kind")))
            for k, v in sorted((row.get("attrs") or {}).items()):
                attributes.append(_attr(f"ray_tpu_torch.attr.{k}", v))
        span = {
            "traceId": _hex_id(row.get("trace_id") or row.get("task_id"),
                               16),
            "spanId": _hex_id(row.get("span_id") or row.get("task_id"), 8),
            "name": row.get("name") or "task",
            "kind": 1,   # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(start * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "attributes": attributes,
            "status": {"code": 2 if failed else 1},
        }
        parent = row.get("parent_span_id")
        if parent:
            span["parentSpanId"] = _hex_id(parent, 8)
        spans.append(span)
    return {
        "resourceSpans": [{
            "resource": {"attributes": [_attr("service.name",
                                              service_name)]},
            "scopeSpans": [{
                "scope": {"name": "ray_tpu_torch.tracing"},
                "spans": spans,
            }],
        }],
    }


def task_events_to_chrome(rows: List[Dict],
                          gauge_series: Optional[List[Dict]] = None
                          ) -> List[Dict]:
    """GCS task-event rows -> chrome://tracing / Perfetto event list.

    Task rows keep the classic layout (pid = node, tid = worker).
    Flight-recorder rows render as per-subsystem tracks (pid =
    ``runtime:<category>``) so engine/store/data/serve phases line up
    under the tasks that caused them; instants emit as ``ph: "i"``.
    Events are sorted by ts and every duration event has dur >= 1us —
    the output loads in either viewer without sanitizing.

    gauge_series: raw time-series rows from the GCS metrics plane
    (``dump_metric_series``: {name, tags, worker_id, samples: [[ts,
    v], ...]}); each renders as a counter track (``ph: "C"``) on the
    ``metrics`` pid, so slot-occupancy / queue-depth curves draw
    alongside the spans that explain them."""
    events: List[Dict] = []
    for s in gauge_series or []:
        label = s.get("name", "metric")
        tags = s.get("tags") or {}
        if tags:
            label += "{" + ",".join(f"{k}={v}"
                                    for k, v in sorted(tags.items())) + "}"
        for ts, value in s.get("samples", []):
            events.append({
                "name": label, "cat": "metrics", "ph": "C",
                "ts": ts * 1e6, "pid": "metrics",
                "args": {"value": value},
            })
    for row in rows:
        times = row.get("state_times", {})
        start = times.get("RUNNING")
        if start is None:
            continue
        end = times.get("FINISHED") or times.get("FAILED")
        end = end if end and end >= start else start
        runtime = row.get("kind") == "runtime_event"
        args = {"task_id": row.get("task_id"), "state": row.get("state"),
                "trace_id": row.get("trace_id"),
                "span_id": row.get("span_id"),
                "parent_span_id": row.get("parent_span_id")}
        if runtime:
            args.update(row.get("attrs") or {})
            ev = {
                "name": row.get("name", "event"),
                "cat": row.get("category", "runtime"),
                "pid": f"runtime:{row.get('category', 'runtime')}",
                "tid": (row.get("worker_id") or "worker")[:8],
                "ts": start * 1e6,
                "args": args,
            }
            if row.get("event_kind") == "instant":
                ev["ph"] = "i"
                ev["s"] = "p"       # process-scoped instant marker
            else:
                ev["ph"] = "X"
                ev["dur"] = max(1.0, (end - start) * 1e6)
        else:
            ev = {
                "name": row.get("name", "task"),
                "cat": row.get("type", "task"),
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(1.0, (end - start) * 1e6),
                "pid": (row.get("node_id") or "node")[:8],
                "tid": (row.get("worker_id") or "worker")[:8],
                "args": args,
            }
        events.append(ev)
    events.sort(key=lambda e: e["ts"])
    return events


def export_otlp(filename: Optional[str] = None,
                endpoint: Optional[str] = None,
                limit: int = 10000,
                service_name: str = "ray_tpu_torch") -> Dict:
    """Export the cluster's spans. filename: write OTLP JSON; endpoint:
    POST to `<endpoint>/v1/traces` (the OTLP/HTTP convention). Returns
    the payload either way."""
    from ray_tpu_torch import _get_worker
    rows = _get_worker().gcs_call("list_task_events", limit=limit)
    payload = task_events_to_otlp(rows, service_name=service_name)
    if filename:
        with open(filename, "w") as f:
            json.dump(payload, f)
    if endpoint:
        import urllib.request
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/v1/traces",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            resp.read()
    return payload


def cluster_stacks() -> Dict:
    """Live Python stacks of every process in the cluster (`ray_tpu_torch
    stack`; reference: `ray stack`)."""
    import asyncio

    from ray_tpu_torch import _get_worker
    core = _get_worker().core
    return asyncio.run_coroutine_threadsafe(
        core.dump_cluster_stacks_async(), core.loop).result(60)


def format_cluster_stacks(dump: Dict) -> str:
    lines = []
    for node_id, node in dump.items():
        lines.append(f"=== node {node_id[:12]} ===")
        if "error" in node:
            lines.append(f"  <{node['error']}>")
            continue
        nm = node.get("node_manager", {})
        lines.append(f"-- node_manager (pid {nm.get('pid')}) --")
        for tname, stack in (nm.get("stacks") or {}).items():
            lines.append(f"thread {tname}:\n{stack}")
        for wid, w in (node.get("workers") or {}).items():
            if "error" in w:
                lines.append(f"-- worker {wid[:12]}: <{w['error']}> --")
                continue
            lines.append(f"-- worker {wid[:12]} (pid {w.get('pid')}, "
                         f"{w.get('mode')}) --")
            for tname, stack in (w.get("stacks") or {}).items():
                lines.append(f"thread {tname}:\n{stack}")
    return "\n".join(lines)
