"""State API: cluster introspection (counterpart of
``ray_tpu/util/state.py``; reference: python/ray/util/state/api.py
— ray list tasks/actors/nodes/objects/jobs, summaries; backed by the GCS
tables and task-event sink instead of a dashboard aggregator)."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional


def _w():
    from ray_tpu_torch import _get_worker
    return _get_worker()


def list_nodes() -> List[Dict]:
    return _w().gcs_call("get_all_nodes")


def list_actors() -> List[Dict]:
    return _w().gcs_call("get_all_actors")


def list_jobs() -> List[Dict]:
    return _w().gcs_call("get_all_jobs")


def list_placement_groups() -> List[Dict]:
    return _w().gcs_call("get_all_placement_groups")


def list_tasks(limit: int = 1000, job_id: Optional[int] = None) -> List[Dict]:
    # task rows only: the flight recorder's runtime events share the GCS
    # sink but are not tasks (see list_runtime_events)
    return _w().gcs_call("list_task_events", limit=limit, job_id=job_id,
                         kind="task")


def list_runtime_events(limit: int = 1000,
                        category: Optional[str] = None) -> List[Dict]:
    """Flight-recorder rows (`ray_tpu_torch/_private/events.py`): spans and
    instants recorded inside tasks/daemons — engine step phases, object
    store spill/restore/transfer, data stage/shuffle windows, serve
    request phases. category filters by subsystem ("engine", "store",
    "data", "serve")."""
    return _w().gcs_call("list_task_events", limit=limit,
                         kind="runtime_event", category=category)


def summarize_runtime_events(limit: int = 10000) -> Dict[str, Dict]:
    """{event_name: {count, total_ms}} over the retained window."""
    out: Dict[str, Dict] = {}
    for r in list_runtime_events(limit=limit):
        times = r.get("state_times", {})
        start = times.get("RUNNING")
        end = times.get("FINISHED", start)
        agg = out.setdefault(r.get("name", "?"),
                             {"count": 0, "total_ms": 0.0})
        agg["count"] += 1
        if start is not None and end is not None:
            agg["total_ms"] += max(0.0, (end - start) * 1e3)
    for agg in out.values():
        agg["total_ms"] = round(agg["total_ms"], 3)
    return out


def query_metrics(name: str, window: float = 60.0, agg: str = "avg",
                  tags: Optional[Dict[str, str]] = None,
                  threshold: Optional[float] = None) -> Dict:
    """Windowed aggregate over the GCS time-series metrics plane (fed by
    every process's 2s registry pushes). agg: "rate"/"sum"/"avg"/"max"/
    "min"/"latest" for counters and gauges; "p50"/"p90"/"p95"/"p99"
    (reconstructed from histogram bucket deltas), "frac_over" (with
    `threshold` — the SLO bad-event fraction) and "buckets" for
    histograms; "series" returns the raw samples. Returns {"value": ...,
    "n_samples": ...}; value is None when nothing matched the window.

    Example::

        state.query_metrics("serve_llm_ttft_ms", window=30, agg="p95")
    """
    return _w().gcs_call("query_metrics", name=name, window=window,
                         agg=agg, tags=tags, threshold=threshold)


def list_metric_series() -> List[Dict]:
    """Per-metric inventory of the time-series plane: name, kind,
    series count, retained samples, staleness."""
    return _w().gcs_call("list_metric_series")


def control_plane_stats(top_n: int = 3) -> Dict:
    """GCS control-plane health: per-handler RPC latency quantiles
    (top_n slowest by p99), global in-flight RPCs, pubsub backlog /
    delivery counters, in-flight actor launches with their current
    phase, and the count of crash black boxes on this session's disk."""
    return _w().gcs_call("control_plane_stats", top_n=top_n)


def list_named_actors(namespace: Optional[str] = None) -> List[Dict]:
    return _w().gcs_call("list_named_actors", namespace=namespace)


def list_objects(limit: int = 1000,
                 include_ledger: bool = True) -> List[Dict]:
    """Objects in this node's shared-memory store, this process's
    ownership entries, and the GCS object-ledger provenance rows joined
    into one table (reference: `ray memory` merges the store view with
    per-worker refcount tables; the ledger adds the cluster-wide and
    historical dimension).

    Merge order (deterministic — same inputs, same rows, same order):

    1. The local shm-store scan runs FIRST — per-object info probes give
       live arena truth (size, ``pins``, ``is_span``, ``stripe``,
       ``age_s``) without pinning or touching LRU.
    2. This process's owned table folds INTO those rows — an object in
       both yields ONE row (kind="owned+shm" carrying store truth AND
       ownership fields); owner-only entries append as kind="owned"
       while the limit budget remains.
    3. GCS object-ledger rows fold in LAST and never override live
       arena truth: a matched row keeps its kind and live size/pins/
       placement, gaining only provenance (``owner``, ``creator_task``,
       ``created_ts``, ``locations``, ``leaked``) and filling
       is_span/pins/age_s when the live scan could not. Unmatched
       ledger rows (objects resident on OTHER nodes) append as
       kind="ledger" within the remaining budget.

    At most `limit` rows return; shm rows win the budget because they
    represent real local arena bytes."""
    core = _w().core
    shm_rows: List[Dict] = []
    if core.store is not None:
        now_sec = core.store.now_sec()
        for oid in core.store.list_objects(max_n=limit):
            info = core.store.object_info(oid)
            if info is None:
                continue
            shm_rows.append({
                "object_id": oid.hex(), "node_id": core.node_id,
                "size_bytes": info["data_size"] + info["meta_size"],
                "kind": "shm", "pins": info["pins"],
                "is_span": info["is_span"], "stripe": info["stripe"],
                "age_s": max(0, now_sec - info["ctime_sec"]),
                "sealed": info["sealed"]})
    ledger_rows: List[Dict] = []
    if include_ledger:
        try:
            ledger_rows = _w().gcs_call("list_object_ledger", limit=limit)
        except Exception:
            ledger_rows = []
    return _merge_object_rows(shm_rows, dict(core.owned), ledger_rows,
                              limit, node_id=core.node_id)


def _merge_object_rows(shm_rows: List[Dict], owned: Dict,
                       ledger_rows: List[Dict], limit: int,
                       node_id: Optional[str] = None,
                       now: Optional[float] = None) -> List[Dict]:
    """Pure merge implementing the order documented on list_objects
    (factored out so the join is testable without a cluster; `now` pins
    the age clock for deterministic tests)."""
    import time as _time
    rows: Dict[str, Dict] = {}
    for r in shm_rows[:limit]:
        rows[r["object_id"]] = dict(r)
    for oid, entry in owned.items():
        hexid = oid.hex() if isinstance(oid, bytes) else oid
        owned_fields = {
            "complete": bool(entry.get("complete")),
            "location": entry.get("location"),
            "borrowers": len(entry.get("borrowers") or ()),
            "task_pins": entry.get("submitted", 0),
        }
        row = rows.get(hexid)
        if row is not None:
            row.update(owned_fields)
            row["kind"] = "owned+shm"
        elif len(rows) < limit:
            rows[hexid] = {"object_id": hexid, "node_id": node_id,
                           "kind": "owned", "pins": None,
                           "is_span": None, "age_s": None,
                           **owned_fields}
    now = _time.time() if now is None else now
    for lr in ledger_rows:
        hexid = lr.get("object_id")
        if not hexid:
            continue
        locations = lr.get("locations") or {}
        prov = {"owner": lr.get("owner"),
                "creator_task": lr.get("creator_task"),
                "created_ts": lr.get("created_ts"),
                "locations": sorted(locations),
                "leaked": bool(lr.get("leaked"))}
        ref_ts = lr.get("sealed_ts") or lr.get("created_ts")
        row = rows.get(hexid)
        if row is not None:
            row.update(prov)   # provenance keys never carry live truth
            if row.get("is_span") is None:
                row["is_span"] = bool(lr.get("is_span"))
            if row.get("pins") is None:
                row["pins"] = sum(int(l.get("pins") or 0)
                                  for l in locations.values())
            if row.get("age_s") is None and ref_ts:
                row["age_s"] = round(max(0.0, now - ref_ts), 3)
        elif len(rows) < limit:
            rows[hexid] = {
                "object_id": hexid,
                "node_id": next(iter(sorted(locations)), None),
                "size_bytes": (lr.get("size") or 0)
                + (lr.get("meta_size") or 0),
                "kind": "ledger", "is_span": bool(lr.get("is_span")),
                "stripe": lr.get("stripe"),
                "pins": sum(int(l.get("pins") or 0)
                            for l in locations.values()),
                "age_s": round(max(0.0, now - ref_ts), 3)
                if ref_ts else None,
                **prov}
    return list(rows.values())[:limit]


def list_object_ledger(limit: int = 1000, node_id: Optional[str] = None,
                       leaked: Optional[bool] = None,
                       live_only: bool = False) -> List[Dict]:
    """Raw provenance rows from the GCS object_ledger table (newest
    first): creator worker/task, owner, size, stripe/span placement,
    lifecycle timestamps (created/sealed/spilled/restored/evicted/
    freed), per-node pins, and the leak flag."""
    return _w().gcs_call("list_object_ledger", limit=limit,
                         node_id=node_id, leaked=leaked,
                         live_only=live_only)


def ledger_stats() -> Dict:
    """{entries, exited_workers, leaked_objects, leaked_bytes}."""
    return _w().gcs_call("ledger_stats")


def ledger_sweep() -> Dict:
    """Run one GCS leak-detector pass NOW (the loop runs it every
    cfg.ledger_sweep_interval_s). Returns {leaked_objects,
    leaked_bytes, newly_flagged}."""
    return _w().gcs_call("ledger_sweep")


def _node_call(address: str, method: str, timeout: float = 10.0, **kw):
    import asyncio
    core = _w().core

    async def call():
        return await core.pool.call(address, method, **kw)
    return asyncio.run_coroutine_threadsafe(call(), core.loop) \
        .result(timeout)


def memory_summary() -> Dict:
    """Cluster memory overview: ledger totals plus each alive node's
    arena occupancy/fragmentation and data-plane counters (from the
    node managers' get_node_info)."""
    out: Dict = {"nodes": []}
    try:
        out["ledger"] = ledger_stats()
    except Exception:
        out["ledger"] = None
    for n in list_nodes():
        if not n.get("alive"):
            continue
        row = {"node_id": n["node_id"]}
        try:
            info = _node_call(n["address"], "get_node_info")
            row["store"] = info.get("store")
            row["data_plane"] = info.get("data_plane")
        except Exception as e:
            row["error"] = str(e)
        out["nodes"].append(row)
    return out


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """{task_name: {state: count}} (reference: ray summary tasks)."""
    summary: Dict[str, Dict[str, int]] = collections.defaultdict(
        lambda: collections.defaultdict(int))
    for t in list_tasks(limit=10000):
        summary[t.get("name", "?")][t.get("state", "?")] += 1
    return {k: dict(v) for k, v in summary.items()}


def summarize_actors() -> Dict[str, int]:
    summary: Dict[str, int] = collections.defaultdict(int)
    for a in list_actors():
        summary[a["state"]] += 1
    return dict(summary)


def cluster_summary() -> Dict:
    import ray_tpu_torch
    nodes = list_nodes()
    return {
        "nodes_alive": sum(1 for n in nodes if n["alive"]),
        "nodes_dead": sum(1 for n in nodes if not n["alive"]),
        "total_resources": ray_tpu_torch.cluster_resources(),
        "available_resources": ray_tpu_torch.available_resources(),
        "actors": summarize_actors(),
    }
