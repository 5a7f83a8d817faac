"""GCS time-series metrics plane.

``report_metrics`` pushes used to overwrite a latest-snapshot table, so
every consumer saw only an instant — nothing in the cluster could answer
"what was p95 TTFT over the last 30s" (the signal ROADMAP's
metrics-driven autoscaling and the SLO engine both need). This module
keeps a bounded ring of ``(ts, value)`` samples per
``(metric, tags, worker)`` series, fed by the existing 2s registry
pushes (reference shape: the per-node MetricsAgent exporting OpenCensus
views to Prometheus, python/ray/_private/metrics_agent.py:483 — here the
GCS itself retains a short Prometheus-style window so queries need no
external TSDB).

Storage discipline — pushes are *cumulative* per process, the ring
stores *increments*:

- counters arrive as per-worker cumulative totals; the ring stores the
  per-push delta (a restart / counter reset is detected as a value
  decrease and the new total is taken as the delta, the Prometheus
  ``rate()`` convention);
- histograms arrive as cumulative bucket counts + sum; the ring stores
  per-push bucket deltas, so any time window's distribution is the
  elementwise sum of the deltas inside it and percentiles reconstruct
  by linear interpolation within a bucket;
- gauges are stored as-is (one sample per push).

Every query is windowed ``(now - window_s, now]``: the left edge is
exclusive, the right edge inclusive, so two adjacent windows partition
the samples exactly (tested in tests/test_metrics_plane.py).

All methods are synchronous and run on the GCS event loop; ingest is
O(samples in push), query is O(samples in window).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

PERCENTILE_AGGS = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99}


def _tags_key(tags) -> Tuple[Tuple[str, str], ...]:
    """Normalize a tag list/dict (msgpack delivers [[k, v], ...]) into a
    sorted hashable tuple."""
    if not tags:
        return ()
    if isinstance(tags, dict):
        items = tags.items()
    else:
        items = ((k, v) for k, v in tags)
    return tuple(sorted((str(k), str(v)) for k, v in items))


def _tags_match(series_tags: Tuple[Tuple[str, str], ...],
                want: Optional[Dict[str, str]]) -> bool:
    """Subset match: every requested tag must be present with the same
    value; extra series tags are fine."""
    if not want:
        return True
    have = dict(series_tags)
    return all(have.get(str(k)) == str(v) for k, v in want.items())


def percentile_from_buckets(boundaries: List[float], counts: List[float],
                            q: float) -> Optional[float]:
    """Reconstruct the q-quantile from bucket counts (len(boundaries)+1,
    last bucket is the +Inf overflow). Linear interpolation inside the
    containing bucket, the Prometheus ``histogram_quantile`` convention;
    observations in the overflow bucket clamp to the highest boundary
    (the reconstruction can't know how far past it they landed)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    lo = 0.0
    for b, c in zip(boundaries, counts):
        if cum + c >= target and c > 0:
            return lo + (b - lo) * (target - cum) / c
        cum += c
        lo = b
    return boundaries[-1] if boundaries else None


def fraction_over(boundaries: List[float], counts: List[float],
                  threshold: float) -> Optional[float]:
    """Fraction of observations with value > threshold (the SLO "bad
    event" fraction). Buckets wholly above the threshold count in full;
    the bucket containing it contributes its interpolated tail."""
    total = sum(counts)
    if total <= 0:
        return None
    over = 0.0
    lo = 0.0
    for b, c in zip(boundaries, counts):
        if lo >= threshold:
            over += c
        elif b > threshold and b > lo:
            over += c * (b - threshold) / (b - lo)
        lo = b
    # overflow bucket spans (last boundary, +inf): its observations are
    # strictly above the top boundary, so they count as over whenever
    # the threshold is at or below it; past it the reconstruction can't
    # know and leaves them out
    if not boundaries or threshold <= boundaries[-1]:
        over += counts[-1]
    return min(1.0, over / total)


class _Series:
    __slots__ = ("kind", "boundaries", "samples")

    def __init__(self, kind: str, max_samples: int,
                 boundaries: Optional[List[float]] = None):
        self.kind = kind
        self.boundaries = boundaries
        # counter/gauge sample: (ts, value). histogram sample:
        # (ts, bucket_deltas, sum_delta). deque maxlen gives
        # deterministic oldest-first eviction.
        self.samples: deque = deque(maxlen=max_samples)


class MetricsTimeSeries:
    def __init__(self, retention_s: float = 600.0, max_samples: int = 600,
                 max_series: int = 4096):
        self.retention_s = float(retention_s)
        self.max_samples = int(max_samples)
        self.max_series = int(max_series)
        # name -> {(tags_key, worker_id): _Series}
        self.series: Dict[str, Dict[Tuple, _Series]] = {}
        # (name, tags_key, worker_id) -> last cumulative value
        self._last: Dict[Tuple, Any] = {}
        self.dropped_series = 0
        self._n_series = 0
        self._ingests = 0

    # ------------------------------------------------------------- ingest
    def ingest(self, worker_id: str, metrics: List[Dict],
               ts: Optional[float] = None) -> None:
        now = time.time() if ts is None else float(ts)
        for m in metrics:
            kind = m.get("type")
            name = m.get("name")
            if not name:
                continue
            if kind == "histogram":
                self._ingest_histogram(worker_id, name, m, now)
            elif kind in ("counter", "gauge"):
                self._ingest_scalar(worker_id, name, kind, m, now)
        self._ingests += 1
        if self._ingests % 128 == 0:
            self.prune(now)

    def _get_series(self, name: str, tags_key: Tuple, worker_id: str,
                    kind: str, boundaries=None) -> Optional[_Series]:
        per = self.series.setdefault(name, {})
        s = per.get((tags_key, worker_id))
        if s is None:
            if self._n_series >= self.max_series:
                self.dropped_series += 1
                return None
            s = _Series(kind, self.max_samples, boundaries)
            per[(tags_key, worker_id)] = s
            self._n_series += 1
        if boundaries is not None:
            s.boundaries = list(boundaries)
        return s

    def _ingest_scalar(self, worker_id: str, name: str, kind: str,
                       m: Dict, now: float) -> None:
        for tags, value in m.get("samples", []):
            tk = _tags_key(tags)
            s = self._get_series(name, tk, worker_id, kind)
            if s is None:
                continue
            value = float(value)
            if kind == "counter":
                lk = (name, tk, worker_id)
                prev = self._last.get(lk)
                self._last[lk] = value
                delta = value if (prev is None or value < prev) \
                    else value - prev
                if delta == 0.0 and prev is not None:
                    continue        # idle counter: don't burn ring slots
                s.samples.append((now, delta))
            else:
                s.samples.append((now, value))
            self._trim(s, now)

    def _ingest_histogram(self, worker_id: str, name: str, m: Dict,
                          now: float) -> None:
        boundaries = m.get("boundaries") or []
        for tags, counts, total in m.get("samples", []):
            tk = _tags_key(tags)
            s = self._get_series(name, tk, worker_id, "histogram",
                                 boundaries)
            if s is None:
                continue
            counts = [float(c) for c in counts]
            lk = (name, tk, worker_id)
            prev = self._last.get(lk)
            self._last[lk] = (counts, float(total))
            if prev is None or any(c < p for c, p in zip(counts, prev[0])) \
                    or len(prev[0]) != len(counts):
                deltas, dsum = counts, float(total)      # first push / reset
            else:
                deltas = [c - p for c, p in zip(counts, prev[0])]
                dsum = float(total) - prev[1]
            if not any(deltas):
                continue
            s.samples.append((now, deltas, dsum))
            self._trim(s, now)

    def _trim(self, s: _Series, now: float) -> None:
        cutoff = now - self.retention_s
        while s.samples and s.samples[0][0] < cutoff:
            s.samples.popleft()

    def prune(self, now: Optional[float] = None) -> None:
        """Drop series whose newest sample has aged out entirely (dead
        workers' gauges stop polluting list_series past retention)."""
        now = time.time() if now is None else now
        cutoff = now - self.retention_s
        for name in list(self.series):
            per = self.series[name]
            for key in list(per):
                samples = per[key].samples
                if not samples or samples[-1][0] < cutoff:
                    del per[key]
                    self._n_series -= 1
                    self._last.pop((name, key[0], key[1]), None)
            if not per:
                del self.series[name]

    def drop_worker(self, worker_id: str) -> None:
        """Forget a worker's delta state (its history ages out via
        retention; only the cumulative baselines must go so a reused id
        doesn't produce a phantom negative-delta reset)."""
        for lk in [k for k in self._last if k[2] == worker_id]:
            del self._last[lk]

    # -------------------------------------------------------------- query
    def query(self, name: str, window_s: float = 60.0, agg: str = "avg",
              tags: Optional[Dict[str, str]] = None,
              threshold: Optional[float] = None,
              now: Optional[float] = None) -> Dict:
        now = time.time() if now is None else float(now)
        window_s = min(float(window_s), self.retention_s)
        t0 = now - window_s
        out = {"name": name, "agg": agg, "window_s": window_s,
               "value": None, "n_samples": 0}
        per = self.series.get(name)
        if not per:
            return out
        matching = [((tk, wid), s) for (tk, wid), s in per.items()
                    if _tags_match(tk, tags)]
        if not matching:
            return out
        kind = matching[0][1].kind
        out["kind"] = kind

        if agg == "series":
            rows = []
            for (tk, wid), s in matching:
                samples = []
                for rec in s.samples:
                    if t0 < rec[0] <= now:
                        samples.append(
                            [rec[0], rec[1]] if len(rec) == 2
                            else [rec[0], list(rec[1]), rec[2]])
                if samples:
                    rows.append({"tags": dict(tk), "worker_id": wid,
                                 "kind": s.kind, "samples": samples})
            out["series"] = rows
            out["n_samples"] = sum(len(r["samples"]) for r in rows)
            return out

        if kind == "histogram":
            return self._query_histogram(out, matching, t0, now, agg,
                                         threshold)

        values = []
        latest = None
        for _key, s in matching:
            for ts, v in s.samples:
                if t0 < ts <= now:
                    values.append(v)
                    if latest is None or ts >= latest[0]:
                        latest = (ts, v)
        out["n_samples"] = len(values)
        if not values:
            return out
        if agg == "rate":
            out["value"] = (sum(values) / window_s if kind == "counter"
                            else None)
        elif agg == "sum":
            out["value"] = sum(values)
        elif agg == "avg":
            out["value"] = sum(values) / len(values)
        elif agg == "max":
            out["value"] = max(values)
        elif agg == "min":
            out["value"] = min(values)
        elif agg == "latest":
            out["value"] = latest[1]
        return out

    def _query_histogram(self, out: Dict, matching, t0: float, now: float,
                         agg: str, threshold: Optional[float]) -> Dict:
        boundaries: Optional[List[float]] = None
        counts: Optional[List[float]] = None
        total_sum = 0.0
        n = 0
        for _key, s in matching:
            if s.boundaries is None:
                continue
            if boundaries is None:
                boundaries = list(s.boundaries)
                counts = [0.0] * (len(boundaries) + 1)
            if s.boundaries != boundaries:
                continue        # mixed-boundary registrations don't merge
            for ts, deltas, dsum in s.samples:
                if t0 < ts <= now:
                    n += 1
                    total_sum += dsum
                    for i, d in enumerate(deltas[:len(counts)]):
                        counts[i] += d
        out["n_samples"] = n
        if counts is None:
            return out
        count_total = sum(counts)
        if agg == "buckets":
            out["value"] = count_total
            out["buckets"] = {"boundaries": boundaries, "counts": counts,
                              "sum": total_sum, "count": count_total}
            return out
        if count_total <= 0:
            return out
        if agg in PERCENTILE_AGGS:
            out["value"] = percentile_from_buckets(
                boundaries, counts, PERCENTILE_AGGS[agg])
        elif agg == "frac_over":
            if threshold is not None:
                out["value"] = fraction_over(boundaries, counts,
                                             float(threshold))
        elif agg == "rate":
            out["value"] = count_total / out["window_s"]
        elif agg == "sum":
            out["value"] = total_sum
        elif agg == "avg":
            out["value"] = total_sum / count_total
        elif agg == "max":
            # best effort: upper edge of the highest non-empty bucket
            hi = None
            lo = 0.0
            for b, c in zip(boundaries, counts):
                if c > 0:
                    hi = b
                lo = b
            if counts[-1] > 0:
                hi = lo
            out["value"] = hi
        return out

    def list_series(self, now: Optional[float] = None) -> List[Dict]:
        now = time.time() if now is None else now
        rows = []
        for name in sorted(self.series):
            per = self.series[name]
            if not per:
                continue
            kinds = {s.kind for s in per.values()}
            newest = max((s.samples[-1][0] for s in per.values()
                          if s.samples), default=None)
            rows.append({
                "name": name,
                "kind": sorted(kinds)[0] if kinds else "untyped",
                "n_series": len(per),
                "n_samples": sum(len(s.samples) for s in per.values()),
                "age_s": (round(now - newest, 3)
                          if newest is not None else None),
            })
        return rows

    def dump_series(self, window_s: float = 600.0,
                    names: Optional[List[str]] = None,
                    kinds: Optional[List[str]] = None,
                    now: Optional[float] = None) -> List[Dict]:
        """Raw sample dump (gauges by default the interesting case: the
        chrome-trace exporter renders them as counter tracks)."""
        now = time.time() if now is None else now
        t0 = now - min(float(window_s), self.retention_s)
        rows = []
        for name, per in sorted(self.series.items()):
            if names is not None and name not in names:
                continue
            for (tk, wid), s in per.items():
                if kinds is not None and s.kind not in kinds:
                    continue
                if s.kind == "histogram":
                    samples = [[ts, sum(d)] for ts, d, _ in s.samples
                               if t0 < ts <= now]
                else:
                    samples = [[ts, v] for ts, v in s.samples
                               if t0 < ts <= now]
                if samples:
                    rows.append({"name": name, "kind": s.kind,
                                 "tags": dict(tk), "worker_id": wid,
                                 "samples": samples})
        return rows

    def stats(self) -> Dict:
        return {"n_series": self._n_series,
                "dropped_series": self.dropped_series,
                "n_names": len(self.series)}
