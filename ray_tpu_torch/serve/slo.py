"""SLO burn-rate engine for Serve deployments.

Deployments declare objectives (``SloConfig``: a latency objective —
"at most ``budget_fraction`` of requests may exceed ``threshold_ms`` on
``latency_metric``", i.e. *p95 TTFT ≤ X ms* with the default 5% budget
— and/or an error-rate objective). The controller evaluates them every
reconcile tick against the GCS time-series plane and publishes:

- ``slo_burn_rate`` gauges (tags: app, deployment, objective, window) —
  burn rate 1.0 means the error budget is being consumed exactly at the
  allowed pace; 2.0 means twice as fast;
- ``slo_violating`` gauges (0/1);
- ``slo.violation`` / ``slo.recovered`` flight-recorder instants on
  state transitions, so outages line up with the spans that caused them
  on the unified timeline.

Violation uses the standard multi-window burn-rate rule (Google
SRE-workbook shape): alert only when BOTH the fast window (reacts
quickly, noisy alone) and the slow window (confirms it is sustained)
burn above threshold. This is precisely the input signal ROADMAP item
2's autoscaling loop needs — scale on sustained burn, not on instant
spikes.

The evaluation core is pure (``evaluate_slo`` takes a query callable)
so tier-1 tests drive it against a synthetic time-series plane with no
cluster. ``SloTracker`` adds the transition memory + metric/event
emission used by the controller.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SloConfig:
    """Objectives for one deployment. Thresholds default to None =
    objective disabled.

    p95_ttft_ms is sugar for the common case: a latency objective with
    threshold = that value and budget_fraction = 0.05 on latency_metric.
    """
    # latency objective: fraction of observations on `latency_metric`
    # above `threshold_ms` must stay below `budget_fraction`
    p95_ttft_ms: Optional[float] = None
    latency_metric: str = "serve_llm_ttft_ms"
    threshold_ms: Optional[float] = None
    budget_fraction: float = 0.05
    # error-rate objective: rate(error_metric+error_tags) /
    # rate(total_metric) must stay below max_error_rate
    max_error_rate: Optional[float] = None
    error_metric: str = "serve_llm_requests_total"
    error_tags: Optional[Dict[str, str]] = None
    total_metric: str = "serve_llm_requests_total"
    # burn-rate windows: violate only when BOTH burn above threshold
    fast_window_s: float = 30.0
    slow_window_s: float = 120.0
    burn_threshold: float = 1.0


def _cfg_get(slo, key, default=None):
    """SloConfig or plain dict (specs cross the wire as dicts)."""
    if isinstance(slo, dict):
        v = slo.get(key, default)
        return default if v is None and default is not None else v
    return getattr(slo, key, default)


def evaluate_slo(slo, query: Callable[..., Dict]) -> List[Dict]:
    """Evaluate every enabled objective. `query(name, window, agg,
    tags=None, threshold=None)` must return the GCS query_metrics shape
    ({"value": ...}). Returns one row per objective:
    {objective, target, burn_fast, burn_slow, violating, windows}.
    A window with no samples contributes burn 0 (no traffic = no budget
    spend), the Prometheus absent-metric convention."""
    out: List[Dict] = []
    fast_w = float(_cfg_get(slo, "fast_window_s", 30.0) or 30.0)
    slow_w = float(_cfg_get(slo, "slow_window_s", 120.0) or 120.0)
    burn_thr = float(_cfg_get(slo, "burn_threshold", 1.0) or 1.0)

    threshold = _cfg_get(slo, "threshold_ms")
    if threshold is None:
        threshold = _cfg_get(slo, "p95_ttft_ms")
    if threshold is not None:
        budget = float(_cfg_get(slo, "budget_fraction", 0.05) or 0.05)
        metric = _cfg_get(slo, "latency_metric", "serve_llm_ttft_ms")
        burns = {}
        for label, w in (("fast", fast_w), ("slow", slow_w)):
            frac = query(metric, window=w, agg="frac_over",
                         threshold=float(threshold)).get("value")
            burns[label] = (frac or 0.0) / budget
        out.append({
            "objective": "latency", "metric": metric,
            "target": float(threshold), "budget_fraction": budget,
            "burn_fast": round(burns["fast"], 4),
            "burn_slow": round(burns["slow"], 4),
            "violating": (burns["fast"] > burn_thr
                          and burns["slow"] > burn_thr),
            "windows": [fast_w, slow_w],
        })

    max_err = _cfg_get(slo, "max_error_rate")
    if max_err is not None:
        max_err = float(max_err)
        err_metric = _cfg_get(slo, "error_metric",
                              "serve_llm_requests_total")
        err_tags = _cfg_get(slo, "error_tags") or {"finish_reason": "error"}
        tot_metric = _cfg_get(slo, "total_metric",
                              "serve_llm_requests_total")
        burns = {}
        for label, w in (("fast", fast_w), ("slow", slow_w)):
            bad = query(err_metric, window=w, agg="rate",
                        tags=dict(err_tags)).get("value") or 0.0
            total = query(tot_metric, window=w, agg="rate").get("value") \
                or 0.0
            frac = bad / total if total > 0 else 0.0
            burns[label] = frac / max_err if max_err > 0 else 0.0
        out.append({
            "objective": "error_rate", "metric": err_metric,
            "target": max_err,
            "burn_fast": round(burns["fast"], 4),
            "burn_slow": round(burns["slow"], 4),
            "violating": (burns["fast"] > burn_thr
                          and burns["slow"] > burn_thr),
            "windows": [fast_w, slow_w],
        })
    return out


def evaluate_tenant_slo(slo, query: Callable[..., Dict],
                        tenants: List[str]) -> List[Dict]:
    """Per-tenant burn rows (ROADMAP item 2d): the deployment's latency
    objective re-evaluated against each tenant's OWN observations
    (``tenant_latency_metric``, default the proxy-recorded
    ``serve_tenant_ttft_ms``, filtered by ``tags={"tenant": ...}``).
    Rows carry ``"tenant"`` and feed the same :class:`BurnRateScaler`
    input list as the aggregate rows — the scaler takes the max burn
    across rows, so ONE tenant burning its budget raises the deployment
    target even while the aggregate p95 looks healthy: tenancy shapes
    capacity, not just admission. A tenant with no samples in either
    window burns 0 and is dropped (absent ≠ violating)."""
    threshold = _cfg_get(slo, "threshold_ms")
    if threshold is None:
        threshold = _cfg_get(slo, "p95_ttft_ms")
    if threshold is None or not tenants:
        return []
    budget = float(_cfg_get(slo, "budget_fraction", 0.05) or 0.05)
    metric = _cfg_get(slo, "tenant_latency_metric",
                      "serve_tenant_ttft_ms")
    fast_w = float(_cfg_get(slo, "fast_window_s", 30.0) or 30.0)
    slow_w = float(_cfg_get(slo, "slow_window_s", 120.0) or 120.0)
    burn_thr = float(_cfg_get(slo, "burn_threshold", 1.0) or 1.0)
    out: List[Dict] = []
    for tenant in tenants:
        burns = {}
        seen = False
        for label, w in (("fast", fast_w), ("slow", slow_w)):
            r = query(metric, window=w, agg="frac_over",
                      threshold=float(threshold),
                      tags={"tenant": tenant})
            frac = r.get("value")
            seen = seen or frac is not None
            burns[label] = (frac or 0.0) / budget
        if not seen:
            continue
        out.append({
            "objective": "tenant_latency", "tenant": tenant,
            "metric": metric, "target": float(threshold),
            "budget_fraction": budget,
            "burn_fast": round(burns["fast"], 4),
            "burn_slow": round(burns["slow"], 4),
            "violating": (burns["fast"] > burn_thr
                          and burns["slow"] > burn_thr),
            "windows": [fast_w, slow_w],
        })
    return out


class BurnRateScaler:
    """Burn-driven replica-target policy — the consumer of the rows
    ``evaluate_slo`` produces (ROADMAP item 2's "control loop
    remaining"). One instance per deployment, held by the controller.

    Decisions are deliberately conservative (SRE multiwindow rule +
    hold + cooldown), because replica churn is the most expensive thing
    a serving fleet can do:

    - **Upscale** only when an objective is *violating* (BOTH burn
      windows above threshold — ``evaluate_slo`` already applies the
      multiwindow rule, so an instant spike that lights up only the
      fast window never reaches here as violating) and has stayed
      violating for ``burn_upscale_hold_s``. The new target scales with
      the slow-window burn (burning 2x over budget doubles the target)
      but always moves by at least one replica.
    - **Downscale** only when every burn is below
      ``burn_release_threshold`` AND the measured load per replica is
      under half the autoscaler's ``target_ongoing_requests`` for
      ``burn_downscale_idle_s`` — idle capacity releases, a loaded but
      healthy fleet does not.
    - ``burn_cooldown_s`` separates consecutive actions in either
      direction so the loop cannot flap faster than the windows can
      re-fill with post-action samples.

    Pure: ``decide`` takes ``now`` and mutates only this object, so
    tests drive it with a fake clock and a synthetic metrics ring."""

    def __init__(self):
        self._violating_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action_t: Optional[float] = None

    def decide(self, auto, rows: List[Dict], target: int,
               total_load: float, now: float) -> int:
        import math
        lo = int(_cfg_get(auto, "min_replicas", 1) or 1)
        hi = int(_cfg_get(auto, "max_replicas", 4) or 4)
        hold = float(_cfg_get(auto, "burn_upscale_hold_s", 6.0))
        idle_s = float(_cfg_get(auto, "burn_downscale_idle_s", 60.0))
        cooldown = float(_cfg_get(auto, "burn_cooldown_s", 30.0))
        release = float(_cfg_get(auto, "burn_release_threshold", 0.25))
        target_ongoing = float(
            _cfg_get(auto, "target_ongoing_requests", 2.0) or 2.0)
        violating = any(r.get("violating") for r in rows)
        burn_slow = max((r.get("burn_slow") or 0.0 for r in rows),
                        default=0.0)
        burn_fast = max((r.get("burn_fast") or 0.0 for r in rows),
                        default=0.0)
        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t < cooldown)

        if violating:
            self._idle_since = None
            if self._violating_since is None:
                self._violating_since = now
            sustained = now - self._violating_since >= hold
            if sustained and not in_cooldown and target < hi:
                desired = min(hi, max(
                    target + 1,
                    math.ceil(target * min(max(burn_slow, 1.0), 2.0))))
                self._last_action_t = now
                self._violating_since = now   # re-arm the hold
                return desired
            return target

        self._violating_since = None
        idle = (burn_fast < release and burn_slow < release
                and total_load < 0.5 * target_ongoing * max(target, 1))
        if not idle:
            self._idle_since = None
            return target
        if self._idle_since is None:
            self._idle_since = now
        if (now - self._idle_since >= idle_s and not in_cooldown
                and target > lo):
            self._last_action_t = now
            self._idle_since = now            # step down one per cooldown
            return target - 1
        return target


class SloTracker:
    """Transition memory + emission. One per controller; keys are
    (app, deployment, objective)."""

    def __init__(self):
        self._violating: Dict[tuple, bool] = {}
        self._gauges = None

    def _ensure_gauges(self):
        if self._gauges is None:
            from ray_tpu_torch.util.metrics import Gauge
            self._gauges = {
                "burn": Gauge(
                    "slo_burn_rate",
                    "error-budget burn rate per objective (1.0 = budget "
                    "consumed exactly at the allowed pace)",
                    tag_keys=("app", "deployment", "objective", "window")),
                "violating": Gauge(
                    "slo_violating",
                    "1 while both burn windows exceed the threshold",
                    tag_keys=("app", "deployment", "objective")),
                "tenant_burn": Gauge(
                    "slo_tenant_burn_rate",
                    "per-tenant error-budget burn rate (slow window)",
                    tag_keys=("app", "deployment", "tenant")),
            }
        return self._gauges

    def update(self, app: str, deployment: str, slo,
               query: Callable[..., Dict],
               tenants: Optional[List[str]] = None) -> List[Dict]:
        """Evaluate + publish. Returns the evaluation rows — aggregate
        objectives first, then per-tenant rows when ``tenants`` is
        given (surfaced via the controller's get_slo_status; the whole
        list feeds BurnRateScaler, so tenant burn shapes capacity)."""
        from ray_tpu_torch._private import events
        rows = evaluate_slo(slo, query)
        g = self._ensure_gauges()
        if tenants:
            trows = evaluate_tenant_slo(slo, query, tenants)
            for row in trows:
                g["tenant_burn"].set(
                    row["burn_slow"],
                    tags={"app": app, "deployment": deployment,
                          "tenant": row["tenant"]})
                key = (app, deployment, "tenant:" + row["tenant"])
                was = self._violating.get(key, False)
                self._violating[key] = row["violating"]
                if row["violating"] and not was:
                    events.record_instant(
                        "slo.violation", category="serve", app=app,
                        deployment=deployment, objective="tenant_latency",
                        tenant=row["tenant"], target=row["target"],
                        burn_fast=row["burn_fast"],
                        burn_slow=row["burn_slow"])
                    logger.warning(
                        "tenant SLO violation: %s/%s tenant=%s burn "
                        "fast=%.2f slow=%.2f", app, deployment,
                        row["tenant"], row["burn_fast"], row["burn_slow"])
                elif was and not row["violating"]:
                    events.record_instant(
                        "slo.recovered", category="serve", app=app,
                        deployment=deployment, objective="tenant_latency",
                        tenant=row["tenant"],
                        burn_fast=row["burn_fast"],
                        burn_slow=row["burn_slow"])
            rows = rows + trows
        for row in rows:
            if row.get("tenant"):
                continue   # published above with tenant tags
            tags = {"app": app, "deployment": deployment,
                    "objective": row["objective"]}
            g["burn"].set(row["burn_fast"], tags={**tags, "window": "fast"})
            g["burn"].set(row["burn_slow"], tags={**tags, "window": "slow"})
            g["violating"].set(1.0 if row["violating"] else 0.0, tags=tags)
            key = (app, deployment, row["objective"])
            was = self._violating.get(key, False)
            self._violating[key] = row["violating"]
            if row["violating"] and not was:
                events.record_instant(
                    "slo.violation", category="serve", app=app,
                    deployment=deployment, objective=row["objective"],
                    metric=row["metric"], target=row["target"],
                    burn_fast=row["burn_fast"], burn_slow=row["burn_slow"])
                logger.warning(
                    "SLO violation: %s/%s %s burn fast=%.2f slow=%.2f "
                    "(target %s)", app, deployment, row["objective"],
                    row["burn_fast"], row["burn_slow"], row["target"])
            elif was and not row["violating"]:
                events.record_instant(
                    "slo.recovered", category="serve", app=app,
                    deployment=deployment, objective=row["objective"],
                    burn_fast=row["burn_fast"], burn_slow=row["burn_slow"])
        return rows
