"""The port's fleet and SLO policy (ray_tpu_torch/serve/fleet.py and
slo.py) against the JAX package's: deficit round robin, tenant admission,
the tenant token bucket, plan_spread, decide_scale_to_zero, the SLO
evaluation with SloTracker, and BurnRateScaler, each driven with the same
inputs (a fake clock, a synthetic metrics query) in both packages, with
equal outputs. These are the unit tier of tests/test_fleet.py and of the
SLO tests; no cluster."""

import importlib

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _both(fn):
    """fn(fleet, slo) run once per package; returns the two results."""
    out = []
    for pkg in PACKAGES:
        fleet = importlib.import_module(f"{pkg}.serve.fleet")
        slo = importlib.import_module(f"{pkg}.serve.slo")
        out.append(fn(fleet, slo))
    return out


def _drr(fleet, slo):
    d = fleet.DeficitRoundRobin(quantum=1.0)
    d.set_weight("a", 3.0)
    d.set_weight("b", 1.0)
    d.set_weight("c", 0.5)
    for i in range(12):
        for t in "abc":
            d.push(t, f"{t}{i}")
    blocked = {"b"}
    order = [d.pop(eligible=lambda t: t not in blocked) for _ in range(10)]
    blocked.clear()
    order += [d.pop() for _ in range(30)]
    return order, len(d), [d.queue_len(t) for t in "abc"]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _admission(fleet, slo):
    clock = _Clock()
    adm = fleet.TenantAdmission(default_quota=0, default_weight=1.0,
                                queue_max=0, total_limit=5, clock=clock)
    adm.apply_quotas([{"tenant": "gold", "quota": 2, "weight": 2.0},
                      {"tenant": "free", "quota": 1},
                      {"tenant": "__default__", "quota": 3}])
    events, leases = [], []
    for tenant in ("gold", "gold", "gold", "free", "free", "", "x", "x",
                   "x", "x"):
        try:
            leases.append(adm.acquire(tenant, timeout_s=0.1))
            events.append(("ok", tenant))
        except fleet.TenantQuotaExceeded as e:
            events.append(("shed", e.tenant, e.retry_after_s))
        clock.t += 0.5
    leases[0].release()
    leases[0].release()                      # idempotent
    adm.acquire("gold", timeout_s=0.1)
    events.append(("ok after release", adm.quota("gold"), adm.quota("x")))
    st = adm.stats()
    return events, st, dict(adm.admitted_total), dict(adm.shed_total)


def _bucket(fleet, slo):
    b = fleet.TenantTokenBucket(rate=2.0, burst=3.0, now=0.0)
    out = []
    for now in (0.0, 0.0, 0.1, 0.1, 0.2, 0.3, 1.0, 1.05, 5.0, 5.0):
        out.append((b.take(now), round(b.wait_s(now), 9)))
    b.set_params(rate=0.5, burst=1.0)
    out.append((b.take(6.0), b.wait_s(6.0), b.take(9.0)))
    free = fleet.TenantTokenBucket(rate=0.0, burst=0.0)
    out.append((free.take(0.0), free.wait_s(0.0), free.burst))
    return out


def _spread(fleet, slo):
    nodes = [{"node_id": "n1", "alive": True, "available": {"CPU": 2}},
             {"node_id": "n2", "alive": True, "available": {"CPU": 8}},
             {"node_id": "n3", "alive": False, "available": {"CPU": 64}},
             {"node_id": "n4", "available": {"CPU": 8}},
             {"alive": True}]
    return [fleet.plan_spread(nodes, used) for used in
            ([], ["n2"], ["n2", "n4"], ["n1", "n2", "n4", "n4"],
             ["n9", None])] + [fleet.plan_spread(nodes[:1], []),
                               fleet.plan_spread([], [])]


def _scale_to_zero(fleet, slo):
    auto = {"min_replicas": 0, "idle_scale_to_zero_s": 10.0}
    out, idle = [], None
    for now, load, reviving in ((0, 0, False), (5, 0, False),
                                (9, 1, False), (10, 0, False),
                                (19, 0, True), (21, 0, False),
                                (31, 0, False)):
        go, idle = fleet.decide_scale_to_zero(auto, idle, now, 1, load,
                                              reviving)
        out.append((go, idle))
    out.append(fleet.decide_scale_to_zero({"min_replicas": 1,
                                           "idle_scale_to_zero_s": 1},
                                          0.0, 100.0, 1, 0))
    out.append(fleet.decide_scale_to_zero(None, None, 0.0, 1, 0))
    out.append(fleet.decide_scale_to_zero(auto, 0.0, 50.0, 0, 0))
    return out


def _query(samples, error_rate=None):
    """A metrics query over fixed per-(metric, window, agg, tenant)
    values; with error_rate, that share of the requests' rate carries
    an error finish_reason tag."""
    def query(name, window, agg, tags=None, threshold=None):
        tags = tags or {}
        if error_rate is not None and tags.get("finish_reason"):
            return {"value": 10.0 * error_rate}
        return {"value": samples.get((name, window, agg,
                                      tags.get("tenant")))}
    return query


def _slo(fleet, slo):
    cfg = slo.SloConfig(p95_ttft_ms=200.0, max_error_rate=0.01,
                        fast_window_s=30.0, slow_window_s=120.0)
    tracker = slo.SloTracker()
    rows = []
    for fast, slow, err in ((0.02, 0.01, 0.0), (0.2, 0.1, 0.05),
                            (0.2, 0.01, 0.05), (0.0, 0.0, None)):
        q = _query({
            ("serve_llm_ttft_ms", 30.0, "frac_over", None): fast,
            ("serve_llm_ttft_ms", 120.0, "frac_over", None): slow,
            ("serve_llm_requests_total", 30.0, "rate", None): 10.0,
            ("serve_llm_requests_total", 120.0, "rate", None): 10.0,
            ("serve_tenant_ttft_ms", 30.0, "frac_over", "t1"): fast,
            ("serve_tenant_ttft_ms", 120.0, "frac_over", "t1"): slow,
            ("serve_tenant_ttft_ms", 30.0, "frac_over", "t2"): 0.0},
            error_rate=err)
        rows.append(tracker.update("app", "dep", cfg, q,
                                   tenants=["t1", "t2", "t3"]))
    rows.append(slo.evaluate_slo({"threshold_ms": 50.0,
                                  "budget_fraction": 0.1}, _query({})))
    return rows, sorted(map(list, tracker._violating.items()))


def _burn(fleet, slo):
    scaler = slo.BurnRateScaler()
    auto = {"min_replicas": 1, "max_replicas": 4,
            "burn_upscale_hold_s": 6.0, "burn_downscale_idle_s": 20.0,
            "burn_cooldown_s": 10.0, "target_ongoing_requests": 2.0}
    hot = [{"violating": True, "burn_fast": 3.0, "burn_slow": 1.7}]
    cool = [{"violating": False, "burn_fast": 0.1, "burn_slow": 0.1}]
    warm = [{"violating": False, "burn_fast": 0.9, "burn_slow": 0.5}]
    target, out = 1, []
    for now, rows, load in ((0, hot, 5), (3, hot, 5), (6, hot, 5),
                            (8, hot, 5), (12, hot, 5), (17, hot, 5),
                            (30, warm, 5), (40, cool, 1), (59, cool, 1),
                            (61, cool, 1), (75, cool, 1), (100, cool, 0),
                            (130, cool, 0), (160, cool, 0)):
        target = scaler.decide(auto, rows, target, load, now)
        out.append(target)
    return out


SCENARIOS = {"drr": _drr, "admission": _admission, "token_bucket": _bucket,
             "plan_spread": _spread, "scale_to_zero": _scale_to_zero,
             "slo_tracker": _slo, "burn_rate_scaler": _burn}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_equals_jax(name):
    jax_out, port_out = _both(SCENARIOS[name])
    assert port_out == jax_out
    assert jax_out          # each scenario returns something to compare


def test_scenarios_reach_the_interesting_branches():
    """The inputs above are not vacuous: sheds, a violating SLO, an
    upscale and a downscale, and a weighted DRR order all happen."""
    _, (events, _, _, shed) = _both(_admission)
    assert any(e[0] == "shed" for e in events) and shed
    _, (rows, _) = _both(_slo)
    assert any(r["violating"] for step in rows for r in step)
    _, targets = _both(_burn)
    assert max(targets) > 1 and targets[-1] < max(targets)
    _, (order, left, _) = _both(_drr)
    assert left == 0 and [o[0] for o in order[:3]] == ["a", "a", "a"]
