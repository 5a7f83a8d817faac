"""Multi-model fleet plane (ROADMAP item 3): scale-to-zero with
pre-warmed shells, per-tenant fair-share admission, and burn-aware
shedding.

The production shape this module serves is hundreds of models sharing
one accelerator fleet (reference: Ray Serve multi-app + autoscaler-v2). Three
problems define it, and three pieces here solve them:

- **Scale-to-zero + cold-start pooling.** A deployment opts in via
  ``AutoscalingConfig(min_replicas=0, idle_scale_to_zero_s=...)``. The
  ordinary autoscaling policy floors at ONE replica; only the fleet
  manager's idle reaper (:func:`decide_scale_to_zero`) takes the last
  step to zero, after the load has been zero for the full idle window.
  Revival goes through a shared :class:`ShellPool` of pre-warmed
  replica *shells* (:class:`ReplicaShell`: a live actor process with
  the heavy imports already paid, no callable, no weights). On the
  first request the router parks callers in a hold queue (the handle-
  level analog of the scheduler's ``submit(hold=)``, serve/handle.py
  ``_hold_for_revival``) and asks the controller to revive; the fleet
  manager checks a shell out, attaches the deployment's callable to it
  (weights load inside the already-warm process — an LLMDeployment's
  ``params_fn`` resolves through the weight plane BY DEFAULT:
  ``serve/weights.py resolve_weight_source`` attaches the recorded
  broadcast tree zero-copy from the local arena and only the very first
  attach cluster-wide runs the loader, with a plain-put fallback when
  the plane is unavailable — ``fleet_weights_from_arena`` flag), lets
  the callable's ``on_shell_attach`` hook warm its compiled programs,
  and only then publishes the replica to routing tables. Cold-start
  latency is measured per revival and exported as
  ``serve_cold_start_ms``.

- **Per-tenant fair-share admission.** Requests carry a tenant
  (``X-RayTPU-Tenant`` header at the proxy, ``options(tenant=)`` at the
  handle). The ingress runs :class:`TenantAdmission`: weighted
  deficit-round-robin (:class:`DeficitRoundRobin`) across per-tenant
  FIFO queues with per-tenant concurrency quotas (GCS ``tenant_quotas``
  table, ``serve.set_tenant_quota``). Over-quota work is rejected with
  429 + ``Retry-After`` instead of collapsing the queue; a
  quota-respecting tenant's service share can never be pushed below its
  DRR weight by a hot neighbour. Exported: ``serve_tenant_qps``,
  ``serve_tenant_shed_total``.

- **Burn-aware shedding + spread placement.** A deployment may declare
  ``fallback_model=<smaller deployment, same API>``: when its replicas
  are saturated the handle routes overflow down the fallback ladder
  (``serve_fallback_shed_total``), and the controller's burn loop
  prefers shedding to asking the cluster autoscaler for new slices
  while the fallback has headroom (:func:`fallback_has_headroom`).
  Replica placement gains anti-affinity (:func:`plan_spread`): one
  deployment's replicas spread across distinct nodes so a single
  preemption cannot zero a model.

Everything policy-shaped here is pure (injectable clocks, no cluster
imports at decision time) so the tier-1 suite drives it hermetically;
the :class:`FleetManager` adds the controller-side threading.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import cfg

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ pure policy
def decide_scale_to_zero(auto: Optional[Dict], idle_since: Optional[float],
                         now: float, target: int, total_load: float,
                         reviving: bool = False
                         ) -> Tuple[bool, Optional[float]]:
    """The idle reaper's decision for one deployment: should the last
    replica go away NOW? Returns ``(scale_to_zero, idle_since')`` where
    ``idle_since'`` is the carried idle-window start (None = not idle).

    Only deployments that opted in (``min_replicas == 0`` AND
    ``idle_scale_to_zero_s`` set) ever scale to zero, and only after the
    probed load has been zero for the FULL idle window — the ordinary
    autoscaling policy floors at one replica precisely so this is the
    single code path that takes the last step. A revival in flight
    pins the deployment up (the fleet manager is mid-cold-start; reaping
    under it would strand the held requests)."""
    idle_s = (auto or {}).get("idle_scale_to_zero_s")
    if not idle_s or int((auto or {}).get("min_replicas", 1) or 0) > 0:
        return False, None
    if reviving or total_load > 0 or target <= 0:
        return False, None
    if idle_since is None:
        idle_since = now
    return (now - idle_since >= float(idle_s)), idle_since


def plan_spread(nodes: List[Dict], used_nodes: List[str]) -> Optional[str]:
    """Anti-affinity placement hint: the alive node hosting the FEWEST
    of this deployment's replicas (ties break to the most available
    CPU), so one preemption or node loss cannot zero a whole model.
    Returns None when there is no choice to make (<= 1 alive node)."""
    counts = collections.Counter(n for n in used_nodes if n)
    best_key, best_nid = None, None
    alive = [n for n in nodes if n.get("alive", True)]
    if len(alive) <= 1:
        return None
    for n in alive:
        nid = n.get("node_id")
        if not nid:
            continue
        avail = float((n.get("available") or {}).get("CPU", 0.0))
        key = (counts.get(nid, 0), -avail)
        if best_key is None or key < best_key:
            best_key, best_nid = key, nid
    return best_nid


def fallback_has_headroom(dep: Dict) -> bool:
    """True when a fallback deployment can absorb shed overflow: it has
    running replicas and its probed load sits under 80% of capacity.
    Caller holds the controller lock (reads in-memory state only)."""
    n = len(dep.get("replicas") or [])
    if n == 0:
        return False
    cap = int(dep["spec"]["config"].get("max_ongoing_requests", 16) or 16)
    load = float(sum(dep.get("loads") or []))
    return load < 0.8 * n * cap


# --------------------------------------------------- fair-share admission
class TenantQuotaExceeded(Exception):
    """Raised (and mapped to HTTP 429 + Retry-After at the proxy) when a
    tenant is over its concurrency quota and its DRR queue is full —
    load-shedding instead of queue collapse."""

    def __init__(self, tenant: str, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"tenant {tenant!r} over quota; retry after "
            f"{self.retry_after_s:.1f}s")


class DeficitRoundRobin:
    """Weighted deficit round robin over per-tenant FIFO queues
    (Shreedhar & Varghese). Each visit to the head of the active ring
    tops the tenant's deficit up by ``quantum * weight``; one unit of
    deficit buys one dequeued item. Backlogged tenants therefore share
    service in proportion to weight regardless of how deep a hot
    tenant's queue grows — the numeric fairness property the unit suite
    asserts. Not thread-safe; callers (TenantAdmission) hold their own
    lock."""

    def __init__(self, quantum: float = 1.0, default_weight: float = 1.0):
        self.quantum = float(quantum)
        self.default_weight = float(default_weight)
        self._w: Dict[str, float] = {}
        self._q: Dict[str, collections.deque] = {}
        self._deficit: Dict[str, float] = {}
        self._ring: collections.deque = collections.deque()
        self._in_ring: set = set()

    def set_weight(self, tenant: str, weight: float):
        self._w[tenant] = max(0.0, float(weight))

    def weight(self, tenant: str) -> float:
        return self._w.get(tenant, self.default_weight)

    def push(self, tenant: str, item: Any):
        q = self._q.get(tenant)
        if q is None:
            q = self._q[tenant] = collections.deque()
        q.append(item)
        if tenant not in self._in_ring:
            self._ring.append(tenant)
            self._in_ring.add(tenant)

    def queue_len(self, tenant: str) -> int:
        q = self._q.get(tenant)
        return len(q) if q else 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def _retire(self, tenant: str):
        # leaving the ring resets the deficit (standard DRR: an idle
        # tenant cannot bank service credit for a later burst)
        try:
            self._ring.remove(tenant)
        except ValueError:
            pass
        self._in_ring.discard(tenant)
        self._deficit.pop(tenant, None)
        self._q.pop(tenant, None)

    def pop(self, eligible: Optional[Callable[[str], bool]] = None
            ) -> Optional[Tuple[str, Any]]:
        """Dequeue the next item under DRR order, visiting only tenants
        for which ``eligible(tenant)`` is true (quota headroom). Returns
        None when nothing is serveable right now."""
        # bounded walk: each active tenant is visited at most twice (one
        # top-up may be needed before the deficit covers an item)
        for _ in range(2 * len(self._ring) + 2):
            if not self._ring:
                return None
            t = self._ring[0]
            q = self._q.get(t)
            if not q:
                self._retire(t)
                continue
            if eligible is not None and not eligible(t):
                self._ring.rotate(-1)
                continue
            if self._deficit.get(t, 0.0) < 1.0:
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + self.quantum * self.weight(t))
                if self._deficit[t] < 1.0:
                    # weight < 1/quantum: banks credit across rounds
                    self._ring.rotate(-1)
                    continue
            item = q.popleft()
            self._deficit[t] -= 1.0
            if not q:
                self._retire(t)
            elif self._deficit[t] < 1.0:
                self._ring.rotate(-1)
            return t, item
        return None


class _Waiter:
    __slots__ = ("event", "granted", "abandoned")

    def __init__(self):
        self.event = threading.Event()
        self.granted = False
        self.abandoned = False


class TenantLease:
    """One admitted request's hold on its tenant's concurrency quota.
    Release exactly once (context-manager friendly)."""

    def __init__(self, admission: "TenantAdmission", tenant: str):
        self._adm = admission
        self.tenant = tenant
        self._done = False

    def release(self):
        if not self._done:
            self._done = True
            self._adm._release(self.tenant)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class TenantAdmission:
    """The ingress admission gate: per-tenant concurrency quotas with a
    weighted-DRR wait queue in front, and load shedding past the queue
    bound. Thread-safe (proxy executor threads call acquire/release
    concurrently).

    Semantics per ``acquire(tenant)``:

    1. under quota, queue empty       -> admitted immediately;
    2. over quota / capacity, queue
       under ``queue_max``            -> parks in the tenant's FIFO
       queue; grants follow DRR order as releases free capacity, so a
       backlogged quota-respecting tenant is served at >= its weight
       share no matter how hot a neighbour runs;
    3. queue full (or the wait times
       out)                           -> :class:`TenantQuotaExceeded`
       (429 + Retry-After at the proxy) — shedding, not collapse.

    Quotas/weights come from the GCS ``tenant_quotas`` table
    (``serve.set_tenant_quota``; the ``__default__`` row moves the
    fleet-wide defaults) via :meth:`maybe_refresh`; a quota <= 0 means
    unlimited, which keeps untagged traffic zero-cost by default.
    Exports ``serve_tenant_qps`` (5s sliding window of offered load)
    and ``serve_tenant_shed_total``."""

    QPS_WINDOW_S = 5.0

    def __init__(self, default_quota: Optional[int] = None,
                 default_weight: Optional[float] = None,
                 queue_max: Optional[int] = None,
                 total_limit: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.default_quota = int(cfg.tenant_default_quota
                                 if default_quota is None else default_quota)
        self.queue_max = int(cfg.tenant_queue_max
                             if queue_max is None else queue_max)
        self.total_limit = int(total_limit)
        self._clock = clock
        self._drr = DeficitRoundRobin(
            default_weight=(cfg.tenant_default_weight
                            if default_weight is None else default_weight))
        self._quota: Dict[str, int] = {}
        self._inflight: Dict[str, int] = {}
        self._total = 0
        self._lock = threading.Lock()
        self._qps: Dict[str, collections.deque] = {}
        self._refresh_t = 0.0
        self._metrics = None
        self.admitted_total: Dict[str, int] = collections.defaultdict(int)
        self.shed_total: Dict[str, int] = collections.defaultdict(int)
        # when a token bucket backs this tenant (QuotaLeaseClient at
        # the proxy), Retry-After derives from its actual refill
        # deficit instead of the fixed cfg constant — a fixed constant
        # herds every shed client into one synchronized retry wave.
        self.retry_hint: Optional[Callable[[str], Optional[float]]] = None

    # ----------------------------------------------------------- quotas
    def quota(self, tenant: str) -> int:
        return self._quota.get(tenant, self.default_quota)

    def set_quota(self, tenant: str, quota: Optional[int] = None,
                  weight: Optional[float] = None):
        with self._lock:
            self._apply_row_locked(tenant, quota, weight)

    def _apply_row_locked(self, tenant, quota, weight):
        if tenant == "__default__":
            if quota is not None:
                self.default_quota = int(quota)
            if weight is not None:
                self._drr.default_weight = float(weight)
            return
        if quota is not None:
            self._quota[tenant] = int(quota)
        if weight is not None:
            self._drr.set_weight(tenant, float(weight))

    def apply_quotas(self, rows: Optional[List[Dict]]):
        """Fold GCS ``tenant_quotas`` rows in (last write wins)."""
        with self._lock:
            for row in rows or []:
                t = row.get("tenant")
                if t:
                    self._apply_row_locked(t, row.get("quota"),
                                           row.get("weight"))

    def maybe_refresh(self, fetch: Callable[[], List[Dict]],
                      interval_s: float = 5.0):
        """Throttled quota refresh (the proxy passes a GCS fetcher);
        failures keep the last applied quotas."""
        now = self._clock()
        if now - self._refresh_t < interval_s:
            return
        self._refresh_t = now
        try:
            self.apply_quotas(fetch())
        except Exception:
            logger.debug("tenant quota refresh failed", exc_info=True)

    # -------------------------------------------------------- admission
    def _admissible_locked(self, tenant: str) -> bool:
        if self.total_limit > 0 and self._total >= self.total_limit:
            return False
        q = self.quota(tenant)
        return q <= 0 or self._inflight.get(tenant, 0) < q

    def _grant_locked(self, tenant: str):
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self._total += 1
        self.admitted_total[tenant] += 1

    def _flush_locked(self):
        """Grant every currently-serveable waiter, DRR order."""
        while True:
            nxt = self._drr.pop(eligible=self._admissible_locked)
            if nxt is None:
                return
            t, w = nxt
            if w.abandoned:
                continue
            self._grant_locked(t)
            w.granted = True
            w.event.set()

    def acquire(self, tenant: str = "", timeout_s: float = 30.0
                ) -> TenantLease:
        """Admit (possibly after queueing) or raise
        :class:`TenantQuotaExceeded`. Blocking — call from an executor
        thread, never an event loop."""
        tenant = tenant or "default"
        self._stamp_qps(tenant)
        with self._lock:
            # flush first so a newcomer never jumps waiters that freed
            # capacity has already earmarked
            self._flush_locked()
            if (self._admissible_locked(tenant)
                    and self._drr.queue_len(tenant) == 0):
                self._grant_locked(tenant)
                return TenantLease(self, tenant)
            if self._drr.queue_len(tenant) >= self.queue_max:
                return self._shed_locked(tenant)
            w = _Waiter()
            self._drr.push(tenant, w)
        if w.event.wait(timeout=timeout_s) and w.granted:
            return TenantLease(self, tenant)
        with self._lock:
            w.abandoned = True
            if w.granted:
                # granted while we were timing out: the slot is ours
                return TenantLease(self, tenant)
            return self._shed_locked(tenant)

    def _shed_locked(self, tenant: str) -> "TenantLease":
        self.shed_total[tenant] += 1
        self._ensure_metrics()
        if self._metrics is not None:
            self._metrics["shed"].inc(tags={"tenant": tenant})
        raise TenantQuotaExceeded(tenant, self._retry_after(tenant))

    def _retry_after(self, tenant: str) -> float:
        hint = self.retry_hint
        if hint is not None:
            try:
                w = hint(tenant)
                if w is not None and w > 0:
                    return float(w)
            except Exception:
                pass
        return cfg.tenant_retry_after_s

    def _release(self, tenant: str):
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n > 0:
                self._inflight[tenant] = n - 1
                self._total = max(0, self._total - 1)
            self._flush_locked()

    # ---------------------------------------------------------- metrics
    def _ensure_metrics(self):
        if self._metrics is not None:
            return
        try:
            from ray_tpu_torch.util.metrics import Counter, Gauge
            self._metrics = {
                "qps": Gauge("serve_tenant_qps",
                             "offered requests/s per tenant "
                             "(5s sliding window)", tag_keys=("tenant",)),
                "shed": Counter("serve_tenant_shed_total",
                                "requests shed (429) per tenant",
                                tag_keys=("tenant",)),
            }
        except Exception:
            self._metrics = None

    def _stamp_qps(self, tenant: str):
        now = self._clock()
        with self._lock:
            win = self._qps.setdefault(tenant, collections.deque())
            win.append(now)
            cut = now - self.QPS_WINDOW_S
            while win and win[0] < cut:
                win.popleft()
            rate = len(win) / self.QPS_WINDOW_S
        self._ensure_metrics()
        if self._metrics is not None:
            self._metrics["qps"].set(rate, tags={"tenant": tenant})

    def stats(self) -> Dict:
        with self._lock:
            return {
                "inflight": {t: n for t, n in self._inflight.items() if n},
                "queued": {t: self._drr.queue_len(t)
                           for t in list(self._drr._q)},
                "admitted_total": dict(self.admitted_total),
                "shed_total": dict(self.shed_total),
                "quotas": dict(self._quota),
                "default_quota": self.default_quota,
            }


# ---------------------------------------------------- shared quota leases
class TenantTokenBucket:
    """One tenant's leased slice of the CLUSTER admission rate at one
    proxy (ROADMAP item 2a). Pure and clock-injectable: callers pass
    ``now`` explicitly, so the tier-1 suite drives refill arithmetic
    hermetically. ``rate <= 0`` means unlimited (untagged traffic stays
    zero-cost, mirroring the concurrency-quota convention)."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._t = float(now)

    def _refill(self, now: float):
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
            self._t = now

    def take(self, now: float) -> bool:
        if self.rate <= 0:
            return True
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def wait_s(self, now: float) -> float:
        """Seconds until ONE token refills — the honest Retry-After.
        Every shed client sees a different deficit, so retries spread
        out instead of herding into a synchronized wave."""
        if self.rate <= 0:
            return 0.0
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate

    def set_params(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = min(self.tokens, self.burst)


class QuotaLeaseClient:
    """Proxy-side half of the GCS quota-lease protocol: N proxies
    enforce ONE cluster-wide fair-share policy instead of N independent
    views (ROADMAP item 2a).

    The GCS owns each tenant's cluster admission rate (``tenant_quotas``
    rows with ``rate``/``burst``, ``serve.set_tenant_quota``) and leases
    every proxy an equal proportional share; this client turns its share
    into local :class:`TenantTokenBucket` instances and renews on
    ``cfg.quota_lease_interval_s`` — pushing per-tenant burn deltas up
    (they aggregate into cluster totals for the edge bench and
    per-tenant SLO) and adopting re-split shares whenever the lease
    epoch moved (proxy join/leave/expire/revoke or a rate change).

    Failure discipline: a proxy whose lease is REVOKED — or that cannot
    renew for ``cfg.quota_lease_ttl_s`` — immediately degrades every
    bucket to ``cfg.quota_lease_conservative_frac`` of its last share
    and keeps trying to re-acquire. The GCS escrows the revoked share
    (it stays in the split denominator) until the lease TTLs out or
    re-acquires, so conservative local admission plus the survivors'
    shares can never sum past the cluster budget: zero over-admission
    by construction, which is exactly what the ``QuotaLeaseRevoker``
    chaos asserts. Thread-safe; ``call`` is a ``gcs_call``-like
    callable so tests inject a fake GCS."""

    def __init__(self, proxy_id: str, call: Callable[..., Any],
                 clock: Callable[[], float] = time.monotonic,
                 on_quotas: Optional[Callable[[List[Dict]], None]] = None):
        self.proxy_id = proxy_id
        self._call = call
        self._clock = clock
        self.on_quotas = on_quotas
        self._lock = threading.Lock()
        self._buckets: Dict[str, TenantTokenBucket] = {}
        self._shares: Dict[str, Dict] = {}
        self._epoch = 0
        self._revoked = False
        self._acquired = False
        self._renew_t = -1e18
        self._last_ok_t = -1e18
        self._burn: Dict[str, int] = collections.defaultdict(int)

    # ---------------------------------------------------------- protocol
    def acquire(self) -> bool:
        try:
            out = self._call("quota_lease_acquire", proxy_id=self.proxy_id)
        except Exception:
            logger.debug("quota lease acquire failed", exc_info=True)
            return False
        if not out:
            return False
        quotas = None
        with self._lock:
            quotas = self._apply_locked(out)
            self._revoked = False
            self._acquired = True
            self._last_ok_t = self._clock()
        if quotas is not None and self.on_quotas is not None:
            try:
                self.on_quotas(quotas)
            except Exception:
                pass
        return True

    def _apply_locked(self, out: Dict) -> Optional[List[Dict]]:
        """Adopt an acquire/renew response: epoch + re-split shares.
        Returns the piggybacked tenant_quotas rows, if any."""
        self._epoch = int(out.get("epoch", self._epoch))
        shares = out.get("shares")
        if shares is not None:
            self._shares = {t: dict(s) for t, s in shares.items()}
            now = self._clock()
            for t, s in shares.items():
                b = self._buckets.get(t)
                if b is None:
                    self._buckets[t] = TenantTokenBucket(
                        s["rate"], s["burst"], now=now)
                else:
                    b.set_params(s["rate"], s["burst"])
            for t in list(self._buckets):
                if t not in shares:
                    del self._buckets[t]
        return out.get("quotas")

    def _enter_degraded_locked(self):
        """Lease revoked or unrenewable: clamp every bucket to the
        conservative fraction of its LAST KNOWN share until re-lease."""
        if self._revoked:
            return
        self._revoked = True
        frac = cfg.quota_lease_conservative_frac
        for b in self._buckets.values():
            b.set_params(b.rate * frac, b.burst * frac)

    def maybe_renew(self, now: Optional[float] = None):
        """Throttled renew/re-acquire, called from the request path (and
        the probe loop) — no dedicated thread needed at the cadence."""
        now = self._clock() if now is None else now
        if now - self._renew_t < cfg.quota_lease_interval_s:
            return
        self._renew_t = now
        if not self._acquired or self._revoked:
            self.acquire()
            return
        with self._lock:
            burn, self._burn = dict(self._burn), collections.defaultdict(int)
        try:
            out = self._call("quota_lease_renew", proxy_id=self.proxy_id,
                             epoch=self._epoch, burn=burn)
        except Exception:
            logger.debug("quota lease renew failed", exc_info=True)
            with self._lock:
                # re-bank the deltas for the next successful push
                for t, n in burn.items():
                    self._burn[t] += n
                if now - self._last_ok_t > cfg.quota_lease_ttl_s:
                    self._enter_degraded_locked()
            return
        if out and out.get("revoked"):
            with self._lock:
                self._enter_degraded_locked()
            return
        quotas = None
        with self._lock:
            self._last_ok_t = now
            quotas = self._apply_locked(out or {})
        if quotas is not None and self.on_quotas is not None:
            try:
                self.on_quotas(quotas)
            except Exception:
                pass

    def release(self):
        try:
            self._call("quota_lease_release", proxy_id=self.proxy_id)
        except Exception:
            pass

    # --------------------------------------------------------- admission
    def admit(self, tenant: str, now: Optional[float] = None
              ) -> Optional[float]:
        """``None`` = admitted (one token burned); a float = shed, retry
        after that many seconds. Unrated tenants pass through — the
        concurrency quota in :class:`TenantAdmission` still applies."""
        now = self._clock() if now is None else now
        self.maybe_renew(now)
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                return None
            if b.take(now):
                self._burn[tenant] += 1
                return None
            return max(0.05, b.wait_s(now))

    def retry_hint(self, tenant: str) -> Optional[float]:
        """Wired into ``TenantAdmission.retry_hint`` so queue-full sheds
        also carry the honest refill deficit."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None or b.rate <= 0:
                return None
            return max(0.05, b.wait_s(self._clock()))

    @property
    def revoked(self) -> bool:
        return self._revoked

    def stats(self) -> Dict:
        with self._lock:
            return {
                "proxy_id": self.proxy_id,
                "epoch": self._epoch,
                "revoked": self._revoked,
                "shares": {t: dict(s) for t, s in self._shares.items()},
                "rates": {t: b.rate for t, b in self._buckets.items()},
                "pending_burn": dict(self._burn),
            }


# --------------------------------------------------------- fallback shed
_shed_metrics = None


def record_fallback_shed(deployment: str, fallback: str, app: str = ""):
    """Count one overflow request routed down the fallback ladder
    (handle-level; serve/handle.py calls this on every shed hop)."""
    global _shed_metrics
    if _shed_metrics is None:
        try:
            from ray_tpu_torch.util.metrics import Counter
            _shed_metrics = Counter(
                "serve_fallback_shed_total",
                "requests shed to a fallback deployment",
                tag_keys=("deployment", "fallback"))
        except Exception:
            return
    _shed_metrics.inc(tags={"deployment": deployment, "fallback": fallback})
    from ray_tpu_torch._private import events
    events.record_instant("serve.fallback_shed", category="serve",
                          app=app, deployment=deployment, fallback=fallback)


# ------------------------------------------------------------ shell pool
class ShellPool:
    """A small shared pool of pre-warmed :class:`ReplicaShell` actors.
    ``ensure()`` (reconcile-loop tick, off the controller lock) tops the
    pool up; ``checkout()`` hands a shell to a revival; a shell that
    fails its attach is ``discard()``-ed (killed), never returned."""

    def __init__(self, spawn: Callable[[], Any],
                 size: Optional[int] = None):
        self._spawn = spawn
        self.size = int(cfg.fleet_shell_pool_size if size is None else size)
        self._idle: List[Any] = []
        self._lock = threading.Lock()
        self._filling = threading.Lock()
        self.spawned_total = 0
        self.checked_out_total = 0
        self.discarded_total = 0

    def ensure(self):
        """Replenish to the target size. Single-flight; spawn failures
        log and stop the pass (the next tick retries)."""
        if not self._filling.acquire(blocking=False):
            return
        try:
            while True:
                with self._lock:
                    if len(self._idle) >= self.size:
                        return
                try:
                    shell = self._spawn()
                except Exception:
                    logger.warning("shell spawn failed (next tick retries)",
                                   exc_info=True)
                    return
                with self._lock:
                    self._idle.append(shell)
                    self.spawned_total += 1
        finally:
            self._filling.release()

    def checkout(self) -> Optional[Any]:
        with self._lock:
            if not self._idle:
                return None
            self.checked_out_total += 1
            return self._idle.pop(0)    # FIFO: oldest (warmest) first

    def checkout_many(self, n: int) -> Optional[List[Any]]:
        """Atomic gang checkout: n shells or none. A partial gang is
        useless (every rank of a sharded replica must come up together)
        and handing out half the pool would starve the next single-shell
        revival for nothing."""
        with self._lock:
            if len(self._idle) < n:
                return None
            self.checked_out_total += n
            out, self._idle = self._idle[:n], self._idle[n:]
            return out

    def discard(self, shell: Any):
        """A shell that failed mid-attach is in an unknown state: kill
        it rather than pool it."""
        with self._lock:
            self.discarded_total += 1
        try:
            import ray_tpu_torch
            ray_tpu_torch.kill(shell)
        except Exception:
            logger.debug("shell kill failed", exc_info=True)

    def idle(self) -> int:
        with self._lock:
            return len(self._idle)

    def stats(self) -> Dict:
        with self._lock:
            return {"idle": len(self._idle), "target": self.size,
                    "spawned_total": self.spawned_total,
                    "checked_out_total": self.checked_out_total,
                    "discarded_total": self.discarded_total}


class ReplicaShell:
    """A pre-warmed replica actor with no deployment attached yet: the
    process exists, the heavy imports (torch/numpy/msgpack) are paid, and
    the actor is sitting warm in the :class:`ShellPool`. ``attach()``
    turns it into an ordinary :class:`~ray_tpu_torch.serve.replica.Replica`
    for one deployment — constructing the callable inside the warm
    process (an LLM's weights load here, e.g. from the weight plane's arena via
    its ``params_fn``) and running the callable's optional
    ``on_shell_attach()`` hook (LLMDeployment warms its compiled
    programs) BEFORE the controller publishes the replica to routing
    tables, so held requests never pay import or compile latency.

    Chaos: ``RAY_TPU_TORCH_TESTING_RPC_FAILURE="shell_attach=p"``
    (:class:`~ray_tpu_torch.util.chaos.ShellAttachKiller`) fires at attach
    entry and again after construction, pre-ready — the fleet manager
    must discard this shell and route the held requests through a fresh
    shell or a cold replica, exactly once."""

    def __init__(self):
        from ray_tpu_torch.serve.replica import Replica
        self._replica_cls = Replica
        Replica._init_state(self)
        self._attached = False
        self._shard = None      # set by attach_shard (gang revival)
        self._prewarm()

    def _prewarm(self):
        try:
            import msgpack  # noqa: F401
            import numpy  # noqa: F401
            import torch  # noqa: F401
        except Exception:
            logger.debug("shell prewarm import failed", exc_info=True)

    def attach(self, serialized_callable: bytes, init_args: tuple,
               init_kwargs: Dict, is_function: bool) -> bool:
        from ray_tpu_torch._private import events, rpc
        rpc._maybe_inject_failure("shell_attach")
        # launch attribution: callable construction and compile warmup
        # chain under the revival's replica.launch trace (the task ctx
        # propagated with the attach call)
        t0 = time.time()
        self._replica_cls._init_callable(
            self, serialized_callable, tuple(init_args), init_kwargs,
            is_function)
        t1 = time.time()
        events.record_complete("launch.shell_attach", t0, t1,
                               category="launch")
        hook = getattr(self._callable, "on_shell_attach", None)
        if hook is not None:
            hook()
            events.record_complete("launch.warmup", t1, time.time(),
                                   category="launch")
        rpc._maybe_inject_failure("shell_attach")
        self._attached = True
        return True

    def attach_shard(self, rank: int, world_size: int, group_name: str,
                     serialized_callable: bytes, init_args: tuple,
                     init_kwargs: Dict, is_function: bool) -> bool:
        """Gang-aware attach: turn this warm shell into ONE RANK of a
        sharded replica group (serve/sharded_replica.py). The fleet
        manager checks out ``world_size`` shells atomically and runs
        this on all of them CONCURRENTLY — setup_distributed's
        rendezvous and the callable's lockstep ``on_shell_attach``
        warmup both need every rank in flight at once. Chaos fires at
        the same two points as a plain attach; one rank failing
        discards the whole gang (partial gangs are never published)."""
        from ray_tpu_torch._private import events, rpc
        from ray_tpu_torch.serve.sharded_replica import ReplicaShard
        rpc._maybe_inject_failure("shell_attach")
        t0 = time.time()
        shard = ReplicaShard(rank, world_size)
        shard.setup_distributed(group_name)
        shard.init_callable(serialized_callable, tuple(init_args),
                            init_kwargs, is_function)
        t1 = time.time()
        events.record_complete("launch.shell_attach", t0, t1,
                               category="launch", rank=rank)
        hook = getattr(shard._callable, "on_shell_attach", None)
        if hook is not None:
            hook()
            events.record_complete("launch.warmup", t1, time.time(),
                                   category="launch", rank=rank)
        rpc._maybe_inject_failure("shell_attach")
        self._shard = shard
        self._attached = True
        return True

    def _require_attached(self):
        if not self._attached:
            raise RuntimeError("replica shell has no deployment attached")

    # ------------------------------------------------- replica protocol
    def handle_request(self, method, args, kwargs):
        self._require_attached()
        if self._shard is not None:
            return self._shard.handle_request(method, args, kwargs)
        return self._replica_cls.handle_request(self, method, args, kwargs)

    def handle_stream(self, method, args, kwargs):
        self._require_attached()
        if self._shard is not None:
            yield from self._shard.handle_stream(method, args, kwargs)
            return
        yield from self._replica_cls.handle_stream(self, method, args,
                                                   kwargs)

    def begin_drain(self):
        if self._shard is not None:
            return self._shard.begin_drain()
        return self._replica_cls.begin_drain(self)

    def get_runtime_state(self):
        if self._shard is not None:
            return self._shard.get_runtime_state()
        return self._replica_cls.get_runtime_state(self)

    def get_queue_len(self):
        if self._shard is not None:
            return self._shard.get_queue_len()
        return self._replica_cls.get_queue_len(self)

    def check_health(self):
        # an idle pooled shell is healthy by construction
        if not self._attached:
            return True
        if self._shard is not None:
            return self._shard.check_health()
        return self._replica_cls.check_health(self)

    def reconfigure(self, user_config):
        self._require_attached()
        if self._shard is not None:
            return self._shard.reconfigure(user_config)
        return self._replica_cls.reconfigure(self, user_config)

    # ------------------------------------- shard protocol (gang peers)
    # Rank 0's ReplicaShard fans to peer handles by these names — when
    # the gang was revived from pooled shells, the peers ARE shells.
    def set_peers(self, peers):
        self._require_attached()
        return self._shard.set_peers(peers)

    def run_shard(self, method, args, kwargs):
        self._require_attached()
        return self._shard.run_shard(method, args, kwargs)

    def run_shard_drain(self, method, args, kwargs):
        self._require_attached()
        return self._shard.run_shard_drain(method, args, kwargs)

    def check_peer_health(self):
        self._require_attached()
        return self._shard.check_peer_health()

    def reconfigure_shard(self, user_config):
        self._require_attached()
        return self._shard.reconfigure_shard(user_config)


# ---------------------------------------------------------- fleet manager
class FleetManager:
    """Controller-side fleet brain: idle reaping, shell-pool upkeep, and
    revival. One instance per :class:`ServeController`, created lazily
    when the first deployment opts into scale-to-zero.

    Lock discipline mirrors the controller's: ``note_load`` runs under
    the controller lock (pure bookkeeping); revivals run on their own
    thread and take the lock only for the quick attach/publish
    mutation, so a slow weight load never stalls reconcile."""

    COLD_HIST_MS = [50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                    10000.0, 30000.0, 60000.0]

    def __init__(self, controller, spawn_shell: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._c = controller
        self._clock = clock
        self._lock = threading.Lock()
        self._idle_since: Dict[tuple, float] = {}
        self._reviving: set = set()
        self._cold_ms: Dict[tuple, List[float]] = {}
        self._hist = None
        self.pool = ShellPool(spawn_shell or self._spawn_shell)
        self.revivals_total = 0
        self.cold_builds_total = 0     # revivals that fell back past pool

    # ----------------------------------------------------- idle reaping
    def note_load(self, app: str, name: str, dep: Dict,
                  total_load: float, now: Optional[float] = None) -> bool:
        """One reconcile tick's idle-reaper step for one deployment.
        Caller holds the controller lock. Returns True when the
        deployment was scaled to zero THIS tick."""
        key = (app, name)
        auto = dep["spec"]["config"].get("autoscaling_config")
        now = self._clock() if now is None else now
        with self._lock:
            reviving = key in self._reviving
        zero, idle_since = decide_scale_to_zero(
            auto, self._idle_since.get(key), now, dep["target"],
            total_load, reviving)
        if idle_since is None:
            self._idle_since.pop(key, None)
        else:
            self._idle_since[key] = idle_since
        if not zero or dep["target"] == 0:
            return False
        dep["target"] = 0
        self._idle_since.pop(key, None)
        from ray_tpu_torch._private import events
        events.record_instant(
            "serve.scale_to_zero", category="serve", app=app,
            deployment=name,
            idle_s=round(now - (idle_since or now), 3))
        logger.info("scale-to-zero: %s/%s idle past %ss", app, name,
                    (auto or {}).get("idle_scale_to_zero_s"))
        return True

    # ------------------------------------------------------------- tick
    def tick(self, want_shells: bool):
        """Reconcile-loop hook (off the controller lock): keep the shell
        pool topped up while any deployment can scale to zero."""
        if want_shells:
            self.pool.ensure()

    def _spawn_shell(self):
        import ray_tpu_torch
        actor_cls = ray_tpu_torch.remote(ReplicaShell)
        return actor_cls.options(max_concurrency=18,
                                 num_cpus=0.1).remote()

    # ---------------------------------------------------------- revival
    def revive(self, app: str, name: str) -> bool:
        """Router-requested cold start. Idempotent: concurrent requests
        for one deployment fold into a single revival; a deployment
        that already has replicas (or one building) returns True
        immediately — the caller keeps polling the routing table."""
        key = (app, name)
        with self._c._lock:
            dep = self._c.apps.get(app, {}).get(name)
            if dep is None:
                return False
            if dep["replicas"]:
                return True
            if dep.get("_creating"):
                return True    # a build is already in flight; poll on
            with self._lock:
                if key in self._reviving:
                    return True
                self._reviving.add(key)
            if dep["target"] < 1:
                dep["target"] = 1
            dep["_creating"] = True        # reconcile must not double-build
            self._idle_since.pop(key, None)
        threading.Thread(target=self._revive_thread, args=(key, dep),
                         name=f"fleet-revive-{name}", daemon=True).start()
        return True

    def _revive_thread(self, key: tuple, dep: Dict):
        import ray_tpu_torch
        t0 = self._clock()
        app, name = key
        try:
            with self._c._lock:
                spec = dep["spec"]
                gen = dep.get("gen", 0)
            handle, group, via = None, None, "shell"
            n_hosts = int(spec["config"].get("num_hosts") or 1)
            if n_hosts > 1:
                got = self._attach_shard_gang(spec, n_hosts)
                if got is not None:
                    handle, group = got
            else:
                # try every pooled shell once, then one fresh cold
                # build — the chaos suite kills shells mid-attach and
                # the held requests must still land exactly once
                from ray_tpu_torch._private import events
                for attempt in range(max(1, self.pool.size)):
                    t_co = time.time()
                    shell = self.pool.checkout()
                    if shell is None:
                        break
                    events.record_complete(
                        "launch.shell_checkout", t_co, time.time(),
                        category="launch", app=app, deployment=name)
                    try:
                        ray_tpu_torch.get(shell.attach.remote(
                            spec["callable"], tuple(spec["init_args"]),
                            spec["init_kwargs"], spec["is_function"]),
                            timeout=cfg.fleet_attach_timeout_s)
                        handle = shell
                        break
                    except Exception:
                        logger.warning(
                            "shell attach failed for %s/%s (attempt %d); "
                            "discarding shell", app, name, attempt + 1,
                            exc_info=True)
                        self.pool.discard(shell)
            if handle is None:
                via = "cold"
                self.cold_builds_total += 1
                handle, group = self._c._build_replica(spec)
            cold_ms = (self._clock() - t0) * 1e3
            with self._c._lock:
                alive = (self._c.apps.get(spec.get("app_name") or "", {})
                         .get(spec["name"]) is dep)
                stale = dep.get("gen", 0) != gen
                if alive and not stale:
                    dep["replicas"].append(handle)
                    dep.setdefault("replica_gens", []).append(gen)
                    if group is not None:
                        dep.setdefault("groups", {})[
                            handle._actor_id] = group
                    dep["version"] += 1
                    self._c._bump_dep(dep)
            if not alive or stale:
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:
                    pass
                return
            self.revivals_total += 1
            self._record_cold_start(key, cold_ms, via)
        except Exception:
            logger.exception("revival failed for %s/%s (reconcile "
                             "retries the build)", app, name)
        finally:
            with self._c._lock:
                dep["_creating"] = False
            with self._lock:
                self._reviving.discard(key)
            try:
                self.pool.ensure()     # replenish for the next cold start
            except Exception:
                logger.debug("shell pool refill failed", exc_info=True)

    def _attach_shard_gang(self, spec: Dict, n_hosts: int):
        """Gang-aware pre-warm revival for a sharded (``num_hosts > 1``)
        deployment: check out ``n_hosts`` shells atomically and attach
        them CONCURRENTLY as the ranks of one replica group —
        rendezvous + lockstep warmup need every rank in flight at once
        (ReplicaShell.attach_shard). Returns ``(rank0_handle,
        group_record)`` or None (pool too shallow / attach failed /
        topology-pinned spec) — the caller cold-builds via the
        controller's gang path.

        Topology-pinned gangs always cold-build: pooled shells carry no
        placement, so they cannot satisfy STRICT_SPREAD over one
        slice's hosts."""
        import uuid

        import ray_tpu_torch
        if spec["config"].get("topology"):
            return None
        shells = self.pool.checkout_many(n_hosts)
        if shells is None:
            return None
        group_name = f"serve-shard-{uuid.uuid4().hex[:8]}"
        try:
            ray_tpu_torch.get(
                [s.attach_shard.remote(
                    rank, n_hosts, group_name, spec["callable"],
                    tuple(spec["init_args"]), spec["init_kwargs"],
                    spec["is_function"])
                 for rank, s in enumerate(shells)],
                timeout=cfg.fleet_attach_timeout_s)
            ray_tpu_torch.get(shells[0].set_peers.remote(shells[1:]), timeout=60)
        except Exception:
            logger.warning(
                "gang shell attach failed for %s (%d ranks); discarding "
                "the whole gang", spec["name"], n_hosts, exc_info=True)
            for s in shells:
                self.pool.discard(s)
            return None
        return shells[0], {"members": list(shells), "pg": None}

    def _record_cold_start(self, key: tuple, cold_ms: float, via: str):
        with self._lock:
            samples = self._cold_ms.setdefault(key, [])
            samples.append(cold_ms)
            del samples[:-256]
        if self._hist is None:
            try:
                from ray_tpu_torch.util.metrics import Histogram
                self._hist = Histogram(
                    "serve_cold_start_ms",
                    "scale-to-zero revival latency (request hold -> "
                    "replica published)", boundaries=self.COLD_HIST_MS)
            except Exception:
                self._hist = False
        if self._hist:
            self._hist.observe(cold_ms)
        from ray_tpu_torch._private import events
        events.record_instant(
            "serve.cold_start", category="serve", app=key[0],
            deployment=key[1], cold_start_ms=round(cold_ms, 1), via=via)
        logger.info("cold start %s/%s via %s in %.0fms", key[0], key[1],
                    via, cold_ms)

    # ------------------------------------------------------------ status
    def cold_start_stats(self) -> Dict[str, Dict]:
        out = {}
        with self._lock:
            for (app, name), samples in self._cold_ms.items():
                if not samples:
                    continue
                s = sorted(samples)
                out[f"{app}/{name}"] = {
                    "count": len(s),
                    "last_ms": round(samples[-1], 1),
                    "p50_ms": round(_pctl(s, 0.50), 1),
                    "p99_ms": round(_pctl(s, 0.99), 1),
                }
        return out

    def status(self) -> Dict:
        with self._lock:
            reviving = [f"{a}/{n}" for a, n in self._reviving]
            idle = {f"{a}/{n}": round(self._clock() - t, 1)
                    for (a, n), t in self._idle_since.items()}
        return {"shell_pool": self.pool.stats(),
                "revivals_total": self.revivals_total,
                "cold_builds_total": self.cold_builds_total,
                "reviving": reviving, "idle_s": idle,
                "cold_starts": self.cold_start_stats()}


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]
