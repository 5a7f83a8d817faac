"""Autoscaler: reconcile cluster size against pending resource demand
(reference: the v2 architecture — python/ray/autoscaler/v2/autoscaler.py:42,
instance_manager, scheduler.py binpacking against ClusterResourceState).
Demand comes from node-manager heartbeats (queued lease requests) through
the GCS node table; the provider launches/terminates nodes."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import scheduling

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    max_workers: int = 10
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeTypeConfig]
    idle_timeout_s: float = 30.0
    upscale_interval_s: float = 2.0
    # consecutive step() failures back the loop off exponentially up to
    # this cap (a dead cloud API must not be hammered — nor fill the log
    # — every upscale_interval_s)
    max_backoff_s: float = 60.0
    # fold the serve controller's unmet replica demand
    # (ServeController.get_replica_demand) into binpacking, so the
    # provider acquires TPU slices for replicas the serve control loop
    # wants before their lease requests even reach a node manager. The
    # controller keeps these rows honest for the fleet plane: a
    # deployment shedding burn overflow to its fallback_model, or one
    # scaled to zero, bids for no slices (serve/fleet.py)
    serve_demand: bool = True


class Autoscaler:
    def __init__(self, config: AutoscalerConfig, provider,
                 protected_node_ids: Optional[List[str]] = None,
                 nodes_fn=None, serve_demand_fn=None):
        self.config = config
        self.provider = provider
        self.protected = set(protected_node_ids or [])
        self._nodes_fn = nodes_fn    # None -> the driver's node table
        self._launched: Dict[str, str] = {}   # node_id -> node_type
        # launched but not yet registered in the node table; counted as
        # capacity during binpacking so a slow-booting node (minutes for a
        # TPU-VM) isn't re-launched every step for the same demand
        self._inflight: Dict[str, str] = {}   # node_id -> node_type
        self._idle_since: Dict[str, float] = {}
        # serve demand source: injected fn for tests, else lazily
        # discovered SERVE_CONTROLLER actor (absent = no serve = [])
        self._serve_demand_fn = serve_demand_fn
        self._serve_ctrl = None
        self._serve_ctrl_next_probe = 0.0
        self._consecutive_failures = 0
        from ray_tpu_torch.util.metrics import Counter
        self._step_failures = Counter(
            "autoscaler_step_failures",
            "autoscaler reconcile steps that raised (provider/API "
            "errors); the run loop backs off exponentially while these "
            "accumulate")

    def _cluster_nodes(self) -> List[Dict]:
        if self._nodes_fn is not None:
            return self._nodes_fn()
        import ray_tpu_torch
        return ray_tpu_torch.nodes()

    def _serve_demand(self) -> List[Dict[str, float]]:
        """Replica demand exported by the serve control loop (ROADMAP
        item 2: the burn-rate autoscaler raises targets, THIS is how
        those targets turn into TPU slices). Best-effort: no controller
        (or a dead one) means no serve demand, never a failed step."""
        if not self.config.serve_demand:
            return []
        if self._serve_demand_fn is not None:
            try:
                return list(self._serve_demand_fn() or [])
            except Exception:
                return []
        import ray_tpu_torch
        now = time.monotonic()
        if self._serve_ctrl is None:
            if now < self._serve_ctrl_next_probe:
                return []
            try:
                self._serve_ctrl = ray_tpu_torch.get_actor(
                    "SERVE_CONTROLLER", namespace="serve")
            except Exception:
                # no serve session yet; re-probe at a gentle cadence
                self._serve_ctrl_next_probe = now + 10.0
                return []
        try:
            return list(ray_tpu_torch.get(
                self._serve_ctrl.get_replica_demand.remote(),
                timeout=5) or [])
        except Exception:
            self._serve_ctrl = None   # controller died/rolled: rediscover
            return []

    def step(self) -> Dict:
        """One reconcile iteration; returns a summary of actions."""
        nodes = self._cluster_nodes()
        alive = [n for n in nodes if n["alive"]]
        demand: List[Dict[str, float]] = []
        for n in alive:
            demand.extend(n.get("pending_demand") or [])
        # serve demand dedupes against lease demand: once a wanted
        # replica's actor lease is queued at a node manager it shows up
        # in pending_demand with the same resource shape — counting both
        # would double-launch
        serve_rows = self._serve_demand()
        if serve_rows:
            queued: Dict[tuple, int] = {}
            for req in demand:
                k = tuple(sorted(req.items()))
                queued[k] = queued.get(k, 0) + 1
            for req in serve_rows:
                k = tuple(sorted(req.items()))
                if queued.get(k, 0) > 0:
                    queued[k] -= 1
                else:
                    demand.append(req)
        actions = {"launched": [], "terminated": []}

        # reconcile in-flight launches: once a launched node registers it
        # counts through the real node table instead. Slice providers
        # (GCE queued resources) name a whole slice; its hosts register
        # with their own node ids but advertise tpu-slice:{provider_id},
        # which is how provider ids map back to cluster nodes.
        alive_ids = {n["node_id"] for n in alive}
        slice_of = {}                    # provider_id -> [cluster node]
        for n in alive:
            for res in n.get("total", {}):
                if res.startswith("tpu-slice:"):
                    slice_of.setdefault(res[len("tpu-slice:"):],
                                        []).append(n)
        for nid in list(self._inflight):
            if nid in alive_ids or nid in slice_of:
                del self._inflight[nid]
        # drop launches the provider declared dead (FAILED queued
        # resources etc.) so the demand can relaunch
        try:
            live_provider = set(self.provider.non_terminated_nodes())
        except Exception:
            live_provider = None
        if live_provider is not None:
            for nid in list(self._inflight):
                if nid not in live_provider:
                    self._inflight.pop(nid, None)
                    self._launched.pop(nid, None)

        # --- scale up: binpack unmet demand onto live + in-flight +
        # hypothetical new nodes (one launch can absorb many requests)
        if demand:
            shadow = {n["node_id"]: {"total": dict(n["total"]),
                                     "available": dict(n["available"]),
                                     "alive": True}
                      for n in alive}
            for nid, tname in self._inflight.items():
                res = dict(self.config.node_types[tname].resources)
                shadow[nid] = {"total": dict(res), "available": res,
                               "alive": True}
            per_type_count: Dict[str, int] = {}
            for tname in self._launched.values():
                per_type_count[tname] = per_type_count.get(tname, 0) + 1
            for req in demand:
                nid = scheduling.hybrid_policy(shadow, req)
                if nid is not None:
                    scheduling.subtract(shadow[nid]["available"], req)
                    continue
                for tname, tcfg in self.config.node_types.items():
                    if per_type_count.get(tname, 0) >= tcfg.max_workers:
                        continue
                    if scheduling.feasible(tcfg.resources, req):
                        nid = self.provider.create_node(
                            tname, tcfg.resources, tcfg.labels)
                        self._launched[nid] = tname
                        self._inflight[nid] = tname
                        per_type_count[tname] = \
                            per_type_count.get(tname, 0) + 1
                        actions["launched"].append(tname)
                        res = dict(tcfg.resources)
                        scheduling.subtract(res, req)
                        shadow[nid] = {"total": dict(tcfg.resources),
                                       "available": res, "alive": True}
                        break

        # --- scale down: terminate launched nodes idle past the timeout
        now = time.monotonic()
        for n in alive:
            nid = n["node_id"]
            # slice hosts terminate at slice granularity via provider id
            provider_id = nid
            if nid not in self._launched:
                provider_id = next(
                    (pid for pid, members in slice_of.items()
                     if pid in self._launched
                     and any(m["node_id"] == nid for m in members)), None)
                if provider_id is None:
                    continue
            if nid in self.protected:
                continue
            busy = any(n["available"].get(k, 0) < n["total"].get(k, 0) - 1e-9
                       for k in n["total"]
                       if k != "object_store_memory")
            if busy or (n.get("pending_demand") or []):
                self._idle_since.pop(nid, None)
                continue
            first_idle = self._idle_since.setdefault(nid, now)
            if now - first_idle > self.config.idle_timeout_s:
                # a slice only terminates when EVERY member host is idle
                if provider_id != nid:
                    members = slice_of.get(provider_id, [])
                    if not all(
                            now - self._idle_since.get(m["node_id"], now)
                            > self.config.idle_timeout_s
                            for m in members):
                        continue
                try:
                    self.provider.terminate_node(provider_id)
                except Exception:
                    logger.exception("terminate %s failed; will retry",
                                     provider_id)
                    continue
                self._launched.pop(provider_id, None)
                # drop idle state for EVERY member of a terminated slice,
                # not just the triggering host (stale entries would
                # otherwise accumulate for the life of the reconciler)
                if provider_id != nid:
                    for m in slice_of.get(provider_id, []):
                        self._idle_since.pop(m["node_id"], None)
                self._idle_since.pop(nid, None)
                actions["terminated"].append(provider_id)
        # prune idle entries for nodes no longer alive (dead or terminated
        # out-of-band): _idle_since must not grow without bound
        alive_ids = {n["node_id"] for n in alive}
        for nid in [k for k in self._idle_since if k not in alive_ids]:
            self._idle_since.pop(nid, None)
        return actions

    def _step_delay(self, failures: int) -> float:
        """Loop cadence: the configured interval while healthy, doubling
        per consecutive failure up to max_backoff_s — a dead provider
        API is retried at a polite pace instead of hot-looping a full
        stack trace every interval."""
        base = self.config.upscale_interval_s
        if failures <= 0:
            return base
        return min(self.config.max_backoff_s,
                   base * (2.0 ** min(failures, 6)))

    def run(self, stop_event=None):
        while stop_event is None or not stop_event.is_set():
            try:
                self.step()
                self._consecutive_failures = 0
            except Exception:
                self._consecutive_failures += 1
                self._step_failures.inc()
                if self._consecutive_failures == 1:
                    logger.exception("autoscaler step failed")
                else:
                    # the first failure carried the stack; repeats log
                    # one line with the escalating backoff
                    logger.warning(
                        "autoscaler step failed (%d consecutive); "
                        "backing off %.1fs",
                        self._consecutive_failures,
                        self._step_delay(self._consecutive_failures))
            delay = self._step_delay(self._consecutive_failures)
            if stop_event is not None:
                if stop_event.wait(delay):
                    return
            else:
                time.sleep(delay)
