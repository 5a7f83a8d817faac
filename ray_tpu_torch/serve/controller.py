"""ServeController: the serve control plane actor (reference:
python/ray/serve/_private/controller.py:84, deployment_state.py:1232
replica reconciliation, autoscaling_state.py). Holds per-application
deployment state, creates/kills replica actors, reconciles health and
autoscaling on a background thread, and serves routing tables to handles
(the reference pushes config via long-poll; here handles poll with a
version number over the same actor RPC path).

Methods are sync (they run on actor executor threads; the worker's event
loop must stay free for RPC)."""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

def autoscale_decision(auto: Dict, hist, total_load: float, target: int,
                       now: float, up_since: Dict, down_since: Dict,
                       key) -> int:
    """Pure autoscaling step (reference: serve/autoscaling_policy.py).
    Appends the sample to `hist`, windows it to look_back_period_s, and
    returns the new target: the desired count (ceil(window-avg load /
    target_ongoing_requests), clamped) applied only once the up/down
    condition has held for its delay. `up_since`/`down_since` carry the
    condition-start timestamps between calls."""
    import math
    hist.append((now, total_load))
    look = auto.get("look_back_period_s", 10.0)
    while hist and hist[0][0] < now - look:
        hist.popleft()
    avg_total = sum(v for _, v in hist) / len(hist)
    desired = math.ceil(avg_total / max(auto["target_ongoing_requests"],
                                        1e-9))
    desired = max(auto["min_replicas"], min(auto["max_replicas"], desired))
    if desired > target:
        down_since.pop(key, None)
        t0 = up_since.setdefault(key, now)
        if now - t0 >= auto.get("upscale_delay_s", 0.0):
            up_since.pop(key, None)
            return desired
    elif desired < target:
        up_since.pop(key, None)
        t0 = down_since.setdefault(key, now)
        if now - t0 >= auto.get("downscale_delay_s", 0.0):
            down_since.pop(key, None)
            return desired
    else:
        up_since.pop(key, None)
        down_since.pop(key, None)
    return target


class ServeController:
    def __init__(self):
        # apps[app][dep] = {spec, replicas: [handle], version, target}
        self.apps: Dict[str, Dict[str, Dict]] = {}
        self._lock = threading.RLock()
        self._load_hist: Dict[tuple, "collections.deque"] = {}
        self._up_since: Dict[tuple, float] = {}
        self._down_since: Dict[tuple, float] = {}
        self._stop = False
        # routing state is controller-owned so every proxy on every node
        # serves one authoritative table (reference: EndpointState +
        # ProxyState in the controller)
        self.routes: Dict[str, str] = {}        # route_prefix -> app
        self.ingress: Dict[str, str] = {}       # app -> deployment
        self.http_port: Optional[int] = None    # None = HTTP disabled
        self.grpc_port: Optional[int] = None    # None = gRPC disabled
        self._proxies: Dict[str, Any] = {}      # node_id -> actor handle
        self._grpc_proxies: Dict[str, Any] = {}
        self._proxy_addrs: Dict[str, Dict] = {} # node_id -> {http, grpc}
        # long-poll: every mutation bumps a key's version and wakes
        # listeners (reference: LongPollHost, _private/long_poll.py:177 —
        # config push instead of client polling)
        self._versions: Dict[str, int] = {"routes": 0}
        # SLO burn-rate engine (serve/slo.py): evaluated each reconcile
        # tick against the GCS time-series plane for deployments that
        # declared slo_config
        self._slo_tracker = None
        # burn-driven replica scaling (serve/slo.py BurnRateScaler):
        # one policy instance per (app, deployment)
        self._burn_scalers: Dict[tuple, Any] = {}
        self._target_gauge = None
        # fleet plane (serve/fleet.py): idle reaper + pre-warmed shell
        # pool + revival, created lazily when the first deployment opts
        # into scale-to-zero
        self._fleet = None
        # router-side prefix-summary push: the reconcile loop snapshots
        # the GCS prefix_summaries table and bumps the long-poll key on
        # change, so routers stop paying the 1 Hz pull
        self._prefix_rows: List[Dict] = []
        self._prefix_sig = None
        self._longpoll = threading.Condition()
        self._proxy_reconcile_lock = threading.Lock()
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------- long poll
    def _bump(self, key: str):
        with self._longpoll:
            self._versions[key] = self._versions.get(key, 0) + 1
            self._longpoll.notify_all()

    def _key_data(self, key: str):
        if key == "routes":
            return {"routes": dict(self.routes),
                    "ingress": dict(self.ingress)}
        if key.startswith("dep:"):
            _, app_name, name = key.split(":", 2)
            return self.get_deployment_info(app_name, name)
        if key == "prefix_summaries":
            return {"rows": list(self._prefix_rows)}
        return None

    def listen_for_change(self, snapshot: Dict[str, int],
                          timeout_s: float = 30.0) -> Dict[str, Dict]:
        """Block until any watched key moves past the caller's version,
        then return {key: {"version": v, "data": ...}} for the changed
        keys (empty dict on timeout — the caller just re-listens)."""
        deadline = time.monotonic() + timeout_s

        def changed():
            return {k: v for k, v in self._versions.items()
                    if k in snapshot and v > snapshot[k]}

        with self._longpoll:
            while True:
                hits = changed()
                if hits:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._longpoll.wait(timeout=remaining)
        with self._lock:
            return {k: {"version": v, "data": self._key_data(k)}
                    for k, v in hits.items()}

    def set_route(self, route_prefix: Optional[str], app_name: str,
                  ingress_deployment: str):
        with self._lock:
            self.ingress[app_name] = ingress_deployment
            if route_prefix:
                self.routes[route_prefix] = app_name
        self._bump("routes")
        return True

    def set_http(self, port: Optional[int] = None,
                 grpc_port: Optional[int] = None,
                 grpc_servicer_functions: Optional[List[str]] = None):
        """Enable ingress: the reconcile loop keeps one HTTP (and
        optionally gRPC) proxy on every alive node (reference: proxy per
        node, controller ProxyState). grpc_servicer_functions: import
        paths of generated add_X_to_server functions registered on every
        gRPC proxy (reference: gRPCOptions.grpc_servicer_functions)."""
        stale = []
        with self._lock:
            if port is not None:
                self.http_port = port
            if grpc_port is not None:
                self.grpc_port = grpc_port
            if grpc_servicer_functions is not None:
                new = list(grpc_servicer_functions)
                if new != getattr(self, "_grpc_servicers", None):
                    self._grpc_servicers = new
                    # existing proxies were built with the old servicer
                    # list: recycle them so the reconcile below brings
                    # them back with the typed services registered
                    stale = list(self._grpc_proxies.values())
                    self._grpc_proxies.clear()
                    for addrs in self._proxy_addrs.values():
                        addrs.pop("grpc", None)
        import ray_tpu_torch
        for p in stale:
            try:
                ray_tpu_torch.kill(p)
            except Exception:
                pass
        self._reconcile_proxies()
        return True

    def shutdown_proxies(self):
        import ray_tpu_torch
        with self._lock:
            proxies = list(self._proxies.values()) + \
                list(self._grpc_proxies.values())
            self._proxies.clear()
            self._grpc_proxies.clear()
            self._proxy_addrs.clear()
            self.http_port = None
            self.grpc_port = None
        for p in proxies:
            try:
                ray_tpu_torch.kill(p)
            except Exception:
                pass
        return True

    def get_proxies(self) -> Dict[str, Dict]:
        with self._lock:
            return dict(self._proxy_addrs)

    def _reconcile_proxies(self):
        import ray_tpu_torch
        from ray_tpu_torch.util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy
        if not self._proxy_reconcile_lock.acquire(blocking=False):
            return   # another reconcile is already creating proxies
        try:
            self._reconcile_proxies_locked(ray_tpu_torch,
                                           NodeAffinitySchedulingStrategy)
        finally:
            self._proxy_reconcile_lock.release()

    def _reconcile_proxies_locked(self, ray_tpu_torch,
                                  NodeAffinitySchedulingStrategy):
        with self._lock:
            http_port = self.http_port
            grpc_port = self.grpc_port
        if http_port is None and grpc_port is None:
            return
        try:
            nodes = [n for n in ray_tpu_torch.nodes() if n["alive"]]
        except Exception:
            return
        alive_ids = {n["node_id"] for n in nodes}
        with self._lock:
            for nid in list(self._proxies):
                if nid not in alive_ids:
                    self._proxies.pop(nid, None)
                    self._proxy_addrs.pop(nid, None)
            for nid in list(self._grpc_proxies):
                if nid not in alive_ids:
                    self._grpc_proxies.pop(nid, None)
        me = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
        for n in nodes:
            nid = n["node_id"]
            if http_port is not None and nid not in self._proxies:
                try:
                    from ray_tpu_torch.serve.proxy import HttpProxy
                    actor_cls = ray_tpu_torch.remote(HttpProxy)
                    proxy = actor_cls.options(
                        name=f"SERVE_PROXY:{nid[:12]}", namespace="serve",
                        max_concurrency=64, num_cpus=0.1,
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            nid)).remote(http_port, me)
                    addr = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
                    with self._lock:
                        self._proxies[nid] = proxy
                        self._proxy_addrs.setdefault(nid, {})["http"] = addr
                except Exception:
                    logger.exception("http proxy start failed on %s",
                                     nid[:12])
            if grpc_port is not None and nid not in self._grpc_proxies:
                try:
                    from ray_tpu_torch.serve.grpc_proxy import GrpcProxy
                    actor_cls = ray_tpu_torch.remote(GrpcProxy)
                    proxy = actor_cls.options(
                        name=f"SERVE_GRPC:{nid[:12]}", namespace="serve",
                        max_concurrency=64, num_cpus=0.1,
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            nid)).remote(grpc_port, me,
                                         getattr(self, "_grpc_servicers",
                                                 None))
                    addr = ray_tpu_torch.get(proxy.ready.remote(),
                                             timeout=60)
                    with self._lock:
                        self._grpc_proxies[nid] = proxy
                        self._proxy_addrs.setdefault(nid, {})["grpc"] = addr
                except Exception:
                    logger.exception("grpc proxy start failed on %s",
                                     nid[:12])

    def deploy_application(self, app_name: str, specs: List[Dict]):
        """specs: dependencies-first list of deployment specs."""
        builds = []
        with self._lock:
            app = self.apps.setdefault(app_name, {})
            for spec in specs:
                spec["app_name"] = app_name
                name = spec["name"]
                dep = app.get(name)
                if dep is None:
                    dep = {"spec": spec, "replicas": [], "version": 0,
                           "target": spec["config"]["num_replicas"]}
                    app[name] = dep
                else:
                    dep["spec"] = spec
                    dep["target"] = spec["config"]["num_replicas"]
                    # code/config change -> ROLLING update: bump the
                    # generation; _reconcile_deployment adds new-gen
                    # replicas first and retires old-gen ones one at a
                    # time, so capacity never drops to zero mid-deploy
                    # (reference: serve deployment_state rolling updates)
                    dep["gen"] = dep.get("gen", 0) + 1
                auto = spec["config"].get("autoscaling_config")
                if auto:
                    dep["target"] = max(auto["min_replicas"],
                                        min(dep["target"],
                                            auto["max_replicas"]))
                builds.append((dep, self._reconcile_deployment(dep)))
        # replica CONSTRUCTION runs outside the lock: a sharded gang can
        # take minutes to come up, and holding the lock would freeze the
        # whole control plane (deploys, long-poll, health) meanwhile
        for dep, n in builds:
            self._create_replicas(dep, n)
        return True

    def _build_replica(self, spec: Dict, spread_node: Optional[str] = None):
        """Construct one replica (possibly slow — sharded gangs do a
        placement-group wait + process-group init + model load). MUST
        be called without self._lock held. Returns (handle, group) where
        group is the gang record for sharded replicas, else None.
        spread_node: anti-affinity hint (serve/fleet.py plan_spread) —
        soft node affinity, so a full node degrades to the default
        policy instead of failing the build."""
        import ray_tpu_torch
        if int(spec["config"].get("num_hosts") or 1) > 1:
            # sharded replica = a gang of ReplicaShard actors; routers see
            # only the rank-0 facade, the controller keeps the group
            # record so retire/kill tears down the whole gang
            from ray_tpu_torch.serve.sharded_replica import \
                create_sharded_group
            return create_sharded_group(spec)
        from ray_tpu_torch.serve.replica import Replica
        opts = dict(spec["config"].get("ray_actor_options") or {})
        max_ongoing = spec["config"].get("max_ongoing_requests", 16)
        actor_cls = ray_tpu_torch.remote(Replica)
        a_opts = dict(
            max_concurrency=max_ongoing + 2,
            num_cpus=opts.get("num_cpus", 0.25),
            num_gpus=opts.get("num_gpus"),
            num_tpus=opts.get("num_tpus"),
            resources=opts.get("resources"))
        if opts.get("runtime_env"):
            a_opts["runtime_env"] = opts["runtime_env"]
        if spread_node:
            from ray_tpu_torch.util.scheduling_strategies import \
                NodeAffinitySchedulingStrategy
            a_opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                spread_node, soft=True)
        return actor_cls.options(**a_opts).remote(
            spec["callable"], tuple(spec["init_args"]),
            spec["init_kwargs"], spec["is_function"]), None

    def _plan_spread_node(self, dep: Dict) -> Optional[str]:
        """Anti-affinity placement for the next replica of `dep`: the
        alive node hosting the fewest of this deployment's replicas, so
        one preemption/node loss can't zero a model. None on single-node
        clusters or when the cluster view is unavailable."""
        import ray_tpu_torch
        try:
            nodes = [n for n in ray_tpu_torch.nodes() if n.get("alive")]
        except Exception:
            return None
        with self._lock:
            node_of = dep.get("replica_nodes") or {}
            used = [node_of.get(getattr(r, "_actor_id", None))
                    for r in dep["replicas"]]
        from ray_tpu_torch.serve.fleet import plan_spread
        return plan_spread(nodes, [u for u in used if u])

    def _create_replicas(self, dep: Dict, n: int):
        """Build `n` replicas WITHOUT holding the lock, then attach each
        under the lock — discarding it if the deployment rolled or was
        deleted while it was building."""
        if n <= 0:
            return
        from ray_tpu_torch.serve.sharded_replica import kill_group
        import ray_tpu_torch
        try:
            for _ in range(n):
                with self._lock:
                    spec = dep["spec"]
                    gen = dep.get("gen", 0)
                spread = self._plan_spread_node(dep)
                try:
                    handle, group = self._build_replica(spec,
                                                        spread_node=spread)
                except Exception:
                    logger.exception("replica build failed for %s/%s "
                                     "(retried next reconcile tick)",
                                     spec.get("app_name"), spec["name"])
                    break
                with self._lock:
                    app = self.apps.get(spec.get("app_name") or "", {})
                    alive = app.get(spec["name"]) is dep
                    stale = dep.get("gen", 0) != gen
                    if alive and not stale:
                        dep["replicas"].append(handle)
                        dep.setdefault("replica_gens", []).append(gen)
                        if spread:
                            dep.setdefault("replica_nodes", {})[
                                getattr(handle, "_actor_id", None)] = spread
                        if group is not None:
                            dep.setdefault("groups", {})[
                                handle._actor_id] = group
                        dep["version"] += 1
                        self._bump_dep(dep)
                        continue
                # rolled/deleted mid-build: the fresh replica is already
                # obsolete — tear it down instead of leaking it
                if group is not None:
                    kill_group(group)
                else:
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass
        finally:
            with self._lock:
                dep["_creating"] = False

    def _kill_replica(self, dep: Dict, handle):
        """Kill a replica; for sharded replicas this retires the whole
        gang (every rank + the placement group)."""
        import ray_tpu_torch
        group = (dep.get("groups") or {}).pop(
            getattr(handle, "_actor_id", None), None)
        if group is not None:
            from ray_tpu_torch.serve.sharded_replica import kill_group
            kill_group(group)
            return
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    def _reconcile_deployment(self, dep: Dict) -> int:
        """Caller holds self._lock. Quick mutations only (retire/drain
        bookkeeping); returns how many replicas the caller must build
        via _create_replicas OUTSIDE the lock."""
        gen = dep.get("gen", 0)
        gens = dep.setdefault("replica_gens", [])
        while len(gens) < len(dep["replicas"]):
            gens.append(gen)        # legacy/pre-roll replicas
        del gens[len(dep["replicas"]):]
        changed = False
        n_create = 0
        new_count = sum(1 for g in gens if g == gen)
        old_idx = [i for i, g in enumerate(gens) if g != gen]
        if dep.get("_creating"):
            pass        # a build is already in flight; let it land first
        elif new_count < dep["target"]:
            if old_idx:
                # mid-roll: surge ONE new-generation replica per
                # reconcile tick — gradual replacement
                n_create = 1
            else:
                # fresh deploy / plain scale-up: fill to target now
                n_create = dep["target"] - new_count
        elif old_idx:
            # current generation is at target: retire ONE old replica —
            # gracefully: routers stop picking it (version bump below),
            # the process lives until its queue drains (reference:
            # replica graceful_shutdown_wait_loop)
            victim = dep["replicas"].pop(old_idx[0])
            gens.pop(old_idx[0])
            self._start_drain(dep, victim)
            changed = True
        while len(dep["replicas"]) > dep["target"] and not old_idx:
            victim = dep["replicas"].pop()
            gens.pop()
            self._start_drain(dep, victim)
            changed = True
        if changed:
            dep["version"] += 1
            self._bump_dep(dep)
        if n_create:
            dep["_creating"] = True
        return n_create

    def _dep_key(self, dep: Dict) -> str:
        spec = dep["spec"]
        return f"dep:{spec.get('app_name', '')}:{spec['name']}"

    def _bump_dep(self, dep: Dict):
        self._bump(self._dep_key(dep))

    def _reconcile_loop(self):
        import ray_tpu_torch

        from ray_tpu_torch._private.config import cfg
        while not self._stop:
            time.sleep(cfg.serve_reconcile_period_s)
            try:
                with self._lock:
                    items = [(a, n, dep) for a, app in self.apps.items()
                             for n, dep in app.items()]
                for app_name, name, dep in items:
                    try:
                        self._reconcile_one(app_name, name, dep)
                    except Exception:
                        # one broken deployment must not starve the
                        # others' health checks / autoscaling / proxies
                        logger.exception("reconcile failed for %s/%s",
                                         app_name, name)
                self._reconcile_proxies()
                self._fleet_tick(items)
                self._push_prefix_summaries(items)
            except Exception:
                logger.exception("reconcile loop iteration failed")

    @staticmethod
    def _wants_scale_to_zero(dep: Dict) -> bool:
        auto = dep["spec"]["config"].get("autoscaling_config") or {}
        return (int(auto.get("min_replicas", 1) or 0) == 0
                and bool(auto.get("idle_scale_to_zero_s")))

    def _fleet_mgr(self):
        if self._fleet is None:
            from ray_tpu_torch.serve.fleet import FleetManager
            self._fleet = FleetManager(self)
        return self._fleet

    def _fleet_tick(self, items):
        """Keep the pre-warmed shell pool topped up while any deployment
        can scale to zero (off the lock; shell spawn is slow)."""
        want = any(self._wants_scale_to_zero(dep) for _, _, dep in items)
        if not want and self._fleet is None:
            return
        self._fleet_mgr().tick(want)

    def _push_prefix_summaries(self, items):
        """Satellite of ROADMAP item 1: deliver prefix_summaries to
        routers over the long-poll plane instead of their 1 Hz GCS pull.
        The reconcile tick snapshots the GCS table; a changed snapshot
        bumps the "prefix_summaries" long-poll key (routers that see no
        push fall back to pulling)."""
        from ray_tpu_torch._private.config import cfg
        if not cfg.prefix_summary_push:
            return
        if not any(dep["spec"]["config"].get("prefix_routed")
                   for _, _, dep in items):
            return
        import ray_tpu_torch
        try:
            rows = ray_tpu_torch._get_worker().gcs_call("get_prefix_summaries")
        except Exception:
            return   # routers keep pulling; next tick retries
        sig = tuple(sorted(
            (r.get("replica_id"), tuple(r.get("fps") or ()))
            for r in rows or []))
        if sig == self._prefix_sig:
            return
        with self._lock:
            self._prefix_sig = sig
            self._prefix_rows = list(rows or [])
        self._bump("prefix_summaries")

    def _reconcile_one(self, app_name: str, name: str, dep: Dict):
        import ray_tpu_torch
        alive, started = [], set()
        for r in dep["replicas"]:
            try:
                # generous timeout: a slow box must not read as
                # death (kills would cascade); real deaths also
                # surface as ActorDiedError immediately. A replica
                # answers only once its constructor has returned.
                ray_tpu_torch.get(r.check_health.remote(), timeout=30)
                alive.append(r)
                started.add(getattr(r, "_actor_id", None))
            except ray_tpu_torch.ActorDiedError:
                logger.warning("replica of %s/%s died; replacing",
                               app_name, name)
            except Exception:
                alive.append(r)   # slow ≠ dead
        probed, states = self._probe_states(dep)
        lens = ([int(s.get("queue_len") or 0) for s in states]
                if states is not None else None)
        self._reap_draining(dep)
        # SLO evaluation talks to the GCS — keep it off the lock; the
        # rows feed both get_slo_status and the burn scaler below
        slo_rows = self._evaluate_slo(app_name, name, dep)
        dead = []
        with self._lock:
            if len(alive) != len(dep["replicas"]):
                alive_set = {id(r) for r in alive}
                dead = [r for r in dep["replicas"]
                        if id(r) not in alive_set]
                gens = dep.get("replica_gens") or []
                dep["replica_gens"] = [
                    g for r, g in zip(dep["replicas"], gens)
                    if id(r) in alive_set]
                dep["replicas"] = alive
                dep["version"] += 1
                self._bump_dep(dep)
            known = dep.get("started", set())
            dep["started"] = (known | started) & {
                getattr(r, "_actor_id", None) for r in dep["replicas"]}
            if dep["started"] - known:
                # routers learn which replicas are past construction
                dep["version"] += 1
                self._bump_dep(dep)
            # preemption notices: a replica that flipped itself into
            # draining (GCE metadata / chaos channel) leaves the routing
            # table NOW and a replacement pre-starts below — the notice
            # grace, not the health checker, is its clock from here on
            if states is not None:
                for r, s in zip(probed, states):
                    if s.get("draining"):
                        self._detach_for_drain(
                            dep, r, self._preempt_grace(dep))
            self._autoscale(app_name, name, dep, lens)
            self._burn_autoscale(app_name, name, dep, slo_rows, lens)
            # idle reaper (serve/fleet.py): the ONLY path that takes the
            # last replica to zero — _autoscale floors at one
            if self._wants_scale_to_zero(dep) and not dep.get("_creating"):
                self._fleet_mgr().note_load(
                    app_name, name, dep,
                    float(sum(lens)) if lens else 0.0)
            n_create = self._reconcile_deployment(dep)
        # a dead sharded rank-0 leaves peers + a PG behind: tear the
        # gang down — OUTSIDE the lock, kill RPCs can block on slow
        # nodes (_kill_replica's groups-dict pop is GIL-atomic, same as
        # the lock-free _reap_draining / delete_application callers)
        for r in dead:
            self._kill_replica(dep, r)
        self._publish_loads(dep, lens)
        self._export_target(app_name, name, dep)
        # slow construction (sharded gangs: pg wait + process-group
        # init + model load) runs on its own thread so ONE rebuilding
        # deployment never stalls the others' health checks — the
        # _creating flag keeps builds single-flight per deployment
        if n_create:
            threading.Thread(
                target=self._create_replicas, args=(dep, n_create),
                name=f"serve-build-{name}", daemon=True).start()

    def _autoscale(self, app_name, name, dep, lens=None):
        """Reference-shaped policy (serve/autoscaling_policy.py): average
        total queue depth over a look-back window, derive the DESIRED
        replica count from target_ongoing_requests, and apply it only
        after the condition has held for the up/downscale delay — bursts
        neither flap replicas up nor drain them mid-dip."""
        auto = dep["spec"]["config"].get("autoscaling_config")
        if not auto or not dep["replicas"] or lens is None \
                or len(lens) != len(dep["replicas"]):
            return
        key = (app_name, name)
        now = time.monotonic()
        hist = self._load_hist.setdefault(key, collections.deque())
        # min_replicas=0 floors at ONE replica here: only the fleet
        # manager's idle reaper (serve/fleet.py, idle_scale_to_zero_s)
        # takes the last step to zero, after the full idle window
        auto_eff = auto
        if int(auto.get("min_replicas", 1) or 0) < 1:
            auto_eff = {**auto, "min_replicas": 1}
        dep["target"] = autoscale_decision(
            auto_eff, hist, float(sum(lens)), dep["target"], now,
            self._up_since, self._down_since, key)

    def _burn_autoscale(self, app_name, name, dep, rows, lens=None):
        """Burn-driven replica scaling (serve/slo.py BurnRateScaler):
        sustained dual-window SLO burn raises dep["target"], sustained
        idle burn releases replicas — with hold + cooldown so instant
        spikes don't flap the fleet. Requires BOTH autoscaling_config
        (bounds + knobs) and slo_config (the signal). Caller holds
        self._lock."""
        auto = dep["spec"]["config"].get("autoscaling_config")
        if not auto or not rows:
            return
        from ray_tpu_torch.serve.slo import BurnRateScaler
        key = (app_name, name)
        scaler = self._burn_scalers.setdefault(key, BurnRateScaler())
        total_load = float(sum(lens)) if lens else 0.0
        new_target = scaler.decide(auto, rows, dep["target"], total_load,
                                   time.monotonic())
        if new_target > dep["target"]:
            # burn-aware shedding (serve/fleet.py): a deployment with a
            # fallback whose replicas still have headroom sheds overflow
            # there (the handle layer routes it) instead of asking the
            # cluster autoscaler for new slices — replica churn and
            # slice acquisition are the most expensive moves an accelerator
            # fleet can make
            fb_name = dep["spec"]["config"].get("fallback_model")
            fb = self.apps.get(app_name, {}).get(fb_name) \
                if fb_name else None
            if fb is not None:
                from ray_tpu_torch.serve.fleet import fallback_has_headroom
                if fallback_has_headroom(fb):
                    if not dep.get("shed_active"):
                        from ray_tpu_torch._private import events
                        events.record_instant(
                            "serve.burn_shed", category="serve",
                            app=app_name, deployment=name,
                            fallback=fb_name, target=dep["target"])
                        logger.info(
                            "burn shed %s/%s: overflow -> %s instead of "
                            "target %d -> %d", app_name, name, fb_name,
                            dep["target"], new_target)
                    dep["shed_active"] = True
                    return
        dep["shed_active"] = False
        if new_target == dep["target"]:
            return
        from ray_tpu_torch._private import events
        events.record_instant(
            "serve.autoscale", category="serve", app=app_name,
            deployment=name, old_target=dep["target"],
            new_target=new_target,
            burn_slow=max((r.get("burn_slow") or 0.0 for r in rows),
                          default=0.0))
        logger.info("burn autoscale %s/%s: target %d -> %d", app_name,
                    name, dep["target"], new_target)
        dep["target"] = new_target

    def _export_target(self, app_name: str, name: str, dep: Dict):
        """serve_replica_target / serve_replica_deficit gauges: the
        autoscaler and dashboards watch the control loop's intent, not
        just its outcome."""
        if self._target_gauge is None:
            from ray_tpu_torch.util.metrics import Gauge
            self._target_gauge = {
                "target": Gauge("serve_replica_target",
                                "replica target per deployment",
                                tag_keys=("app", "deployment")),
                "deficit": Gauge("serve_replica_deficit",
                                 "replicas wanted but not yet running",
                                 tag_keys=("app", "deployment")),
            }
        tags = {"app": app_name, "deployment": name}
        with self._lock:
            target = dep["target"]
            running = len(dep["replicas"])
        self._target_gauge["target"].set(float(target), tags=tags)
        self._target_gauge["deficit"].set(float(max(0, target - running)),
                                          tags=tags)

    def get_replica_demand(self) -> List[Dict]:
        """Unmet replica demand as resource requests — one dict per
        missing replica, shaped like a node-manager pending_demand row —
        so the cluster autoscaler (autoscaler/autoscaler.py) acquires
        accelerator nodes for replicas the serve control loop wants but
        cannot place yet, instead of waiting for lease-queue
        heartbeats."""
        out: List[Dict] = []
        with self._lock:
            for app in self.apps.values():
                for dep in app.values():
                    if dep.get("shed_active"):
                        # burn overflow is being shed to the fallback
                        # (serve/fleet.py): don't also bid for slices
                        continue
                    deficit = dep["target"] - len(dep["replicas"])
                    if deficit <= 0:
                        continue
                    spec = dep["spec"]
                    opts = dict(spec["config"].get("ray_actor_options")
                                or {})
                    req: Dict[str, float] = {
                        "CPU": float(opts.get("num_cpus", 0.25))}
                    if opts.get("num_gpus"):
                        req["GPU"] = float(opts["num_gpus"])
                    if opts.get("num_tpus"):
                        req["TPU"] = float(opts["num_tpus"])
                    for k, v in (opts.get("resources") or {}).items():
                        req[k] = float(v)
                    out.extend([dict(req)] * int(deficit))
        return out

    def _start_drain(self, dep: Dict, victim,
                     timeout_s: Optional[float] = None):
        """Enroll a retired replica for graceful drain (deadline from
        the deployment's graceful_shutdown_timeout_s, default 30s;
        preemptions pass the shorter notice grace). Caller holds
        self._lock."""
        if timeout_s is None:
            timeout_s = float(dep["spec"]["config"]
                              .get("graceful_shutdown_timeout_s", 30.0))
        dep.setdefault("draining", []).append(
            (victim, time.time() + float(timeout_s)))

    def _preempt_grace(self, dep: Dict) -> float:
        return float(dep["spec"]["config"].get("preempt_grace_s", 25.0))

    def _detach_for_drain(self, dep: Dict, victim,
                          grace_s: Optional[float] = None) -> bool:
        """Remove a replica from the routing set and enroll it for
        drain — the draining replica never appears in a routing table
        again (get_deployment_info reads dep["replicas"]). Caller holds
        self._lock. Returns False when the replica already left the set
        (raced with a health-check prune or a second notice)."""
        idx = next((i for i, r in enumerate(dep["replicas"])
                    if r is victim), None)
        if idx is None:
            return False
        dep["replicas"].pop(idx)
        gens = dep.get("replica_gens") or []
        if idx < len(gens):
            gens.pop(idx)
        self._start_drain(dep, victim, grace_s)
        dep["version"] += 1
        self._bump_dep(dep)
        return True

    def preempt_replica(self, app_name: str, name: str,
                        replica_index: int = 0,
                        grace_s: Optional[float] = None) -> bool:
        """Notice-based preemption (the graceful half of spot-instance
        economics): deliver a drain notice to one replica, drop it from
        the routing table, and pre-start its replacement immediately —
        BEFORE the kill deadline, so capacity never dips. The replica
        finishes in-flight streams; _reap_draining force-kills it at
        the grace deadline if its queue never empties."""
        import ray_tpu_torch
        with self._lock:
            dep = self.apps.get(app_name, {}).get(name)
            if dep is None or not dep["replicas"]:
                return False
            victim = dep["replicas"][replica_index % len(dep["replicas"])]
        try:
            # outside the lock: the notice is an RPC into user code
            ray_tpu_torch.get(victim.begin_drain.remote(), timeout=10)
        except Exception:
            # already dead or wedged — the health checker replaces it
            # through the crash path instead
            logger.warning("drain notice to %s/%s replica failed",
                           app_name, name, exc_info=True)
        with self._lock:
            if grace_s is None:
                grace_s = self._preempt_grace(dep)
            if not self._detach_for_drain(dep, victim, grace_s):
                return False
            n_create = self._reconcile_deployment(dep)
        if n_create:
            threading.Thread(
                target=self._create_replicas, args=(dep, n_create),
                name=f"serve-build-{name}", daemon=True).start()
        return True

    def _reap_draining(self, dep: Dict):
        """Kill retired replicas once their queues empty (or the drain
        deadline passes) — in-flight requests routed before the router
        saw the new replica set complete instead of dying. Probes run
        as ONE batched get outside the lock; only dead replicas or
        expired deadlines reap (slow != dead, same as health checks)."""
        import ray_tpu_torch
        with self._lock:
            snapshot = list(dep.get("draining") or [])
        if not snapshot:
            return
        refs = [h.get_queue_len.remote() for h, _ in snapshot]
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=5)
        done_set = {r.id for r in done}
        victims, keep = [], []
        now = time.time()
        for (h, deadline), ref in zip(snapshot, refs):
            qlen = None
            dead = False
            if ref.id in done_set:
                try:
                    qlen = ray_tpu_torch.get(ref, timeout=1)
                except ray_tpu_torch.ActorDiedError:
                    dead = True
                except Exception:
                    pass
            if dead or now > deadline or qlen == 0:
                victims.append(h)
            else:
                keep.append((h, deadline))   # busy or merely slow
        for h in victims:
            self._kill_replica(dep, h)
        with self._lock:
            current = dep.get("draining") or []
            # keep anything enrolled since the snapshot + the keepers
            snap_ids = {id(h) for h, _ in snapshot}
            dep["draining"] = keep + [e for e in current
                                      if id(e[0]) not in snap_ids]

    def _probe_states(self, dep: Dict):
        """One runtime-state probe per reconcile tick, shared by
        autoscaling, the router load push, and preemption-notice pickup.
        Returns (replica_snapshot, [{"queue_len", "draining"}, ...]) or
        (None, None) when the probe failed."""
        import ray_tpu_torch
        replicas = list(dep["replicas"])
        if not replicas:
            return None, None
        try:
            states = ray_tpu_torch.get(
                [r.get_runtime_state.remote() for r in replicas],
                timeout=5)
            return replicas, states
        except Exception:
            return None, None

    def _publish_loads(self, dep: Dict, lens):
        """Push probed queue depths to routers: every handle then shares
        ONE load view instead of its private in-flight counts (reference:
        pow_2_scheduler probes replica queue lengths,
        replica_scheduler/pow_2_scheduler.py:52 — here the controller
        probes once and fans out over long-poll)."""
        if lens is None:
            return
        with self._lock:
            if len(lens) != len(dep["replicas"]):
                return   # replica set moved since the probe (death or
                         # drain detach): stale loads would misroute
            if lens != dep.get("loads"):
                dep["loads"] = lens
                self._bump_dep(dep)

    def _evaluate_slo(self, app_name: str, name: str, dep: Dict):
        """Burn-rate evaluation over the GCS time-series plane: exports
        slo_burn_rate/slo_violating gauges and emits slo.violation /
        slo.recovered runtime events on transitions (the signal ROADMAP
        item 2's autoscaling loop consumes)."""
        slo = (dep["spec"]["config"] or {}).get("slo_config")
        if not slo:
            return
        if self._slo_tracker is None:
            from ray_tpu_torch.serve.slo import SloTracker
            self._slo_tracker = SloTracker()
        import ray_tpu_torch

        def query(metric, window=60.0, agg="avg", tags=None,
                  threshold=None):
            return ray_tpu_torch._get_worker().gcs_call(
                "query_metrics", name=metric, window=window, agg=agg,
                tags=tags, threshold=threshold)

        try:
            # per-tenant burn (ROADMAP 2d): every configured tenant gets
            # its own burn rows appended, so one tenant torching its
            # budget raises this deployment's target via BurnRateScaler
            # (and thus get_replica_demand) even while the aggregate
            # objective looks healthy
            tenants: List[str] = []
            try:
                tenants = [r["tenant"] for r in
                           (ray_tpu_torch._get_worker()
                            .gcs_call("get_tenant_quotas") or [])
                           if r.get("tenant")
                           and r["tenant"] != "__default__"]
            except Exception:
                pass
            rows = self._slo_tracker.update(app_name, name, slo, query,
                                            tenants=tenants or None)
            with self._lock:
                dep["slo_status"] = rows
            return rows
        except Exception:
            logger.exception("SLO evaluation failed for %s/%s",
                             app_name, name)
            return None

    def get_slo_status(self) -> Dict:
        """{app: {deployment: [objective rows]}} for declared SLOs."""
        with self._lock:
            return {
                app_name: {
                    name: list(dep.get("slo_status") or [])
                    for name, dep in app.items()
                    if (dep["spec"]["config"] or {}).get("slo_config")}
                for app_name, app in self.apps.items()}

    def get_deployment_info(self, app_name: str, name: str) -> Dict:
        with self._lock:
            dep = self.apps.get(app_name, {}).get(name)
            if dep is None:
                return {"version": -1, "replicas": []}
            return {"version": dep["version"],
                    "replicas": list(dep["replicas"]),
                    "loads": list(dep.get("loads") or []),
                    "resumable": bool(dep["spec"]["config"]
                                      .get("resumable_streams")),
                    "coalesced": bool(dep["spec"]["config"]
                                      .get("coalesce_streams")),
                    # cluster-wide prefix routing (serve/disagg.py):
                    # replica actor ids key the GCS prefix_summaries
                    # rows back onto routing-table indices
                    "prefix_routed": bool(dep["spec"]["config"]
                                          .get("prefix_routed")),
                    "tier": dep["spec"]["config"].get("tier"),
                    # fleet plane (serve/fleet.py): an empty replica set
                    # on a scale_to_zero deployment makes the router
                    # hold + request revival instead of erroring; the
                    # fallback/max_ongoing pair drives overflow shedding
                    "scale_to_zero": self._wants_scale_to_zero(dep),
                    "fallback": dep["spec"]["config"]
                    .get("fallback_model"),
                    "max_ongoing": int(dep["spec"]["config"]
                                       .get("max_ongoing_requests", 0)
                                       or 0),
                    "replica_ids": [getattr(r, "_actor_id", None)
                                    for r in dep["replicas"]],
                    # which replicas have answered a health check, i.e.
                    # finished construction: a router sends a request to
                    # one still loading only when no started one can
                    # take it
                    "started": [getattr(r, "_actor_id", None)
                                in dep.get("started", ())
                                for r in dep["replicas"]]}

    def revive_deployment(self, app_name: str, name: str) -> bool:
        """Router-requested cold start for a scaled-to-zero deployment
        (serve/fleet.py). Idempotent: concurrent calls while a revival
        is in flight (or once replicas exist) return True immediately —
        callers keep polling the routing table, which updates the
        moment the revived replica is published."""
        return self._fleet_mgr().revive(app_name, name)

    def get_fleet_status(self) -> Dict:
        """Fleet-plane view: per-deployment scale-to-zero state plus
        shell-pool / revival / cold-start stats."""
        with self._lock:
            deployments = {
                app_name: {
                    name: {
                        "target": dep["target"],
                        "running": len(dep["replicas"]),
                        "scale_to_zero": self._wants_scale_to_zero(dep),
                        "scaled_to_zero": (
                            self._wants_scale_to_zero(dep)
                            and dep["target"] == 0),
                        "fallback": dep["spec"]["config"]
                        .get("fallback_model"),
                        "shed_active": bool(dep.get("shed_active")),
                        "tier": dep["spec"]["config"].get("tier"),
                    }
                    for name, dep in app.items()}
                for app_name, app in self.apps.items()}
        out = {"deployments": deployments}
        if self._fleet is not None:
            out["fleet"] = self._fleet.status()
        return out

    def get_status(self) -> Dict:
        with self._lock:
            return {
                app_name: {
                    name: {"target": dep["target"],
                           "running": len(dep["replicas"]),
                           "version": dep["version"],
                           "tier": dep["spec"]["config"].get("tier")}
                    for name, dep in app.items()}
                for app_name, app in self.apps.items()}

    def list_applications(self):
        with self._lock:
            return list(self.apps.keys())

    def delete_application(self, app_name: str):
        import ray_tpu_torch
        with self._lock:
            app = self.apps.pop(app_name, {})
            self.ingress.pop(app_name, None)
            for prefix in [p for p, a in self.routes.items()
                           if a == app_name]:
                self.routes.pop(prefix, None)
        self._bump("routes")
        for dep in app.values():
            draining = [h for h, _ in dep.get("draining") or []]
            for r in list(dep["replicas"]) + draining:
                self._kill_replica(dep, r)
        return True
