"""serve public API (reference: python/ray/serve/api.py — @deployment :240,
run :463; batching: python/ray/serve/batching.py)."""

from __future__ import annotations

import asyncio
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.deployment import (Application, AutoscalingConfig,
                                      Deployment, DeploymentConfig)
from ray_tpu_torch.serve.handle import DeploymentHandle

CONTROLLER_NAME = "SERVE_CONTROLLER"
# the HTTP ingress's default port: not the JAX package's 8000, so the
# two runtimes' proxies never answer for each other on one machine
DEFAULT_HTTP_PORT = 8100
_controller_handle = None


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               ray_actor_options: Optional[Dict] = None,
               autoscaling_config=None, slo_config=None,
               num_hosts: int = 1, resumable_streams: Optional[bool] = None,
               coalesce_streams: Optional[bool] = None,
               preempt_grace_s: Optional[float] = None,
               prefix_routed: Optional[bool] = None,
               tier: Optional[str] = None,
               fallback_model: Optional[str] = None,
               topology: Optional[str] = None, **_ignored):
    def wrap(target):
        # a callable opts into stream resume with __serve_resumable__ =
        # True (its streaming methods accept resume_tokens=); the
        # explicit kwarg overrides either way
        resumable = (getattr(target, "__serve_resumable__", False)
                     if resumable_streams is None else resumable_streams)
        # likewise __serve_coalesce_stream__ = True: streams yield
        # token-chunk lists that the handle layer unpacks per token
        coalesced = (getattr(target, "__serve_coalesce_stream__", False)
                     if coalesce_streams is None else coalesce_streams)
        # and __serve_prefix_route__ = True: the router fingerprints
        # prompts and routes by deepest cluster-wide trie match
        # (serve/disagg.py DisaggLLMDeployment)
        prefixed = (getattr(target, "__serve_prefix_route__", False)
                    if prefix_routed is None else prefix_routed)
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options,
            num_hosts=num_hosts, topology=topology,
            resumable_streams=bool(resumable),
            coalesce_streams=bool(coalesced),
            prefix_routed=bool(prefixed), tier=tier,
            fallback_model=fallback_model)
        if preempt_grace_s is not None:
            cfg.preempt_grace_s = float(preempt_grace_s)
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                AutoscalingConfig(**autoscaling_config)
                if isinstance(autoscaling_config, dict)
                else autoscaling_config)
        if slo_config is not None:
            from ray_tpu_torch.serve.deployment import _coerce_slo
            cfg.slo_config = _coerce_slo(slo_config)
        return Deployment(target, name or target.__name__, cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def _get_controller():
    global _controller_handle
    if _controller_handle is not None:
        return _controller_handle
    try:
        _controller_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                               namespace="serve")
    except ValueError:
        from ray_tpu_torch.serve.controller import ServeController
        actor_cls = ray_tpu_torch.remote(ServeController)
        _controller_handle = actor_cls.options(
            name=CONTROLLER_NAME, namespace="serve", lifetime="detached",
            # long-poll listeners park one executor thread each for
            # up to 30s (proxies + handle clients); size for ~100
            # nodes of headroom. An asyncio LongPollHost would scale
            # further (reference does this) if ever needed.
            max_concurrency=256, num_cpus=0.1).remote()
    return _controller_handle


def _app_to_specs(app: Application, app_name: str) -> List[Dict]:
    import cloudpickle
    import dataclasses

    from ray_tpu_torch.serve.sharded_replica import refuse_topology
    specs = []
    for node in app.flatten():
        dep = node.deployment
        cfg = dataclasses.asdict(dep.config)
        refuse_topology(cfg)

        def materialize(v):
            if isinstance(v, Application):
                return DeploymentHandle(v.deployment.name, app_name)
            return v

        specs.append({
            "name": dep.name,
            "callable": cloudpickle.dumps(dep.func_or_class),
            "is_function": not isinstance(dep.func_or_class, type),
            "init_args": [materialize(a) for a in node.args],
            "init_kwargs": {k: materialize(v)
                            for k, v in node.kwargs.items()},
            "config": cfg,
        })
    return specs


_ingress: Dict[str, str] = {}          # app_name -> ingress deployment


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _http: bool = False, http_port: int = DEFAULT_HTTP_PORT
        ) -> DeploymentHandle:
    controller = _get_controller()
    specs = _app_to_specs(app, name)
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs),
                timeout=120)
    # routes live in the controller and are long-poll-pushed to every
    # proxy (reference: EndpointState + LongPollHost)
    ray_tpu_torch.get(controller.set_route.remote(route_prefix, name,
                                            app.deployment.name),
                timeout=30)
    _ingress[name] = app.deployment.name
    handle = DeploymentHandle(app.deployment.name, name)
    # wait for replicas
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = ray_tpu_torch.get(controller.get_status.remote(), timeout=30)
        dep = st.get(name, {}).get(app.deployment.name, {})
        if dep.get("running", 0) >= 1:
            break
        time.sleep(0.2)
    if _http:
        start(http_port=http_port)
    return handle


def start(http_port: Optional[int] = None, grpc_port: Optional[int] = None,
          grpc_servicer_functions: Optional[List[str]] = None,
          wait: bool = True, timeout: float = 120.0):
    """Enable ingress: the controller keeps one HTTP (and optionally
    gRPC) proxy on every alive node (reference: proxy-per-node,
    controller ProxyState + gRPCProxy proxy.py:558). Blocks until every
    alive node has its proxies unless wait=False.
    grpc_servicer_functions: import paths of protoc-generated
    add_X_to_server functions — registers the typed protobuf services on
    every gRPC proxy (reference: gRPCOptions.grpc_servicer_functions)."""
    if http_port is None and grpc_port is None:
        http_port = DEFAULT_HTTP_PORT   # serve.start() serves HTTP
    ctrl = _get_controller()
    ray_tpu_torch.get(ctrl.set_http.remote(http_port, grpc_port,
                                     grpc_servicer_functions), timeout=120)
    if not wait:
        return
    want_http = http_port is not None
    want_grpc = grpc_port is not None
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        n_alive = len([n for n in ray_tpu_torch.nodes() if n["alive"]])
        addrs = ray_tpu_torch.get(ctrl.get_proxies.remote(), timeout=30)
        ok = len(addrs) >= n_alive and all(
            (not want_http or "http" in a) and (not want_grpc or "grpc" in a)
            for a in addrs.values())
        if ok and addrs:
            return
        # the reconcile lock may have skipped this round: nudge again
        ray_tpu_torch.get(ctrl.set_http.remote(None, None), timeout=30)
        time.sleep(0.3)
    raise TimeoutError("serve ingress proxies did not come up")


def proxies() -> Dict:
    """node_id -> {"http": addr, "grpc": addr} for every ingress proxy."""
    return ray_tpu_torch.get(_get_controller().get_proxies.remote(), timeout=30)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    ingress = _ingress.get(name)
    if ingress is None:
        st = status()
        deps = st.get(name)
        if not deps:
            raise ValueError(f"no application {name!r}")
        ingress = list(deps)[0]
    return DeploymentHandle(ingress, name)


def status() -> Dict:
    return ray_tpu_torch.get(_get_controller().get_status.remote(), timeout=30)


def slo_status() -> Dict:
    """Latest burn-rate evaluation per declared SLO objective:
    {app: {deployment: [{objective, burn_fast, burn_slow, violating,
    ...}]}}."""
    return ray_tpu_torch.get(_get_controller().get_slo_status.remote(),
                       timeout=30)


def fleet_status() -> Dict:
    """Fleet-plane view (serve/fleet.py): per-deployment scale-to-zero
    state, shell-pool occupancy, revival counts, and cold-start
    latency percentiles."""
    return ray_tpu_torch.get(_get_controller().get_fleet_status.remote(),
                       timeout=30)


# ------------------------------------------------------------- tenancy
def set_tenant_quota(tenant: str, max_concurrent: Optional[int] = None,
                     weight: Optional[float] = None,
                     rate: Optional[float] = None,
                     burst: Optional[float] = None):
    """Configure one tenant's fair-share admission at the serve ingress
    (serve/fleet.py TenantAdmission; GCS ``tenant_quotas`` table):
    ``max_concurrent`` caps the tenant's in-flight requests (<= 0 =
    unlimited), ``weight`` sets its deficit-round-robin share while
    queued, ``rate`` sets the tenant's CLUSTER-WIDE admission rate in
    requests/s (<= 0 = unlimited) which the quota-lease layer splits
    proportionally across live proxies, and ``burst`` the token-bucket
    depth backing that rate (defaults to ~rate). The special tenant
    ``"__default__"`` moves the fleet-wide defaults. Proxies refresh
    quotas within ~5s; rate changes bump the lease epoch so every proxy
    re-splits within one renew interval (~2s)."""
    return ray_tpu_torch._get_worker().gcs_call(
        "set_tenant_quota", tenant=tenant, quota=max_concurrent,
        weight=weight, rate=rate, burst=burst)


def get_tenant_quotas() -> List[Dict]:
    """Configured tenant rows: [{tenant, quota, weight, rate, burst,
    ts}]."""
    return ray_tpu_torch._get_worker().gcs_call("get_tenant_quotas")


def quota_lease_status() -> Dict:
    """The GCS quota-lease view: {epoch, leases: [...], tenant_burn:
    {tenant: cluster-total admitted}} — the edge probe reads cluster
    burn totals from here."""
    return ray_tpu_torch._get_worker().gcs_call("quota_lease_status")


def delete(name: str = "default"):
    ray_tpu_torch.get(_get_controller().delete_application.remote(name),
                timeout=60)


def shutdown():
    global _controller_handle
    try:
        ctrl = _get_controller()
        for app in ray_tpu_torch.get(ctrl.list_applications.remote(), timeout=30):
            ray_tpu_torch.get(ctrl.delete_application.remote(app), timeout=60)
        try:
            ray_tpu_torch.get(ctrl.shutdown_proxies.remote(), timeout=60)
        except Exception:
            pass
        ray_tpu_torch.kill(ctrl)
    except Exception:
        pass
    _controller_handle = None
    _ingress.clear()
    from ray_tpu_torch.serve.handle import _LongPollClient
    _LongPollClient.reset()


# ------------------------------------------------------------------ batching
def batch(_func=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Dynamic request batching for async methods (reference:
    python/ray/serve/batching.py @serve.batch). Calls buffer until the
    batch fills or the wait timeout fires, then the wrapped function runs
    once on the list of requests."""

    def wrap(fn):
        state = {"queue": None, "task": None}

        @functools.wraps(fn)
        async def wrapper(*args):
            self_arg = args[0] if len(args) == 2 else None
            item = args[-1]
            loop = asyncio.get_event_loop()
            if state["queue"] is None:
                state["queue"] = []
                state["cond"] = asyncio.Condition()

            fut = loop.create_future()
            state["queue"].append((item, fut))
            if state["task"] is None or state["task"].done():
                state["task"] = asyncio.ensure_future(
                    _flusher(self_arg, fn, state, max_batch_size,
                             batch_wait_timeout_s))
            return await fut

        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


async def _flusher(self_arg, fn, state, max_batch_size, wait_s):
    await asyncio.sleep(wait_s)
    while state["queue"]:
        batch_items = state["queue"][:max_batch_size]
        del state["queue"][:max_batch_size]
        items = [b[0] for b in batch_items]
        futs = [b[1] for b in batch_items]
        try:
            if self_arg is not None:
                results = await fn(self_arg, items)
            else:
                results = await fn(items)
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)
        except Exception as e:
            for f in futs:
                if not f.done():
                    f.set_exception(e)

