"""Deployment / Application objects (reference: python/ray/serve/api.py:240
@serve.deployment, serve/deployment.py). A Deployment is a user class (or
function) plus replica/autoscaling config; `.bind(...)` produces an
Application node whose handle-typed arguments express model composition
(reference: build_app.py graph binding)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # queue-depth samples are averaged over this window before any
    # decision — bursty load doesn't flap replicas (reference:
    # serve/autoscaling_policy.py look_back_period_s)
    look_back_period_s: float = 10.0
    # burn-rate scaling knobs (serve/slo.py BurnRateScaler) — active
    # only when the deployment also declares slo_config. Dual-window
    # burn must persist burn_upscale_hold_s before the target rises;
    # burn below burn_release_threshold with per-replica load under
    # half of target_ongoing_requests for burn_downscale_idle_s
    # releases one replica; burn_cooldown_s separates actions so the
    # loop cannot flap faster than the windows refill
    burn_upscale_hold_s: float = 6.0
    burn_downscale_idle_s: float = 60.0
    burn_cooldown_s: float = 30.0
    burn_release_threshold: float = 0.25
    # scale-to-zero (serve/fleet.py): with min_replicas=0 AND this set,
    # the fleet manager reaps the LAST replica after the probed load has
    # been zero for this many seconds; the ordinary autoscaling policy
    # floors at one replica so the idle reaper is the only path to zero.
    # Revival goes through the pre-warmed shell pool on first request
    # (cold-start p99 exported as serve_cold_start_ms). None = never
    # scale to zero, even at min_replicas=0.
    idle_scale_to_zero_s: Optional[float] = None


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    ray_actor_options: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    # SLO objectives (serve/slo.py SloConfig): the controller evaluates
    # fast/slow-window burn rates against the GCS time-series plane and
    # exports slo_burn_rate gauges + slo.violation timeline events
    slo_config: Optional["Any"] = None
    health_check_period_s: float = 5.0
    # multi-host (sharded) replicas: num_hosts > 1 makes each replica a
    # gang of ReplicaShard actors placed PACK and joined into one
    # torch.distributed process group (serve/sharded_replica.py);
    # topology would pin the gang onto one healthy slice, STRICT_SPREAD
    # over its hosts, and is refused until slice gangs are ported
    # (ROADMAP.md, Queue A item A3c-2)
    num_hosts: int = 1
    topology: Optional[str] = None
    # streaming resume (serve/handle.py): True when the callable opted
    # in (``__serve_resumable__ = True``) — its streaming methods accept
    # ``resume_tokens=<chunks already delivered>`` and continue from
    # there, so a stream severed by replica death restarts on a
    # survivor with zero dropped or duplicated chunks
    resumable_streams: bool = False
    # coalesced streams (serve/handle.py): True when the callable opted
    # in (``__serve_coalesce_stream__ = True``) — its streaming methods
    # yield CHUNK LISTS (several tokens per frame) and the handle layer
    # unpacks them back to per-item iteration, with delivered/skip
    # accounting token-granular inside each chunk
    coalesce_streams: bool = False
    # drain deadline handed to a replica on a preemption NOTICE (GCE
    # spot VMs get ~30s between notice and kill; leave headroom for
    # the forced reap). Plain retirement keeps using
    # graceful_shutdown_timeout_s
    preempt_grace_s: float = 25.0
    graceful_shutdown_timeout_s: float = 30.0
    # cluster-wide prefix routing (serve/disagg.py): True when the
    # callable opted in (``__serve_prefix_route__ = True``) — the router
    # fingerprints each prompt's chunk-aligned prefixes and routes to
    # the replica whose published trie summary matches deepest, with
    # session-hash fallback on ties/misses
    prefix_routed: bool = False
    # burn-aware shedding (serve/fleet.py): name of a deployment in the
    # SAME application (smaller model, same API) that absorbs overflow.
    # When this deployment's replicas are saturated the handle routes
    # new requests down the fallback ladder, and the controller's burn
    # loop prefers shedding over asking the cluster autoscaler for new
    # slices while the fallback has headroom.
    fallback_model: Optional[str] = None
    # disaggregated-serving tier label ("prefill" / "decode" / None):
    # informational for status surfaces, and the unit independent
    # autoscaling operates on — each tier is its own deployment, so
    # burn-driven scaling and autoscaler binpacking size the tiers
    # separately (the tier-aware half of placement)
    tier: Optional[str] = None


def _coerce_slo(slo):
    """Accept an SloConfig or a plain dict (YAML configs)."""
    if isinstance(slo, dict):
        from ray_tpu_torch.serve.slo import SloConfig
        return SloConfig(**slo)
    return slo


class Deployment:
    def __init__(self, func_or_class, name: str, config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                ray_actor_options: Optional[Dict] = None,
                autoscaling_config=None, slo_config=None,
                num_hosts: Optional[int] = None,
                fallback_model: Optional[str] = None,
                topology: Optional[str] = None) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if slo_config is not None:
            cfg.slo_config = _coerce_slo(slo_config)
        if fallback_model is not None:
            cfg.fallback_model = fallback_model
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if num_hosts is not None:
            cfg.num_hosts = num_hosts
        if topology is not None:
            cfg.topology = topology
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


class Application:
    """A bound deployment graph node; nested Applications in args become
    DeploymentHandles at deploy time."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def flatten(self) -> List["Application"]:
        """All applications in this graph, dependencies first."""
        seen: List[Application] = []

        def visit(app: Application):
            for a in list(app.args) + list(app.kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            if app not in seen:
                seen.append(app)

        visit(self)
        return seen
