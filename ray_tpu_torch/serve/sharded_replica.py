"""Multi-host serve replicas: one replica = one gang of worker processes
serving a model sharded over the gang's ``torch.distributed`` mesh (the
JAX package's serve/sharded_replica.py; reference replica lifecycle:
python/ray/serve/_private/deployment_state.py:1232 — the reference has
no multi-host replica, this is the runtime's extension of it).

Shape: a replica group is `num_hosts` ReplicaShard actors gang-placed by
a PACK placement group and joined into one ``torch.distributed`` world
through the GCS-KV rendezvous (``util/collective._init_torch_distributed``:
rank 0 serves a ``TCPStore`` and publishes its address in the KV), with
a process-group timeout of its own (``_GANG_PG_TIMEOUT_S``), so a
survivor of a dead rank fails its collective instead of waiting out
gloo's 30-minute default. Every rank constructs the user callable — its
__init__ builds the model sharded over the gang's mesh — and rank 0 is
the ingress: routers hold only the rank-0 handle, which fans each
request out to the peer ranks so every process enters the same sequence
of collectives, and returns its own (rank-0) result. A gang pinned to
one slice's hosts (``topology``) is not ported yet (ROADMAP.md, Queue A
item A3c-2).

SPMD discipline: ranks deadlock if two requests interleave their
collectives in different orders, so the rank-0 facade admits one
request into the compute at a time (queue depth still reported for
autoscaling). Batching therefore belongs *inside* the callable
(@serve.batch) where it rides one SPMD entry.

Failure semantics match training gangs: one dead rank invalidates the
whole group (collectives span every rank), so health checks probe all
ranks and the controller replaces the entire group, never a single rank.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)

# the gang's process-group timeout: a collective with a dead rank fails
# within it (gloo often sooner, when it sees the connection close), so a
# survivor fails its stream and the gang wedges for replacement
_GANG_PG_TIMEOUT_S = 60.0


class ReplicaShard:
    """One rank of a sharded replica group (actor; max_concurrency must
    leave room for health/queue probes while a request runs)."""

    def __init__(self, rank: int, world_size: int):
        self._rank = rank
        self._world = world_size
        self._callable = None
        self._is_function = False
        self._peers: List = []
        self._ongoing = 0
        self._lock = threading.Lock()
        # serializes SPMD entry on rank 0 (see module docstring)
        self._spmd_lock = threading.Lock()
        # set when a stream died mid-collective: the gang's ranks are
        # desynchronized and must be replaced as a unit
        self._wedged = False
        self._draining = False

    def setup_distributed(self, group_name: str) -> bool:
        """Join the group's ``torch.distributed`` world (KV rendezvous),
        with the gang's process-group timeout. Must run before the
        callable is built."""
        from ray_tpu_torch.util.collective import _init_torch_distributed
        _init_torch_distributed(self._world, self._rank, group_name,
                                timeout_s=_GANG_PG_TIMEOUT_S)
        return True

    def init_callable(self, serialized_callable: bytes, init_args: Tuple,
                      init_kwargs: Dict, is_function: bool) -> bool:
        """Construct the user callable on THIS rank. All ranks run the
        same __init__, so a model distributed over the gang's mesh
        (each rank keeping its shards of the same whole weights) lands
        distributed across the group."""
        import cloudpickle
        target = cloudpickle.loads(serialized_callable)
        self._is_function = is_function
        if is_function:
            self._callable = target
        else:
            self._callable = target(*init_args, **init_kwargs)
        return True

    def set_peers(self, peers: List) -> bool:
        """Rank 0 only: handles to ranks 1..world-1, fan-out targets."""
        self._peers = list(peers)
        return True

    # ------------------------------------------------------------ data plane
    def handle_request(self, method: str, args: Tuple, kwargs: Dict):
        """Rank-0 ingress: admit one SPMD request, fan out to peers, run
        the local shard, surface the first failure (peer errors included
        — a hung peer would otherwise deadlock the *next* request)."""
        import ray_tpu_torch
        with self._lock:
            self._ongoing += 1
        try:
            with self._spmd_lock:
                refs = [p.run_shard.remote(method, args, kwargs)
                        for p in self._peers]
                try:
                    result = self.run_shard(method, args, kwargs)
                finally:
                    # peers must finish their shard of this request before
                    # the next one may enter (SPMD ordering)
                    ray_tpu_torch.get(refs, timeout=300)
            return result
        finally:
            with self._lock:
                self._ongoing -= 1

    def run_shard(self, method: str, args: Tuple, kwargs: Dict):
        """Execute the user method on this rank's shard of the world."""
        kwargs = dict(kwargs)
        kwargs.pop("__serve_model_id", None)
        if self._is_function:
            fn = self._callable
        else:
            fn = getattr(self._callable, method)
        import asyncio
        import inspect
        if inspect.iscoroutinefunction(fn):
            from ray_tpu_torch._private.worker import global_worker
            return asyncio.run_coroutine_threadsafe(
                fn(*args, **kwargs), global_worker.core.loop).result()
        return fn(*args, **kwargs)

    # --------------------------------------------------------- streaming
    def handle_stream(self, method: str, args: Tuple, kwargs: Dict):
        """Rank-0 streaming ingress (token streaming): every rank runs
        the same generator method; rank 0 yields its chunks to the
        router while peers drain theirs. Lockstep comes from the SPMD
        collectives themselves — with one stream admitted at a time
        (the SPMD lock), each rank's generator steps through the same
        collective sequence and the rendezvous throttles whoever runs
        ahead.

        Abandoned streams: if the client walks away mid-collective, rank
        0's generator closes but the peers stay parked at the
        rendezvous. The drain wait is BOUNDED; on timeout the group
        marks itself wedged — health checks then fail and the
        controller replaces the whole gang (a half-finished SPMD world
        cannot be safely reused)."""
        import ray_tpu_torch
        kwargs = dict(kwargs)
        kwargs.pop("__serve_model_id", None)
        with self._lock:
            self._ongoing += 1
        try:
            with self._spmd_lock:
                refs = [p.run_shard_drain.remote(method, args, kwargs)
                        for p in self._peers]
                completed = False
                try:
                    fn = self._callable if self._is_function \
                        else getattr(self._callable, method)
                    for chunk in fn(*args, **kwargs):
                        yield chunk
                    completed = True
                finally:
                    try:
                        ray_tpu_torch.get(refs,
                                    timeout=300 if completed else 15)
                    except Exception:
                        self._wedged = True
                        raise
                if completed:
                    self._verify_stream_digest()
        finally:
            with self._lock:
                self._ongoing -= 1

    def _verify_stream_digest(self):
        """Digest agreement on sampled tokens (opt-in: the callable
        exposes ``last_stream_digest``). After a completed stream every
        rank must have produced the same token bytes — a mismatch means
        the SPMD invariant broke (rank-local rng drift, bad kernel) and
        the gang is serving split-brain output, so it wedges itself for
        whole-group replacement rather than continue."""
        import ray_tpu_torch
        fn = getattr(self._callable, "last_stream_digest", None)
        if fn is None or not self._peers:
            return
        local = fn()
        theirs = ray_tpu_torch.get(
            [p.run_shard.remote("last_stream_digest", (), {})
             for p in self._peers], timeout=30)
        for rank, d in enumerate(theirs, start=1):
            if d != local:
                self._wedged = True
                raise RuntimeError(
                    f"sharded replica digest divergence: rank 0 "
                    f"produced {local}, rank {rank} produced {d} — "
                    f"gang wedged for replacement")

    def run_shard_drain(self, method: str, args: Tuple, kwargs: Dict):
        """Peer side of a streamed request: step the generator to
        exhaustion (outputs discarded — rank 0 owns the response)."""
        kwargs = dict(kwargs)
        kwargs.pop("__serve_model_id", None)
        fn = self._callable if self._is_function \
            else getattr(self._callable, method)
        n = 0
        for _ in fn(*args, **kwargs):
            n += 1
        return n

    # --------------------------------------------------------- control plane
    def get_queue_len(self) -> int:
        return self._ongoing

    def begin_drain(self) -> bool:
        """Drain notice for the whole gang (ingress is rank 0, so
        flipping the rank-0 callable stops new admissions)."""
        self._draining = True
        fn = getattr(self._callable, "begin_drain", None)
        if fn is not None:
            try:
                fn()
            except Exception:
                logger.warning("callable begin_drain failed",
                               exc_info=True)
        return True

    def get_runtime_state(self) -> Dict:
        return {"queue_len": self._ongoing,
                "draining": getattr(self, "_draining", False)}

    def check_health(self) -> bool:
        """Rank 0 probes every peer: one dead rank = unhealthy group, so
        the controller replaces the gang as a unit (gang semantics)."""
        import ray_tpu_torch
        if self._wedged:
            raise ray_tpu_torch.ActorDiedError(
                "sharded replica gang wedged by an abandoned stream")
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        if self._peers:
            ray_tpu_torch.get([p.check_peer_health.remote()
                               for p in self._peers], timeout=25)
        return True

    def check_peer_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def reconfigure(self, user_config) -> bool:
        import ray_tpu_torch
        refs = [p.reconfigure_shard.remote(user_config)
                for p in self._peers]
        self.reconfigure_shard(user_config)
        ray_tpu_torch.get(refs, timeout=60)
        return True

    def reconfigure_shard(self, user_config) -> bool:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True


def refuse_topology(config: Dict) -> None:
    """A gang pinned to one slice's hosts is not ported yet: refuse a
    ``topology`` (at deploy, and again where a gang is built)."""
    if config.get("topology"):
        raise NotImplementedError(
            f"a sharded replica on a slice topology "
            f"({config['topology']!r}) is not ported yet (ROADMAP.md, "
            f"Queue A item A3c-2); PACK placement (no topology) is")


def create_sharded_group(spec: Dict) -> Tuple[object, Dict]:
    """Gang-create one sharded replica group for `spec` (controller
    helper). Returns (rank0_handle, group_record) where group_record =
    {"members": [handles], "pg": placement_group} — the controller keeps
    it so kill/drain retires the whole gang and releases the bundle.

    Placement: `num_hosts` plain bundles placed PACK (a gang of processes
    on commodity nodes, the CPU CI shape); each bundle asks the
    deployment's CPUs, GPUs (``num_gpus``) and custom resources."""
    import uuid

    import ray_tpu_torch
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                    placement_group, remove_placement_group)

    cfg = spec["config"]
    refuse_topology(cfg)
    n = int(cfg.get("num_hosts") or 1)
    opts = dict(cfg.get("ray_actor_options") or {})
    res = {"CPU": opts.get("num_cpus", 0.25)}
    if opts.get("num_gpus"):
        res["GPU"] = opts["num_gpus"]
    for k, v in (opts.get("resources") or {}).items():
        res[k] = v
    bundles = [dict(res) for _ in range(n)]
    pg = placement_group(bundles, strategy="PACK")
    if not pg.wait(timeout=120):
        remove_placement_group(pg)
        raise RuntimeError(
            f"placement group for sharded replica ({n} hosts) "
            f"not schedulable: {bundles}")
    max_ongoing = cfg.get("max_ongoing_requests", 16)
    actor_cls = ray_tpu_torch.remote(ReplicaShard)
    members = []
    try:
        for rank in range(n):
            bundle = dict(bundles[rank])
            a_opts = dict(
                max_concurrency=max_ongoing + 4,
                num_cpus=bundle.pop("CPU"),
                num_gpus=bundle.pop("GPU", None),
                resources=bundle or None,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    pg, placement_group_bundle_index=rank))
            if opts.get("runtime_env"):
                a_opts["runtime_env"] = opts["runtime_env"]
            members.append(actor_cls.options(**a_opts).remote(rank, n))
        group_name = f"serve-shard-{uuid.uuid4().hex[:8]}"
        ray_tpu_torch.get([m.setup_distributed.remote(group_name)
                           for m in members], timeout=300)
        ray_tpu_torch.get([m.init_callable.remote(
            spec["callable"], tuple(spec["init_args"]),
            spec["init_kwargs"], spec["is_function"])
            for m in members], timeout=600)
        ray_tpu_torch.get(members[0].set_peers.remote(members[1:]),
                          timeout=60)
    except Exception:
        for m in members:
            try:
                ray_tpu_torch.kill(m)
            except Exception:
                pass
        try:
            remove_placement_group(pg)
        except Exception:
            pass
        raise
    return members[0], {"members": members, "pg": pg}


def kill_group(group: Dict) -> None:
    """Tear down every rank + release the gang's placement group."""
    import ray_tpu_torch
    from ray_tpu_torch.util import remove_placement_group
    for m in group.get("members", []):
        try:
            ray_tpu_torch.kill(m)
        except Exception:
            pass
    pg = group.get("pg")
    if pg is not None:
        try:
            remove_placement_group(pg)
        except Exception:
            pass
