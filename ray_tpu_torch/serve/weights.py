"""Cluster weight-source resolution for replica construction.

ROADMAP item 3 leftover: a fleet shell revival used to RE-RUN the
deployment's ``params_fn`` — a full checkpoint read (or re-init) inside
every cold start, on every node, every time a scaled-to-zero deployment
woke up. The weight-distribution plane already solves exactly
this: one loaded tree broadcast once lands in every node's pinned arena,
and every later attach is a zero-copy local get.

``resolve_weight_source(key, loader)`` is the default path LLMDeployment
routes ``params_fn`` through (``fleet_weights_from_arena`` flag):

1. the GCS KV (namespace ``serve_weights``) is probed for a recorded
   broadcast ref under ``key`` — hit → ``ray_tpu_torch.get`` attaches the tree
   from the local arena (cross-node pulls ride the zero-copy data
   plane); a stale/lost ref falls through;
2. miss → ``loader()`` runs ONCE (the only attach that pays the load),
   the host tree is published via ``ray_tpu_torch.broadcast_weights`` — or a
   plain ``ray_tpu_torch.put`` when the weight plane is unavailable (single
   node, no data plane) — and the ref is recorded for every future
   attach, shell revivals included. The loader first claims the key in
   the KV (a put that does not overwrite), so replicas of one deployment
   built together do not all load: the others wait for the claimant's
   ref (until the attach timeout, then load themselves).

``last_resolve`` keeps how the latest resolve in this process went: the
source (``arena`` or ``loader``) and its seconds; for an attach, the wait
for a claimant's publish and the read, for a load, the loader's and the
publish's.

The tree is a state dict (or any nest of dicts, lists and tuples) of
tensors. It is published as CPU tensors, each one out-of-band buffer of
the object store, so an attach reads views of the arena (zero-copy) and
moves them to its own device (``LLMDeployment``).

``checkpoint_weight_source(path)`` builds a params_fn whose miss path
reads a sharded checkpoint (``train/sharded_checkpoint.py``) into CPU
tensors once and publishes it through the weight plane.

Outside a cluster everything degrades to a bare ``loader()`` call, so
the same deployment code runs in unit tests and bare scripts.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

KV_NS = "serve_weights"
_CLAIM = "#loading"
_WAIT_POLL_S = 0.1

last_resolve: dict = {}
# refs this process published: the object lives as long as its owner
# holds a ref (the KV keeps only a pickled copy), so the publisher keeps
# each one for its lifetime
_published: dict = {}


def _worker():
    from ray_tpu_torch import _get_worker
    return _get_worker()


def _connected() -> bool:
    try:
        import ray_tpu_torch
        return ray_tpu_torch.is_initialized()
    except Exception:
        return False


def _host_tree(params: Any) -> Any:
    """Pull a params tree to host leaves (CPU tensors), the broadcastable
    form; device placement happens per attach anyway."""
    import torch

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return x
    return host(params)


def cached_ref(key: str):
    """The recorded broadcast ref for ``key``, or None."""
    import cloudpickle
    try:
        blob = _worker().gcs_call("kv_get", ns=KV_NS, key=key.encode())
    except Exception:
        return None
    if not blob:
        return None
    try:
        return cloudpickle.loads(blob)
    except Exception:
        return None


def record_ref(key: str, ref) -> None:
    import cloudpickle
    _worker().gcs_call("kv_put", ns=KV_NS, key=key.encode(),
                       value=cloudpickle.dumps(ref))


def _claim(key: str) -> bool:
    """Claim the load of ``key`` (True), or learn that another process
    holds the claim (False). A failing KV counts as claimed: loading is
    always safe."""
    try:
        return bool(_worker().gcs_call("kv_put", ns=KV_NS,
                                       key=(key + _CLAIM).encode(),
                                       value=b"1", overwrite=False))
    except Exception:
        return True


def _unclaim(key: str) -> None:
    try:
        _worker().gcs_call("kv_del", ns=KV_NS, key=(key + _CLAIM).encode())
    except Exception:
        logger.debug("weight-source unclaim failed for %s", key,
                     exc_info=True)


def _wait_for_ref(key: str, timeout_s: float):
    import time
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ref = cached_ref(key)
        if ref is not None:
            return ref
        time.sleep(_WAIT_POLL_S)
    return None


def clear_ref(key: str) -> None:
    try:
        _worker().gcs_call("kv_del", ns=KV_NS, key=key.encode())
    except Exception:
        logger.debug("weight-source kv_del failed for %s", key,
                     exc_info=True)


def publish_weights(key: str, params: Any):
    """Broadcast a loaded tree cluster-wide (plain-put fallback when the
    weight plane is unavailable) and record the ref under ``key``.
    Returns the ref, or None when even the put failed — callers always
    still hold the in-memory tree, so publish failures only cost the
    NEXT attach a reload."""
    import ray_tpu_torch
    host = _host_tree(params)
    try:
        ref = ray_tpu_torch.broadcast_weights(host)
        via = "broadcast"
    except Exception:
        try:
            ref = ray_tpu_torch.put(host)
            via = "put"
        except Exception:
            logger.warning("weight publish failed for %s", key,
                           exc_info=True)
            return None
    _published[key] = ref
    try:
        record_ref(key, ref)
    except Exception:
        logger.warning("weight-source ref record failed for %s", key,
                       exc_info=True)
        return None
    from ray_tpu_torch._private import events
    events.record_instant("serve.weight_publish", category="serve",
                          key=key, via=via)
    return ref


def resolve_weight_source(key: Optional[str], loader: Callable[[], Any],
                          *, enabled: Optional[bool] = None,
                          timeout_s: Optional[float] = None) -> Any:
    """Resolve a deployment's params through the cluster weight plane
    (see module docstring). Any failure along the arena path falls back
    to ``loader()`` — serving never breaks on weight-plane trouble."""
    from ray_tpu_torch._private.config import cfg
    if enabled is None:
        enabled = cfg.fleet_weights_from_arena
    if not enabled or not key or not _connected():
        return loader()
    import time

    from ray_tpu_torch._private import events
    t0 = time.perf_counter()
    timeout = (timeout_s if timeout_s is not None
               else cfg.fleet_attach_timeout_s)
    ref = cached_ref(key)
    claimed = False
    if ref is None:
        claimed = _claim(key)
        if not claimed:
            # a replica built beside this one is loading: attach to its
            # publish instead of loading a second time
            ref = _wait_for_ref(key, timeout)
    if ref is not None:
        try:
            import ray_tpu_torch
            t1 = time.perf_counter()
            params = ray_tpu_torch.get(ref, timeout=timeout)
            t2 = time.perf_counter()
            events.record_instant("serve.weight_attach", category="serve",
                                  key=key, source="arena")
            last_resolve.clear()
            last_resolve.update(key=key, source="arena", seconds=t2 - t0,
                                wait_s=t1 - t0, get_s=t2 - t1)
            return params
        except Exception:
            # ref outlived its object (node loss, store restart):
            # forget it and reload below
            logger.info("weight-source ref for %s unreadable; reloading",
                        key, exc_info=True)
            clear_ref(key)
    try:
        t1 = time.perf_counter()
        params = loader()
        t2 = time.perf_counter()
        published = publish_weights(key, params) is not None
        t3 = time.perf_counter()
    finally:
        if claimed:
            _unclaim(key)
    events.record_instant("serve.weight_attach", category="serve",
                          key=key, source="loader", published=published)
    last_resolve.clear()
    last_resolve.update(key=key, source="loader", seconds=t3 - t0,
                        load_s=t2 - t1, publish_s=t3 - t2,
                        published=published)
    return params


def checkpoint_weight_source(path: str,
                             key: Optional[str] = None
                             ) -> Callable[[], Any]:
    """A ``params_fn`` whose cold path is
    ``sharded_checkpoint.restore_and_broadcast``: the first attach reads
    the checkpoint off storage ONCE and fans it out over the weight
    plane; every other attach (and every shell revival) gets a local
    arena attach. Outside a cluster it reads the checkpoint directly."""
    key = key or f"ckpt/{path}"

    def params_fn():
        from ray_tpu_torch.train.sharded_checkpoint import \
            restore_host_arrays
        if not _connected():
            return restore_host_arrays(path)

        def loader():
            return restore_host_arrays(path)
        return resolve_weight_source(key, loader)
    return params_fn
