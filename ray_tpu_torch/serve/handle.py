"""DeploymentHandle + client-side power-of-two-choices routing.

Reference: python/ray/serve/handle.py:745 (DeploymentHandle),
_private/replica_scheduler/pow_2_scheduler.py:52. The router here is
embedded in the handle (no proxy hop for handle calls): it tracks its own
in-flight count per replica and picks the less-loaded of two random
replicas — the cached-queue-length variant of P2C."""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class DeploymentResponse:
    """Future for one deployment call."""

    def __init__(self, ref, router=None, replica_id=None, resubmit=None):
        self._ref = ref
        self._router = router
        self._replica_id = replica_id
        self._resubmit = resubmit
        self._done = False

    def result(self, timeout: Optional[float] = None):
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout)
        except Exception as e:
            # the replica died after accepting the call (e.g. retired
            # mid-roll before the router refreshed) or refused it while
            # draining: re-route ONCE through the handle against the
            # current replica set
            if not _is_replica_death(e):
                raise
            self._settle()
            if self._resubmit is None:
                raise
            retry, self._resubmit = self._resubmit, None
            return retry().result(timeout=timeout)
        finally:
            self._settle()

    def _settle(self):
        if not self._done and self._router is not None:
            self._done = True
            self._router._dec(self._replica_id)

    def __await__(self):
        async def _get():
            try:
                from ray_tpu_torch._private.worker import global_worker
                return await global_worker.core.get_async(self._ref)
            except ray_tpu_torch.ActorDiedError:
                self._settle()
                if self._resubmit is None:
                    raise
                retry, self._resubmit = self._resubmit, None
                return await retry()
            finally:
                self._settle()
        return _get().__await__()

    @property
    def _object_ref(self):
        return self._ref

    def __del__(self):
        self._settle()


def _is_replica_death(e: BaseException) -> bool:
    """Failures that mean THIS replica is gone (re-routable), as opposed
    to an application error the caller must see. A draining replica
    (preemption notice won the race against the routing-table update)
    counts: it refuses the call at the boundary, before side effects."""
    from ray_tpu_torch.serve.replica import ReplicaDrainingError
    return isinstance(e, (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ObjectLostError,
                          ray_tpu_torch.WorkerCrashedError,
                          ReplicaDrainingError))


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call: a thin value-fetching
    wrapper around the core ObjectRefGenerator — chunks arrive as the
    replica's generator yields, with the core protocol's backpressure
    (reference: DeploymentResponseGenerator, serve/handle.py).

    Coalesced deployments (``__serve_coalesce_stream__``) yield LISTS of
    items per wire frame; with ``unpack=True`` this wrapper buffers each
    frame and hands items out one at a time, so the public per-item
    iteration is identical while the handle→router→replica round-trip
    amortizes over the whole frame. ``next_batch()`` exposes the frame
    boundary for egress paths (the proxy writes a frame's NDJSON lines
    in one syscall). All delivery/dedupe accounting below is
    ITEM-granular — a resume mid-frame never drops or duplicates the
    frame's tail.

    Replica death mid-stream re-routes ONCE, like the unary
    DeploymentResponse: ``resume(fetched, items)`` (installed by the
    handle) restarts the stream on the current replica set. Resumable
    deployments get the fetched items back as ``resume_tokens`` and
    continue in place; non-resumable ones restart from scratch and this
    wrapper discards the first ``fetched`` items — either way the
    consumer sees every item exactly once."""

    def __init__(self, ref_gen, router, replica_idx, resume=None,
                 record_chunks: bool = False, unpack: bool = False):
        self._gen = ref_gen
        self._router = router
        self._idx = replica_idx
        self._got_first = False
        self._resume = resume
        self._unpack = unpack
        self._buf: List = []          # fetched-but-undelivered items
        self._delivered = 0           # items handed to the consumer
        self._fetched = 0             # items pulled off the wire
        # fetched items, kept only for resumable deployments (they are
        # token ids there — small); non-resumable re-routes dedupe by
        # count alone. Buffered items count as fetched: on a resume they
        # are still delivered from the buffer, so the fresh stream must
        # continue AFTER them.
        self._chunks: Optional[List] = [] if record_chunks else None

    def __iter__(self):
        return self

    def _fetch(self):
        """One wire frame off the underlying ref generator, unpacked to
        a list of items (StopIteration at end of stream). Split out so
        the resume path and the skip-ahead dedupe share it."""
        # 60s liveness bound: a replica generator wedged in user
        # code surfaces a TimeoutError instead of hanging the caller
        ref = self._gen.next(timeout=60)
        value = self._get(ref)
        if self._unpack and isinstance(value, (list, tuple)):
            return list(value)
        return [value]

    @staticmethod
    def _get(ref):
        return ray_tpu_torch.get(ref, timeout=60)

    def _fill_buf(self):
        """Fetch the next non-empty frame into the buffer, re-routing
        once on replica death. Raises StopIteration at end of stream."""
        while not self._buf:
            try:
                items = self._fetch()
            except StopIteration:
                self._settle()
                raise
            except Exception as e:
                if self._resume is None or not _is_replica_death(e):
                    self._settle()
                    raise
                resume, self._resume = self._resume, None   # one-shot
                try:
                    fresh, skip = resume(self._fetched, self._chunks)
                    self._adopt(fresh, skip)
                except StopIteration:
                    self._settle()
                    raise
                except Exception:
                    self._settle()
                    raise e   # surface the ORIGINAL death, not the retry
                continue
            self._fetched += len(items)
            if self._chunks is not None:
                self._chunks.extend(items)
            self._buf.extend(items)

    def __next__(self):
        self._fill_buf()
        if not self._got_first:
            # client-observed first chunk (TTFT as the CALLER saw it,
            # network + queueing included — the engine-side first-token
            # instant measures the same moment from the other end)
            self._got_first = True
            from ray_tpu_torch._private import events
            events.record_instant("serve.first_chunk", category="serve")
        self._delivered += 1
        return self._buf.pop(0)

    def next_batch(self) -> List:
        """Drain everything currently buffered (at least one item,
        fetching a frame if needed) in one call — the coalesced-egress
        counterpart of __next__. Raises StopIteration at end of
        stream."""
        self._fill_buf()
        if not self._got_first:
            self._got_first = True
            from ray_tpu_torch._private import events
            events.record_instant("serve.first_chunk", category="serve")
        batch, self._buf = self._buf, []
        self._delivered += len(batch)
        return batch

    def _adopt(self, fresh: "DeploymentResponseGenerator", skip: int):
        """Take over a freshly routed stream: steal its underlying
        generator + routing slot (neutering the donor so its __del__
        doesn't decrement our in-flight count), then discard the first
        `skip` items — the ones a non-resumable restart re-produces.
        Item-granular: a restart frame that straddles the skip boundary
        keeps its tail."""
        self._settle()
        self._gen = fresh._gen
        self._idx = fresh._idx
        self._router = fresh._router
        fresh._router = None
        while skip > 0:
            items = self._fetch()
            if len(items) > skip:
                self._buf.extend(items[skip:])
                self._fetched += len(items) - skip
                if self._chunks is not None:
                    self._chunks.extend(items[skip:])
                skip = 0
            else:
                skip -= len(items)

    def _settle(self):
        if self._router is not None:
            self._router._dec(self._idx)
            self._router = None

    def close(self):
        """Walk away mid-stream: stops the replica-side generator (its
        finally/GeneratorExit path runs, freeing whatever the stream
        held — e.g. an inference-engine slot), drops unconsumed chunks,
        and releases this handle's in-flight routing count."""
        try:
            self._gen.close()
        except Exception:
            pass
        self._settle()

    def __del__(self):
        # only the routing count here: the underlying ObjectRefGenerator
        # closes itself (non-blocking) in its own __del__
        self._settle()


class _LongPollClient:
    """One background listener per process pushing controller config into
    registered routers (reference: LongPollClient, long_poll.py:64 —
    replaces interval polling; the 2s refresh in _Router stays as a
    fallback when the controller is unreachable)."""

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get(cls) -> "_LongPollClient":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls):
        """Serve shutdown: stop the listener so a later serve session (new
        controller identity) starts a fresh client instead of a thread
        stuck talking to a dead actor."""
        with cls._lock:
            inst = cls._instance
            cls._instance = None
        if inst is not None:
            inst._stopped = True

    def __init__(self):
        self._routers: Dict[str, List] = {}
        self._summary_routers: Dict[str, List] = {}
        self._versions: Dict[str, int] = {}
        self._reg_lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def register(self, router: "_Router"):
        key = f"dep:{router.app_name}:{router.deployment_name}"
        with self._reg_lock:
            self._routers.setdefault(key, []).append(router)
            self._versions.setdefault(key, -1)

    def watch_summaries(self, router: "_Router"):
        """Subscribe a prefix-routed router to pushed prefix summaries
        (the controller bumps the "prefix_summaries" key when the GCS
        table changes — ROADMAP item 1's push satellite). Idempotent."""
        with self._reg_lock:
            lst = self._summary_routers.setdefault("prefix_summaries", [])
            if router not in lst:
                lst.append(router)
            self._versions.setdefault("prefix_summaries", -1)

    def _loop(self):
        from ray_tpu_torch.serve.long_poll import run_longpoll_loop

        def get_controller():
            from ray_tpu_torch.serve.api import _get_controller
            return _get_controller()

        def on_update(key, data):
            if key == "prefix_summaries":
                with self._reg_lock:
                    routers = list(self._summary_routers.get(key, []))
                for r in routers:
                    r._apply_summary_push((data or {}).get("rows") or [])
                return
            with self._reg_lock:
                routers = list(self._routers.get(key, []))
            for r in routers:
                r._apply_push(data)

        run_longpoll_loop(get_controller, self._versions, on_update,
                          should_stop=lambda: self._stopped)


class _Router:
    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.replicas: List = []        # actor handles
        self.inflight: Dict[int, int] = {}
        self.shared_load: Dict[int, int] = {}  # controller-probed depths
        self.version = -1
        self.resumable = False   # deployment streams accept resume_tokens
        self.coalesced = False   # streams yield token-chunk lists
        # cluster-wide prefix routing (serve/disagg.py): the deployment
        # opted in, replica_ids key the GCS prefix_summaries rows onto
        # routing indices, and _summaries caches {replica_id: fp set}
        self.prefix_routed = False
        self.replica_ids: List = []
        # per replica: past construction (controller health-checked)
        self.started: List[bool] = []
        self._summaries: Dict[str, set] = {}
        self._summary_chunk: Optional[int] = None
        self._last_summary_refresh = 0.0
        self._summary_push_t = 0.0    # last long-poll summary push
        self._watching_summaries = False
        # fleet plane (serve/fleet.py): scale-to-zero deployments hold
        # callers instead of erroring on an empty replica set; fallback
        # + max_ongoing drive overflow shedding down the fallback ladder
        self.scale_to_zero = False
        self.fallback: Optional[str] = None
        self.max_ongoing = 0
        self._revive_t = 0.0          # last revive request (throttle)
        self.lock = threading.Lock()
        self._last_refresh = 0.0
        self.model_map: Dict[str, int] = {}   # multiplexed model -> replica
        try:
            _LongPollClient.get().register(self)
        except Exception:
            pass   # push is an optimization; polling still works

    def _ingest(self, info: Dict, now: float):
        """Fold one controller get_deployment_info payload in (shared by
        the long-poll push and the polling refresh). Caller holds
        self.lock."""
        self._last_refresh = now
        self.resumable = bool(info.get("resumable"))
        self.coalesced = bool(info.get("coalesced"))
        self.prefix_routed = bool(info.get("prefix_routed"))
        self.replica_ids = list(info.get("replica_ids") or [])
        self.started = list(info.get("started") or [])
        self.scale_to_zero = bool(info.get("scale_to_zero"))
        self.fallback = info.get("fallback") or None
        self.max_ongoing = int(info.get("max_ongoing") or 0)
        if info["version"] != self.version:
            self.version = info["version"]
            self.replicas = info["replicas"]
            self.inflight = {i: 0 for i in range(len(self.replicas))}
            self.model_map.clear()
        self.shared_load = dict(enumerate(info.get("loads") or []))

    def _watch_summaries_once(self):
        if self._watching_summaries:
            return
        self._watching_summaries = True
        try:
            _LongPollClient.get().watch_summaries(self)
        except Exception:
            pass   # pull fallback still works

    def _apply_push(self, info: Dict):
        with self.lock:
            self._ingest(info, time.monotonic())
            prefix = self.prefix_routed
        if prefix:
            self._watch_summaries_once()

    def _controller(self):
        from ray_tpu_torch.serve.api import _get_controller
        return _get_controller()

    def refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and self.replicas and now - self._last_refresh < 2.0:
            return
        info = ray_tpu_torch.get(self._controller().get_deployment_info.remote(
            self.app_name, self.deployment_name), timeout=30)
        with self.lock:
            self._ingest(info, now)
            prefix = self.prefix_routed
        if prefix:
            self._watch_summaries_once()

    def _apply_summary_push(self, rows: List[Dict]):
        """Prefix summaries arriving over the long-poll plane (the
        controller snapshots the GCS table each reconcile tick). While
        pushes keep coming the 1 Hz GCS pull is suppressed — the push
        path replaces it, it doesn't stack on top."""
        summaries: Dict[str, set] = {}
        chunk = None
        for row in rows or []:
            summaries[row["replica_id"]] = set(row.get("fps") or ())
            chunk = chunk or int(row.get("chunk") or 0)
        with self.lock:
            mine = set(r for r in self.replica_ids if r)
            self._summaries = {rid: s for rid, s in summaries.items()
                               if not mine or rid in mine}
            self._summary_chunk = chunk or None
            self._summary_push_t = time.monotonic()

    def _refresh_summaries(self):
        """Pull the GCS prefix_summaries rows for this deployment's
        replicas (throttled to 1 Hz; the rows themselves refresh at
        cfg.prefix_summary_interval_s and expire at the TTL). Skipped
        while long-poll pushes are fresh (_apply_summary_push) — the
        pull is the fallback for when the push plane is unavailable.
        Failure just leaves routing on the session-hash/P2C rungs."""
        now = time.monotonic()
        from ray_tpu_torch._private.config import cfg
        if now - getattr(self, "_summary_push_t", 0.0) < 2.0 * max(
                1.0, cfg.prefix_summary_interval_s):
            return
        if now - self._last_summary_refresh < 1.0:
            return
        self._last_summary_refresh = now
        try:
            rows = ray_tpu_torch._get_worker().gcs_call(
                "get_prefix_summaries",
                ids=[r for r in self.replica_ids if r] or None)
        except Exception:
            return
        summaries: Dict[str, set] = {}
        chunk = None
        for row in rows or []:
            summaries[row["replica_id"]] = set(row.get("fps") or ())
            chunk = chunk or int(row.get("chunk") or 0)
        with self.lock:
            self._summaries = summaries
            self._summary_chunk = chunk or None

    def _cluster_match_depths(self, prompt_tokens, n: int) -> Dict[int, int]:
        """{replica_idx: matched chunk depth} over the cached summaries:
        depth d means the replica's published trie covers the prompt's
        first d chunks. Pure set intersections — no tokens leave the
        client, no RPC on this path."""
        if not self._summaries or not self._summary_chunk:
            return {}
        from ray_tpu_torch.inference.prefix_cache import chunk_fingerprints
        C = self._summary_chunk
        # same cap as engine admission: the last token always prefills
        fps = chunk_fingerprints(
            [int(t) for t in prompt_tokens], C,
            max_chunks=max(0, (len(prompt_tokens) - 1) // C))
        if not fps:
            return {}
        depths: Dict[int, int] = {}
        for i in range(n):
            rid = self.replica_ids[i] if i < len(self.replica_ids) else None
            s = self._summaries.get(rid)
            if not s:
                continue
            d = 0
            for j, fp in enumerate(fps):
                if fp in s:
                    d = j + 1
            if d:
                depths[i] = d
        return depths

    def overloaded(self) -> bool:
        """True when every replica sits at (or past) its
        max_ongoing_requests — the shed trigger for deployments with a
        fallback_model. A zero-replica set counts as overloaded (there
        is nothing to serve; a scale-to-zero revival may be warming in
        parallel). max_ongoing unknown (0) never reads overloaded."""
        with self.lock:
            n = len(self.replicas)
            if n == 0:
                return True
            if not self.max_ongoing:
                return False
            load = sum(self.shared_load.get(i, 0)
                       + self.inflight.get(i, 0) for i in range(n))
            return load >= n * self.max_ongoing

    def _request_revive(self):
        """Ask the controller to cold-start this deployment (throttled
        to 1/s; the revival itself is idempotent controller-side)."""
        now = time.monotonic()
        if now - self._revive_t < 1.0:
            return
        self._revive_t = now
        try:
            ray_tpu_torch.get(self._controller().revive_deployment.remote(
                self.app_name, self.deployment_name), timeout=10)
        except Exception:
            pass   # the next poll retries

    def _hold_for_revival(self):
        """Handle-level hold queue (serve/fleet.py; the analog of the
        scheduler's ``submit(hold=)`` remote-prefill state): callers of
        a scaled-to-zero deployment park HERE — request submitted zero
        times — while the fleet manager attaches a pre-warmed shell.
        They release the moment the revived replica is published to the
        routing table, so every held request is dispatched exactly
        once, to a replica that actually exists. Returns when replicas
        appear; on timeout the caller falls through to the ordinary
        no-replica error."""
        from ray_tpu_torch._private.config import cfg
        deadline = time.monotonic() + cfg.fleet_cold_start_timeout_s
        while time.monotonic() < deadline:
            with self.lock:
                if self.replicas:
                    return
            self._request_revive()
            time.sleep(0.1)
            try:
                self.refresh(force=True)
            except Exception:
                pass   # controller briefly unreachable: keep holding

    def pick(self, model_id: str = "", session_id: str = "",
             avoid: Optional[set] = None, prompt_tokens=None,
             hint_out: Optional[Dict] = None):
        self.refresh()
        if self.prefix_routed and prompt_tokens is not None:
            self._refresh_summaries()
        if not self.replicas and getattr(self, "scale_to_zero", False):
            self._hold_for_revival()
        with self.lock:
            n = len(self.replicas)
            if n == 0:
                raise RuntimeError(
                    f"deployment {self.deployment_name} has no replicas")
            score = lambda i: (self.shared_load.get(i, 0)  # noqa: E731
                               + self.inflight.get(i, 0))
            avoid = avoid or set()
            # a replica still in its constructor (a replacement loading
            # its weights) takes a request only when no started one can
            starting = {i for i, up in enumerate(self.started[:n])
                        if not up}
            if any(i not in avoid and i not in starting for i in range(n)):
                avoid = avoid | starting
            prefix_depths: Dict[int, int] = {}
            if self.prefix_routed and prompt_tokens is not None \
                    and not model_id:
                prefix_depths = {
                    i: d for i, d in
                    self._cluster_match_depths(prompt_tokens, n).items()
                    if i not in (avoid or set())}
            if model_id and self.model_map.get(model_id, n) < n:
                # sticky multiplex routing: the replica that loaded this
                # model keeps serving it (reference: multiplexed replica
                # preference in the pow-2 scheduler)
                idx = self.model_map[model_id]
            elif prefix_depths:
                # cluster-wide longest-prefix routing (ROADMAP 1c): the
                # replica whose published trie summary covers the prompt
                # deepest serves it — N private caches act as one. Ties
                # break to session affinity when the sticky replica is
                # among the deepest, else to the least-loaded of them.
                best = max(prefix_depths.values())
                winners = [i for i, d in prefix_depths.items()
                           if d == best]
                if session_id:
                    import zlib
                    sticky = zlib.crc32(str(session_id).encode()) % n
                    if sticky in winners:
                        idx = sticky
                    else:
                        idx = min(winners, key=score)
                else:
                    idx = min(winners, key=score)
            elif session_id:
                # session affinity (ROADMAP 1c): hash the session onto a
                # sticky replica so repeat prompts land where their
                # prefix KV is cached. Draining replicas are detached
                # from `replicas` by the controller, so the hash only
                # ever lands on live ones; if the sticky pick already
                # failed this call (stale view: drained/died under us),
                # fall back to least-ongoing among the others.
                import zlib
                idx = zlib.crc32(str(session_id).encode()) % n
                if idx in avoid:
                    rest = [i for i in range(n) if i not in avoid]
                    if rest:
                        idx = min(rest, key=score)
            elif n == 1:
                idx = 0
            else:
                # P2C on the SHARED load signal (controller-probed queue
                # depth, pushed over long-poll) plus this handle's own
                # in-flight count — many independent handles converge on
                # one view instead of each degrading toward random
                # (reference: pow_2_scheduler.py:52 queue-length probes)
                cand = [i for i in range(n) if i not in avoid] \
                    or list(range(n))
                if len(cand) >= 2:
                    a, b = random.sample(cand, 2)
                    idx = a if score(a) <= score(b) else b
                else:
                    idx = cand[0]
            if model_id:
                self.model_map[model_id] = idx
            if hint_out is not None and prefix_depths:
                # KV-fabric peer hint (serve/disagg.py): routing landed
                # somewhere OTHER than the deepest-covering replica
                # (session affinity / load / avoid broke the tie) — tell
                # the chosen replica who holds the prefix so its fabric
                # rung skips the GCS summary query
                best = max(((d, i) for i, d in prefix_depths.items()
                            if i != idx), default=None)
                if best is not None and best[0] > prefix_depths.get(idx, 0):
                    d, i = best
                    rid = (self.replica_ids[i]
                           if i < len(self.replica_ids) else None)
                    if rid:
                        hint_out["peer"] = {
                            "replica_id": rid,
                            "depth": d * (self._summary_chunk or 0)}
            self.inflight[idx] = self.inflight.get(idx, 0) + 1
            return idx, self.replicas[idx]

    def _dec(self, idx):
        with self.lock:
            if idx in self.inflight and self.inflight[idx] > 0:
                self.inflight[idx] -= 1


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._invoke(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str = "default"):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._router = _Router(deployment_name, app_name)

    def _invoke(self, method: str, args, kwargs,
                retry: int = 2,
                allow_resubmit: bool = True,
                shed_depth: int = 0,
                avoid: Optional[set] = None) -> DeploymentResponse:
        # burn-aware shedding (serve/fleet.py): a saturated deployment
        # with a fallback_model hands NEW requests down the fallback
        # ladder (each rung may shed again; depth-capped so a cycle in
        # the ladder cannot loop). Resubmits of accepted requests never
        # shed — exactly-once stays with the original deployment.
        if allow_resubmit:
            shed = self._maybe_shed(method, args, kwargs, retry,
                                    shed_depth)
            if shed is not None:
                return shed
        # unwrap nested responses so replicas receive resolved values
        args = tuple(a._object_ref if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: (v._object_ref if isinstance(v, DeploymentResponse)
                      else v) for k, v in kwargs.items()}
        model_id = getattr(self, "_model_id", "")
        if model_id:
            kwargs = {**kwargs, "__serve_model_id": model_id}
        tenant = getattr(self, "_tenant", "")
        if tenant:
            # fair-share routing metadata (serve/fleet.py): the replica
            # pops it; proxy-side admission enforces quotas
            kwargs = {**kwargs, "__serve_tenant": tenant}
        session_id = getattr(self, "_session_id", "")
        stream = getattr(self, "_stream", False)
        # prefix-routed deployments (serve/disagg.py): the prompt is the
        # streaming call's first positional arg — fingerprint it so the
        # router can match against the cluster's published trie
        # summaries. Anything non-tokenlike just skips the rung.
        prompt = None
        if self._router.prefix_routed and args \
                and method in ("__call__", "generate"):
            try:
                prompt = [int(t) for t in args[0]]
            except (TypeError, ValueError):
                prompt = None
        last_err = None
        # replicas that already failed this call
        avoid = set(avoid or ())
        from ray_tpu_torch._private import events
        for _ in range(retry + 1):
            hint_out: Optional[Dict] = {} if prompt is not None else None
            with events.record_span("serve.route", category="serve",
                                    deployment=self.deployment_name,
                                    app=self.app_name) as route_span:
                idx, replica = self._router.pick(model_id, session_id,
                                                 avoid,
                                                 prompt_tokens=prompt,
                                                 hint_out=hint_out)
                route_span.set(replica=idx)
            call_kwargs = kwargs
            if hint_out and hint_out.get("peer"):
                call_kwargs = {**kwargs,
                               "__serve_peer_hint": hint_out["peer"]}
            try:
                if stream:
                    ref_gen = replica.handle_stream.options(
                        num_returns="streaming").remote(
                            method, args, call_kwargs)
                    resume = None
                    if allow_resubmit:
                        resume = self._make_stream_resume(method, args,
                                                          kwargs, retry,
                                                          replica)
                    return DeploymentResponseGenerator(
                        ref_gen, self._router, idx, resume=resume,
                        record_chunks=self._router.resumable,
                        unpack=self._router.coalesced)
                ref = replica.handle_request.remote(method, args,
                                                    call_kwargs)
                # one resubmit only: the retried response carries NO
                # further resubmit, so a crash loop surfaces instead of
                # retrying unboundedly past the caller's timeout
                resub = None
                if allow_resubmit:
                    resub = lambda: (  # noqa: E731
                        self._router.refresh(force=True)
                        or self._invoke(method, args, kwargs, retry=retry,
                                        allow_resubmit=False,
                                        avoid=self._listed(replica)))
                return DeploymentResponse(ref, self._router, idx,
                                          resubmit=resub)
            except Exception as e:
                self._router._dec(idx)
                avoid.add(idx)
                self._router.refresh(force=True)
                last_err = e
        raise last_err

    MAX_SHED_DEPTH = 4

    def _maybe_shed(self, method, args, kwargs, retry, shed_depth):
        """One rung of the fallback ladder: when this deployment is
        saturated (router.overloaded()) and declares a fallback_model,
        route the request there instead of queueing into the overload.
        Returns None to serve locally. A scaled-to-zero primary also
        kicks its revival here, so the fallback absorbs traffic WHILE
        the primary warms — burn-aware shedding's whole point."""
        r = self._router
        if not r.fallback or shed_depth >= self.MAX_SHED_DEPTH:
            return None
        try:
            r.refresh()
        except Exception:
            return None
        if not r.overloaded():
            return None
        if r.scale_to_zero and not r.replicas:
            r._request_revive()
        from ray_tpu_torch.serve.fleet import record_fallback_shed
        record_fallback_shed(self.deployment_name, r.fallback,
                             app=self.app_name)
        return self._fallback_handle()._invoke(
            method, args, kwargs, retry=retry,
            shed_depth=shed_depth + 1)

    def _fallback_handle(self) -> "DeploymentHandle":
        fb = getattr(self, "_fb_handle", None)
        if fb is None or fb.deployment_name != self._router.fallback:
            fb = DeploymentHandle(self._router.fallback, self.app_name)
            self._fb_handle = fb
        # carry the caller's traits (stream/session/tenant/model) down
        # the ladder so the fallback serves the same call shape
        return fb.options(
            multiplexed_model_id=getattr(self, "_model_id", ""),
            stream=getattr(self, "_stream", False),
            session_id=getattr(self, "_session_id", ""),
            tenant=getattr(self, "_tenant", ""))

    def _listed(self, replica) -> set:
        """Where ``replica`` sits in the router's current list: the
        re-route after its death avoids it, which the controller may not
        have taken off the list yet."""
        rid = getattr(replica, "_actor_id", None)
        return {i for i, r in enumerate(self._router.replicas)
                if rid is not None and getattr(r, "_actor_id", None) == rid}

    def _make_stream_resume(self, method, args, kwargs, retry, severed):
        """One-shot re-route for a stream severed by replica death (the
        streaming counterpart of DeploymentResponse's resubmit). Returns
        (fresh DeploymentResponseGenerator, chunks_to_skip): resumable
        deployments receive the delivered chunks as resume_tokens and
        continue from the exact next position (skip 0); non-resumable
        ones restart the stream internally and the caller skips the
        first `delivered` chunks so the client never sees a duplicate.
        The re-route avoids the ``severed`` replica while it is still
        listed."""
        def resume(delivered: int, chunks):
            self._router.refresh(force=True)
            avoid = self._listed(severed)
            if self._router.resumable and chunks is not None:
                kw = dict(kwargs)
                prior = list(kw.pop("resume_tokens", None) or [])
                kw["resume_tokens"] = prior + list(chunks)
                return self._invoke(method, args, kw, retry=retry,
                                    allow_resubmit=False, avoid=avoid), 0
            return self._invoke(method, args, kwargs, retry=retry,
                                allow_resubmit=False,
                                avoid=avoid), delivered
        return resume

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._invoke("__call__", args, kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("deployment_name", "app_name"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def options(self, *, multiplexed_model_id: str = "",
                stream: bool = False, session_id: str = "",
                tenant: str = "", **_kw) -> "DeploymentHandle":
        if not multiplexed_model_id and not stream and not session_id \
                and not tenant:
            return self
        clone = DeploymentHandle(self.deployment_name, self.app_name)
        clone._router = self._router          # share routing state
        if multiplexed_model_id:
            clone._model_id = multiplexed_model_id
        if session_id:
            # sticky-session routing: calls through this handle hash to
            # one replica so repeat prompts hit its prefix cache
            clone._session_id = str(session_id)
        if tenant:
            # fair-share admission identity (serve/fleet.py): the
            # HTTP-header analog is X-RayTPU-Tenant at the proxy
            clone._tenant = str(tenant)
        # a handle derived twice (options().options()) keeps its traits
        clone._stream = stream or getattr(self, "_stream", False)
        if not session_id and getattr(self, "_session_id", ""):
            clone._session_id = self._session_id
        if not multiplexed_model_id and getattr(self, "_model_id", ""):
            clone._model_id = self._model_id
        if not tenant and getattr(self, "_tenant", ""):
            clone._tenant = self._tenant
        return clone

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, self.app_name))
