"""Disaggregated prefill/decode serving plane (ROADMAP item 1b/1c).

Prefill is compute-bound, decode is memory-bound; colocating them on one
replica wastes both sides of the roofline. This module splits
``LLMDeployment``
into two tiers and turns N replica prefix caches into one logical
cluster cache:

- **Prefill tier** (:class:`PrefillLLMDeployment`): replicas run chunked
  prefill only. ``prefill_export(tokens)`` makes sure the prompt's
  chunk-aligned prefix is in the local radix cache (its blocks are
  immutable chunk-aligned spans), copies the blocks out of the pool
  (``InferenceEngine.export_kv_blocks``), frames them into
  one contiguous payload, and parks it in the **pinned shared-memory
  arena** via ``ray_tpu_torch.put`` — returning the ObjectRef, never the
  bytes. The payload therefore moves between nodes over the zero-copy
  data plane: the decode node's ``recv_into`` writes straight
  into its arena, and the import path reads ``np.frombuffer`` views of
  that region (no host staging copy; the single host->device copy is
  the irreducible one).

- **Decode tier** (:class:`DisaggLLMDeployment`): on a request whose
  prefix is not cached locally, the replica hold-submits the request
  (the scheduler keeps its FIFO position but won't admit it — the
  remote-prefill admission state), asks the prefill tier for the KV
  blocks, imports them into its own block pool + trie, and releases the
  hold. Admission then takes the ordinary radix-hit path: ``load_span``
  restores the imported blocks into scratch and only the final chunk
  prefills. Greedy output is bit-identical to the colocated path.

- **Cluster-wide prefix routing**: every decode replica periodically
  publishes a compact trie summary — the top-K most-recently-touched
  path fingerprints (~8 bytes per cached chunk) — to the GCS
  ``prefix_summaries`` table. The router (serve/handle.py) computes the
  incoming prompt's own chunk fingerprints and routes to the replica
  with the DEEPEST cluster-wide match; session hash breaks ties and
  handles the no-match case. N private caches become one logical cache:
  a prefix warmed on replica A serves sessions that have never touched
  A.

- **Decode→decode KV fabric** (ROADMAP item 2b): any decode replica
  whose published summary covers the prompt can serve the pinned-arena
  payload DIRECTLY to a peer via :meth:`DisaggLLMDeployment.peer_export`
  — same wire framing, same data plane, no prefill-tier funnel. The
  exporter proves the requested fingerprint against its LIVE trie
  (``RadixPrefixCache.covered_fp``) before shipping, so a stale summary
  (blocks evicted since the last publish cadence) is refused instead of
  installing KV for the wrong tokens. K concurrent exports of one hot
  fingerprint coalesce in :class:`_ExportSingleFlight` — one
  ``export_kv_blocks`` run — and when the waiters span enough distinct
  nodes the payload relays through the weight plane's broadcast tree
  (``ray_tpu_torch.broadcast_weights``, binomial fan-out) instead of K
  point-to-point pulls (item 2c).

Fallback ladder (every rung preserves exactly-once token delivery —
nothing has streamed yet when a rung fails):

  1. cluster longest-prefix route  (router; stale summary -> rung 2)
  2. local radix hit               (no hand-off needed)
  3. decode→decode peer hand-off   (KV fabric; dead peer / stale
                                    fingerprint / empty export -> 4)
  4. KV hand-off from the prefill tier (replica death / timeout -> 5)
  5. local chunked prefill         (always available)

The framing is byte for byte the JAX package's, so spans cross between
the two packages' tiers. A bf16 pool's spans ship as 2-byte
``ml_dtypes.bfloat16`` arrays (header dtype ``"bfloat16"``), whose numpy
name exists once ``ml_dtypes`` is imported: ``unpack_kv_spans`` imports
it for such a payload.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np

from ray_tpu_torch._private import events, rpc
from ray_tpu_torch._private.config import cfg
from ray_tpu_torch.inference.api import LLMDeployment

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ KV framing
def pack_kv_spans(spans: List[Tuple[np.ndarray, ...]]) -> bytes:
    """Frame exported KV spans into one contiguous payload:
    ``[u32 header_len][msgpack {n, shape, dtype}][k0][v0][k1][v1]...``
    with raw array bytes back to back — the shape ``unpack_kv_spans``
    reads as zero-copy ``np.frombuffer`` views of the arena buffer the
    data plane received into.

    A ``kv_quant="int8"`` exporter hands 4-tuple spans ``(qk, qv,
    k_scales, v_scales)``; the header then carries ``quant: "int8"``
    plus the scale shape/dtype and each span frames as
    ``[qk][qv][ks][vs]`` — the wire payload shrinks by
    ``~itemsize * D / (D + 4)`` vs the fp framing (kv_quant.slot_gain),
    which is the disagg hand-off half of the int8 win."""
    if not spans:
        hdr = msgpack.packb({"n": 0, "shape": [], "dtype": ""})
        return len(hdr).to_bytes(4, "little") + hdr
    k0 = spans[0][0]
    meta = {"n": len(spans), "shape": list(k0.shape),
            "dtype": str(k0.dtype)}
    if len(spans[0]) == 4:
        s0 = spans[0][2]
        meta["quant"] = "int8"
        meta["sshape"] = list(s0.shape)
        meta["sdtype"] = str(s0.dtype)
    hdr = msgpack.packb(meta)
    parts = [len(hdr).to_bytes(4, "little"), hdr]
    for span in spans:
        for a in span:
            parts.append(np.ascontiguousarray(a).tobytes())
    return b"".join(parts)


def unpack_kv_spans(buf) -> List[Tuple[np.ndarray, ...]]:
    """Inverse of :func:`pack_kv_spans`. Accepts bytes or a memoryview
    (e.g. the zero-copy arena view ``ray_tpu_torch.get`` returns) and hands
    back ``np.frombuffer`` views into it — no copy until the engine's
    one host->device put. Quantized payloads come back as the same
    4-tuples the exporter produced; ``import_kv_blocks`` accepts either
    form on either engine (host re/de-quantization bridges mixed-mode
    tiers)."""
    mv = memoryview(buf)
    hlen = int.from_bytes(mv[:4], "little")
    meta = msgpack.unpackb(bytes(mv[4:4 + hlen]), raw=False)
    n = int(meta["n"])
    if n == 0:
        return []
    shape = tuple(int(s) for s in meta["shape"])
    if meta["dtype"] == "bfloat16":
        import ml_dtypes  # noqa: F401  (registers numpy's "bfloat16")
    dtype = np.dtype(meta["dtype"])
    span_bytes = dtype.itemsize * int(np.prod(shape))
    off = 4 + hlen

    def take(nbytes, dt, shp):
        nonlocal off
        a = np.frombuffer(mv[off:off + nbytes], dt).reshape(shp)
        off += nbytes
        return a

    spans = []
    if meta.get("quant") == "int8":
        sshape = tuple(int(s) for s in meta["sshape"])
        sdtype = np.dtype(meta["sdtype"])
        sbytes = sdtype.itemsize * int(np.prod(sshape))
        for _ in range(n):
            spans.append((take(span_bytes, dtype, shape),
                          take(span_bytes, dtype, shape),
                          take(sbytes, sdtype, sshape),
                          take(sbytes, sdtype, sshape)))
        return spans
    for _ in range(n):
        spans.append((take(span_bytes, dtype, shape),
                      take(span_bytes, dtype, shape)))
    return spans


# ------------------------------------------------------- payload parking
class _PayloadParking:
    """An exported payload's ref travels to the importer inside a return
    value; the object lives only while its owner (this exporter) holds a
    ref. So an exporter parks the refs of its last few exports: an
    importer fetches within its hand-off timeout, long before a payload
    leaves this window."""

    def __init__(self, n: int = 8):
        self._refs: "collections.deque" = collections.deque(maxlen=n)
        self._lock = threading.Lock()

    def put(self, payload: bytes):
        """Put one framed payload into the store and hold its ref."""
        import ray_tpu_torch
        ref = ray_tpu_torch.put(payload)
        with self._lock:
            self._refs.append(ref)
        return ref


# --------------------------------------------------- summary publication
class PrefixSummaryPublisher:
    """Background publisher of one replica's trie summary into the GCS
    ``prefix_summaries`` table (cadence ``cfg.prefix_summary_interval_s``;
    rows expire after ``cfg.prefix_summary_ttl_s`` so a dead replica
    falls out of routing within one TTL). No-op outside a cluster
    (direct instantiation in tests) — start() simply doesn't spawn the
    thread when there is no runtime context to publish under."""

    def __init__(self, engine, deployment: str):
        self._engine = engine
        self._deployment = deployment
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.published = 0

    def start(self) -> "PrefixSummaryPublisher":
        if self._engine.prefix_cache is None:
            return self
        try:
            import ray_tpu_torch
            rid = ray_tpu_torch.get_runtime_context().get("actor_id")
        except Exception:
            return self
        if not rid:
            return self
        self._rid = rid
        self._thread = threading.Thread(
            target=self._loop, name="prefix-summary-pub", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        import ray_tpu_torch
        while not self._stop.wait(cfg.prefix_summary_interval_s):
            cache = self._engine.prefix_cache
            if cache is None or self._engine._stop:
                return   # engine retired: let the GCS row TTL out
            try:
                s = cache.summary(cfg.prefix_summary_top_k)
                ray_tpu_torch._get_worker().gcs_call(
                    "publish_prefix_summary", replica_id=self._rid,
                    fps=s["fps"], chunk=s["chunk"], blocks=s["blocks"],
                    deployment=self._deployment)
                self.published += 1
            except Exception:
                # routing falls back to session hash while the GCS is
                # unreachable; the next tick retries
                logger.debug("prefix summary publish failed",
                             exc_info=True)

    def stop(self):
        self._stop.set()


# ------------------------------------------------------ peer-hint channel
# The router (serve/handle.py) may know which OTHER replica covers the
# prompt deepest (its push-updated summary cache) at the moment it
# routes somewhere else — session affinity or load broke the tie. It
# threads that knowledge through as a __serve_peer_hint kwarg; the
# replica pops it into this thread-local and the decode tier's fabric
# rung tries the hinted peer first, saving a GCS summary query on the
# hot path. Purely advisory: a wrong/stale hint just falls through to
# the summary-derived candidates.
_peer_hint = threading.local()


def set_peer_hint(hint: Optional[Dict]):
    _peer_hint.value = hint


def _pop_peer_hint() -> Optional[Dict]:
    hint = getattr(_peer_hint, "value", None)
    _peer_hint.value = None
    return hint


# ------------------------------------------------- batched hot-prefix export
class _ExportSingleFlight:
    """Exporter-side coalescing for hot prefixes (ROADMAP item 2c): K
    concurrent ``peer_export`` calls for ONE fingerprint run one
    ``export_kv_blocks`` + one ``pack_kv_spans``; followers park on the
    leader's event and share its payload. The leader also sees every
    waiter's node id, so when the audience spans >=
    ``cfg.kv_fabric_relay_min`` distinct nodes it relays the
    pinned-arena payload through the broadcast tree (binomial fan-out,
    <= log2(K)+1 hops, ``store.broadcast`` events) instead of letting K
    importers pull point-to-point."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: Dict[int, Dict] = {}
        self.exports = 0     # leader runs (the "exactly 1" assertion)
        self.coalesced = 0   # follower calls served from a leader's run
        self.relays = 0      # broadcast-tree relays triggered

    def run(self, key: int, fn, node_id: Optional[str] = None,
            timeout_s: float = 10.0, relay=None) -> Dict:
        with self._lock:
            fl = self._flights.get(key)
            leader = fl is None
            if leader:
                fl = {"ev": threading.Event(), "out": None, "err": None,
                      "nodes": set([node_id] if node_id else [])}
                self._flights[key] = fl
            else:
                if node_id:
                    fl["nodes"].add(node_id)
                self.coalesced += 1
        if not leader:
            if not fl["ev"].wait(timeout_s):
                raise TimeoutError("peer export single-flight timed out")
            if fl["err"] is not None:
                raise fl["err"]
            return fl["out"]
        try:
            out = fn()
            self.exports += 1
        except Exception as e:
            with self._lock:
                self._flights.pop(key, None)
            fl["err"] = e
            fl["ev"].set()
            raise
        # snapshot the audience and retire the flight BEFORE releasing
        # waiters: late arrivals start a fresh flight (the trie is warm,
        # their export is cheap) instead of racing this one's cleanup
        with self._lock:
            self._flights.pop(key, None)
            nodes = set(fl["nodes"])
        if relay is not None:
            try:
                if relay(out, nodes):
                    self.relays += 1
            except Exception:
                # the relay is an optimization: waiters can still pull
                # the ref point-to-point over the data plane
                logger.debug("hot-prefix relay failed", exc_info=True)
        fl["out"] = out
        fl["ev"].set()
        return out
class PrefillLLMDeployment(LLMDeployment):
    """Prefill-tier replica: fills KV blocks, never decodes for clients.

    ``prefill_export`` is the tier's whole API: make sure the prompt's
    chunk-aligned prefix is cached (running chunked prefill if it is
    not), export the blocks, and hand back a pinned-arena ObjectRef the
    decode tier pulls over the data plane. The engine keeps a SMALL slot
    pool (prefill scratch + the single throwaway decode step per cold
    prompt) and a LARGE prefix block pool — the inverse of a decode
    replica's shape, which is the point of disaggregating.

    Chaos: ``rpc._maybe_inject_failure("prefill_export")`` fires at
    entry and again right before the return (the mid-export death the
    ServeReplicaKiller/PrefillExportKiller suites exercise); the decode
    tier treats any failure as "fall back to local prefill"."""

    def __init__(self, model="llama-debug", *, n_slots: int = 2,
                 prefix_cache_slots: int = 8, **kw):
        if prefix_cache_slots <= 0:
            raise ValueError("the prefill tier IS its prefix cache: "
                             "prefix_cache_slots must be > 0")
        super().__init__(model, n_slots=n_slots,
                         prefix_cache_slots=prefix_cache_slots, **kw)
        self._parking = _PayloadParking()
        self._publisher = PrefixSummaryPublisher(
            self.engine, type(self).__name__).start()

    def prefill_export(self, prompt_tokens,
                       max_chunks: Optional[int] = None) -> Dict:
        """Prefill (if needed) and export the KV blocks covering
        ``prompt_tokens``' chunk-aligned prefix. Returns ``{covered,
        chunk, ref}`` with the payload parked in the pinned arena —
        or ``{covered, chunk, payload}`` with inline bytes outside a
        cluster (direct instantiation in tests/benches)."""
        rpc._maybe_inject_failure("prefill_export")
        toks = [int(t) for t in prompt_tokens]
        eng = self.engine
        C = eng.config.prefill_chunk
        cap = (max(0, len(toks) - 1) // C if max_chunks is None
               else max(0, int(max_chunks)))
        span = events.start_span("serve.prefill_export", category="serve",
                                 prompt_tokens=len(toks))
        try:
            if cap and eng.prefix_cache.peek(toks) < cap * C:
                # cold prefix: one budgeted chunked-prefill pass fills
                # the blocks via the ordinary _populate_prefix path (the
                # single sampled token is discarded — this tier's decode
                # step exists only to complete the prefill lifecycle)
                h = eng.submit(toks, max_new_tokens=1)
                for _ in h:
                    pass
            covered, spans = eng.export_kv_blocks(toks, max_chunks=cap)
            payload = pack_kv_spans(spans)
            out: Dict[str, Any] = {"covered": covered, "chunk": C}
            try:
                out["ref"] = self._parking.put(payload)
            except Exception:
                # no cluster runtime (unit tier / in-process bench):
                # inline the bytes — same framing, no data plane
                out["payload"] = payload
            rpc._maybe_inject_failure("prefill_export")
            span.set(covered=covered, payload_bytes=len(payload))
            return out
        finally:
            span.end()


# ------------------------------------------------------------ decode tier
class DisaggLLMDeployment(LLMDeployment):
    """Decode-tier replica: serves streams, never runs a long prefill
    when the cluster already has the KV.

    Admission ladder per request (see module docstring): local radix
    hit -> KV hand-off from ``prefill`` -> local chunked prefill. The
    hand-off window uses the scheduler's hold state so the request
    keeps its FIFO position while blocks are in flight; every failure
    path releases the hold, so the worst case is exactly the colocated
    path. Publishes trie summaries for cluster-wide prefix routing
    (``__serve_prefix_route__`` makes the router fingerprint incoming
    prompts and route by deepest cluster match)."""

    __serve_prefix_route__ = True

    def __init__(self, model="llama-debug", *, prefill=None,
                 handoff_timeout_s: float = 10.0,
                 prefix_cache_slots: int = 4,
                 peers: Optional[Dict[str, Any]] = None,
                 summaries_fn=None, kv_fabric: Optional[bool] = None,
                 **kw):
        super().__init__(model, prefix_cache_slots=prefix_cache_slots,
                         **kw)
        self._prefill = prefill
        self._handoff_timeout_s = float(handoff_timeout_s)
        # KV fabric (ROADMAP 2b): `peers` maps replica_id -> direct
        # object and `summaries_fn` replaces the GCS summary query —
        # both injectable so the fallback-ladder tests and the fabric
        # bench segment run hermetically, mirroring _call_prefill's
        # direct-object support. In a cluster both default to the GCS.
        self._peers = peers or {}
        self._summaries_fn = summaries_fn
        self._kv_fabric = (cfg.kv_fabric_enabled if kv_fabric is None
                           else bool(kv_fabric))
        self._singleflight = _ExportSingleFlight()
        self._parking = _PayloadParking()
        self._publisher = PrefixSummaryPublisher(
            self.engine, type(self).__name__).start()
        from ray_tpu_torch.util.metrics import Counter
        self._m_handoffs = Counter(
            "serve_kv_handoffs_total",
            "prefill->decode KV hand-offs by outcome",
            tag_keys=("outcome",))
        self._m_handoff_tokens = Counter(
            "serve_kv_handoff_tokens_total",
            "prompt tokens imported via KV hand-off")
        self._m_handoff_bytes = Counter(
            "serve_kv_handoff_bytes_total",
            "KV hand-off payload bytes pulled over the data plane "
            "(int8 framing roughly halves this vs fp16)")
        self._m_fabric = Counter(
            "serve_kv_fabric_total",
            "decode->decode KV fabric events by kind (peer_ok, "
            "peer_fallback, export, stale_fp, quant_mismatch, "
            "coalesced, relayed)",
            tag_keys=("kind",))

    # ------------------------------------------------- fabric: exporter
    def peer_export(self, prompt_tokens, max_chunks: Optional[int] = None,
                    want_fp: Optional[int] = None,
                    node_id: Optional[str] = None) -> Dict:
        """Serve this replica's pinned trie blocks to a PEER decode
        replica — the decode→decode half of the cluster KV fabric. Same
        contract as ``prefill_export`` (``{covered, chunk, ref|payload}``,
        int8-or-fp framing decided by this engine's kv_quant) with two
        deliberate differences: it NEVER prefills a cold prefix (a peer
        asking for tokens we don't hold should fall to its own ladder,
        not push work here), and ``want_fp`` must prove against the LIVE
        trie — a GCS summary is a push-cadence snapshot, so it can name
        blocks evicted since publication; shipping them would install KV
        for the wrong tokens on the importer. Concurrent exports of one
        fingerprint coalesce (single-flight + broadcast-tree relay)."""
        rpc._maybe_inject_failure("peer_export")
        toks = [int(t) for t in prompt_tokens]
        eng = self.engine
        C = eng.config.prefill_chunk
        cap = (max(0, len(toks) - 1) // C if max_chunks is None
               else max(0, int(max_chunks)))
        cache = eng.prefix_cache
        if cache is None or cap == 0:
            raise LookupError("nothing to export")
        live_fp = cache.covered_fp(toks, cap)
        if live_fp is None:
            self._m_fabric.inc(tags={"kind": "stale_fp"})
            raise LookupError("prefix not cached here (stale summary?)")
        if want_fp is not None and int(live_fp) != int(want_fp):
            self._m_fabric.inc(tags={"kind": "stale_fp"})
            raise LookupError(
                f"stale fingerprint: caller wants {want_fp:#x}, live "
                f"trie covers {live_fp:#x} — blocks evicted since the "
                "last summary publish")

        def _export() -> Dict:
            span = events.start_span("serve.peer_export", category="serve",
                                     prompt_tokens=len(toks))
            try:
                covered, spans = eng.export_kv_blocks(toks, max_chunks=cap)
                if not spans:
                    raise LookupError("prefix evicted under the export")
                payload = pack_kv_spans(spans)
                out: Dict[str, Any] = {"covered": covered, "chunk": C,
                                       "fp": int(live_fp)}
                try:
                    out["ref"] = self._parking.put(payload)
                except Exception:
                    out["payload"] = payload
                self._m_fabric.inc(tags={"kind": "export"})
                span.set(covered=covered, payload_bytes=len(payload))
                return out
            finally:
                span.end()

        def _relay(out: Dict, nodes: set) -> bool:
            ref = out.get("ref")
            try:
                import ray_tpu_torch
                nodes = {n for n in nodes
                         if n and n != ray_tpu_torch.get_runtime_context()
                         .get("node_id")}
            except Exception:
                return False
            if ref is None or len(nodes) < cfg.kv_fabric_relay_min:
                return False
            # binomial fan-out over the data plane: <= log2(K)+1 hops,
            # each arrival emits store.broadcast events the edge probe
            # asserts on. After this the waiters' ray_tpu_torch.get(ref) is a
            # local-arena read.
            ray_tpu_torch.broadcast_weights(ref, node_ids=sorted(nodes))
            out["relayed"] = len(nodes)
            self._m_fabric.inc(tags={"kind": "relayed"})
            return True

        out = self._singleflight.run(
            int(live_fp), _export, node_id=node_id,
            timeout_s=self._handoff_timeout_s, relay=_relay)
        rpc._maybe_inject_failure("peer_export")
        return out

    # ------------------------------------------------- fabric: importer
    def _replica_id(self) -> Optional[str]:
        try:
            import ray_tpu_torch
            return ray_tpu_torch.get_runtime_context().get("actor_id")
        except Exception:
            return None

    def _node_id(self) -> Optional[str]:
        try:
            import ray_tpu_torch
            return ray_tpu_torch.get_runtime_context().get("node_id")
        except Exception:
            return None

    def _peer_summaries(self) -> List[Dict]:
        if self._summaries_fn is not None:
            return self._summaries_fn() or []
        import ray_tpu_torch
        return ray_tpu_torch._get_worker().gcs_call(
            "get_prefix_summaries") or []

    def _peer_candidates(self, toks: List[int], C: int, cap: int,
                         hint: Optional[Dict]
                         ) -> List[Tuple[str, Any, int]]:
        """Peers that claim to cover this prompt, deepest first:
        ``[(replica_id, callable_peer, depth_chunks)]``. The router's
        ``__serve_peer_hint`` (if any) ranks first at its claimed depth;
        the rest come from published summaries. A replica_id without an
        injected direct object resolves to a raw ActorHandle speaking
        the replica's ``handle_request`` protocol — no controller hop."""
        from ray_tpu_torch.inference.prefix_cache import chunk_fingerprints
        fps = chunk_fingerprints(toks, C, max_chunks=cap)
        if not fps:
            return []
        me = self._replica_id()
        ranked: List[Tuple[str, int]] = []
        seen = set()
        if hint and hint.get("replica_id") and hint["replica_id"] != me:
            d = min(cap, max(1, int(hint.get("depth") or 0) // C or cap))
            ranked.append((hint["replica_id"], d))
            seen.add(hint["replica_id"])
        try:
            rows = self._peer_summaries()
        except Exception:
            rows = []
        scored = []
        for row in rows:
            rid = row.get("replica_id")
            if not rid or rid == me or rid in seen:
                continue
            if int(row.get("chunk") or 0) != C:
                continue
            s = set(row.get("fps") or ())
            d = 0
            for j, fp in enumerate(fps):
                if fp in s:
                    d = j + 1
            if d:
                scored.append((d, rid))
        scored.sort(reverse=True)
        ranked.extend((rid, d) for d, rid in scored)
        out: List[Tuple[str, Any, int]] = []
        for rid, d in ranked:
            peer = self._peers.get(rid)
            if peer is None:
                try:
                    from ray_tpu_torch.actor import ActorHandle
                    peer = ActorHandle(rid, ["handle_request"])
                except Exception:
                    continue
            out.append((rid, peer, d))
        return out

    def _call_peer(self, peer, toks: List[int], max_chunks: int,
                   want_fp: Optional[int]) -> Dict:
        kw = {"max_chunks": max_chunks, "want_fp": want_fp,
              "node_id": self._node_id()}
        fn = getattr(peer, "peer_export", None)
        if fn is not None and not hasattr(fn, "remote"):
            return fn(toks, **kw)            # direct object (tests/bench)
        if fn is not None and hasattr(fn, "remote"):
            return fn.remote(toks, **kw).result(
                timeout=self._handoff_timeout_s)
        # raw replica ActorHandle: speak the replica protocol
        import ray_tpu_torch
        ref = peer.handle_request.remote("peer_export", (toks,), kw)
        return ray_tpu_torch.get(ref, timeout=self._handoff_timeout_s)

    def _import_from_peers(self, toks: List[int], C: int, want: int,
                           hint: Optional[Dict], req_span) -> int:
        """The fabric rung: try the deepest-covering peers (at most
        two) and import whatever spans arrive. Raises when no peer
        delivers — the caller falls down the ladder."""
        eng = self.engine
        cap = want // C
        cands = self._peer_candidates(toks, C, cap, hint)
        if not cands:
            raise LookupError("no peer covers this prefix")
        from ray_tpu_torch.inference.prefix_cache import chunk_fingerprints
        fps = chunk_fingerprints(toks, C, max_chunks=cap)
        last: Optional[Exception] = None
        for rid, peer, depth in cands[:2]:
            d = max(1, min(depth, cap, len(fps)))
            try:
                out = self._call_peer(peer, toks, d, fps[d - 1])
                if int(out.get("chunk") or 0) != C:
                    raise ValueError(
                        f"peer chunk={out.get('chunk')} != {C}")
                payload = self._fetch_payload(out)
                spans = unpack_kv_spans(payload)
                if (spans and len(spans[0]) == 4
                        and not getattr(eng, "_kv_quant", False)):
                    # int8 wire into an fp pool is the ONE lossy
                    # direction (dequantized blocks != fp-prefilled
                    # blocks); the fabric promises greedy bit-identical,
                    # so refuse and fall to local prefill. fp wire into
                    # an int8 pool quantizes with the save-path math and
                    # stays exact, so that direction imports.
                    self._m_fabric.inc(tags={"kind": "quant_mismatch"})
                    raise ValueError(
                        "quantized peer wire into fp pool; refusing "
                        "lossy import")
                covered = min(int(out["covered"]), len(spans) * C)
                if covered <= 0:
                    raise LookupError("peer export came back empty")
                imported = eng.import_kv_blocks(toks[:covered], spans)
                self._m_fabric.inc(tags={"kind": "peer_ok"})
                self._m_handoff_tokens.inc(max(0, imported))
                self._m_handoff_bytes.inc(len(payload))
                events.record_instant(
                    "serve.kv_fabric_import", category="serve",
                    trace_id=req_span.trace_id,
                    parent_span_id=req_span.span_id,
                    peer=rid, covered=covered, imported=imported,
                    payload_bytes=len(payload))
                return imported
            except Exception as e:
                last = e
                logger.debug("peer KV import from %s failed: %s", rid, e)
        raise last if last is not None else LookupError("no peer")

    # ------------------------------------------------------- hand-off
    def _call_prefill(self, toks: List[int]) -> Dict:
        p = self._prefill
        fn = getattr(p, "prefill_export", None)
        if fn is None:
            raise TypeError("prefill tier object has no prefill_export")
        if hasattr(fn, "remote"):       # DeploymentHandle method caller
            return fn.remote(toks).result(timeout=self._handoff_timeout_s)
        return fn(toks)                  # direct object (tests/benches)

    def _fetch_payload(self, out: Dict):
        if out.get("ref") is not None:
            import ray_tpu_torch
            # the pull lands via the data plane: recv_into straight into
            # this node's arena; the returned view needs no staging copy
            return ray_tpu_torch.get(out["ref"],
                               timeout=self._handoff_timeout_s)
        return out.get("payload")

    def _submit_request(self, prompt_tokens, max_new_tokens, temperature,
                        eos_id, deadline_s, req_span):
        eng = self.engine
        toks = [int(t) for t in prompt_tokens]
        C = eng.config.prefill_chunk
        want = (max(0, len(toks) - 1) // C) * C
        local = (eng.prefix_cache.peek(toks)
                 if eng.prefix_cache is not None else 0)
        hint = _pop_peer_hint()
        fabric = (self._kv_fabric and eng.prefix_cache is not None
                  and want > 0 and local < want)
        if ((self._prefill is None and not fabric)
                or eng.prefix_cache is None
                or want == 0 or local >= want):
            # rung 2 (local hit) or rung 5 (nothing to hand off):
            # plain colocated admission
            return super()._submit_request(
                prompt_tokens, max_new_tokens, temperature, eos_id,
                deadline_s, req_span)
        with events.trace_context(req_span.trace_id, req_span.span_id):
            handle = eng.submit(toks, max_new_tokens=max_new_tokens,
                                temperature=temperature, eos_id=eos_id,
                                deadline_s=deadline_s, hold=True)
        hspan = events.start_span(
            "serve.kv_handoff", category="serve",
            trace_id=req_span.trace_id, parent_span_id=req_span.span_id,
            prompt_tokens=len(toks), local_tokens=local)
        done = False
        try:
            # rung 3: decode→decode KV fabric — a peer replica already
            # holding the prefix serves it directly; the prefill tier
            # is no longer the only exporter in the cluster.
            if fabric:
                try:
                    imported = self._import_from_peers(toks, C, want,
                                                       hint, req_span)
                    hspan.set(source="peer", imported=imported)
                    done = True
                except Exception as e:
                    self._m_fabric.inc(tags={"kind": "peer_fallback"})
                    logger.debug("KV fabric rung failed (%s); trying "
                                 "the next rung", e)
            if not done and self._prefill is not None:
                # rung 4: the prefill tier fills cold prefixes on demand
                try:
                    out = self._call_prefill(toks)
                    if int(out.get("chunk") or 0) != C:
                        raise ValueError(
                            f"prefill tier chunk={out.get('chunk')} "
                            f"!= {C}")
                    payload = self._fetch_payload(out)
                    spans = unpack_kv_spans(payload)
                    covered = min(int(out["covered"]), len(spans) * C)
                    imported = eng.import_kv_blocks(toks[:covered], spans)
                    self._m_handoffs.inc(tags={"outcome": "ok"})
                    self._m_handoff_tokens.inc(max(0, imported))
                    self._m_handoff_bytes.inc(len(payload))
                    hspan.set(source="prefill", covered=covered,
                              imported=imported,
                              payload_bytes=len(payload))
                    done = True
                except Exception as e:
                    self._m_handoffs.inc(tags={"outcome": "fallback"})
                    logger.warning("KV hand-off failed; falling back to "
                                   "local prefill: %s", e)
                    hspan.set(error=type(e).__name__)
            if not done:
                # rung 5: local prefill. Nothing has streamed, so
                # exactly-once delivery is untouched — the request
                # simply pays the prefill it would have paid colocated.
                events.record_instant(
                    "serve.kv_handoff_fallback", category="serve",
                    trace_id=req_span.trace_id,
                    parent_span_id=req_span.span_id)
            hspan.end(ok=done)
        finally:
            eng.release_hold(handle)
        return handle


# ------------------------------------------------------------ app builder
def build_disagg_app(model="llama-debug", *, decode_replicas: int = 2,
                     prefill_replicas: int = 1,
                     prefill_kwargs: Optional[Dict] = None,
                     decode_kwargs: Optional[Dict] = None,
                     prefill_deployment_kwargs: Optional[Dict] = None,
                     decode_deployment_kwargs: Optional[Dict] = None):
    """Wire the two tiers into one Serve application graph: the decode
    tier is the ingress, bound to the prefill tier so every decode
    replica holds a handle to it. ``serve.run(build_disagg_app(...))``
    is the whole deployment story."""
    from ray_tpu_torch import serve
    prefill = serve.deployment(
        PrefillLLMDeployment, name="prefill", tier="prefill",
        num_replicas=prefill_replicas,
        **(prefill_deployment_kwargs or {})).bind(
            model, **(prefill_kwargs or {}))
    decode = serve.deployment(
        DisaggLLMDeployment, tier="decode",
        num_replicas=decode_replicas,
        **(decode_deployment_kwargs or {})).bind(
            model, prefill=prefill, **(decode_kwargs or {}))
    return decode
