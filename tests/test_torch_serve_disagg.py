"""The port's disaggregated prefill/decode plane (ray_tpu_torch/serve/
disagg.py with the prefix cache's fingerprints, the scheduler's hold
state, the GCS prefix_summaries table and the router's prefix rung):

- the cluster-free cases of tests/test_disagg_serving.py on the port:
  fingerprints and trie summaries, hold state, the summaries table, the
  router, the KV framing, engine export/import (remote-prefill greedy
  tokens equal the colocated ones), every rung of the deployment tier's
  fallback ladder (the PrefillExportKiller spec included) and the
  idle-span spill;
- against the JAX package: chunk_fingerprints bit-equal over seeded token
  lists, summary/peek/covered_fp equal after the same inserts and
  evictions, and pack_kv_spans' bytes equal for the same spans, bf16
  (2-byte ml_dtypes spans) included.

fp32 and a tiny model, on the CPU."""

import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.inference import RadixPrefixCache as JaxRadixPrefixCache
from ray_tpu.inference.prefix_cache import \
    chunk_fingerprints as jax_chunk_fingerprints
from ray_tpu.serve.disagg import pack_kv_spans as jax_pack_kv_spans
from ray_tpu_torch.inference import (EngineConfig, InferenceEngine,
                                     LLMDeployment, RadixPrefixCache,
                                     Request, Scheduler)
from ray_tpu_torch.inference.prefix_cache import chunk_fingerprints
from ray_tpu_torch.models import (TransformerConfig, TransformerLM,
                                  init_params)
from ray_tpu_torch.serve.disagg import (DisaggLLMDeployment,
                                        PrefillLLMDeployment, pack_kv_spans,
                                        unpack_kv_spans)


# --------------------------------------------------------------------------
# fingerprints + trie summary (pure host code)
# --------------------------------------------------------------------------

def test_chunk_fingerprints_rolling_and_divergence():
    toks = list(range(100, 117))            # 17 tokens, chunk 4
    fps = chunk_fingerprints(toks, 4)
    assert len(fps) == 4                    # full chunks only
    # deterministic and prefix-stable
    assert chunk_fingerprints(toks + [1, 2, 3, 4, 5], 4)[:4] == fps
    # divergence at chunk i changes fingerprints from i on
    other = list(toks)
    other[5] = 999                          # inside chunk 1
    fps3 = chunk_fingerprints(other, 4)
    assert fps3[0] == fps[0]
    assert fps3[1] != fps[1] and fps3[2] != fps[2]
    assert chunk_fingerprints(toks, 4, max_chunks=2) == fps[:2]
    assert chunk_fingerprints([1, 2], 4) == []


def test_trie_summary_matches_chunk_fingerprints_and_caps_topk():
    c = RadixPrefixCache(4, 8)
    toks = list(range(40, 52))              # 3 chunks
    c.insert(toks)
    s = c.summary()
    assert s["chunk"] == 4 and s["blocks"] == 3
    # the summary's fingerprints ARE the prompt's path fingerprints
    assert set(s["fps"]) == set(chunk_fingerprints(toks, 4))
    # top-k keeps the most recently touched nodes
    c.insert([7, 7, 7, 7])
    m, nodes = c.match(toks + [99])         # touch the whole chain
    assert m == 12
    c.release(nodes)
    top = c.summary(top_k=3)["fps"]
    assert len(top) == 3
    assert set(top) == set(chunk_fingerprints(toks, 4))


def test_peek_and_walk_semantics():
    c = RadixPrefixCache(4, 8)
    toks = list(range(10, 23))              # 13 tokens = 3 full chunks
    c.insert(toks)
    lookups0, hits0 = c.lookups, c.hits
    # peek: capped like match, but no pins, no stats
    assert c.peek(toks) == 12
    assert c.peek(toks[:12]) == 8           # cap leaves the last token
    assert c.peek([99] + toks[1:]) == 0
    assert (c.lookups, c.hits) == (lookups0, hits0)
    assert all(n.pins == 0 for n in c._root.children.values())
    # walk: uncapped up to n_chunks, PINNED, still stats-free
    nodes = c.walk(toks, 3)
    assert len(nodes) == 3 and all(n.pins == 1 for n in nodes)
    assert (c.lookups, c.hits) == (lookups0, hits0)
    c.release(nodes)
    assert all(n.pins == 0 for n in nodes)
    assert c.walk(toks, 2) and len(c.walk(toks, 0)) == 0


@pytest.mark.parametrize("seed,chunk", [(0, 1), (1, 4), (2, 16), (3, 128)])
def test_chunk_fingerprints_bit_equal_to_jax(seed, chunk):
    rng = np.random.RandomState(seed)
    for n in (0, chunk - 1, chunk, 5 * chunk + 3, 700):
        toks = [int(t) for t in rng.randint(-2 ** 31, 2 ** 31 - 1, n)]
        assert chunk_fingerprints(toks, chunk) == \
            jax_chunk_fingerprints(toks, chunk)
        assert chunk_fingerprints(toks, chunk, max_chunks=2) == \
            jax_chunk_fingerprints(toks, chunk, max_chunks=2)


def test_trie_reads_equal_jax_after_inserts_and_evictions():
    """The same inserts, matches and evictions (by block pressure) on both
    caches: equal summaries (fingerprints in the same order), peeks and
    covered fingerprints after every step."""
    rng = np.random.RandomState(7)
    ours, theirs = RadixPrefixCache(4, 6), JaxRadixPrefixCache(4, 6)
    shared = [int(t) for t in rng.randint(0, 50, 8)]
    prompts = [shared + [int(t) for t in rng.randint(0, 50, n)]
               for n in (5, 9, 13, 4, 10, 7)]

    def same():
        for top_k in (2, 128):
            assert ours.summary(top_k) == theirs.summary(top_k)
        for p in prompts:
            assert ours.peek(p) == theirs.peek(p)
            for k in range(5):
                assert ours.covered_fp(p, k) == theirs.covered_fp(p, k)
        assert ours.stats() == theirs.stats()

    for i, p in enumerate(prompts):
        assert ours.insert(p) == theirs.insert(p)
        if i % 2:
            (m, a), (m2, b) = ours.match(p), theirs.match(p)
            assert m == m2
            ours.release(a)
            theirs.release(b)
        same()
    assert ours.evictions > 2


# --------------------------------------------------------------------------
# scheduler: remote-prefill hold state
# --------------------------------------------------------------------------

def _sched(n_slots=2, budget=8):
    return Scheduler(n_slots, budget, chunk_size=4)


def test_hold_blocks_admission_until_release():
    s = _sched()
    held = s.submit(Request(tokens=np.arange(6)), hold=True)
    assert s.plan_prefill() == []           # held: not admissible
    assert not s.has_work()                 # and not spinning the loop
    assert s.release_hold(held.rid)
    assert s.has_work()
    chunks = s.plan_prefill()
    assert chunks and chunks[0].state.rid == held.rid


def test_held_request_keeps_fifo_position_but_yields_slots():
    s = _sched(n_slots=1)
    held = s.submit(Request(tokens=np.arange(4)), hold=True)
    other = s.submit(Request(tokens=np.arange(4)))
    # a later arrival admits past the held head (its KV is in flight)
    assert [c.state.rid for c in s.plan_prefill()] == [other.rid]
    s.release_hold(held.rid)
    assert s._queue[0].rid == held.rid


def test_held_request_still_reaped_on_cancel_and_release_is_idempotent():
    s = _sched()
    held = s.submit(Request(tokens=np.arange(4)), hold=True)
    held.cancel()
    assert [st.rid for st in s.reap()] == [held.rid]
    assert held.finish_reason == "cancelled"
    assert s.release_hold(held.rid) is False   # already gone


# --------------------------------------------------------------------------
# GCS prefix_summaries table: publish / read / expire
# --------------------------------------------------------------------------

def test_gcs_prefix_summary_publish_read_filter_and_expire():
    from ray_tpu_torch._private.config import cfg
    from ray_tpu_torch._private.gcs import GcsServer
    g = GcsServer()
    assert g.h_publish_prefix_summary(None, "rep-a", [1, 2, 3], 4,
                                      blocks=3, deployment="llm")
    g.h_publish_prefix_summary(None, "rep-b", [9], 4, deployment="other")
    rows = g.h_get_prefix_summaries(None)
    assert {r["replica_id"] for r in rows} == {"rep-a", "rep-b"}
    assert [r["replica_id"] for r in
            g.h_get_prefix_summaries(None, ids=["rep-a"])] == ["rep-a"]
    assert [r["replica_id"] for r in
            g.h_get_prefix_summaries(None, deployment="other")] == ["rep-b"]
    # last write wins per replica
    g.h_publish_prefix_summary(None, "rep-a", [5], 4)
    (row,) = g.h_get_prefix_summaries(None, ids=["rep-a"])
    assert row["fps"] == [5]
    # fps are bounded by the top-k knob
    big = list(range(cfg.prefix_summary_top_k + 50))
    g.h_publish_prefix_summary(None, "rep-c", big, 4)
    (row,) = g.h_get_prefix_summaries(None, ids=["rep-c"])
    assert len(row["fps"]) == cfg.prefix_summary_top_k
    # rows older than the TTL vanish at read time
    g.prefix_summaries["rep-a"]["ts"] -= cfg.prefix_summary_ttl_s + 1
    assert "rep-a" not in {r["replica_id"]
                           for r in g.h_get_prefix_summaries(None)}
    assert "rep-a" not in g.prefix_summaries
    assert g.h_publish_prefix_summary(None, "", [1], 4) is False


# --------------------------------------------------------------------------
# router: cluster longest-match vs session-hash tie-breaking
# --------------------------------------------------------------------------

def _router(n, chunk=4):
    import threading

    from ray_tpu_torch.serve.handle import _Router
    r = _Router.__new__(_Router)     # skip ctor (no long-poll client)
    r.deployment_name = "d"
    r.app_name = "a"
    r.replicas = [object() for _ in range(n)]
    r.inflight = {i: 0 for i in range(n)}
    r.shared_load = {}
    r.version = 0
    r.resumable = False
    r.coalesced = False
    r.prefix_routed = True
    r.replica_ids = [f"rep-{i}" for i in range(n)]
    r.started = [True] * n
    r._summaries = {}
    r._summary_chunk = chunk
    r._last_summary_refresh = time.monotonic() + 1e6   # never re-pull
    r.lock = threading.Lock()
    r._last_refresh = time.monotonic() + 1e6           # never refresh
    r.model_map = {}
    return r


def _set_summary(r, idx, tokens, depth, chunk=4):
    r._summaries[f"rep-{idx}"] = set(
        chunk_fingerprints(tokens, chunk, max_chunks=depth))


def test_router_routes_to_deepest_cluster_match():
    prompt = list(range(60, 77))            # 4 full chunks of 4
    r = _router(4)
    _set_summary(r, 1, prompt, depth=1)
    _set_summary(r, 3, prompt, depth=3)
    # deepest match wins regardless of load or session hash
    r.inflight = {0: 0, 1: 0, 2: 0, 3: 99}
    for s in ("sess-a", "sess-b", ""):
        idx, _ = r.pick(session_id=s, prompt_tokens=prompt)
        assert idx == 3
        r._dec(idx)


def test_router_tie_breaks_to_session_then_least_loaded():
    import zlib
    prompt = list(range(10, 27))
    r = _router(4)
    _set_summary(r, 0, prompt, depth=2)
    _set_summary(r, 2, prompt, depth=2)
    sticky2 = next(s for s in (f"s{i}" for i in range(64))
                   if zlib.crc32(str(s).encode()) % 4 == 2)
    idx, _ = r.pick(session_id=sticky2, prompt_tokens=prompt)
    assert idx == 2
    r._dec(idx)
    sticky1 = next(s for s in (f"s{i}" for i in range(64))
                   if zlib.crc32(str(s).encode()) % 4 == 1)
    r.inflight = {0: 5, 1: 0, 2: 0, 3: 0}
    idx, _ = r.pick(session_id=sticky1, prompt_tokens=prompt)
    assert idx == 2
    r._dec(idx)
    r.inflight = {0: 0, 1: 0, 2: 7, 3: 0}
    idx, _ = r.pick(prompt_tokens=prompt)
    assert idx == 0


def test_router_falls_back_to_session_hash_without_match():
    prompt = list(range(30, 47))
    r = _router(4)
    _set_summary(r, 1, list(range(200, 217)), depth=3)
    picks = {r.pick(session_id="sess-x", prompt_tokens=prompt)[0]
             for _ in range(6)}
    assert len(picks) == 1                  # sticky, not prefix-routed
    r2 = _router(2)
    _set_summary(r2, 0, prompt, depth=2)
    idx, _ = r2.pick(prompt_tokens=prompt, avoid={0})
    assert idx == 1


def test_router_short_prompt_and_disabled_flag_skip_prefix_rung():
    r = _router(3)
    _set_summary(r, 1, list(range(8)), depth=2)
    idx, _ = r.pick(session_id="s", prompt_tokens=[1, 2])
    assert idx in range(3)
    r._dec(idx)
    r.prefix_routed = False
    idx2, _ = r.pick(session_id="s", prompt_tokens=list(range(8)))
    assert idx2 == idx                      # same session-hash pick


# --------------------------------------------------------------------------
# KV payload framing
# --------------------------------------------------------------------------

def test_pack_unpack_roundtrip_and_zero_copy_views():
    rng = np.random.RandomState(3)
    shape = (2, 1, 4, 2, 8)                 # [n_layers, 1, C, Hkv, D]
    spans = [(rng.randn(*shape).astype(np.float32),
              rng.randn(*shape).astype(np.float32)) for _ in range(3)]
    out = unpack_kv_spans(pack_kv_spans(spans))
    assert len(out) == 3
    for (k, v), (k2, v2) in zip(spans, out):
        assert np.array_equal(k, k2) and np.array_equal(v, v2)
    out2 = unpack_kv_spans(memoryview(pack_kv_spans(spans)))
    assert not out2[0][0].flags.owndata     # views, not copies
    assert np.array_equal(out2[2][1], spans[2][1])
    assert unpack_kv_spans(pack_kv_spans([])) == []


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_pack_kv_spans_bytes_equal_jax(kind):
    rng = np.random.RandomState(5)
    shape = (2, 1, 4, 2, 8)

    def arr(s=shape):
        a = rng.randn(*s).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if kind == "bf16" else a
    if kind == "int8":
        spans = [(rng.randint(-127, 128, shape).astype(np.int8),
                  rng.randint(-127, 128, shape).astype(np.int8),
                  arr(shape[:-1]), arr(shape[:-1])) for _ in range(2)]
    else:
        spans = [(arr(), arr()) for _ in range(3)]
    buf = pack_kv_spans(spans)
    assert buf == jax_pack_kv_spans(spans)
    for a, b in zip(unpack_kv_spans(buf), spans):
        assert all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                   for x, y in zip(a, b))


# --------------------------------------------------------------------------
# engine: export/import parity
# --------------------------------------------------------------------------

TINY = TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq_len=128,
                         dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return init_params(TINY, torch.Generator().manual_seed(0), "cpu")


def _engine(params, **kw):
    cfg = dict(n_slots=2, max_len=48, prefill_chunk=4, prefill_budget=8,
               prefix_cache_slots=1)
    cfg.update(kw)
    model = TransformerLM(TINY, device="meta")
    model.load_state_dict(params, assign=True)
    return InferenceEngine(model, EngineConfig(**cfg), device="cpu")


def _drain(eng, handle, max_steps=300):
    for _ in range(max_steps):
        eng.step()
        if handle.finish_reason is not None:
            return handle.tokens()
    raise AssertionError("request did not finish")


def test_remote_prefill_greedy_bit_identical(params):
    """A prompt prefilled on ANOTHER engine, shipped as packed KV spans
    and imported, gives greedy output equal to the colocated path."""
    prompt = np.random.RandomState(11).randint(0, 128, 17)
    eng_co = _engine(params)
    want = _drain(eng_co, eng_co.submit(prompt, max_new_tokens=10))
    prefill = _engine(params, prefix_cache_slots=2)
    _drain(prefill, prefill.submit(prompt, max_new_tokens=1))
    covered, spans = prefill.export_kv_blocks(prompt)
    assert covered == 16 and len(spans) == 4
    assert prefill.kv_exports == 1
    decode = _engine(params, prefix_cache_slots=2)
    payload = pack_kv_spans(spans)          # the real wire framing
    imported = decode.import_kv_blocks(prompt[:covered],
                                       unpack_kv_spans(payload))
    assert imported == 16 and decode.kv_imports == 1
    h = decode.submit(prompt, max_new_tokens=10)
    assert _drain(decode, h) == want
    assert h.prefix_matched == 16           # admission skipped prefill
    assert decode.stats()["remote_prefix_tokens"] == 16
    # a redundant import of already-cached chunks is a no-op
    assert decode.import_kv_blocks(prompt[:covered],
                                   unpack_kv_spans(payload)) == 0


def test_import_partial_prefix_and_longer_prompt_reuse(params):
    rng = np.random.RandomState(12)
    shared = rng.randint(0, 128, 12)        # 3 full chunks
    prefill = _engine(params, prefix_cache_slots=2)
    _drain(prefill, prefill.submit(shared, max_new_tokens=1))
    covered, spans = prefill.export_kv_blocks(shared, max_chunks=3)
    assert covered == 12
    decode = _engine(params, prefix_cache_slots=2)
    decode.import_kv_blocks(shared, unpack_kv_spans(pack_kv_spans(spans)))
    longer = np.concatenate([shared, rng.randint(0, 128, 7)])
    eng_co = _engine(params)
    want = _drain(eng_co, eng_co.submit(longer, max_new_tokens=8))
    h = decode.submit(longer, max_new_tokens=8)
    assert _drain(decode, h) == want
    assert h.prefix_matched == 12


# --------------------------------------------------------------------------
# deployment tier: hand-off + fallback ladder
# --------------------------------------------------------------------------

TIER = dict(n_slots=2, max_len=64, prefill_chunk=4, prefill_budget=8,
            device="cpu")


def _mk_prefill(params, **kw):
    return PrefillLLMDeployment(TINY, **dict(TIER, prefix_cache_slots=2,
                                             params_fn=lambda: params, **kw))


def _mk_decode(params, prefill, **kw):
    return DisaggLLMDeployment(TINY, **dict(TIER, prefix_cache_slots=2,
                                            params_fn=lambda: params,
                                            prefill=prefill, **kw))


def _oracle(params):
    return LLMDeployment(TINY, **dict(TIER, prefix_cache_slots=0,
                                      params_fn=lambda: params))


def _stop(*deps):
    for d in deps:
        d.engine.stop()


def test_disagg_deployment_handoff_end_to_end(params):
    oracle, prefill = _oracle(params), _mk_prefill(params)
    decode = _mk_decode(params, prefill)
    try:
        prompt = list(range(50, 67))        # 17 tokens: 4 full chunks
        want = oracle.generate(prompt, max_new_tokens=10)
        assert decode.generate(prompt, max_new_tokens=10) == want
        assert prefill.engine.kv_exports >= 1
        assert decode.engine.kv_imports == 1
        assert decode.engine.remote_prefix_tokens == 16
        # second request: local hit, no new hand-off
        assert decode.generate(prompt, max_new_tokens=10) == want
        assert decode.engine.kv_imports == 1
        assert decode.engine.sched.queue_depth() == 0   # hold released
    finally:
        _stop(oracle, prefill, decode)


class _BrokenPrefill:
    def prefill_export(self, tokens):
        raise RuntimeError("prefill tier unreachable")


def test_disagg_falls_back_to_local_prefill_on_handoff_failure(params):
    oracle = _oracle(params)
    decode = _mk_decode(params, _BrokenPrefill())
    try:
        prompt = list(range(20, 37))
        want = oracle.generate(prompt, max_new_tokens=8)
        assert decode.generate(prompt, max_new_tokens=8) == want
        assert decode.engine.kv_imports == 0
        assert decode.engine.sched.queue_depth() == 0   # hold released
    finally:
        _stop(oracle, decode)


def test_prefill_export_killer_spec_forces_fallback(params):
    """With "prefill_export=1.0" armed every export dies (entry or
    pre-return) and the decode tier falls back to local prefill with
    the same output."""
    from ray_tpu_torch.util.chaos import PrefillExportKiller
    oracle, prefill = _oracle(params), _mk_prefill(params)
    decode = _mk_decode(params, prefill)
    killer = PrefillExportKiller(1.0)
    try:
        prompt = list(range(70, 87))
        want = oracle.generate(prompt, max_new_tokens=8)
        killer.arm_local()
        with pytest.raises(Exception):
            prefill.prefill_export(prompt)  # the injection really fires
        assert decode.generate(prompt, max_new_tokens=8) == want
        assert decode.engine.kv_imports == 0
    finally:
        killer.disarm_local()
        _stop(oracle, prefill, decode)


def test_prefill_export_inline_payload_contract(params):
    """Outside a cluster prefill_export inlines the payload; the
    covered/chunk fields line up with the admission cap."""
    prefill = _mk_prefill(params)
    try:
        out = prefill.prefill_export(list(range(90, 107)))   # 17 tokens
        assert out["covered"] == 16 and out["chunk"] == 4
        assert "payload" in out and out.get("ref") is None
        assert len(unpack_kv_spans(out["payload"])) == 4
    finally:
        _stop(prefill)


def test_summary_publisher_noop_outside_cluster(params):
    prefill = _mk_prefill(params)
    try:
        pub = prefill._publisher
        assert pub._thread is None and pub.published == 0
    finally:
        _stop(prefill)


# --------------------------------------------------------------------------
# span spill eligibility
# --------------------------------------------------------------------------

class _FakeSpanStore:
    """Duck-typed store for the node manager's span-spill sweep."""

    def __init__(self, spans, now=1000):
        self._spans = dict(spans)           # oid -> info dict
        self._now = now
        self.bytes_in_use = sum(s["data_size"] for s in spans.values())
        self.capacity = 100

    def list_spans(self):
        return list(self._spans)

    def object_info(self, oid):
        return self._spans.get(oid)

    def now_sec(self):
        return self._now

    def stats(self):
        return {"bytes_in_use": self.bytes_in_use,
                "capacity": self.capacity}


def _nm_with(store):
    from ray_tpu_torch._private.node_manager import NodeManager
    nm = NodeManager.__new__(NodeManager)
    nm.store = store
    nm.spilled = {}
    spilled = []

    def spill_one(oid, _os):
        info = store._spans.pop(oid, None)
        if info is None:
            return None
        spilled.append(oid)
        store.bytes_in_use -= info["data_size"]
        return info["data_size"]

    nm._spill_one = spill_one
    return nm, spilled


def _span(size=10, age=100, pins=0, sealed=True, now=1000):
    return {"data_size": size, "meta_size": 0, "pins": pins,
            "stripe": 0, "ctime_sec": now - age, "is_span": True,
            "sealed": sealed, "flags": 0}


def test_idle_unpinned_spans_spill_oldest_first_until_target():
    store = _FakeSpanStore({
        b"old": _span(size=40, age=500),
        b"mid": _span(size=40, age=100),
        b"new": _span(size=40, age=1),      # younger than the idle gate
        b"pin": _span(size=40, age=500, pins=1),
        b"raw": _span(size=40, age=500, sealed=False),
    })
    nm, spilled = _nm_with(store)
    n, freed = nm._spill_idle_spans(None, target_bytes=180)
    assert spilled == [b"old"] and n == 1 and freed == 40
    nm._spill_idle_spans(None, target_bytes=1)
    assert spilled == [b"old", b"mid"]
    assert set(store._spans) == {b"new", b"pin", b"raw"}


def test_span_spill_noop_without_spans_or_eligible_rows():
    nm, _ = _nm_with(_FakeSpanStore({}))
    assert nm._spill_idle_spans(None) == (0, 0)
    nm2, spilled2 = _nm_with(_FakeSpanStore({b"pin": _span(pins=2)}))
    assert nm2._spill_idle_spans(None) == (0, 0) and spilled2 == []


def test_list_spans_filters_spanning_objects(tmp_path):
    """The span first: a spanning allocation takes whole stripes and
    evicts what they held (so a stripe object made before it may be
    gone)."""
    from ray_tpu_torch._private.object_store import ObjectStoreClient
    store = ObjectStoreClient(path=str(tmp_path / "arena"), size=8 << 20,
                              create=True, stripes=2)
    try:
        oid_s = bytes(range(1, 21))
        store.create_spanning(oid_s, 4096)
        store.seal(oid_s)
        oid_a = bytes(range(20))
        store.create(oid_a, 128)
        store.seal(oid_a)
        assert store.list_spans() == [oid_s]
        assert sorted(store.list_objects()) == sorted([oid_a, oid_s])
    finally:
        store.close()


# --------------------------------------------------------------------------
# cluster tier: the two tiers as Serve deployments
# --------------------------------------------------------------------------

def test_disagg_app_hands_off_through_the_store(params):
    """build_disagg_app on the port's runtime: the decode replica asks the
    prefill replica for the prompt's KV, whose payload crosses the object
    store (the exporter holds its ref until the importer has read it);
    the tokens equal a colocated LLMDeployment's."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.disagg import build_disagg_app
    prompt = list(range(30, 47))            # 17 tokens: 4 full chunks
    oracle = _oracle(params)
    try:
        want = oracle.generate(prompt, max_new_tokens=8)
    finally:
        _stop(oracle)
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        tier = dict(TIER, params_fn=lambda: params, weights_key="t/disagg")
        h = serve.run(build_disagg_app(
            TINY, decode_replicas=1, prefill_replicas=1,
            prefill_kwargs=dict(tier, prefix_cache_slots=2),
            decode_kwargs=dict(tier, prefix_cache_slots=2)),
            name="disagg", route_prefix=None)
        got = list(h.options(stream=True).remote(prompt, max_new_tokens=8))
        st = h.stats.remote().result(timeout=60)
        assert got == want
        assert st["kv_imports"] == 1 and st["remote_prefix_tokens"] == 16
    finally:
        serve.shutdown()
        rt.shutdown()
