"""ray_tpu_torch's prefix cache, int8 KV blocks and KV span hand-off
against ray_tpu's on the CPU.

The trie tests of tests/test_prefix_cache.py run over both the JAX
package's RadixPrefixCache and the port's copy. ``quantize_kv`` is held
bit for bit to JAX's. Then the engine, with the tiny fp32 config of
tests/test_torch_engine.py and the same weights on both sides: with the
prefix cache (full precision and int8 blocks) its greedy tokens and
``prefix_matched`` equal the JAX engine's on the same schedule, and a hit
equals the miss that populated it and a cache-less engine
(tests/test_torch_kv_spans.py moves the blocks between the packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.inference import EngineConfig as JaxEngineConfig
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference import kv_quant as jax_kvq
from ray_tpu.inference.prefix_cache import RadixPrefixCache as JaxCache
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import TransformerLM as JaxLM
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.inference import kv_quant as kvq
from ray_tpu_torch.inference.prefix_cache import RadixPrefixCache
from ray_tpu_torch.models import (TransformerConfig, TransformerLM,
                                  params_from_jax)

ENGINE = dict(n_slots=2, max_len=48, prefill_chunk=4, prefill_budget=8)
CACHES = pytest.mark.parametrize("cache_cls", [JaxCache, RadixPrefixCache],
                                 ids=["jax", "port"])


# ------------------------------------------------------------------ trie

@CACHES
def test_trie_insert_and_longest_match(cache_cls):
    c = cache_cls(4, 8)
    toks = list(range(40, 53))              # 13 tokens = 3 full chunks
    created = c.insert(toks)
    assert [off for off, _ in created] == [0, 4, 8]
    # longest match walks the chunk path; capped BELOW the prompt length
    m, nodes = c.match(toks)
    assert m == 12 and len(nodes) == 3      # 13 tokens: last one prefills
    c.release(nodes)
    # a 12-token prompt with the same prefix may match at most 8 (cap)
    m, nodes = c.match(toks[:12])
    assert m == 8
    c.release(nodes)
    # diverging suffix matches only the shared chunks
    m, nodes = c.match(toks[:8] + [99, 98, 97, 96, 95])
    assert m == 8
    c.release(nodes)
    # diverging FIRST chunk matches nothing
    m, nodes = c.match([99] + toks[1:])
    assert m == 0 and nodes == []
    # re-insert of cached chunks allocates nothing new
    assert c.insert(toks) == []
    # extension allocates only the new chunk
    created = c.insert(toks[:12] + [7, 7, 7, 7])
    assert [off for off, _ in created] == [12]


@CACHES
def test_trie_refcount_blocks_eviction_lru_under_pressure(cache_cls):
    c = cache_cls(2, 2)
    c.insert([1, 2])                        # block A (oldest stamp)
    c.insert([3, 4])                        # block B
    # pool exhausted: next insert must evict the LRU leaf (A)
    created = c.insert([5, 6])
    assert len(created) == 1 and c.evictions == 1
    assert c.match([1, 2, 9])[0] == 0       # A is gone
    # pin B (an in-flight request matched it): under pressure only the
    # UNPINNED leaves cycle; B survives arbitrarily many evictions
    m, pinned = c.match([3, 4, 9])
    assert m == 2
    c.insert([7, 8])                        # evicts [5,6]
    c.insert([9, 10])                       # evicts [7,8]
    assert c.evictions == 3
    assert c.match([3, 4, 1])[0] == 2       # B still matchable
    c.release(pinned)


@CACHES
def test_trie_pinned_never_evicted_explicitly(cache_cls):
    c = cache_cls(2, 1)
    c.insert([1, 2])
    m, nodes = c.match([1, 2, 3])
    assert m == 2
    # the only block is pinned: allocation for a new chunk must fail
    # (insert returns nothing) rather than reuse pinned memory
    assert c.insert([5, 6]) == []
    c.release(nodes)
    assert len(c.insert([5, 6])) == 1       # unpinned -> evictable
    assert c.evictions == 1


@CACHES
def test_trie_interior_nodes_not_evicted_before_leaves(cache_cls):
    c = cache_cls(2, 3)
    c.insert([1, 2, 3, 4, 5, 6])            # chain of 3 nodes
    # pressure: the leaf (5,6) must go first, never the root chunk
    created = c.insert([9, 9])
    assert len(created) == 1
    assert c.match([1, 2, 3, 4, 9])[0] == 4  # interior chain survives


def test_trie_walk_and_stats_match_jax():
    """The export walk (pinned, no cap, no stats) and the stats dict."""
    caches = [JaxCache(4, 8), RadixPrefixCache(4, 8)]
    toks = list(range(20))
    for c in caches:
        c.insert(toks[:12])
        c.release(c.walk(toks, 5))
        c.match(toks)
        c.match([99] * 9)
    jax_stats, port_stats = (c.stats() for c in caches)
    assert port_stats == jax_stats
    assert [len(c.walk(toks, 5)) for c in caches] == [3, 3]


# --------------------------------------------------------------- int8 KV

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact_against_jax(dtype):
    """Values, scales and the dequantized rows equal those of JAX's
    ``quantize_kv`` under jit, as the JAX engine runs it, bit for bit, with
    a zero row (scale 1.0), rows whose quotients land on .5 (round half to
    even in both) and rows that reach +-127. XLA compiles JAX's
    ``amax / 127.0`` into a multiply by fp32(1/127); the numpy variants of
    both packages divide, and agree with each other."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 4, 8).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                  # zero row
    x[0, 1, 0] = [127, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -127]
    x[1, 2, 3] = [254, 1, 3, 5, -7, 9, 253, -254]     # scale 2: odd/2
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jax.jit(jax_kvq.quantize_kv)(jx)
    q, s = kvq.quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0, 0] == 1.0 and (q[0, 0, 0] == 0).all()
    back = kvq.dequantize_kv(q, s, torch.float32)
    want = jax_kvq.dequantize_kv(jq, js, jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    # the host variants: the same numbers as JAX's own
    qn, sn = kvq.quantize_kv_np(np.asarray(jx.astype(jnp.float32)))
    jqn, jsn = jax_kvq.quantize_kv_np(np.asarray(jx.astype(jnp.float32)))
    np.testing.assert_array_equal(qn, jqn)
    np.testing.assert_array_equal(sn, jsn)
    np.testing.assert_array_equal(kvq.dequantize_kv_np(qn, sn),
                                  jax_kvq.dequantize_kv_np(jqn, jsn))
    assert kvq.int8_block_bytes_per_token(8, 128) == \
        jax_kvq.int8_block_bytes_per_token(8, 128)
    assert kvq.slot_gain(128, 2) == jax_kvq.slot_gain(128, 2)
    with pytest.raises(ValueError, match="kv_quant='fp8'"):
        kvq.check_mode("fp8")


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def tiny():
    shape = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq_len=128)
    jmodel = JaxLM(JaxConfig(**shape, dtype=jnp.float32,
                             param_dtype=jnp.float32, remat=False))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = TransformerLM(TransformerConfig(**shape, dtype=torch.float32),
                           device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, meta.unbox(params))))
    return jmodel, params, tmodel


def _jax_engine(tiny, **kw):
    jmodel, params, _ = tiny
    return JaxEngine(jmodel, params, JaxEngineConfig(
        **{**ENGINE, **kw}, step_profile=False))


def _port_engine(tiny, **kw):
    return InferenceEngine(tiny[2], EngineConfig(**{**ENGINE, **kw}),
                           device="cpu")


def _drain(eng, handle, max_steps=300):
    for _ in range(max_steps):
        eng.step()
        if handle.finish_reason is not None:
            return handle.tokens()
    raise AssertionError("request did not finish")


def _prefix_schedule(eng):
    """A miss, then the same prompt (a hit on 16 of its 17 tokens), then a
    longer prompt sharing the prefix, then two prompts in flight together
    sharing a 12-token head, the second submitted while the first decodes
    (a hit on the 12). Returns [(tokens, prefix_matched), ...]."""
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 128, 17)
    prompt2 = np.concatenate([prompt, rng.randint(0, 128, 9)])
    out = []
    for p in (prompt, prompt, prompt2):
        h = eng.submit(p, max_new_tokens=10)
        out.append((_drain(eng, h), h.prefix_matched))
    shared = rng.randint(0, 128, 12)
    first = eng.submit(np.concatenate([shared, rng.randint(0, 128, 3)]),
                       max_new_tokens=6)
    while first.first_token_t is None:
        eng.step()
    second = eng.submit(np.concatenate([shared, rng.randint(0, 128, 7)]),
                        max_new_tokens=6)
    for h in (first, second):
        out.append((_drain(eng, h), h.prefix_matched))
    return out


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefix_cache_engine_matches_jax(tiny, kv_quant):
    """Tokens and prefix_matched equal the JAX engine's on the same
    schedule, exactly; the hit equals the miss; in full precision every
    request equals a cache-less engine's (int8 blocks change the numbers
    a hit and its miss attend, so there only hit = miss is held)."""
    kw = dict(prefix_cache_slots=2, kv_quant=kv_quant)
    jeng = _jax_engine(tiny, **kw)
    want = _prefix_schedule(jeng)
    eng = _port_engine(tiny, **kw)
    got = _prefix_schedule(eng)
    assert got == want
    assert [m for _, m in got] == [0, 16, 16, 0, 12]
    assert got[1][0] == got[0][0]                      # hit == miss
    if kv_quant == "none":
        assert [t for t, _ in _prefix_schedule(_port_engine(tiny))] == \
            [t for t, _ in got]
    st, jst = eng.stats(), jeng.stats()
    assert {k: v for k, v in st.items() if k.startswith("prefix_")} == \
        {k: v for k, v in jst.items() if k.startswith("prefix_")}
    assert ("kv_quant" in st) == (kv_quant == "int8")
