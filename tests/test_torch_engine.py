"""ray_tpu_torch's continuous-batching engine against ray_tpu's on the CPU.

The tiny config of tests/test_inference_engine.py, fp32, the same weights
on both sides: greedy token streams must be equal token for token through
chunked prefill, mid-decode admission and slot reuse; held requests and
drain behave alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.inference import EngineConfig as JaxEngineConfig
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import TransformerLM as JaxLM
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import (TransformerConfig, TransformerLM,
                                  params_from_jax)

ENGINE = dict(n_slots=2, max_len=48, prefill_chunk=4, prefill_budget=8)


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


def _drive(engine, rng):
    """A fixed schedule: A admits and decodes; B arrives mid-decode; C
    queues behind two busy slots and takes the first one freed; D reuses
    a slot after C. Returns every request's (tokens, finish_reason)."""
    def run(cond, max_steps=300):
        for _ in range(max_steps):
            engine.step()
            if cond():
                return
        raise AssertionError("engine did not get there")

    prompts = [rng.randint(0, 128, n) for n in (10, 3, 7, 13)]
    a = engine.submit(prompts[0], max_new_tokens=12)
    run(lambda: a.first_token_t is not None)
    b = engine.submit(prompts[1], max_new_tokens=5)
    c = engine.submit(prompts[2], max_new_tokens=6)
    run(lambda: b.first_token_t is not None)
    assert a.finish_reason is None          # B started while A decodes
    assert c.first_token_t is None          # C waits for a free slot
    run(lambda: b.finish_reason is not None)
    d = engine.submit(prompts[3], max_new_tokens=8)
    run(lambda: all(h.finish_reason for h in (a, b, c, d)))
    return [(h.tokens(), h.finish_reason) for h in (a, b, c, d)]


def test_greedy_streams_match_jax_engine(tiny):
    jmodel, params, tmodel = tiny
    want = _drive(JaxEngine(jmodel, params, JaxEngineConfig(
        **ENGINE, step_profile=False)), np.random.RandomState(0))
    eng = InferenceEngine(tmodel, EngineConfig(**ENGINE), device="cpu")
    got = _drive(eng, np.random.RandomState(0))
    assert [len(t) for t, _ in got] == [12, 5, 6, 8]
    assert got == want
    stats = eng.stats()
    assert stats["slots_free"] == 2 and stats["tokens_generated"] > 0


def test_threaded_loop_streams_and_stops(tiny):
    _, _, tmodel = tiny
    eng = InferenceEngine(tmodel, EngineConfig(**ENGINE), device="cpu")
    eng.start()
    try:
        hs = [eng.submit(np.arange(1, 6 + i), max_new_tokens=4)
              for i in range(3)]
        outs = [[h.next(timeout=30) for _ in range(4)] for h in hs]
        assert all(len(o) == 4 for o in outs)
    finally:
        eng.stop()
    assert all(h.finish_reason == "length" for h in hs)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2, 3])


def test_a_mesh_that_is_not_one_raises_as_jax(tiny):
    """The sharded engine is ported (tests/test_torch_engine_mesh.py); a
    ``mesh`` that is not a mesh fails as the JAX engine's does."""
    jmodel, params, tmodel = tiny
    with pytest.raises(AttributeError):
        JaxEngine(jmodel, params, JaxEngineConfig(**ENGINE), mesh=object())
    with pytest.raises(AttributeError):
        InferenceEngine(tmodel, EngineConfig(**ENGINE), device="cpu",
                        mesh=object())


def test_engine_features_are_checked_as_jax(tiny):
    """Speculative decoding, the prefix cache and int8 blocks are ported
    (tests/test_torch_prefix_cache.py, tests/test_torch_spec_decode.py);
    their configuration is checked as the JAX engine checks it."""
    with pytest.raises(TypeError, match="SpecDecodeConfig or dict"):
        InferenceEngine(tiny[2], device="cpu", spec=object())
    with pytest.raises(ValueError, match="requires a draft_model"):
        InferenceEngine(tiny[2], device="cpu", spec={"k": 2})
    with pytest.raises(ValueError, match="kv_quant='fp8'"):
        InferenceEngine(tiny[2], EngineConfig(kv_quant="fp8"), device="cpu")
    eng = InferenceEngine(tiny[2], EngineConfig(
        **ENGINE, prefix_cache_slots=1, kv_quant="int8"), device="cpu")
    st = eng.stats()
    assert st["kv_quant"] == "int8"
    assert st["prefix_blocks_free"] == ENGINE["max_len"] // \
        ENGINE["prefill_chunk"]


def test_engine_default_device_is_the_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tiny[2])


def _hold_drain(eng):
    """A held request keeps its place while a later one admits past it;
    release admits it; a drain refuses new work, finishes what is in
    flight and reports drained. Returns what was observed."""
    rng = np.random.RandomState(8)
    a = eng.submit(rng.randint(0, 128, 6), max_new_tokens=5, hold=True)
    b = eng.submit(rng.randint(0, 128, 5), max_new_tokens=5)
    for _ in range(3):
        eng.step()
    seen = [a.first_token_t is None, b.first_token_t is not None,
            eng.sched.has_work()]
    eng.release_hold(a)
    eng.begin_drain()
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit([1, 2, 3])
    seen.append(eng.sched.drained())
    for _ in range(50):
        eng.step()
    seen += [eng.sched.drained(), eng.stats()["draining"]]
    return seen, a.tokens(), b.tokens()


def test_hold_release_and_drain_match_jax(tiny):
    """``submit(hold=)``/``release_hold`` and ``begin_drain`` behave as the
    JAX engine's on the same schedule."""
    jmodel, params, tmodel = tiny
    want = _hold_drain(JaxEngine(jmodel, params, JaxEngineConfig(
        **ENGINE, step_profile=False)))
    got = _hold_drain(InferenceEngine(tmodel, EngineConfig(**ENGINE),
                                      device="cpu"))
    assert got == want
    assert got[0] == [True, True, True, False, True, True]
