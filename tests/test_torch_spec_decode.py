"""ray_tpu_torch's speculative decoding against ray_tpu's engine on the
CPU.

The tiny fp32 config of tests/test_torch_engine.py with the same weights
on both sides, and a smaller draft (one layer, d_model 32) whose weights
are the JAX draft's own, converted. Greedy spec-on streams equal spec-off
streams and the JAX engine's spec-on streams token for token, and the
accept counts equal JAX's, for a self-draft (the target's own weights) and
a random draft."""

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
from ray_tpu_torch.inference.spec_decode import accept_prefix
from ray_tpu_torch.models import (TransformerConfig, TransformerLM,
                                  params_from_jax)

ENGINE = dict(n_slots=2, max_len=48, prefill_chunk=4, prefill_budget=8)
SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
DRAFT = dict(vocab_size=128, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=128)


def _jax_params(shape, seed):
    model = JaxLM(JaxConfig(**shape, dtype=jnp.float32,
                            param_dtype=jnp.float32, remat=False))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _state_dict(params):
    return params_from_jax(jax.tree.map(np.asarray, meta.unbox(params)))


@pytest.fixture(scope="module")
def tiny():
    jmodel, params = _jax_params(SHAPE, 0)
    tmodel = TransformerLM(TransformerConfig(**SHAPE, dtype=torch.float32),
                           device="cpu")
    tmodel.load_state_dict(_state_dict(params))
    # a random draft, made by the JAX initialisers from a seed
    _, draft_params = _jax_params(DRAFT, 3)
    return jmodel, params, tmodel, draft_params


def _specs(tiny, which, k):
    """(JAX spec, port spec) for a self-draft or the random draft."""
    jmodel, params, tmodel, draft_params = tiny
    if which == "self":
        return ({"draft_model": jmodel.cfg, "k": k,
                 "draft_params_fn": lambda: params},
                {"draft_model": tmodel.cfg, "k": k,
                 "draft_params_fn": tmodel.state_dict})
    dcfg = TransformerConfig(**DRAFT, dtype=torch.float32)
    jcfg = JaxConfig(**DRAFT, dtype=jnp.float32, param_dtype=jnp.float32,
                     remat=False)
    return ({"draft_model": jcfg, "k": k,
             "draft_params_fn": lambda: draft_params},
            {"draft_model": dcfg, "k": k,
             "draft_params_fn": lambda: _state_dict(draft_params)})


def _jax_engine(tiny, spec=None, **kw):
    return JaxEngine(tiny[0], tiny[1], JaxEngineConfig(
        **{**ENGINE, **kw}, step_profile=False), spec=spec)


def _port_engine(tiny, spec=None, **kw):
    return InferenceEngine(tiny[2], EngineConfig(**{**ENGINE, **kw}),
                           device="cpu", spec=spec)


def _run(eng):
    """Three prompts, two at a time in the slots, one with an EOS cut, the
    third admitted into the first slot freed. (No request reaches its
    slot's capacity: there both engines may emit up to k tokens past
    max_len, into the pool's k extra positions, where spec-off stops.)
    Returns every (tokens, finish)."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, n) for n in (8, 3, 20)]
    hs = [eng.submit(prompts[0], max_new_tokens=24),
          eng.submit(prompts[1], max_new_tokens=16, eos_id=7),
          eng.submit(prompts[2], max_new_tokens=21)]
    for _ in range(400):
        eng.step()
        if all(h.finish_reason for h in hs):
            return [(h.tokens(), h.finish_reason) for h in hs]
    raise AssertionError("requests did not finish")


@pytest.mark.parametrize("which", ["self", "random"])
def test_spec_streams_and_accepts_match_jax(tiny, which):
    """k=4: spec-on tokens = spec-off tokens = the JAX engine's spec-on
    tokens, and the proposed/accepted counts equal JAX's (all accepted for
    the self-draft)."""
    jspec, tspec = _specs(tiny, which, 4)
    off = _run(_port_engine(tiny))
    jeng = _jax_engine(tiny, spec=jspec)
    want = _run(jeng)
    eng = _port_engine(tiny, spec=tspec)
    got = _run(eng)
    assert got == want
    assert got == off
    assert [len(t) for t, _ in got] == [24, 16, 21]
    st, jst = eng.stats(), jeng.stats()
    for key in ("spec_k", "spec_tokens_proposed", "spec_tokens_accepted",
                "spec_accept_rate"):
        assert st[key] == jst[key], key
    assert st["spec_tokens_proposed"] > 0
    if which == "self":
        assert st["spec_accept_rate"] == 1.0
    else:
        assert st["spec_accept_rate"] < 1.0


def test_sampled_rows_emit_one_token_per_step(tiny):
    """A row at temperature > 0 takes accept 0: one target-sampled token
    per step, beside a greedy row that keeps its spec-off stream."""
    _, tspec = _specs(tiny, "self", 3)
    eng = _port_engine(tiny, spec=tspec)
    rng = np.random.RandomState(6)
    greedy = eng.submit(rng.randint(0, 128, 6), max_new_tokens=12)
    hot = eng.submit(rng.randint(0, 128, 6), max_new_tokens=12,
                     temperature=1.0)
    steps = 0
    while not (greedy.finish_reason and hot.finish_reason):
        eng.step()
        steps += 1
    assert len(hot.tokens()) == 12 and steps >= 12
    off = _port_engine(tiny)
    h = off.submit(np.random.RandomState(6).randint(0, 128, 6),
                   max_new_tokens=12)
    while h.finish_reason is None:
        off.step()
    assert greedy.tokens() == h.tokens()
    drafts = torch.tensor([[1, 2, 3], [1, 2, 3], [1, 9, 3]])
    out = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]])
    acc = accept_prefix(drafts, out, torch.tensor([0.0, 0.5, 0.0]))
    assert acc.tolist() == [3, 0, 1]
