"""The MoE family through ray_tpu_torch's entry points against ray_tpu on
the CPU.

moe-debug (2 layers, 4 experts, top-2) with the JAX initialisers' weights,
converted by ``params_from_jax``, and the same numpy inputs go through
both packages: the logits (fp32 at 1e-4, bf16 at the 2e-2 relative L2 of
tests/test_torch_transformer.py), the generator's and the engine's greedy
tokens (equal, with picks dropped in a padded prefill chunk). The trainer
is held in tests/test_torch_moe_train.py. Routing is discrete: a bf16
rounding that swaps a near-tied pick moves that token by O(1), so the
bf16 comparison reports how many routing decisions agree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from ray_tpu.inference import EngineConfig as JaxEngineConfig
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.models import make_generate_fn as jax_make_generate_fn
from ray_tpu.models.moe import MoEMLP as JaxMoE
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM,
                                  make_generate_fn, params_from_jax)
from ray_tpu_torch.models.moe import capacity

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
B, L = 2, 24


def _cfgs(dtype="fp32", **kw):
    tdtype, jdtype = DTYPES[dtype]
    kw.setdefault("remat", False)
    jcfg = dataclasses.replace(JAX_REGISTRY["moe-debug"], dtype=jdtype,
                               param_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(MODEL_REGISTRY["moe-debug"], dtype=tdtype,
                               **kw)
    return jcfg, tcfg


def _tree(params):
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        meta.unbox(params))


@pytest.fixture(scope="module")
def weights():
    """moe-debug's JAX params (fp32, made once for the file) and the same
    as numpy."""
    jcfg, _ = _cfgs()
    params = jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8), jnp.int32))["params"]
    return params, _tree(params)


def _port(tree, dtype="fp32", **kw):
    _, tcfg = _cfgs(dtype, **kw)
    model = TransformerLM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _tokens(seed, shape):
    vocab = MODEL_REGISTRY["moe-debug"].vocab_size
    # ids from 1: the engine pads a prompt's last chunk with token 0
    return np.random.RandomState(seed).randint(1, vocab, shape)


def _jax_logits_and_moe_inputs(jcfg, params, tokens):
    """The JAX model's logits and each expert layer's input, captured
    (in layer order) by a method interceptor."""
    inputs = []

    def capture(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxMoE) and \
                context.method_name == "__call__":
            jax.debug.callback(
                lambda x: inputs.append(np.asarray(x, np.float32)), args[0],
                ordered=True)
        return next_fun(*args, **kwargs)
    with nn.intercept_methods(capture):
        logits = jax.jit(lambda p, t: JaxLM(jcfg).apply({"params": p}, t))(
            params, jnp.asarray(tokens))
        logits = np.asarray(logits, np.float32)
    return logits, inputs


def _port_logits_and_moe_inputs(model, tokens):
    inputs = []
    hooks = [blk.moe.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].float().numpy()))
        for blk in model.layers]
    try:
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens)).float().numpy()
    finally:
        for h in hooks:
            h.remove()
    return logits, inputs


def _routing(model, inputs):
    """(top-k experts in priority order, kept) per layer, each [B, L, K],
    for the expert layers' inputs, through the port's router (fp32)."""
    out = []
    for blk, x in zip(model.layers, inputs):
        _, _, idx, pos = blk.moe.route(torch.tensor(x))
        out.append((idx.numpy(), (pos < capacity(blk.moe.cfg,
                                                 x.shape[1])).numpy()))
    return out


def test_fp32_logits_match_jax(weights):
    params, tree = weights
    jcfg, _ = _cfgs()
    tokens = _tokens(0, (B, L))
    want, jin = _jax_logits_and_moe_inputs(jcfg, params, tokens)
    model = _port(tree)
    got, tin = _port_logits_and_moe_inputs(model, tokens)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for (ji, jk), (ti, tk) in zip(_routing(model, jin), _routing(model, tin)):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tk, jk)


def test_bf16_logits_near_jax(weights):
    """bf16 activations and weights (fp32 router and norm scales) on both
    sides, held as the dense model is: a relative L2 error of 2e-2. The
    share of (token, layer) routing decisions that agree is printed."""
    params, tree = weights
    jcfg, _ = _cfgs("bf16")
    tokens = _tokens(1, (B, L))
    want, jin = _jax_logits_and_moe_inputs(jcfg, params, tokens)
    model = _port(tree, "bf16")
    got, tin = _port_logits_and_moe_inputs(model, tokens)
    agree = [((ji == ti) & (jk == tk)).all(-1) for (ji, jk), (ti, tk) in
             zip(_routing(model, jin), _routing(model, tin))]
    share = float(np.mean(agree))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"bf16 moe-debug: routing decisions equal to JAX's {share:.4f}, "
          f"logits relative L2 {rel:.3e}")
    assert rel < 2e-2, (rel, share)


def test_greedy_generate_matches_jax(weights):
    params, tree = weights
    jcfg, _ = _cfgs()
    P, N = 12, 6
    tokens = _tokens(2, (B, P))
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    _, jgen, _ = jax_make_generate_fn(JaxLM(jcfg), mesh, batch=B,
                                      prompt_len=P, max_new_tokens=N)
    want = np.asarray(jgen(params, jnp.asarray(tokens),
                           jax.random.PRNGKey(7)))
    _, gen = make_generate_fn(_port(tree), batch=B, prompt_len=P,
                              max_new_tokens=N, device="cpu")
    np.testing.assert_array_equal(gen(torch.from_numpy(tokens)).numpy(),
                                  want)


ENGINE = dict(n_slots=2, max_len=48, prefill_chunk=8, prefill_budget=16)


def _serve(engine, prompts, new=6):
    handles = [engine.submit(p, max_new_tokens=new) for p in prompts]
    for _ in range(300):
        if all(h.finish_reason for h in handles):
            break
        engine.step()
    return [h.tokens() for h in handles]


def test_engine_greedy_streams_match_jax_with_drops(weights):
    """Capacity factor 1.0: a prefill chunk of 8 tokens gives each expert
    C = 4 slots for 16 picks, and the pads (token 0) that fill a prompt's
    last chunk take part in routing and compete for them. Prompts of 5,
    13 and 19 tokens (every last chunk padded); picks must be dropped in a
    padded chunk, and the port's streams must equal the JAX engine's."""
    params, tree = weights
    jcfg, _ = _cfgs(capacity_factor=1.0)
    prompts = [_tokens(3 + i, n) for i, n in enumerate((5, 13, 19))]
    want = _serve(JaxEngine(JaxLM(jcfg), params, JaxEngineConfig(
        **ENGINE, step_profile=False)), prompts)

    model = _port(tree, capacity_factor=1.0)
    calls = []
    model.register_forward_pre_hook(
        lambda mod, args: calls.append([args[0], 0]))

    def count_drops(mod, args, out):
        _, _, _, pos = mod.route(args[0])
        calls[-1][1] += int((pos >= capacity(mod.cfg, args[0].shape[1]))
                            .sum())
    for blk in model.layers:
        blk.moe.register_forward_hook(count_drops)
    got = _serve(InferenceEngine(model, EngineConfig(**ENGINE),
                                 device="cpu"), prompts)
    assert got == want
    padded = [d for toks, d in calls
              if toks.shape[1] == ENGINE["prefill_chunk"] and toks[0, -1] == 0]
    # every prompt's last chunk is padded (a budget cut may pad another)
    assert len(padded) >= len(prompts) and max(padded) > 0, padded
