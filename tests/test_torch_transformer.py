"""ray_tpu_torch's transformer against the JAX model on the CPU.

The same llama-debug weights (made by the JAX initialisers from a seed)
go through ``ray_tpu.models.TransformerLM`` and, converted by
``params_from_jax``, through ``ray_tpu_torch.models.TransformerLM``.
fp32 parity is held at atol = rtol = 1e-4: both compute the same fp32
arithmetic and differ only in summation order and in the libm of exp,
sin, cos and pow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.models import init_cache as jax_init_cache
from ray_tpu.models.transformer import _cache_write as jax_cache_write
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM, init_cache,
                                  init_params, params_from_jax)
from ray_tpu_torch.models.transformer import _cache_write

TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_model(dtype):
    cfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=dtype,
                              param_dtype=jnp.float32, remat=False)
    model = JaxLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, model, params


def _japply(model):
    return jax.jit(lambda params, tokens, cache=None: model.apply(
        {"params": params}, tokens, cache=cache))


@pytest.fixture(scope="module")
def models():
    cfg, jmodel, params = _jax_model(jnp.float32)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    tcfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=torch.float32)
    tmodel = TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(tree))
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 12))
    return jmodel, params, tree, tmodel, tokens


def test_state_dict_keys_and_shapes_match_the_model(models):
    _, _, tree, tmodel, _ = models
    sd = params_from_jax(tree)
    want = tmodel.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


def test_full_forward_logits_match_jax(models):
    jmodel, params, _, tmodel, tokens = models
    want = np.asarray(_japply(jmodel)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_then_decode_scalar_idx_matches_jax(models):
    """Prefill 8 tokens (one-shot path) then 4 single-token decode steps
    with a shared scalar write position."""
    jmodel, params, _, tmodel, tokens = models
    cfg = tmodel.cfg
    jc = jax_init_cache(jmodel.cfg, 2, 12, dtype=jnp.float32)
    tc = init_cache(cfg, 2, 12, device="cpu")
    japply = _japply(jmodel)
    with torch.no_grad():
        for lo, hi in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12)):
            jl, jc = japply(params, jnp.asarray(tokens[:, lo:hi]), jc)
            tl, tc = tmodel(torch.from_numpy(tokens[:, lo:hi]), cache=tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["idx"] == int(jc["idx"]) == 12
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_decode_per_slot_idx_matches_jax(models):
    """Rows at different lengths decode together through a [B] write
    position, as the engine's slot pool does."""
    jmodel, params, _, tmodel, tokens = models
    cfg = tmodel.cfg
    lens = [5, 9]
    jc = jax_init_cache(jmodel.cfg, 2, 16, dtype=jnp.float32)
    tc = init_cache(cfg, 2, 16, device="cpu")
    japply = _japply(jmodel)
    for b, n in enumerate(lens):     # fill each row's prefix separately
        jrow = jax_init_cache(jmodel.cfg, 1, 16, dtype=jnp.float32)
        _, jrow = japply(params, jnp.asarray(tokens[b:b + 1, :n]), jrow)
        jc["k"] = jc["k"].at[:, b:b + 1].set(jrow["k"])
        jc["v"] = jc["v"].at[:, b:b + 1].set(jrow["v"])
    tc["k"].copy_(torch.from_numpy(np.array(jc["k"])))
    tc["v"].copy_(torch.from_numpy(np.array(jc["v"])))
    jc["idx"] = jnp.asarray(lens, jnp.int32)
    tc["idx"] = torch.tensor(lens)
    with torch.no_grad():
        for _ in range(4):
            step = np.stack([tokens[b, int(jc["idx"][b]) % 12]
                             for b in range(2)])[:, None]
            jl, jc = japply(params, jnp.asarray(step), jc)
            tl, tc = tmodel(torch.from_numpy(step), cache=tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)


@pytest.mark.parametrize("idx", [0, 5, 7, 100, -3, [1, 6], [9, -2]])
def test_cache_write_clamps_as_xla(idx):
    """Out-of-range write positions clamp to [0, M-L] (a negative one
    first counts from the end) as JAX's dynamic_update_slice does, per row
    for a [B] position."""
    rng = np.random.RandomState(1)
    cache = rng.randn(2, 8, 2, 4).astype(np.float32)
    new = rng.randn(2, 3, 2, 4).astype(np.float32)
    jidx = jnp.asarray(idx, jnp.int32)
    want = np.asarray(jax_cache_write(jnp.asarray(cache), jnp.asarray(new),
                                      jidx))
    tidx = torch.tensor(idx) if isinstance(idx, list) else idx
    got = _cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                       tidx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_logits_near_jax():
    """bf16 weights and activations on both sides. The two round at
    different places (JAX's reference attention rounds its logits to bf16;
    the port's flash path keeps scores in fp32), so they are held to a
    relative L2 error of 2e-2: a few bf16 ulps (2**-8) over two layers."""
    cfg, jmodel, params = _jax_model(jnp.bfloat16)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    tmodel = TransformerLM(MODEL_REGISTRY["llama-debug"], device="cpu")
    tmodel.load_state_dict(params_from_jax(tree))
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 16))
    want = np.asarray(_japply(jmodel)(params, jnp.asarray(tokens)),
                      np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens)).float().numpy()
    assert got.dtype == want.dtype
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def test_init_params_seeded_with_jax_scales():
    cfg = MODEL_REGISTRY["llama-debug"]
    a = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    model = TransformerLM(cfg, device="meta")
    model.load_state_dict(a, assign=True)
    assert model.layers[0].attn.q.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
    q = a["layers.0.attn.q"].float()
    # lecun_normal: std 1/sqrt(fan_in); normal(0.02) for the embedding
    assert abs(q.std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(q.abs().max().item() * cfg.d_model ** 0.5) < 2 / 0.8796 + .01
    assert abs(a["embed"].float().std().item() - 0.02) < 1e-3


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(MODEL_REGISTRY["llama-debug"])


def test_moe_config_is_not_ported():
    """An MoE configuration builds now: every block holds the expert layer
    in place of the dense MLP (held against JAX in
    tests/test_torch_moe*.py)."""
    model = TransformerLM(MODEL_REGISTRY["moe-debug"], device="meta")
    assert all(blk.moe is not None and blk.mlp is None
               for blk in model.layers)


def test_tied_embeddings_and_fp32_logits_match_jax():
    """tie_embeddings (no unembed param: logits use the embedding) and
    logits_fp32, at the fp32 tolerance."""
    cfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=jnp.float32,
                              param_dtype=jnp.float32, remat=False,
                              tie_embeddings=True, logits_fp32=True)
    jmodel = JaxLM(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    assert "unembed" not in tree
    tcfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=torch.float32, tie_embeddings=True,
                               logits_fp32=True)
    tmodel = TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(tree))
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 10))
    want = np.asarray(_japply(jmodel)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
