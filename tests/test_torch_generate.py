"""ray_tpu_torch's generator and sampling against ray_tpu's on the CPU.

Greedy generation is held token-exact against the JAX one-program
generator on the same llama-debug weights (fp32). Sampling draws its noise
from a torch.Generator, so it is held as a filter (the top-k/top-p masks
equal JAX's) and as a distribution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.models import make_generate_fn as jax_make_generate_fn
from ray_tpu.models.sampling import _apply_top_k as jax_top_k
from ray_tpu.models.sampling import _apply_top_p as jax_top_p
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM,
                                  make_generate_fn, params_from_jax,
                                  sample_logits, sample_logits_dynamic)
from ray_tpu_torch.models import sampling


def test_greedy_generate_matches_jax():
    cfg = dataclasses.replace(JAX_REGISTRY["llama-debug"],
                              dtype=jnp.float32, param_dtype=jnp.float32,
                              remat=False)
    jmodel = JaxLM(cfg)
    B, P, N = 2, 12, 6
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (B, P))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(tokens))["params"]
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    _, jgen, _ = jax_make_generate_fn(jmodel, mesh, batch=B, prompt_len=P,
                                      max_new_tokens=N)
    want = np.asarray(jgen(params, jnp.asarray(tokens),
                           jax.random.PRNGKey(7)))

    tcfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=torch.float32)
    tmodel = TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, meta.unbox(params))))
    _, gen = make_generate_fn(tmodel, batch=B, prompt_len=P,
                              max_new_tokens=N, device="cpu")
    got = gen(torch.from_numpy(tokens)).numpy()
    assert got.shape == (B, N)
    np.testing.assert_array_equal(got, want)


def test_init_fn_fills_seeded_weights():
    model = TransformerLM(MODEL_REGISTRY["llama-debug"], device="meta")
    init, gen = make_generate_fn(model, batch=1, prompt_len=4,
                                 max_new_tokens=3, device="cpu")
    init(torch.Generator().manual_seed(0))
    out = gen(torch.zeros(1, 4, dtype=torch.long))
    assert out.shape == (1, 3) and out.dtype == torch.long
    assert 0 <= int(out.min()) and int(out.max()) < model.cfg.vocab_size


def test_generate_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    model = TransformerLM(MODEL_REGISTRY["llama-debug"], device="meta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_generate_fn(model, batch=1, prompt_len=4, max_new_tokens=2)


@pytest.mark.parametrize("top_k", [0, 1, 5, 64])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3, 0.0])
def test_top_k_top_p_masks_match_jax(top_k, top_p):
    logits = np.random.RandomState(4).randn(3, 64).astype(np.float32) * 3
    want = jax_top_p(jax_top_k(jnp.asarray(logits), top_k), top_p)
    got = sampling._filtered(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy() > -1e29,
                                  np.asarray(want) > -1e29)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_takes_the_first_index_on_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    np.testing.assert_array_equal(sample_logits(logits).numpy(), [1, 0])
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)), [1, 0])


def test_sampling_distribution():
    """Gumbel-max at temperature 2 draws each token with the softmax
    probability of logits / 2: 20000 draws hold every frequency within
    0.015 (over 4 standard errors); a zero-temperature row stays greedy."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0, 0.5]] * 20000)
    g = torch.Generator().manual_seed(0)
    draws = sample_logits(logits, g, temperature=2.0)
    freq = np.bincount(draws.numpy(), minlength=5) / len(draws)
    want = torch.softmax(logits[0] / 2.0, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)
    temps = torch.zeros(20000)
    temps[::2] = 2.0
    mixed = sample_logits_dynamic(logits, g, temps)
    assert (mixed[1::2] == 2).all()
    freq = np.bincount(mixed[::2].numpy(), minlength=5) / 10000
    np.testing.assert_allclose(freq, want, atol=0.02)
    # top-k 2 at temperature: only the two largest logits are ever drawn
    top2 = sample_logits(logits[:2000], g, temperature=1.0, top_k=2)
    assert set(top2.tolist()) <= {1, 2}
