"""Sharded serving against the JAX package: a gloo world of 4 ranks
serves llama-debug in fp32 on fsdp 2 x tensor 2 from the weights JAX's
``make_infer_fns`` init gives on the same mesh over 4 host devices.
``make_infer_fns``' last-position logits are held to JAX's at rtol 1e-4,
and ``make_generate_fn(mesh=...)``'s greedy tokens (the KV cache sharded
over batch and KV heads) must equal JAX's sharded generator's
(``tests/test_generate.py::test_generate_sharded_mesh``'s layout cut to
4 devices) and the single-process port's."""

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
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel.train_step import make_infer_fns as jax_make_infer_fns
from ray_tpu_torch.models import TransformerLM, make_generate_fn
from ray_tpu_torch.models import params_from_jax
from tests import torch_mesh_cases as cases
from tests.torch_world import World

B, P, N = 8, 16, 8


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    mesh = make_mesh(MeshConfig(fsdp=2, tensor=2), devices=jax.devices()[:4])
    jinit, jinfer, _ = jax_make_infer_fns(jmodel, mesh, batch_shape=(B, P))
    params = jinit(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, meta.unbox(params)))
    prompt = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, P))
    torch.save({"model": "llama-debug", "weights": sd, "prompt": prompt,
                "layouts": ["f2t2"], "new": N}, work / "inputs.pt")
    with World("tests.torch_mesh_cases:serve", 4, work, timeout=300) as world:
        jlogits = np.asarray(jinfer(params, jnp.asarray(prompt)))
        _, jgen, _ = jax_make_generate_fn(jmodel, mesh, batch=B,
                                          prompt_len=P, max_new_tokens=N)
        jtokens = np.asarray(jgen(params, jnp.asarray(prompt),
                                  jax.random.PRNGKey(2)))
        with cases.one_thread():
            model = TransformerLM(cases.config("llama-debug"), device="cpu")
            model.load_state_dict(sd)
            _, gen = make_generate_fn(model, batch=B, prompt_len=P,
                                      max_new_tokens=N, device="cpu")
            single = gen(torch.from_numpy(prompt))
        got = world.join()["f2t2"]
    return got, jlogits, jtokens, single


def test_infer_logits_match_jax(results):
    got, jlogits, _, _ = results
    assert got["logits"].shape == (B, JAX_REGISTRY["llama-debug"].vocab_size)
    np.testing.assert_allclose(got["logits"].numpy(), jlogits, rtol=1e-4,
                               atol=1e-5)


def test_greedy_tokens_match_jax_and_single_process(results):
    got, _, jtokens, single = results
    np.testing.assert_array_equal(got["tokens"].numpy(), jtokens)
    np.testing.assert_array_equal(got["tokens"].numpy(), single.numpy())
