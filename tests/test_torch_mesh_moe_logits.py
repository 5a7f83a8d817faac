"""MoE logits across expert layouts: a gloo world of 4 ranks serves
moe-debug in fp32 from the JAX initialisers' weights
(``params_from_jax``); the last-position logits of ``make_infer_fns``
with the experts 1-way (fsdp 4) and 4-way (expert 4) agree at 1e-4
(``tests/test_moe.py::test_moe_output_matches_across_expert_layouts``)
and equal the JAX model's at 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from torch.distributed.tensor import Shard

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu_torch.models import params_from_jax
from tests.torch_world import World


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("moe_logits")
    jcfg = dataclasses.replace(JAX_REGISTRY["moe-debug"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    prompt = np.random.RandomState(2).randint(0, jcfg.vocab_size, (4, 32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(prompt))
    tree = jax.tree.map(np.asarray, meta.unbox(params["params"]))
    torch.save({"model": "moe-debug", "weights": params_from_jax(tree),
                "prompt": prompt, "layouts": ["f4", "e4"]},
               work / "inputs.pt")
    with World("tests.torch_mesh_cases:serve", 4, work, timeout=300) as world:
        jlogits = np.asarray(jmodel.apply({"params": tree},
                                          jnp.asarray(prompt))[:, -1])
        got = world.join()
    return got, jlogits


def test_logits_agree_across_expert_layouts_and_with_jax(results):
    got, jlogits = results
    one, four = got["f4"]["logits"], got["e4"]["logits"]
    np.testing.assert_allclose(one.numpy(), four.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(four.numpy(), jlogits, rtol=1e-4, atol=1e-4)
    assert got["e4"]["placements"]["layers.0.moe.gate"] == (Shard(0),)
    assert got["f4"]["placements"]["layers.0.moe.gate"] == (Shard(1),)
