"""Sharded training against the JAX package on the same layout: a gloo
world of 4 ranks trains llama-debug in fp32 on fsdp 2 x tensor 2 (three
AdamW(1e-3) steps, chunked loss), from the weights that JAX's
``make_train_fns`` init gives on the same mesh over 4 host devices
(``params_from_jax``). Each step's metrics are held to JAX's sharded step
at rtol 1e-4, as ``tests/test_torch_train_step.py`` holds the one-device
step; metrics, first-step gradients and final parameters to the
single-process port at rtol 1e-4 (``assert_same_training``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta
from torch.distributed.tensor import Shard

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel import train_step as jax_train
from ray_tpu_torch.models import params_from_jax
from tests import torch_mesh_cases as cases
from tests.torch_world import World

B, L = 8, 64


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("f2t2")
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=jnp.float32,
                               param_dtype=jnp.float32, remat=False)
    mesh = make_mesh(MeshConfig(fsdp=2, tensor=2), devices=jax.devices()[:4])
    jinit, jstep, _ = jax_train.make_train_fns(
        JaxLM(jcfg), optax.adamw(1e-3), mesh, batch_shape=(B, L + 1),
        loss_chunk=16)
    jstate = jinit(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, meta.unbox(jstate.params))
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, L + 1))
    inputs = {"model": "llama-debug", "weights": params_from_jax(tree),
              "tokens": tokens}
    torch.save(inputs, work / "inputs.pt")
    with World("tests.torch_mesh_cases:train_f2t2", 4, work,
               timeout=300) as world:
        jax_metrics = []
        for _ in range(3):
            jstate, jm = jstep(jstate, jnp.asarray(tokens))
            jax_metrics.append({k: float(v) for k, v in jm.items()})
        with cases.one_thread():
            single = cases.train(("single",), inputs)["single"]
        got = world.join()
    return got["f2t2"], single, jax_metrics


def test_f2t2_matches_jax_on_the_same_layout(results):
    got, _, jax_metrics = results
    for m, jm in zip(got["metrics"], jax_metrics, strict=True):
        for key in ("loss", "total_loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-4,
                                       err_msg=key)
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]


def test_f2t2_matches_single_process(results):
    got, single, _ = results
    cases.assert_same_training(got, single)
    assert got["mesh_dims"] == ("fsdp", "tensor")
    # q [d_model, H*D]: d_model over fsdp, whole heads over tensor
    assert got["placements"]["layers.0.attn.q"] == (Shard(0), Shard(1))
