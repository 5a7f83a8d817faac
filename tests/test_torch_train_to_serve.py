"""Train, checkpoint, then serve from a multi-host replica, on the port
(tests/test_train_to_serve.py's roundtrip): llama-debug in fp32 trained 2
AdamW steps in a gloo world of 4 ranks on the fsdp x tensor layout
(fsdp=2, tensor=2) from weights converted from the JAX initialisers,
saved with ``save_sharded``; a ``num_hosts=2`` ReplicaShard gang restores
it over its own 2-rank mesh (tensor=2) and serves last-position logits.
They equal the driver's forward of the trained parameters within 2e-3
(the JAX test's bound), and the JAX package's forward after the same 2
steps from the same weights within 2e-3 as well."""

import dataclasses

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from tests import torch_checkpoint_cases as cases
from tests.torch_world import World

B, L = 8, 32


def test_train_checkpoint_serve_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    from flax.core import meta

    from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from ray_tpu.models import TransformerLM as JaxLM
    from ray_tpu.parallel import MeshConfig, make_mesh
    from ray_tpu.parallel import train_step as jax_train
    from ray_tpu_torch.models import TransformerLM, params_from_jax

    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"],
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               remat=False)
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size,
                                              (B, L + 1))
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    jmodel = JaxLM(jcfg)
    init, step, _ = jax_train.make_train_fns(
        jmodel, optax.adamw(1e-3), mesh, batch_shape=(B, L + 1),
        loss_chunk=16)
    jstate = init(jax.random.PRNGKey(0))
    first = jax.tree.map(np.asarray, meta.unbox(jstate.params))
    torch.save({"tokens": tokens, "weights": params_from_jax(first)},
               tmp_path / "inputs.pt")
    with World("tests.torch_checkpoint_cases:train_and_save", 4, tmp_path,
               timeout=300) as world:
        for _ in range(2):
            jstate, _ = step(jstate, jnp.asarray(tokens))
        jref = np.asarray(jax.jit(jmodel.apply)(
            {"params": meta.unbox(jstate.params)},
            jnp.asarray([cases.PROMPT], jnp.int32)))[0, -1]
        trained = world.join()

    model = TransformerLM(cases.config("llama-debug"), device="cpu")
    model.load_state_dict(trained)
    with torch.no_grad():
        ref = model(torch.tensor([cases.PROMPT]))[0, -1].numpy()

    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
            _system_config={"serve_reconcile_period_s": 0.25})
    try:
        app = serve.deployment(
            cases.CheckpointedLM, num_hosts=2,
            ray_actor_options={"num_cpus": 1}).bind(str(tmp_path / "ckpt"))
        handle = serve.run(app, name="lm", route_prefix=None)
        got = np.asarray(handle.remote(cases.PROMPT).result(timeout=180))
    finally:
        serve.shutdown()
        rt.shutdown()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, jref, rtol=2e-3, atol=2e-3)
