"""The JAX bench's training recipe through ray_tpu_torch against ray_tpu
on the CPU.

bf16 (or fp32) weights with fp32 norm scales, ``adafactor``, remat "dots"
and the chunked loss, through the port's make_train_fns against JAX
make_train_fns with optax.adafactor on a one-device mesh, from the same
weights, for 3 steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel import train_step as jax_train
from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM, params_from_jax
from ray_tpu_torch.parallel import adafactor, make_train_fns

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

# the recipe at llama-debug size with head_dim 128 (2 heads over d_model
# 256, 2:1 GQA), so q, k, o and the MLP are factored per layer as at tpu-3b
B, L = 2, 24


def _recipe_configs(dtype):
    tdtype, jdtype = DTYPES[dtype]
    geometry = dict(n_heads=2, n_kv_heads=1)
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=jdtype,
                               param_dtype=jdtype, remat=True,
                               remat_policy="dots", **geometry)
    tcfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"], dtype=tdtype,
                               param_dtype=tdtype, remat=True,
                               remat_policy="dots", **geometry)
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_recipe_trajectory_matches_jax(dtype):
    """Loss and grad_norm over 3 steps of adafactor(1e-2), remat "dots",
    loss_chunk 16, on one repeated batch, from the same weights: the
    port's make_train_fns against JAX make_train_fns + optax.adafactor on
    a one-device mesh. fp32: rtol 1e-4. bf16: both compute in bf16 with
    fp32 softmax statistics, but JAX's CPU attention rounds its scores to
    bf16 where the port's flash plain version keeps them fp32, and the
    weights round at each update, so 1e-2 relative (half the bound the
    port holds its bf16 logits to against JAX; 3e-3 measured on grad_norm).
    The weights stay in their dtype (bf16 with fp32 norm scales, as in
    JAX)."""
    jcfg, tcfg = _recipe_configs(dtype)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    jinit, jstep, _ = jax_train.make_train_fns(
        JaxLM(jcfg), optax.adafactor(1e-2), mesh, batch_shape=(B, L + 1),
        loss_chunk=16)
    jstate = jinit(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        meta.unbox(jstate.params))

    model = TransformerLM(tcfg, device="meta")
    init_fn, step_fn, _ = make_train_fns(model, adafactor(1e-2),
                                         batch_shape=(B, L + 1), loss_chunk=16,
                                         device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    state.model.load_state_dict(params_from_jax(tree))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert {d for n, d in dtypes.items() if "norm" in n} == {torch.float32}
    assert {d for n, d in dtypes.items() if "norm" not in n} \
        == {tcfg.param_dtype}

    vocab = tcfg.vocab_size
    tokens = np.random.RandomState(2).randint(0, vocab, (B, L + 1))
    rtol = 1e-4 if dtype == "fp32" else 1e-2
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        for key in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=rtol, err_msg=key)
    for name, p in model.named_parameters():
        assert p.grad.dtype == p.dtype, name
    assert state.step == 3 and int(jstate.step) == 3
