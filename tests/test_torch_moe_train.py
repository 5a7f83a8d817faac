"""ray_tpu_torch's trainer on an expert model against ray_tpu's on the CPU.

moe-debug (2 layers, 4 experts, top-2) from the same weights and the same
numpy batch through the port's make_train_fns and JAX make_train_fns on a
one-device mesh, 3 steps each: the loss the trainer differentiates is the
cross-entropy plus router_aux_coef (0.01) times the expert layers' summed
load-balancing loss, reported as ``total_loss`` and ``moe_aux``. Then
adafactor on the expert layer's stacked 3-D and 4-D leaves against
optax."""

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
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM, init_params,
                                  jax_leaf_groups, params_from_jax)
from ray_tpu_torch.parallel import adafactor, adamw, make_train_fns

B, L = 2, 24
# recipe -> (torch dtype, jax dtype, port optimizer, optax optimizer, remat)
RECIPES = {
    "adamw fp32": (torch.float32, jnp.float32, adamw(1e-3),
                   optax.adamw(1e-3), False),
    "adafactor bf16": (torch.bfloat16, jnp.bfloat16, adafactor(1e-2),
                       optax.adafactor(1e-2), True),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_train_steps_match_jax(recipe):
    """adamw(1e-3) with fp32 weights and no remat, at rtol 1e-4; the JAX
    bench's recipe, bf16 weights (fp32 router and norm scales) with
    adafactor(1e-2) and remat "dots", at rtol 1e-2, the bound of
    tests/test_torch_recipe.py. loss, total_loss, moe_aux, grad_norm and
    tokens every step, then every parameter (relative L2 at the same
    bound)."""
    tdtype, jdtype, opt, jopt, remat = RECIPES[recipe]
    jcfg = dataclasses.replace(JAX_REGISTRY["moe-debug"], dtype=jdtype,
                               param_dtype=jdtype, remat=remat,
                               remat_policy="dots")
    tcfg = dataclasses.replace(MODEL_REGISTRY["moe-debug"], dtype=tdtype,
                               param_dtype=tdtype, remat=remat,
                               remat_policy="dots")
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    jinit, jstep, _ = jax_train.make_train_fns(
        JaxLM(jcfg), jopt, mesh, batch_shape=(B, L + 1), loss_chunk=16)
    jstate = jinit(jax.random.PRNGKey(0))

    def tree(params):
        return jax.tree.map(lambda x: np.asarray(x, np.float32),
                            meta.unbox(params))

    model = TransformerLM(tcfg, device="meta")
    init_fn, step_fn, _ = make_train_fns(model, opt, batch_shape=(B, L + 1),
                                         loss_chunk=16, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    state.model.load_state_dict(params_from_jax(tree(jstate.params)))
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.gate.dtype == tdtype

    tokens = np.random.RandomState(5).randint(0, tcfg.vocab_size,
                                              (B, L + 1))
    rtol = 1e-4 if tdtype == torch.float32 else 1e-2
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        for key in ("loss", "total_loss", "moe_aux", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=rtol, err_msg=key)
        np.testing.assert_allclose(
            float(m["total_loss"]),
            float(m["loss"]) + tcfg.router_aux_coef * float(m["moe_aux"]),
            rtol=1e-6)
        assert float(m["moe_aux"]) > 0
    want = params_from_jax(tree(jstate.params))
    for name, p in model.named_parameters():
        w = want[name]
        rel = ((p.detach().float() - w).norm() / w.norm()).item()
        assert rel < rtol, (name, rel)


def test_adafactor_on_expert_leaves_matches_optax():
    """optax factors a stacked expert weight [n, E, d_model, d_ff] over its
    two largest dims and leaves the router [n, d_model, E] unfactored (its
    second largest dim is under 128); the port's adafactor, over the
    model's JAX-leaf param groups, must take the same 5 steps of
    adafactor(1e-2) on the same gradients in fp32: every leaf within rtol
    1e-5 and an atol of 1e-5 of its largest value (tests/
    test_torch_adafactor.py's fp32 bound)."""
    cfg = dataclasses.replace(MODEL_REGISTRY["moe-debug"], dtype=torch.float32,
                              param_dtype=torch.float32)
    model = TransformerLM(cfg, device="meta")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"), assign=True)
    groups = jax_leaf_groups(model)

    def leaf(group):
        ps = [p.detach().reshape(group["shape"][1:] if group["stacked"]
                                 else group["shape"]) for p in group["params"]]
        return (torch.stack(ps) if group["stacked"] else ps[0]).numpy()
    jp = {g["name"]: jnp.asarray(leaf(g)) for g in groups}
    tx = optax.adafactor(1e-2)
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    opt = adafactor(1e-2)(groups)
    rng = np.random.RandomState(6)
    for _ in range(5):
        grads = {g["name"]: (rng.randn(*g["shape"]) * 0.01).astype(np.float32)
                 for g in groups}
        updates, jstate = update({k: jnp.asarray(v) for k, v in grads.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for g in groups:
            x = torch.from_numpy(grads[g["name"]])
            for i, p in enumerate(g["params"]):
                p.grad = (x[i] if g["stacked"] else x).reshape(p.shape)
        opt.step()
    moe = [g for g in groups if "/moe/" in g["name"]]
    assert {g["name"].rsplit("/", 1)[1] for g in moe} == {
        "router", "gate", "up", "down"}
    for g in groups:
        want = np.asarray(jp[g["name"]])
        np.testing.assert_allclose(leaf(g), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=g["name"])
    state = opt.state[model.layers[0].moe.gate]
    assert set(state) == {"step", "v_row", "v_col"}
    assert set(opt.state[model.layers[0].moe.router]) == {"step", "v"}
