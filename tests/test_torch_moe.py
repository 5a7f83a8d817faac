"""ray_tpu_torch's expert layer and its weights against ray_tpu's on the CPU.

The same seeded inputs (numpy) and the same weights (made by the JAX
initialisers) go through ``ray_tpu.models.moe.MoEMLP`` and
``ray_tpu_torch.models.moe.MoEMLP`` at moe-debug widths (d_model 256,
d_ff 512, 4 experts, top-2), in fp32: the output, the aux loss and the
gradients with respect to the input and all four weights. Both compute
the same fp32 arithmetic and the same integer routing, so they differ only
in summation order: 1e-5 on the layer, 1e-4 relative on gradients. Then the
converter on an expert model: its state_dict and param groups against the
JAX tree, the full mixtral-8x7b parameter count on the meta device, and
the initialisers' fan-in."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.models.moe import MoEMLP as JaxMoE
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM,
                                  count_params, init_params, jax_leaf_groups,
                                  params_from_jax)
from ray_tpu_torch.models.moe import MoEMLP, capacity
from ray_tpu_torch.models.transformer import MLP

TOL = dict(rtol=1e-5, atol=1e-5)
B, L = 2, 32


def _cfgs(**kw):
    jcfg = dataclasses.replace(JAX_REGISTRY["moe-debug"], dtype=jnp.float32,
                               param_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(MODEL_REGISTRY["moe-debug"],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _layers(seed=0, **kw):
    """The JAX layer with its weights (numpy) and the port's layer loaded
    with them, and a seeded input x [B, L, d_model]."""
    jcfg, tcfg = _cfgs(**kw)
    x = np.random.RandomState(seed).randn(B, L, jcfg.d_model).astype(
        np.float32)
    jmoe = JaxMoE(jcfg)
    params = jax.tree.map(np.asarray, meta.unbox(
        jmoe.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]))
    tmoe = MoEMLP(tcfg, device="cpu")
    tmoe.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    return jmoe, params, tmoe, x


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_layer_output_and_aux_match_jax(capacity_factor):
    """At the default capacity factor and at 0.25 (C = 4 of 32 tokens' 64
    picks over 4 experts, so most picks are dropped)."""
    jmoe, params, tmoe, x = _layers(capacity_factor=capacity_factor)
    want, want_aux = jax.jit(jmoe.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tmoe(torch.from_numpy(x))
        _, _, _, pos = tmoe.route(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    dropped = int((pos >= capacity(tmoe.cfg, L)).sum())
    if capacity_factor < 1:
        assert dropped > B * L, dropped
        # a dropped token (both picks over capacity) gives a zero row
        assert (np.abs(got.numpy()).sum(-1) == 0).any()


def test_gradients_match_jax_grad():
    """d/d(x, router, gate, up, down) of sum(out * r) + aux, at a capacity
    factor of 0.5 so that some picks are dropped: the port's autograd
    against jax.grad of the JAX layer."""
    jmoe, params, tmoe, x = _layers(seed=1, capacity_factor=0.5)
    r = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def f(params, x):
        out, aux = jmoe.apply({"params": params}, x)
        return (out * r).sum() + aux
    jg_params, jg_x = jax.jit(jax.grad(f, argnums=(0, 1)))(
        params, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe(tx)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x),
                               rtol=1e-4, atol=1e-6)
    for name, p in tmoe.named_parameters():
        want = np.asarray(jg_params[name])
        scale = np.abs(want).max()
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_tied_router_picks_the_lower_expert_first():
    """With a zero router every expert has the same probability: lax.top_k
    takes experts 0 and 1, in that order, and so must the port (the order
    sets the capacity priority)."""
    jmoe, params, tmoe, x = _layers(capacity_factor=0.5)
    params["router"] = np.zeros_like(params["router"])
    with torch.no_grad():
        tmoe.router.zero_()
        _, gates, idx, _ = tmoe.route(torch.from_numpy(x))
        got, aux = tmoe(torch.from_numpy(x))
    assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()
    assert torch.equal(gates, torch.full_like(gates, 0.5))
    want, want_aux = jax.jit(jmoe.apply)({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_single_expert_equals_dense_mlp():
    """One expert, top-1, capacity factor 2: every token's gate is 1 and
    nothing is dropped, so the layer is the dense MLP on the same weights
    and its aux loss is 1 (tests/test_moe.py's check, on the port)."""
    _, tcfg = _cfgs(n_experts=1, expert_top_k=1, capacity_factor=2.0)
    moe = MoEMLP(tcfg, device="cpu")
    mlp = MLP(tcfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in list(moe.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        mlp.gate.copy_(moe.gate[0])
        mlp.up.copy_(moe.up[0])
        mlp.down.copy_(moe.down[0])
        x = torch.randn(B, L, tcfg.d_model, generator=g)
        out, aux = moe(x)
        torch.testing.assert_close(out, mlp(x), **TOL)
    assert abs(aux.item() - 1.0) < 1e-6


@pytest.fixture(scope="module")
def jax_moe_tree():
    """moe-debug's JAX param tree (numpy), made once for the file."""
    jmodel = JaxLM(dataclasses.replace(JAX_REGISTRY["moe-debug"],
                                       remat=False))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, meta.unbox(params))


def test_state_dict_and_leaf_groups_match_the_jax_tree(jax_moe_tree):
    """params_from_jax fills every parameter of an expert model (no mlp
    leaves, four moe leaves per layer), and jax_leaf_groups names each
    JAX leaf with its stacked shape, so adafactor factors them as optax."""
    tree = jax_moe_tree
    model = TransformerLM(MODEL_REGISTRY["moe-debug"], device="cpu")
    sd = params_from_jax(tree)
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].mlp is None

    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    groups = {g["name"]: g["shape"] for g in jax_leaf_groups(model)}
    assert groups == leaves
    n_grouped = sum(p.numel() for g in jax_leaf_groups(model)
                    for p in g["params"])
    assert n_grouped == count_params(model)


def test_mixtral_builds_on_meta_at_its_published_size():
    """The full model on the meta device (no memory): 46,702,792,704
    parameters, as the JAX model's eval_shape counts them."""
    model = TransformerLM(MODEL_REGISTRY["mixtral-8x7b"], device="meta")
    assert count_params(model) == 46_702_792_704
    moe = model.layers[0].moe
    assert tuple(moe.gate.shape) == (8, 4096, 14336)
    assert tuple(moe.down.shape) == (8, 14336, 4096)
    assert tuple(moe.router.shape) == (4096, 8)


def test_init_params_expert_fan_in_and_dtypes():
    """flax's lecun_normal counts a 3-D expert weight's experts in its
    fan-in (d_model * E for gate/up, d_ff * E for down); the router stays
    fp32 in every storage dtype."""
    cfg = MODEL_REGISTRY["moe-debug"]
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    for name, fan_in in (("gate", D * E), ("up", D * E), ("down", F * E),
                         ("router", D)):
        w = sd[f"layers.0.moe.{name}"]
        std = w.float().std().item() * fan_in ** 0.5
        assert abs(std - 1) < 0.05, (name, std)
        assert w.dtype == (torch.float32 if name == "router"
                           else torch.bfloat16), name
    assert "layers.0.mlp.gate" not in sd


def test_remat_dots_gradients_equal_no_remat(jax_moe_tree):
    """The expert layer's einsums reach aten as bmm, which remat "dots"
    keeps; the routing is recomputed. The gradients of a loss plus the aux
    loss must equal those of remat off exactly."""
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, MODEL_REGISTRY["moe-debug"].vocab_size, (B, L)))
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(MODEL_REGISTRY["moe-debug"],
                                  dtype=torch.float32, remat=remat,
                                  remat_policy="dots")
        model = TransformerLM(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jax_moe_tree))
        out, aux = model(tokens, return_aux=True)
        (out.logsumexp(-1).mean() + aux).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
