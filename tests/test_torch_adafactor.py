"""ray_tpu_torch's Adafactor against optax on the CPU.

``parallel.adafactor`` against ``optax.adafactor`` on a tree shaped as the
JAX model's leaves (layers stacked on a leading axis): q/o in 4-D with
head_dim 128 (factored per layer over head_dim and d_model) and with
head_dim 64 (second largest dim under 128: not factored), an embedding
with vocab > d_model (factored over rows and columns), stacked and final
norm scales (not factored), 130 stacked vectors (factored over the layer
axis), over 5 steps in fp32 and in bf16; its
signature; and the model's JAX-leaf param groups
(tests/test_torch_recipe.py runs the whole recipe against JAX)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM,
                                  jax_leaf_groups)
from ray_tpu_torch.parallel import adafactor
from ray_tpu_torch.parallel.optim import factored_dims

N_LAYERS = 2
LEAVES = {   # name: (JAX shape, stacked over layers)
    "q128": ((N_LAYERS, 256, 2, 128), True),
    "o128": ((N_LAYERS, 2, 128, 256), True),
    "q64": ((N_LAYERS, 256, 4, 64), True),
    "norm": ((N_LAYERS, 256), True),
    # 130 stacked vectors: the layer axis itself is factored
    "deep": ((130, 256), True),
    "embed": ((1024, 256), False),
    "final_norm": ((256,), False),
}
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _groups(params, dtype):
    """One param group per leaf; a stacked leaf's tensors are 2-D (or 1-D)
    per layer, as the port stores them."""
    groups = []
    for name, (shape, stacked) in LEAVES.items():
        x = torch.from_numpy(params[name]).to(dtype)
        if stacked:
            tensors = [torch.nn.Parameter(x[i].reshape(shape[1], -1)
                                          .squeeze(-1).clone())
                       for i in range(shape[0])]
        else:
            tensors = [torch.nn.Parameter(x.clone())]
        groups.append({"params": tensors, "name": name, "shape": shape,
                       "stacked": stacked})
    return groups


def _leaf(group):
    ps = [p.detach().float() for p in group["params"]]
    x = torch.stack(ps) if group["stacked"] else ps[0]
    return x.reshape(group["shape"]).numpy()


# optax's optional links: momentum (ema) and weight decay, masked off the
# embedding (optax takes a tree of booleans, the port a predicate on the
# leaf's path)
EXTRAS = {"defaults": ({}, {}),
          "momentum, weight decay": (
              dict(momentum=0.9, weight_decay_rate=1e-3,
                   weight_decay_mask=lambda name: name != "embed"),
              dict(momentum=0.9, weight_decay_rate=1e-3,
                   weight_decay_mask={k: k != "embed" for k in LEAVES}))}


@pytest.mark.parametrize("dtype,extras", [("fp32", "defaults"),
                                          ("bf16", "defaults"),
                                          ("fp32", "momentum, weight decay")])
def test_adafactor_matches_optax(dtype, extras):
    """5 steps of adafactor(1e-2) on the same gradients. fp32: every
    parameter within rtol 1e-5 and an atol of 1e-5 of its leaf's largest
    value (the entries nearest zero carry an absolute error). bf16: the
    update rounds to bf16 at each of optax's steps and XLA may fuse them
    with fp32 in between, so a parameter may land one bf16 step (2**-8 of
    its size) from optax's: within 2**-7 relative and an atol of 2**-8 of
    the leaf's largest value, on at most 10% of the entries. The second
    moments are stored in the parameters' dtype, as optax stores them, with
    optax's shapes (and, in fp32, its values to rtol 1e-5)."""
    tdtype, jdtype = DTYPES[dtype]
    rng = np.random.RandomState(0)
    params = {k: (rng.randn(*s) * 0.05).astype(np.float32)
              for k, (s, _) in LEAVES.items()}
    grads = [{k: (rng.randn(*s) * 0.01).astype(np.float32)
              for k, (s, _) in LEAVES.items()} for _ in range(5)]
    ours, theirs = EXTRAS[extras]
    tx = optax.adafactor(1e-2, **theirs)
    jp = {k: jnp.asarray(v, jdtype) for k, v in params.items()}
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    groups = _groups(params, tdtype)
    opt = adafactor(1e-2, **ours)(groups)
    for g in grads:
        updates, jstate = update({k: jnp.asarray(v, jdtype)
                                  for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for group in groups:
            x = torch.from_numpy(g[group["name"]]).to(tdtype)
            for i, p in enumerate(group["params"]):
                p.grad = (x[i] if group["stacked"] else x).reshape(p.shape)
        opt.step()
    factored = jstate[0]
    for group in groups:
        name, shape = group["name"], group["shape"]
        want = np.asarray(jp[name].astype(jnp.float32))
        got = _leaf(group)
        scale = np.abs(want).max()
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -8 * scale, err_msg=name)
            assert (got != want).mean() <= 0.1, name
        dims = factored_dims(shape, True, 128)
        st = opt.state[group["params"][0]]
        keys = ("v",) if dims is None else ("v_row", "v_col")
        assert set(st) - {"ema"} == {"step", *keys}, name
        for key in keys:
            jv = np.asarray(getattr(factored, key)[name].astype(jnp.float32))
            assert st[key].dtype == tdtype, (name, key)
            assert tuple(st[key].shape) == jv.shape, (name, key)
            if dtype == "fp32":
                np.testing.assert_allclose(st[key].numpy(), jv, rtol=1e-5,
                                           err_msg=f"{name} {key}")
        assert st["step"] == 5
    # the leaves this tree means to cover, factored or not
    assert factored_dims(LEAVES["q128"][0], True, 128) == (3, 1)
    assert factored_dims(LEAVES["o128"][0], True, 128) == (2, 3)
    assert factored_dims(LEAVES["embed"][0], True, 128) == (1, 0)
    assert factored_dims(LEAVES["q64"][0], True, 128) is None
    assert factored_dims(LEAVES["norm"][0], True, 128) is None
    assert factored_dims(LEAVES["deep"][0], True, 128) == (0, 1)


def test_adafactor_has_optax_signature_and_defaults():
    ours = inspect.signature(adafactor).parameters
    theirs = inspect.signature(optax.adafactor).parameters
    assert list(ours) == list(theirs)
    for name, p in theirs.items():
        if name == "dtype_momentum":
            assert p.default == jnp.float32
            assert ours[name].default == torch.float32
        else:
            assert ours[name].default == p.default, name


def test_jax_leaf_groups_cover_the_model_in_jax_shapes():
    """One group per leaf of the JAX param tree, with its shape, holding
    every parameter of the port's model once."""
    jcfg = JAX_REGISTRY["llama-debug"]
    shapes = jax.eval_shape(
        lambda: JaxLM(jcfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32)))["params"]
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.value.shape
                                                      if hasattr(leaf, "value")
                                                      else leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes, is_leaf=lambda x: hasattr(x, "value"))[0]}
    model = TransformerLM(MODEL_REGISTRY["llama-debug"], device="meta")
    groups = jax_leaf_groups(model)
    assert {g["name"]: g["shape"] for g in groups} == flat
    ids = [id(p) for g in groups for p in g["params"]]
    assert sorted(ids) == sorted(id(p) for p in model.parameters())
