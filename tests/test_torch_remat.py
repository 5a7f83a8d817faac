"""Activation recompute in ray_tpu_torch against the JAX model's remat.

The port's ``TransformerConfig.remat``/``remat_policy`` checkpoint each
block of a training forward. On the CPU: each policy's gradients against
``remat=False``; which products each policy keeps (aten ops counted in the
backward); the flash forward's calls per step against the ``pallas_call``s
in JAX's grad program under the same policy (the flash kernel is not a dot,
so both re-run it in the backward); the serving forward's freedom from
checkpointing; and JAX's error for an unknown policy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.ops.attention import flash_attention as jax_flash
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM, init_cache,
                                  init_params)
from ray_tpu_torch.models import transformer as transformer_mod
from ray_tpu_torch.ops import attention as ops
from ray_tpu_torch.parallel import adafactor, make_train_fns

B, L = 2, 32
POLICIES = ("dots", "dots_no_batch", "nothing")
JAX_POLICIES = {
    "dots": jax.checkpoint_policies.checkpoint_dots,
    "dots_no_batch":
        jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims,
    "nothing": jax.checkpoint_policies.nothing_saveable,
}


def _cfg(**kw):
    return dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=torch.float32, **kw)


def _tokens():
    vocab = MODEL_REGISTRY["llama-debug"].vocab_size
    return torch.from_numpy(
        np.random.RandomState(0).randint(0, vocab, (B, L + 1)))


@pytest.fixture(scope="module")
def weights():
    return init_params(_cfg(), torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)


class _CountProducts(TorchDispatchMode):
    """Counts aten mm and bmm calls."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(weights, **cfg_kw):
    """One forward and backward of llama-debug; returns (loss, grads,
    forward product counts, backward product counts)."""
    model = TransformerLM(_cfg(**cfg_kw), device="cpu")
    model.load_state_dict(weights)
    t = _tokens()
    fwd, bwd = _CountProducts(), _CountProducts()
    with fwd:
        logits = model(t[:, :-1])
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), t[:, 1:].reshape(-1))
    with bwd:
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), grads, fwd.counts, bwd.counts


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_no_remat(weights, policy):
    """Loss and every gradient under each policy equal those of
    ``remat=False`` exactly: the recompute runs the same CPU ops on the
    same inputs."""
    loss0, grads0, _, _ = _loss_and_grads(weights, remat=False)
    loss, grads, _, _ = _loss_and_grads(weights, remat=True,
                                        remat_policy=policy)
    assert torch.equal(loss, loss0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_keeps_the_policys_products(weights, policy):
    """The products a policy recomputes, counted as the backward's extra
    aten calls over ``remat=False``: "dots" keeps every mm and bmm (none
    recomputed), "dots_no_batch" keeps the mms and recomputes the bmms
    (the plain flash forward's two batched einsums per layer on the CPU),
    "nothing" recomputes every product of the blocks that the backward
    needs: the forward's products less the unembed (outside the blocks)
    and less each block's last product, the down projection, whose output
    no backward reads (the recompute stops once it has what the backward
    saved, as JAX's recompute drops dead code)."""
    _, _, fwd, bwd0 = _loss_and_grads(weights, remat=False)
    _, _, _, bwd = _loss_and_grads(weights, remat=True, remat_policy=policy)
    n_layers = _cfg().n_layers
    recomputed = {k: bwd[k] - bwd0[k] for k in bwd}
    want = {"dots": {"mm": 0, "bmm": 0},
            "dots_no_batch": {"mm": 0, "bmm": fwd["bmm"]},
            "nothing": {"mm": fwd["mm"] - 1 - n_layers,
                        "bmm": fwd["bmm"]}}[policy]
    assert fwd["bmm"] > 0 and fwd["mm"] > 1
    assert recomputed == want


def _count_pallas_calls(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "pallas_call"
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    n += _count_pallas_calls(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    n += _count_pallas_calls(sub)
    return n


def _jax_pallas_calls(policy) -> int:
    """pallas_calls in the grad program of JAX's flash attention (interpret
    mode, as its CPU tests run it) under ``jax.checkpoint`` with the policy
    (None: no remat)."""
    q = jnp.ones((1, 128, 2, 64), jnp.float32)
    k = jnp.ones((1, 128, 1, 64), jnp.float32)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=True, interpret=True).sum()
    if policy is not None:
        f = jax.checkpoint(f, policy=JAX_POLICIES[policy])
    return _count_pallas_calls(
        jax.make_jaxpr(jax.grad(f, argnums=(0, 1, 2)))(q, k, k).jaxpr)


@pytest.mark.parametrize("policy", (None,) + POLICIES)
def test_flash_calls_per_step_match_jax_pallas_calls(monkeypatch, policy):
    """One make_train_fns step: the port calls the flash forward once per
    layer without remat and twice under each policy, the dQ and dK/dV
    kernels once per layer, which is JAX's grad program per attention call
    (3 pallas_calls without remat, 4 with: the forward is re-run)."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for key, name in (("fwd", "flash_attention_fwd"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        def counted(*a, _fn=getattr(ops, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = _cfg(remat=policy is not None, remat_policy=policy or "dots")
    model = TransformerLM(cfg, device="meta")
    init_fn, step_fn, _ = make_train_fns(model, adafactor(1e-3),
                                         batch_shape=(B, L + 1), loss_chunk=16,
                                         device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    step_fn(state, _tokens())
    per_layer = _jax_pallas_calls(policy)
    n = cfg.n_layers
    assert calls == {"fwd": n * (per_layer - 2), "dq": n, "dkv": n}
    assert per_layer == (3 if policy is None else 4)


def test_serving_forward_does_not_checkpoint(monkeypatch, weights):
    """Without grad, or with a cache, the blocks run plainly: a forward
    with remat on never reaches ``checkpoint``."""
    def refuse(*a, **kw):
        raise AssertionError("checkpoint called")
    monkeypatch.setattr(transformer_mod, "checkpoint", refuse)
    cfg = _cfg()
    assert cfg.remat and cfg.remat_policy == "dots"
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(weights)
    t = _tokens()[:, :8]
    with torch.no_grad():
        model(t)
    with torch.inference_mode():
        model(t, cache=init_cache(cfg, B, 16, device="cpu"))
    model(t, cache=init_cache(cfg, B, 16, device="cpu"))
    with pytest.raises(AssertionError, match="checkpoint called"):
        model(t)


def test_unknown_policy_raises_as_jax():
    """The training forward refuses an unknown policy with JAX's
    ValueError, word for word."""
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], remat=True,
                               remat_policy="everything")
    with pytest.raises(ValueError) as jax_err:
        JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = TransformerLM(_cfg(remat_policy="everything"), device="meta")
    with pytest.raises(ValueError) as err:
        model(torch.zeros((1, 8), dtype=torch.long, device="meta"))
    assert str(err.value) == str(jax_err.value)
