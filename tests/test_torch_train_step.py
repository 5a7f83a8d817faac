"""ray_tpu_torch's training step against ray_tpu's on the CPU.

The same llama-debug weights (made by the JAX initialisers from a seed,
converted by ``params_from_jax``) and the same token batch (numpy, from a
seed) go through both packages in fp32: one step's loss and every
parameter's gradient, a 3-step AdamW trajectory through ``make_train_fns``,
and the two cross-entropy functions. In fp32 both sides compute the same
arithmetic and differ in summation order and libm, so the bounds are
1e-4 relative unless a test says otherwise."""

import dataclasses
import inspect

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
from ray_tpu_torch.parallel import (adamw, chunked_cross_entropy,
                                    cross_entropy_loss, make_train_fns)

B, L = 2, 24


def _configs():
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=jnp.float32,
                               param_dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=torch.float32)
    return jcfg, tcfg


def _tokens(seed):
    vocab = MODEL_REGISTRY["llama-debug"].vocab_size
    return np.random.RandomState(seed).randint(0, vocab, (B, L + 1))


def _tree(params):
    return jax.tree.map(np.asarray, meta.unbox(params))


@pytest.fixture(scope="module")
def jax_train_fns():
    """JAX ``make_train_fns`` (AdamW(1e-3), chunk 16) on a one-device mesh,
    its initial state and that state's parameters as numpy, made once for
    the file: each JAX compile here costs seconds, so the one-step test
    takes its weights from this init."""
    jcfg, _ = _configs()
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    init, step, _ = jax_train.make_train_fns(
        JaxLM(jcfg), optax.adamw(1e-3), mesh, batch_shape=(B, L + 1),
        loss_chunk=16)
    state = init(jax.random.PRNGKey(0))
    return step, state, _tree(state.params)


def test_one_step_loss_and_every_gradient_match_jax(jax_train_fns):
    """Loss and the gradient of every parameter, with a loss mask, against
    ``jax.value_and_grad`` of the JAX ``cross_entropy_loss`` over
    ``TransformerLM.apply``; the JAX gradient tree goes through
    ``params_from_jax`` onto the port's parameter names. Gradients at
    rtol 1e-4 and atol 1e-6 (the smallest entries are ~1e-6 of the
    largest)."""
    jcfg, tcfg = _configs()
    jmodel = JaxLM(jcfg)
    tokens = _tokens(0)
    mask = np.random.RandomState(1).rand(B, L + 1) > 0.2
    _, _, params = jax_train_fns

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(tokens[:, :-1]))
        return jax_train.cross_entropy_loss(logits, jnp.asarray(tokens[:, 1:]),
                                            jnp.asarray(mask[:, 1:]))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(_tree(want_grads))

    model = TransformerLM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(_tree(params)))
    t = torch.from_numpy(tokens)
    loss, denom = cross_entropy_loss(model(t[:, :-1]), t[:, 1:],
                                     torch.from_numpy(mask[:, 1:]))
    loss.backward()
    assert float(denom) == mask[:, 1:].sum()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_three_step_trajectory_matches_jax(jax_train_fns):
    """Loss and grad_norm over 3 AdamW(1e-3) steps on one repeated batch:
    the port's make_train_fns + adamw against JAX make_train_fns +
    optax.adamw on a one-device mesh, from the same weights, with the
    chunked loss (chunk 16 over L=24 also pads the last chunk; the
    unchunked loss is held by the one-step test). rtol 1e-4."""
    jstep, jstate, params = jax_train_fns
    _, tcfg = _configs()
    sd = params_from_jax(params)

    model = TransformerLM(tcfg, device="meta")
    init_fn, step_fn, _ = make_train_fns(model, adamw(1e-3),
                                         batch_shape=(B, L + 1),
                                         loss_chunk=16, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    state.model.load_state_dict(sd)

    tokens = _tokens(2)
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        for key in ("loss", "total_loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
        assert float(m["moe_aux"]) == 0.0
    assert state.step == 3 and int(jstate.step) == 3


def test_chunked_cross_entropy_matches_jax_and_the_unchunked_loss():
    """With a mask and L=37 (not a multiple of the chunk of 16): loss and
    denom against JAX's chunked_cross_entropy, and the gradient w.r.t. h
    against JAX's and against the unchunked loss's."""
    rng = np.random.RandomState(3)
    h = rng.randn(2, 37, 32).astype(np.float32)
    unembed = rng.randn(32, 64).astype(np.float32) * 0.3
    targets = rng.randint(0, 64, (2, 37))
    mask = rng.rand(2, 37) > 0.3

    def jloss(h):
        return jax_train.chunked_cross_entropy(
            h, jnp.asarray(unembed), jnp.asarray(targets),
            jnp.asarray(mask), chunk=16)

    (want, want_denom), want_dh = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    args = (torch.from_numpy(unembed), torch.from_numpy(targets),
            torch.from_numpy(mask))
    loss, denom = chunked_cross_entropy(th, *args, chunk=16)
    (dh,) = torch.autograd.grad(loss, th)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert float(denom) == float(want_denom) == mask.sum()
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), rtol=1e-4,
                               atol=1e-7)
    th2 = torch.from_numpy(h).requires_grad_()
    full, full_denom = cross_entropy_loss(th2 @ args[0], args[1], args[2])
    (dh_full,) = torch.autograd.grad(full, th2)
    np.testing.assert_allclose(loss.item(), full.item(), rtol=1e-5)
    assert float(full_denom) == float(denom)
    torch.testing.assert_close(dh, dh_full, rtol=1e-4, atol=1e-7)


def test_bf16_cross_entropy_takes_gold_from_bf16_logits():
    """bf16 logits: logsumexp in fp32, the gold logit gathered in bf16 and
    then upcast, as JAX does, so both give the same number."""
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 8, 50).astype(np.float32) * 4
    targets = rng.randint(0, 50, (2, 8))
    want, n = jax.jit(jax_train.cross_entropy_loss)(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets))
    got, denom = cross_entropy_loss(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets))
    assert got.dtype == torch.float32 and denom == n == 16
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_has_optax_defaults_and_update():
    """``adamw`` passes optax.adamw's defaults (torch's own weight decay
    default is 1e-2) and gives optax's update: three steps on the same
    gradients, rtol 1e-6."""
    ours = inspect.signature(adamw).parameters
    theirs = inspect.signature(optax.adamw).parameters
    for name in ("b1", "b2", "eps", "weight_decay"):
        assert ours[name].default == theirs[name].default, name
    rng = np.random.RandomState(5)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = adamw(1e-2)([w])
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-2, (0.9, 0.999), 1e-8, 1e-4)
    tx = optax.adamw(1e-2)
    jw, jopt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        updates, jopt = tx.update(jnp.asarray(g), jopt, jw)
        jw = optax.apply_updates(jw, updates)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_make_train_fns_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    model = TransformerLM(MODEL_REGISTRY["llama-debug"], device="meta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_fns(model, adamw(1e-3))


def test_step_takes_only_its_batch_shape():
    model = TransformerLM(MODEL_REGISTRY["llama-debug"], device="meta")
    init_fn, step_fn, _ = make_train_fns(model, adamw(1e-3), batch_shape=(2, 9),
                                         device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match=r"\(2, 9\)"):
        step_fn(state, torch.zeros(2, 8, dtype=torch.long))
    assert state.step == 0
