"""The training step on one device.

Counterpart of ``ray_tpu/parallel/train_step.py`` (``make_train_fns``,
``cross_entropy_loss``, ``chunked_cross_entropy``), single device. A step
runs the model's forward under autograd (attention through the flash
kernels' ``torch.autograd.Function``: the forward kernel, then the dQ and
dK/dV kernels in the backward), the loss, ``backward``, the global norm of
the gradients and the optimizer's update. Parameters are stored in
``cfg.param_dtype`` and cast to ``cfg.dtype`` at each use, so their
gradients arrive in the parameters' dtype, as JAX's AD returns them: fp32
master weights by default, or bf16 weights and gradients with
``param_dtype=torch.bfloat16`` (the JAX bench's recipe); RMSNorm scales
stay fp32 in both. Each block runs under activation recompute as
``cfg.remat``/``cfg.remat_policy`` say. For an expert model
(``cfg.n_experts > 0``) the loss differentiated is the cross-entropy plus
``cfg.router_aux_coef`` times the expert layers' load-balancing loss, as
in the JAX step. The optimizer is built over one
param group per JAX leaf (``models.jax_leaf_groups``), which optax's
per-leaf rules (``parallel.optim.adafactor``) need.

The device mesh and its sharding rules (ROADMAP.md, Queue A item A3) and
the step profiler (item A3b) are not ported: ``make_train_fns`` takes
neither, and returns no sharding tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.convert import init_params, jax_leaf_groups
from ray_tpu_torch.models.transformer import TransformerLM


@dataclasses.dataclass
class TrainState:
    """Counterpart of the JAX ``TrainState``: the step count, and the model
    and optimizer, which hold the parameters and the optimizer's state and
    are updated in place."""
    step: int
    model: TransformerLM
    optimizer: torch.optim.Optimizer


def _nll(logits, targets):
    """Per-position negative log-likelihood: logsumexp in fp32 over the
    logits (bf16 or fp32), the gold logit gathered in the logits' dtype and
    then upcast, as JAX does."""
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return logz - gold.float()


def cross_entropy_loss(logits, targets, mask=None):
    """Mean cross-entropy of logits [B,L,V] against targets [B,L] over the
    positions ``mask`` keeps. Returns (loss, denom): denom is the number of
    positions (no mask) or max(mask.sum(), 1)."""
    nll = _nll(logits, targets)
    if mask is None:
        return nll.mean(), nll.numel()
    mask = mask.float()
    denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom, denom


def _chunk_nll_sum(h, unembed, targets, mask):
    return (_nll(h @ unembed, targets) * mask).sum()


def chunked_cross_entropy(h, unembed, targets, mask=None, chunk=256):
    """Cross-entropy over sequence chunks: the logits of one [B,chunk,V]
    block at a time, each chunk's body under activation checkpointing, so
    the backward recomputes the block's unembed product instead of keeping
    its logits and the [B,L,V] logits never exist (JAX's
    ``jax.checkpoint(nothing_saveable)`` scan body).

    h [B,L,d] final hidden states; unembed [d,V]. An L that is not a
    multiple of the chunk is padded and the pad masked. Returns
    (loss, denom) with denom = max(mask.sum(), 1)."""
    B, L, _ = h.shape
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        keep = (torch.arange(L + pad, device=h.device) < L).expand(B, -1)
        if mask is not None:
            mask = torch.cat([mask.bool(), mask.new_zeros(
                (B, pad), dtype=torch.bool)], dim=1) & keep
        else:
            mask = keep
    m = (torch.ones(targets.shape, device=h.device) if mask is None
         else mask.float())
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, L + pad, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, h[:, i:i + chunk], unembed,
            targets[:, i:i + chunk], m[:, i:i + chunk], use_reentrant=False)
    denom = m.sum().clamp_min(1.0)
    return total / denom, denom


def make_train_fns(model: TransformerLM,
                   optimizer: Callable[..., torch.optim.Optimizer],
                   batch_shape: Tuple[int, int] = (8, 512),
                   loss_chunk: Optional[int] = None, device="cuda"
                   ) -> Tuple[Callable, Callable]:
    """Returns (init_fn(generator) -> TrainState, step_fn(state, tokens,
    mask=None) -> (state, metrics)).

    ``optimizer`` is a factory over param groups (``parallel.optim.adamw``,
    ``parallel.optim.adafactor``). ``init_fn`` fills the model with seeded
    random weights in ``cfg.param_dtype`` (``convert.init_params``; norm
    scales in fp32) on ``device`` and builds the optimizer over its JAX-leaf
    param groups; a model loaded another way can be loaded after it
    (``load_state_dict`` copies into the same parameters).
    ``step_fn`` takes tokens of ``batch_shape`` [B, L+1]: inputs are
    ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, the loss mask
    ``mask[:, 1:]``. It updates the model and optimizer in place, advances
    ``state.step``, and returns the metrics ``loss`` (cross-entropy),
    ``total_loss`` (what was differentiated: for an expert model
    ``loss + cfg.router_aux_coef * moe_aux``, else ``loss``), ``moe_aux``
    (the expert layers' summed load-balancing loss, 0 for a dense model),
    ``grad_norm`` (global L2 norm of the gradients before the update) and
    ``tokens`` (the loss's denominator). ``loss_chunk`` turns on
    ``chunked_cross_entropy``.

    Unlike the JAX function it takes no mesh, sharding rules or profiler
    and returns no sharding tree (see the module docstring)."""
    dev = resolve_device(device)
    cfg = model.cfg

    def init_fn(generator: torch.Generator) -> TrainState:
        model.load_state_dict(init_params(cfg, generator, dev,
                                          dtype=cfg.param_dtype),
                              assign=True)
        return TrainState(step=0, model=model,
                          optimizer=optimizer(jax_leaf_groups(model)))

    def loss_fn(tokens, mask):
        """-> (cross-entropy, its denominator, the MoE aux loss)."""
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        tgt_mask = None if mask is None else mask[:, 1:]
        out, aux = model(inputs, return_hidden=bool(loss_chunk),
                         return_aux=True)
        if loss_chunk:
            ce, denom = chunked_cross_entropy(
                out, model.unembed_weight(), targets, tgt_mask,
                chunk=loss_chunk)
        else:
            ce, denom = cross_entropy_loss(out, targets, tgt_mask)
        return ce, denom, aux

    def step_fn(state: TrainState, tokens, mask=None):
        tokens = torch.as_tensor(tokens, device=dev)
        if tuple(tokens.shape) != tuple(batch_shape):
            raise ValueError(f"tokens {tuple(tokens.shape)}; this step "
                             f"takes {tuple(batch_shape)}")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        state.optimizer.zero_grad(set_to_none=True)
        ce, denom, aux = loss_fn(tokens, mask)
        loss = ce + cfg.router_aux_coef * aux if cfg.n_experts > 0 else ce
        loss.backward()
        gnorm = torch.nn.utils.get_total_norm(
            [p.grad for p in state.model.parameters() if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        return state, {"loss": ce.detach(), "total_loss": loss.detach(),
                       "moe_aux": aux.detach(), "grad_norm": gnorm,
                       "tokens": denom}

    return init_fn, step_fn
