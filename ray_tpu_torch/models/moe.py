"""Mixture-of-Experts feed-forward: GShard/Switch-style dense dispatch.

Counterpart of ``ray_tpu/models/moe.py`` (``MoEMLP``), one device, the same
function step for step:

- the router is an fp32 [d_model, E] matrix (fp32 whatever the storage
  dtype of the other weights): ``probs = softmax(x.f32 @ router)``;
- the top K experts per token, ties to the lower index (``lax.top_k``'s
  order; slot 0 is the first choice), gates renormalised by
  max(sum, 1e-9);
- each batch row is its own dispatch group, with a capacity of
  C = max(1, ceil(capacity_factor * L * K / E)) tokens per expert; a
  pick's slot in its expert's buffer is the number of earlier picks of
  that expert counted slot-major (every token's first choice before any
  second choice), and a pick whose slot is >= C is dropped;
- one-hot combine [B, L, E, C] and dispatch (combine > 0) tensors, the
  token->expert shuffle and the combine as einsums, and the experts as
  stacked [E, d_model, d_ff] / [E, d_ff, d_model] weights in a SwiGLU,
  cast to ``cfg.dtype`` at use;
- the Switch load-balancing loss E * sum_e frac_tokens_e * mean_prob_e,
  over the picks before any drop, averaged over the batch.

The routing is integer bookkeeping and is computed exactly. Under a mesh
(``parallel.mesh``) the stacked experts are DTensors sharded over the
``expert`` axis, and the shuffle's output and the experts' output are
pinned to ``("experts", None, None, "embed")`` as the JAX module pins
them (``parallel.sharding.constrain``): between the token layout and the
experts' layout DTensor redistributes with an all-to-all. The experts'
output then goes back to the tokens' layout before the combine, where
XLA folds that into the combine itself. Without a mesh ``constrain`` is
the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _one_hot(x, n: int):
    """``F.one_hot`` as a comparison, which DTensor propagates also under
    inference mode (where ``one_hot`` decomposes into an assert that it
    has no sharding rule for)."""
    return (x[..., None] == torch.arange(n, device=x.device)).long()


def capacity(cfg, L: int) -> int:
    """Slots per expert in a dispatch group (one batch row) of L tokens."""
    return max(1, math.ceil(cfg.capacity_factor * L * cfg.expert_top_k
                            / cfg.n_experts))


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP with ``cfg.n_experts``
    experts and top-``cfg.expert_top_k`` routing. ``forward`` returns
    (out, aux)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(
            torch.empty(D, E, dtype=torch.float32, device=device))
        w = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=cfg.dtype, device=device))
        self.gate = w(E, D, Fd)
        self.up = w(E, D, Fd)
        self.down = w(E, Fd, D)

    def route(self, x):
        """x [B,L,D] -> (probs [B,L,E] fp32, gates [B,L,K] renormalised,
        idx [B,L,K] the chosen experts in priority order, pos [B,L,K] each
        pick's slot in its expert's buffer; a pick with pos >= capacity is
        dropped)."""
        K = self.cfg.expert_top_k
        B, L, _ = x.shape
        probs = torch.softmax(x.float() @ self.router, dim=-1)
        # a stable descending sort keeps the lower index first on ties
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[..., :K], idx[..., :K]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        sel = _one_hot(idx, self.cfg.n_experts)               # [B,L,K,E]
        flat = sel.transpose(1, 2).reshape(B, K * L, -1)      # slot-major
        before = flat.cumsum(1) - flat
        pos = (before.reshape(B, K, L, -1).transpose(1, 2) * sel).sum(-1)
        return probs, gates, idx, pos

    def forward(self, x):
        # imported here: the parallel package imports the model
        from ray_tpu_torch.parallel.sharding import constrain
        cfg = self.cfg
        B, L, _ = x.shape
        E, K, dt = cfg.n_experts, cfg.expert_top_k, cfg.dtype
        C = capacity(cfg, L)
        probs, gates, idx, pos = self.route(x)
        keep = pos < C
        sel = _one_hot(idx, E).to(probs.dtype)                # [B,L,K,E]
        # a dropped pick's slot is clamped into range; its gate is zeroed,
        # as jax.nn.one_hot's zero row for an index >= C leaves it out
        slot = _one_hot(pos.clamp(max=C - 1), C).to(probs.dtype)
        combine = torch.einsum("blke,blkc->blec",
                               (gates * keep)[..., None] * sel, slot)
        dispatch = (combine > 0).to(x.dtype)

        # the token->expert shuffle: under an expert-sharded mesh the
        # redistribute to the experts' layout is an all-to-all (a no-op
        # without a mesh)
        expert_in = torch.einsum("blec,bld->ebcd", dispatch, x)
        expert_in = constrain(expert_in, ("experts", None, None, "embed"))
        h = torch.einsum("ebcd,edf->ebcf", expert_in, self.gate.to(dt))
        u = torch.einsum("ebcd,edf->ebcf", expert_in, self.up.to(dt))
        expert_out = torch.einsum("ebcf,efd->ebcd", F.silu(h) * u,
                                  self.down.to(dt))
        expert_out = constrain(expert_out, ("experts", None, None, "embed"))
        # back to the tokens' layout for the combine (every expert's
        # output, the batch over the data axes): DTensor (torch 2.11)
        # cannot flatten an expert-sharded dim into the combine einsum's
        # contraction
        expert_out = constrain(expert_out, (None, "batch", None, None))
        out = torch.einsum("blec,ebcd->bld", combine.to(x.dtype), expert_out)

        frac_tokens = sel.sum((1, 2)) / (L * K)               # [B,E]
        aux = E * (frac_tokens * probs.mean(1)).sum(-1).mean()
        return out, aux
