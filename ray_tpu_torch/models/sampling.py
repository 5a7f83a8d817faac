"""Token selection shared by the generator and the engine.

Counterpart of ``ray_tpu/models/sampling.py``. Greedy is an argmax (the
first index on ties, as ``jnp.argmax``). Sampling is Gumbel-max, as
``jax.random.categorical``, with the noise drawn from a ``torch.Generator``
(so the sampled tokens differ from JAX's; the distribution and the
top-k/top-p masks are the same). top-k and top-p filtering default off.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _apply_top_k(logits, top_k: int):
    """Keep the top_k highest logits per row; mask the rest."""
    if not top_k or top_k >= logits.shape[-1]:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
    return torch.where(logits >= kth, logits, _NEG_INF)


def _apply_top_p(logits, top_p: float):
    """Nucleus filtering: keep the smallest prefix of the probability-
    sorted vocab whose mass reaches top_p (the first token always stays)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p      # mass BEFORE the token < top_p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, _NEG_INF)


def _filtered(logits, top_k: int, top_p: float):
    return _apply_top_p(_apply_top_k(logits.float(), top_k), top_p)


def _gumbel_argmax(scaled, generator: Optional[torch.Generator]):
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0):
    """logits [..., V] -> token ids [...]. temperature <= 0 is greedy;
    otherwise sampling at that temperature after top-k/top-p filtering."""
    if not temperature or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return _gumbel_argmax(_filtered(logits, top_k, top_p) / temperature,
                          generator)


def sample_logits_dynamic(logits, generator: Optional[torch.Generator],
                          temperature, top_k: int = 0, top_p: float = 1.0):
    """logits [B, V], temperature [B] -> token ids [B]. Rows with
    temperature <= 0 take the greedy argmax, the rest sample at their own
    temperature."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    greedy = torch.argmax(logits, dim=-1)
    temp = temperature.clamp_min(1e-6)
    sampled = _gumbel_argmax(_filtered(logits, top_k, top_p) / temp[:, None],
                             generator)
    return torch.where(temperature > 0.0, sampled, greedy)
