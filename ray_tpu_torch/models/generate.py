"""Autoregressive generation on one device: prefill + KV-cache decode.

Counterpart of ``ray_tpu/models/generate.py`` (``make_generate_fn``),
single-device. The prompt goes through one one-shot prefill forward (the
flash-attention kernel's path), which seeds every layer's cache; then a
Python loop runs single-token decode steps against the cache. Weights
live on the model (an ``nn.Module``), not in a separate params tree.
The mesh/sharding arguments are not ported yet (ROADMAP.md, Queue A item
A3).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.sampling import sample_logits
from ray_tpu_torch.models.transformer import TransformerLM, init_cache


def make_generate_fn(model: TransformerLM, batch: int = 8,
                     prompt_len: int = 128, max_new_tokens: int = 128,
                     temperature: float = 0.0, device="cuda"
                     ) -> Tuple[Callable, Callable]:
    """Returns (init_fn(generator) -> model, generate_fn(tokens,
    generator=None) -> [batch, max_new_tokens] token ids).

    ``init_fn`` fills the model with seeded random weights
    (``convert.init_params``) on ``device``; a model loaded another way
    needs no ``init_fn``. temperature 0.0 is greedy; > 0 samples.
    max_len = prompt_len + max_new_tokens bounds the KV cache."""
    dev = resolve_device(device)
    cfg = model.cfg
    max_len = prompt_len + max_new_tokens

    def init_fn(generator: torch.Generator) -> TransformerLM:
        model.load_state_dict(init_params(cfg, generator, dev), assign=True)
        return model

    @torch.inference_mode()
    def generate_fn(tokens, generator: Optional[torch.Generator] = None):
        tokens = torch.as_tensor(tokens, device=dev)
        if tuple(tokens.shape) != (batch, prompt_len):
            raise ValueError(f"tokens {tuple(tokens.shape)}; this generator "
                             f"takes ({batch}, {prompt_len})")
        cache = init_cache(cfg, batch, max_len, device=dev)
        # prefill: one full-prompt forward seeds every layer's cache
        logits, cache = model(tokens, cache=cache)
        tok = sample_logits(logits[:, -1, :], generator, temperature)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = model(tok[:, None], cache=cache)
            tok = sample_logits(logits[:, -1, :], generator, temperature)
            out.append(tok)
        return torch.stack(out, dim=1)

    return init_fn, generate_fn
