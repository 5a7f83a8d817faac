"""Autoregressive generation: prefill + KV-cache decode, on one device or
over a device mesh.

Counterpart of ``ray_tpu/models/generate.py`` (``make_generate_fn``). The
prompt goes through one one-shot prefill forward (the flash-attention
kernel's path), which seeds every layer's cache; then a Python loop runs
single-token decode steps against the cache. Weights live on the model
(an ``nn.Module``), not in a separate params tree.

With a ``mesh`` the parameters are DTensors placed per
``parallel.train_step.state_shardings``, and the KV cache is sharded as
``(None, "batch", None, "kv_heads", None)`` says (a dim that does not
divide replicated): batch over the data axes, KV heads over ``tensor``.
Every rank runs the same program on the same inputs: the last position's
logits are gathered whole on every rank before a token is picked, and a
sampling generator seeded alike on every rank picks the same tokens, so
the tokens come out the same on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.sampling import sample_logits
from ray_tpu_torch.models.transformer import TransformerLM, init_cache


def make_generate_fn(model: TransformerLM, mesh=None, rules=None,
                     batch: int = 8, prompt_len: int = 128,
                     max_new_tokens: int = 128, temperature: float = 0.0,
                     device="cuda") -> Tuple[Callable, Callable]:
    """Returns (init_fn(generator) -> model, generate_fn(tokens,
    generator=None) -> [batch, max_new_tokens] token ids).

    ``init_fn`` fills the model with seeded random weights
    (``convert.init_params``) on ``device``, distributed over ``mesh`` when
    there is one; a model loaded another way needs no ``init_fn``.
    temperature 0.0 is greedy; > 0 samples. max_len = prompt_len +
    max_new_tokens bounds the KV cache."""
    # imported here: the parallel package imports this module's package
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts
    dev = resolve_device(device)
    cfg = model.cfg
    max_len = prompt_len + max_new_tokens
    shardings = (ts.state_shardings(model, mesh, rules) if mesh is not None
                 else None)
    rules = rules or sharding.DEFAULT_RULES

    def init_fn(generator: torch.Generator) -> TransformerLM:
        sharding.load_whole(model, init_params(cfg, generator, dev), mesh,
                            shardings)
        return model

    def new_cache():
        cache = init_cache(cfg, batch, max_len, device=dev)
        if mesh is None:
            return cache
        place = ts._batch_placements(
            mesh, rules, tuple(cache["k"].shape),
            (None, "batch", None, "kv_heads", None))
        return {"k": sharding.distribute_whole(cache["k"], mesh, place),
                "v": sharding.distribute_whole(cache["v"], mesh, place),
                "idx": cache["idx"]}

    def generate_fn(tokens, generator: Optional[torch.Generator] = None):
        tokens = torch.as_tensor(tokens, device=dev)
        if tuple(tokens.shape) != (batch, prompt_len):
            raise ValueError(f"tokens {tuple(tokens.shape)}; this generator "
                             f"takes ({batch}, {prompt_len})")
        # under a mesh no_grad, not inference_mode: see sharding.constrain
        no_grad = torch.inference_mode if mesh is None else torch.no_grad
        with no_grad(), sharding.on_mesh(mesh):
            if mesh is not None:
                tokens = sharding.distribute_whole(
                    tokens, mesh, ts._batch_placements(
                        mesh, rules, (batch, prompt_len), ("batch", None)))
            cache = new_cache()
            # prefill: one full-prompt forward seeds every layer's cache
            logits, cache = model(tokens, cache=cache)
            tok = sample_logits(sharding.gather_whole(logits[:, -1, :]),
                                generator, temperature)
            out = [tok]
            for _ in range(max_new_tokens - 1):
                logits, cache = model(tok[:, None], cache=cache)
                tok = sample_logits(sharding.gather_whole(logits[:, -1, :]),
                                    generator, temperature)
                out.append(tok)
        return torch.stack(out, dim=1)

    return init_fn, generate_fn
