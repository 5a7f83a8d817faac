"""Draft-model speculative decoding for the slot-pool engine.

Counterpart of ``ray_tpu/inference/spec_decode.py``. A small draft model
proposes K greedy tokens per slot, the target model scores all K+1
positions in ONE batched forward (the chunked-prefill cached-attention
path prefill uses), and the engine emits the longest agreeing prefix plus
one bonus token from the target's own distribution. Greedy decoding is
exact by construction: every emitted token is an argmax of target logits
over the same cache contents a one-token decode step would have seen, so
spec-on and spec-off streams are equal and the accept rate only moves
throughput. (On the card the verify forward's products have K+1 times the
rows of a decode step's, and a library may pick another algorithm for
them, so a bf16 logit may move in its last bit and flip an argmax at a
near-tie.)

- the draft runs K+1 single-token steps (step j also writes the draft KV
  of its input token at position ``len+j``, so the draft cache is complete
  however many drafts the target accepts);
- the verify forward is one fixed ``[n_slots, K+1]`` call;
- the accept counts come back to the host as an ``[n_slots]`` vector, and
  every branch on them (how many tokens to emit) runs on the host values;
- both KV pools are K positions longer than ``max_len`` so the write
  window ``[len, len+K+1)`` never clamps back onto live entries.

Rejected speculation leaves stale KV above ``len + accepted + 1`` in both
pools; it is never attended (the causal mask cuts at the per-row ``idx``)
and the next step's window overwrites it.

Sampled rows (temperature > 0) emit one target-sampled token per step:
position 0 of the verify output is drawn through ``sample_logits_dynamic``
as the non-spec decode step draws it, and the accept count is forced to 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.sampling import sample_logits_dynamic
from ray_tpu_torch.parallel import sharding as sharding_lib


@dataclasses.dataclass
class SpecDecodeConfig:
    """Speculative-decoding knobs for :class:`InferenceEngine`.

    draft_model: registry name / TransformerConfig / TransformerLM of the
        (small) proposer. Must share the target's vocab.
    k: draft tokens proposed per step; the engine emits 1..k+1 tokens per
        decode step depending on agreement.
    draft_params_fn: optional zero-arg callable returning the draft's
        state dict (a checkpoint, or the target's own ``state_dict()`` for
        a self-draft, whose tensors the draft then shares, uncopied);
        defaults to random weights from ``draft_seed`` (or, for a
        TransformerLM, the weights it holds).
    """
    draft_model: Any = None
    k: int = 4
    draft_params_fn: Optional[Callable[[], Dict[str, torch.Tensor]]] = None
    draft_seed: int = 0


def resolve_spec(spec) -> Optional[SpecDecodeConfig]:
    """Accept None / SpecDecodeConfig / kwargs dict."""
    if spec is None:
        return None
    if isinstance(spec, SpecDecodeConfig):
        cfg = spec
    elif isinstance(spec, dict):
        cfg = SpecDecodeConfig(**spec)
    else:
        raise TypeError(f"spec_decode: expected SpecDecodeConfig or "
                        f"dict, got {type(spec).__name__}")
    if cfg.draft_model is None:
        raise ValueError("spec_decode requires a draft_model")
    if cfg.k < 1:
        raise ValueError(f"spec_decode k={cfg.k}; must be >= 1")
    return cfg


def resolve_draft(cfg: SpecDecodeConfig, target_cfg, device):
    """Build the draft TransformerLM with its weights on ``device`` and
    check it against the target model's config."""
    from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM
    from ray_tpu_torch.models.transformer import TransformerConfig
    m = cfg.draft_model
    built = not isinstance(m, TransformerLM)
    if isinstance(m, str):
        m = MODEL_REGISTRY[m]
    if isinstance(m, TransformerConfig):
        m = TransformerLM(m, device="meta")
    if m.cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {m.cfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}: accept comparison is meaningless")
    if cfg.draft_params_fn is not None:
        m.load_state_dict({name: t.to(device) for name, t in
                           cfg.draft_params_fn().items()}, assign=True)
    elif built:
        gen = torch.Generator(device=device).manual_seed(cfg.draft_seed)
        m.load_state_dict(init_params(m.cfg, gen, device), assign=True)
    return m


def accept_prefix(drafts, out, temps):
    """Longest agreeing prefix, per slot.

    drafts: [S, K] the draft's proposals d_1..d_K.
    out:    [S, K+1] the target's choice at every position (out[:, j] is
            what the target emits AFTER j accepted drafts; out[:, :K] is
            what d_{j+1} must equal to count).
    temps:  fp32 [S]; sampled rows (temp > 0) force accept = 0.

    Returns int32 [S] in [0, K]."""
    match = (drafts == out[:, :-1]).to(torch.int32)
    acc = torch.cumprod(match, dim=1).sum(dim=1)
    temps = torch.as_tensor(temps, device=acc.device)
    return torch.where(temps > 0.0, 0, acc).to(torch.int32)


def build_spec_step(model, draft_model, k: int, top_k: int, top_p: float):
    """The fused draft+verify step.

    ``spec_step(pk, pv, dk, dv, lengths, toks, generator, temps) -> (out
    [S, K+1], accept [S])`` writes the target slot pools (pk, pv) and the
    draft slot pools (dk, dv), all ``max_len + K`` positions long, in
    place; lengths/toks/temps are the engine's per-slot vectors.
    ``out[s, :accept[s]+1]`` are the tokens slot ``s`` emits this step.
    The caller runs it under its device context (the engine's: inference
    mode, or no_grad with the mesh current); over a mesh the pools are
    DTensors and the logits are gathered whole before a token is picked,
    on every rank alike."""

    def spec_step(pk, pv, dk, dv, lengths, toks, generator, temps):
        # draft: K+1 greedy single-token steps; step j consumes cur_j
        # (cur_0 = the last emitted token), writes its KV at len+j and
        # proposes cur_{j+1}; the (K+1)th step exists only for its write
        cur, ys = toks, []
        for j in range(k + 1):
            logits, _ = draft_model(cur[:, None], cache={
                "k": dk, "v": dv, "idx": lengths + j})
            cur = torch.argmax(sharding_lib.gather_whole(logits[:, -1]),
                               dim=-1)
            ys.append(cur)
        drafts = torch.stack(ys[:k], dim=1)                  # [S, K]

        # verify: ONE target forward over [last_tok, d_1..d_K] through
        # the chunked cached-attention path (per-row idx, causal window)
        seq = torch.cat([toks[:, None], drafts], dim=1)
        logits, _ = model(seq, cache={"k": pk, "v": pv, "idx": lengths},
                          chunked_prefill=True)
        logits = sharding_lib.gather_whole(logits)
        # position 0 samples exactly like the non-spec decode step
        out0 = sample_logits_dynamic(logits[:, 0], generator, temps, top_k,
                                     top_p)
        greedy = torch.argmax(logits, dim=-1)
        out = torch.cat([out0[:, None], greedy[:, 1:]], dim=1)
        return out, accept_prefix(drafts, out, temps)

    return spec_step
