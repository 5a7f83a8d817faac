"""Llama-style decoder-only transformer in PyTorch: the training and
serving forward.

Counterpart of ``ray_tpu/models/transformer.py``, with the same numbers:
linear, embedding and unembedding weights are cast to ``cfg.dtype`` at
every use, as the JAX model casts its ``param_dtype`` kernels (embedding
rows are gathered, then cast, which gives the same values); RMSNorm scales
stay fp32, RMSNorm and rope compute in fp32. The weights' storage dtype is
that of the tensors loaded into the model: ``cfg.dtype`` by default (the
model's allocation and ``convert.init_params``' default, the serving
storage, where the cast is free), ``cfg.param_dtype`` (fp32 master
weights) where the trainer's ``init_fn`` loads them. Weights keep
the JAX layout flattened to 2-D ([in, out], e.g. q is [d_model, H * D]),
so ``models/convert.py`` maps a flax tree one to one. The forward without
a cache carries autograd end to end: it writes nothing in place. With
``n_experts > 0`` every block's MLP is the expert layer of
``models/moe.py``, whose load-balancing loss the training forward returns
to a caller that asks for it (``return_aux``).

Activation recompute follows the JAX model's ``remat``/``remat_policy``:
each block of a training forward runs under
``torch.utils.checkpoint.checkpoint``, and the policy names which
operations' outputs are kept for the backward (JAX's checkpoint policies
keep dot outputs; ``REMAT_SAVED_OPS`` maps them to aten's matrix
products). The flash autograd Function is not a product, so the backward's
recompute runs the forward kernel again, as JAX's grad re-runs its
``pallas_call``. A forward without grad (serving) is not checkpointed.

The KV cache is a dict {"k", "v": [n_layers, B, M, Hkv, D], "idx"}; a
forward with a cache writes its keys and values INTO those tensors in
place (the JAX model returns new arrays) and returns a new dict with the
advanced ``idx``.

Under a device mesh (``parallel.mesh``) the parameters, the activations
and the cache are DTensors and the same code runs: the activations are
pinned to ``("batch", "seq", None)`` where the JAX model pins them
(``parallel.sharding.constrain``, a no-op without a mesh), attention runs
as a ``local_map`` island (``ops/dispatch.py``), a sharded cache is
written in its local shards and attended in an island over its own
placements, and the embedding table is gathered whole for the lookup.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.moe import MoEMLP
from ray_tpu_torch.ops.dispatch import attention as attention_dispatch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # the trainer's master weights (make_train_fns' init_fn stores them so)
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = False
    # activation recompute of each block in a training forward, with the
    # JAX model's defaults: "dots" keeps the matrix products' outputs and
    # recomputes the rest, "dots_no_batch" keeps only products without
    # batch dims, "nothing" recomputes everything
    remat: bool = True
    remat_policy: str = "dots"
    # keep logits in the activation dtype unless asked for fp32
    logits_fp32: bool = False
    # "auto"/"flash": the flash kernel; "reference": plain attention
    attention_impl: str = "auto"
    # Mixture-of-Experts: n_experts=0 is a dense MLP in every block;
    # n_experts>0 replaces every MLP with a top-k-routed expert layer
    # (models/moe.py), whose aux loss the trainer weighs by router_aux_coef
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# JAX policy -> the aten products whose outputs it keeps: checkpoint_dots
# keeps every dot_general, checkpoint_dots_with_no_batch_dims only those
# without batch dims (a bmm, such as the plain attention's einsums, is
# recomputed); nothing_saveable keeps nothing
REMAT_SAVED_OPS = {
    "nothing": (),
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def remat_context_fn(policy: str):
    """``checkpoint``'s context_fn for a JAX remat policy ("nothing" is
    plain checkpointing, which keeps no intermediate)."""
    if policy not in REMAT_SAVED_OPS:
        raise ValueError(f"remat_policy={policy!r}; expected one of "
                         f"{sorted(REMAT_SAVED_OPS)}")
    names = REMAT_SAVED_OPS[policy]
    if not names:
        return noop_context_fn
    saved = {getattr(torch.ops.aten, n).default for n in names}

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.empty(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(self.dtype)


def rope(x, positions, theta: float):
    """Rotary embeddings, rotate-half split in fp32. x[B,L,H,D],
    positions[B,L]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs          # [B,L,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _cached_attention(q, k_cache, v_cache, q_pos0):
    """Decode-path attention against a padded KV cache, in fp32.

    q [B,S,H,D] are the S newest positions starting at q_pos0, a scalar
    (shared start) or a [B] tensor (per-slot starts); the caches [B,M,Hkv,D]
    already hold the new keys/values. Query i attends cache slots
    j <= q_pos0 + i. GQA is a grouped einsum against the unexpanded cache.
    """
    B, S, H, D = q.shape
    M, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bshgd,bmhd->bhgsm", qg,
                          k_cache.float()) / float(D) ** 0.5
    qpos = _positions(q_pos0, S, q.device)                    # [B|1,S]
    mask = torch.arange(M, device=q.device)[None, None, :] <= qpos[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgsm,bmhd->bshgd", probs, v_cache.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _cached_attention_sharded(q, k_cache, v_cache, q_pos0):
    """``_cached_attention`` on DTensors, as a ``local_map`` island over the
    cache's own placements (batch over the data axes, KV heads over
    ``tensor``): q's heads shard as the cache's KV heads do, whole GQA
    groups per shard, so each rank attends its shard of the cache
    locally. DTensor would also propagate the einsums, anew at every
    call."""
    place = list(k_cache.placements)
    fn = local_map(_cached_attention, out_placements=place,
                   in_placements=(place, place, place, None),
                   device_mesh=k_cache.device_mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache, _local_rows(q_pos0, k_cache))


def _local_rows(idx, like):
    """A per-row [B] offset tensor cut to the rows this rank's shard of
    ``like`` (a DTensor whose dim 0 is the batch) holds; a scalar offset
    as it is. The engine's slot pool decodes every row at its own
    length, with the slots sharded over the batch axes."""
    if not (isinstance(idx, torch.Tensor) and idx.dim() > 0):
        return idx
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        like.shape, like.device_mesh, like.placements)
    return idx[off[0]:off[0] + shape[0]]


def _positions(start, L: int, device):
    """[1, L] (scalar start) or [B, L] (per-row [B] starts) absolute
    positions start + 0..L-1. A Python int start costs no host-to-device
    copy (which would wait for the stream)."""
    steps = torch.arange(L, device=device)[None, :]
    if isinstance(start, torch.Tensor):
        return start.to(device).reshape(-1, 1) + steps
    return steps + start


def _cache_write(cache, new, idx):
    """Write ``new`` [B,L,Hkv,D] into ``cache`` [B,M,Hkv,D] in place at
    ``idx``: a scalar (shared offset) or a [B] tensor (per-row offsets).
    As in JAX's dynamic_update_slice, a negative start counts from the end
    and starts are then clamped to [0, M-L], so a full or free slot writes
    at M-L harmlessly. Returns cache."""
    if isinstance(cache, DTensor):
        # write into the local shards: the slice moves every step, and
        # DTensor would propagate each new slice's sharding anew. Per-row
        # offsets are cut to the rows of this rank's shard.
        new = new.redistribute(cache.device_mesh, cache.placements)
        _cache_write(cache.to_local(), new.to_local(),
                     _local_rows(idx, cache))
        return cache
    L, M = new.shape[1], cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(idx, torch.Tensor) and idx.dim() > 0:
        start = idx.to(cache.device).long()
        start = torch.where(start < 0, start + M, start).clamp(0, M - L)
        cols = start[:, None] + torch.arange(L, device=cache.device)
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[rows, cols] = new
        return cache
    start = int(idx)
    start = min(max(start + M if start < 0 else start, 0), M - L)
    cache[:, start:start + L] = new
    return cache


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        w = lambda i, o: nn.Parameter(  # noqa: E731
            torch.empty(i, o, dtype=cfg.dtype, device=device))
        self.q = w(E, H * D)
        self.k = w(E, Hkv * D)
        self.v = w(E, Hkv * D)
        self.o = w(H * D, E)

    def forward(self, x, positions, cache=None, chunked: bool = False):
        """cache=None: prefill/training forward, returns out.
        cache=(k_cache, v_cache, idx): writes this call's K/V at
        [idx, idx+L) (idx scalar or per-slot [B]) and returns
        (out, (k_cache, v_cache)). With L > 1 and not ``chunked`` it is a
        one-shot prefill from an empty cache: the block attends only within
        itself, through the flash kernel; otherwise (decode, or a chunk that
        continues an occupied cache) it attends against the cache."""
        cfg = self.cfg
        B, L, _ = x.shape
        H, Hkv, D, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype
        q = rope((x @ self.q.to(dt)).view(B, L, H, D), positions,
                 cfg.rope_theta)
        k = rope((x @ self.k.to(dt)).view(B, L, Hkv, D), positions,
                 cfg.rope_theta)
        v = (x @ self.v.to(dt)).view(B, L, Hkv, D)
        if cache is None:
            out = attention_dispatch(q, k, v, causal=True,
                                     impl=cfg.attention_impl)
            return out.reshape(B, L, H * D) @ self.o.to(dt)
        k_cache, v_cache, idx = cache
        _cache_write(k_cache, k, idx)
        _cache_write(v_cache, v, idx)
        if L > 1 and not chunked:
            out = attention_dispatch(q, k, v, causal=True,
                                     impl=cfg.attention_impl)
        elif isinstance(k_cache, DTensor):
            out = _cached_attention_sharded(q, k_cache, v_cache, idx)
        else:
            out = _cached_attention(q, k_cache, v_cache, idx)
        return out.reshape(B, L, H * D) @ self.o.to(dt), (k_cache, v_cache)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        w = lambda i, o: nn.Parameter(  # noqa: E731
            torch.empty(i, o, dtype=cfg.dtype, device=device))
        self.gate = w(cfg.d_model, cfg.d_ff)
        self.up = w(cfg.d_model, cfg.d_ff)
        self.down = w(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        dt = self.dtype
        return (F.silu(x @ self.gate.to(dt)) * (x @ self.up.to(dt))) \
            @ self.down.to(dt)


class Block(nn.Module):
    """Attention and a feed-forward: the dense ``mlp``, or the ``moe``
    expert layer when ``cfg.n_experts > 0``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        moe = cfg.n_experts > 0
        self.moe = MoEMLP(cfg, device) if moe else None
        self.mlp = None if moe else MLP(cfg, device)

    def forward(self, x, positions, cache=None, chunked: bool = False):
        """Without a cache -> (out, aux): the expert layer's aux loss, None
        for a dense block. With a cache -> (out, new_cache); the aux loss
        is dropped, as the JAX model's decode scan drops it."""
        att = self.attn(self.attn_norm(x), positions, cache, chunked)
        new_cache = None
        if cache is not None:
            att, new_cache = att
        h = x + att
        normed = self.mlp_norm(h)
        if self.moe is not None:
            y, aux = self.moe(normed)
        else:
            y, aux = self.mlp(normed), None
        return (h + y, aux) if cache is None else (h + y, new_cache)


class BlockStage(nn.Module):
    """A run of consecutive blocks as one pipeline stage
    (``parallel.pipeline``, ``train.mpmd``): x [B, L, d_model] in
    ``cfg.dtype`` -> the blocks' output at positions 0..L-1, as the JAX
    pipelines' stage functions apply their blocks; an expert block's aux
    loss is dropped, as theirs drop it. Its parameters are named as the
    model's (``layers.{i}....``, i counted within the stage), so
    ``convert.stage_state_dict`` cuts a stage's weights out of a model's
    state_dict. Allocation as ``TransformerLM``."""

    def __init__(self, cfg: TransformerConfig, n_blocks: int, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, dev) for _ in range(n_blocks))

    def forward(self, x):
        B, L, _ = x.shape
        positions = _positions(0, L, x.device).expand(B, L)
        for block in self.layers:
            x, _ = block(x, positions)
        return x


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda"):
    """Fresh KV cache: {'k','v': [n_layers,B,max_len,Hkv,D], 'idx': 0}
    (idx is the next write position, a Python int here)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "idx": 0}


class TransformerLM(nn.Module):
    """Parameters are allocated uninitialised in ``cfg.dtype`` on
    ``device`` (default the card; "meta" allocates nothing): load them with
    ``load_state_dict`` from ``convert.params_from_jax`` or
    ``convert.init_params``. With ``assign=True`` the loaded tensors'
    dtype is kept (the trainer loads fp32 masters so); without it they are
    cast to ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, dev)
        self.unembed = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype,
                        device=dev))

    def forward(self, tokens, positions=None, return_hidden: bool = False,
                cache=None, chunked_prefill: bool = False,
                return_aux: bool = False):
        """tokens [B,L] -> logits [B,L,V] (or the final-norm hidden states
        with ``return_hidden``); with a cache -> (logits, new_cache).

        return_aux=True (without a cache): -> (logits or hidden, aux), aux
        the sum of the expert layers' load-balancing losses (an fp32 scalar,
        0 for a dense model), which the JAX model sows into its
        ``losses/moe_aux`` collection. A forward with a cache computes none.

        chunked_prefill=True (needs a cache): this L>1 forward CONTINUES a
        partly filled cache, attending it at the causal offset cache["idx"],
        which may be a scalar or a per-row [B] tensor (the engine's slot
        pool, where every row decodes at its own length)."""
        B, L = tokens.shape
        if positions is None:
            start = 0 if cache is None else cache["idx"]
            positions = _positions(start, L, tokens.device).expand(B, L)
        # imported here: the parallel package imports this module
        from ray_tpu_torch.parallel.sharding import constrain
        # a vocab-sharded table is gathered whole for the lookup: DTensor's
        # sharded lookup leaves a masked partial sum whose gradient it
        # cannot carry back (a no-op without a mesh)
        embed = constrain(self.embed, (None, "embed_lookup"))
        x = F.embedding(tokens, embed).to(self.cfg.dtype)
        # the canonical activation layout from the first op on (a no-op
        # without a mesh), as the JAX model pins it
        x = constrain(x, ("batch", "seq", None))
        if cache is not None:
            return self._decode(x, positions, cache, return_hidden,
                                chunked_prefill)
        cfg = self.cfg
        context_fn = remat_context_fn(cfg.remat_policy) if cfg.remat \
            else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.layers:
            x = constrain(x, ("batch", "seq", None))
            if context_fn is not None and torch.is_grad_enabled():
                x, aux = checkpoint(block, x, positions, use_reentrant=False,
                                    context_fn=context_fn)
            else:
                x, aux = block(x, positions)
            x = constrain(x, ("batch", "seq", None))
            if aux is not None:
                aux_total = aux_total + aux
        x = constrain(self.final_norm(x), ("batch", "seq", None))
        out = x if return_hidden else self._logits(x)
        return (out, aux_total) if return_aux else out

    def unembed_weight(self):
        """The [d_model, vocab] output projection in ``cfg.dtype``: the
        embedding's transpose under ``tie_embeddings``."""
        if self.cfg.tie_embeddings:
            return self.embed.to(self.cfg.dtype).t()
        return self.unembed.to(self.cfg.dtype)

    def _logits(self, x):
        """Final-norm hidden -> vocab logits, honouring tie_embeddings and
        logits_fp32."""
        logits = x @ self.unembed_weight()
        return logits.float() if self.cfg.logits_fp32 else logits

    def _decode(self, x, positions, cache, return_hidden,
                chunked_prefill=False):
        idx = cache["idx"]
        for i, block in enumerate(self.layers):
            x, _ = block(x, positions, (cache["k"][i], cache["v"][i], idx),
                         chunked_prefill)
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "idx": idx + x.shape[1]}
        x = self.final_norm(x)
        return (x if return_hidden else self._logits(x)), new_cache


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
