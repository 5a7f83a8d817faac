"""Ring attention: exact causal attention over a sequence-sharded axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``, in plain PyTorch (the
JAX function is plain jnp, no Pallas kernel). Each rank of the ``seq``
mesh dim holds a contiguous sequence shard of Q/K/V; the K/V blocks
rotate around the ring (``ppermute``) while every rank accumulates the
attention of its local queries against each passing block with an fp32
online softmax, so the result is exact attention.

``ppermute`` is a ``torch.autograd.Function``: its forward sends to the
next rank of the ring and receives from the previous one
(``batch_isend_irecv`` on the mesh dim's process group), its backward
sends the gradient the other way. On a ring of one rank it is the
identity and sends nothing.

Call it on local shards inside a ``local_map`` island
(``ops/dispatch.py``), with the ``seq`` dim's process group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _ring_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _ring_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _shift(x, group, offset: int):
    """Send x to the rank ``offset`` steps on around the ring and return
    what arrives from ``offset`` steps back."""
    size = _ring_size(group)
    if size == 1:
        return x
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + offset) % size),
                      group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - offset) % size),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift(x, group, offset)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.offset), None, None


def ppermute(x, group, offset: int = 1):
    """Differentiable ring shift over ``group``: rank i's ``x`` lands on
    rank (i + offset) % size (JAX's ``lax.ppermute`` with the permutation
    ``[(j, (j + offset) % size)]``); group None is a ring of one."""
    return _PPermute.apply(x, group, offset)


def ring_attention(q, k, v, group, causal: bool = True,
                   scale: Optional[float] = None):
    """q[B,Lq,H,D], k/v[B,Lk,Hkv,D]: this rank's shards, the ``seq`` dim's
    process group ``group`` (None: a ring of one) -> this rank's
    [B,Lq,H,D]."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    size = _ring_size(group)
    my_idx = _ring_rank(group)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    q32 = q.float()
    acc = q.new_zeros((B, Lq, H, D), dtype=torch.float32)
    m = q.new_full((B, H, Lq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, H, Lq), dtype=torch.float32)
    kb, vb = k, v
    qpos = my_idx * Lq + torch.arange(Lq, device=q.device)
    for i in range(size):
        # the block held now originated on rank (my_idx - i) % size
        src = (my_idx - i) % size
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
        if causal:
            kpos = src * Lk + torch.arange(Lk, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if i + 1 < size:
            # rotate K/V around the ring for the next step (JAX also
            # rotates after the last step, whose result it drops)
            kb = ppermute(kb, group)
            vb = ppermute(vb, group)
    denom = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)
