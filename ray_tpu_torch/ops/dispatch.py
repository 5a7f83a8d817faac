"""Attention dispatch, single device.

Counterpart of ``ray_tpu/ops/dispatch.py``. On one device every attention
call goes to ``flash_attention`` (the Hopper kernel on a CUDA tensor, its
plain version on a CPU tensor); ``mha_reference`` runs only when asked
for. Sequence-sharded (ring) and head/batch-sharded attention need the
device mesh, which is not ported yet.
"""

from __future__ import annotations

from ray_tpu_torch.ops.attention import flash_attention, mha_reference

IMPLS = ("auto", "flash", "reference", "ring", "sharded_local")


def attention(q, k, v, causal: bool = True, impl: str = "auto"):
    """q[B,L,H,D], k/v[B,L,Hkv,D] -> [B,L,H,D]."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal)
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal)
    if impl in ("ring", "sharded_local"):
        raise NotImplementedError(
            f"attention impl {impl!r} needs the device mesh, which is not "
            f"ported yet (ROADMAP.md, Queue A item A3)")
    raise ValueError(f"attention impl {impl!r}; expected one of {IMPLS}")
