"""int8 KV-cache quantization for the engine's prefix block pool.

The port's own copy of ``ray_tpu/inference/kv_quant.py``: the same scheme
and the same numbers, bit for bit, as the JAX engine computes them. JAX's
``quantize_kv`` writes ``amax / 127.0``, which XLA compiles into a multiply
by the fp32 reciprocal of 127; ``quantize_kv`` here multiplies so, and its
blocks equal the JAX engine's. The numpy variants divide, as JAX's numpy
variants do (the two differ in the last bit of some scales).

Scheme: symmetric per-row int8 over the head dimension. Each ``[..., D]``
row of a K or V span quantizes independently with ``scale = amax / 127``
(a zero row keeps scale 1.0, so dequantizing it is exact), stored as
``int8[..., D]`` values plus an ``fp32[...]`` scale array that drops the
last axis. The engine dequantizes a span in one multiply when it loads it
back into its full-precision scratch, so attention never sees int8.

Where it plugs in (``inference/engine.py``, ``kv_quant="int8"``): the
prefix-cache BLOCK pool stores int8 + scales; the decode slot pool and the
prefill scratch stay full precision. To keep greedy output bit-identical
between a prefix-cache hit and the miss that populated it, the miss path
publishes each completed chunk and reloads the dequantized values into its
own scratch, so both attend over the same once-quantized numbers. The
export/import spans carry int8 values + scales.

The numpy variants compute the same fp32 math on the host (for a span
that arrives in the other format than the pool's).
"""

from __future__ import annotations

import numpy as np
import torch

VALID_MODES = ("none", "int8")
# fp32(1/127): what XLA multiplies by for JAX's amax / 127.0
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def check_mode(mode) -> str:
    mode = mode or "none"
    if mode not in VALID_MODES:
        raise ValueError(f"kv_quant={mode!r}; expected one of "
                         f"{VALID_MODES}")
    return mode


def quantize_kv(x: torch.Tensor):
    """fp[..., D] -> (int8[..., D], fp32 scale[...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax * _INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    """Inverse: (int8[..., D], fp32[...]) -> dtype[..., D]."""
    return (q.float() * scale[..., None]).to(dtype)


def quantize_kv_np(x):
    """Host variant of :func:`quantize_kv` in fp32 (dividing by 127, as
    JAX's ``quantize_kv_np`` does)."""
    xf = np.asarray(x, np.float32)
    amax = np.max(np.abs(xf), axis=-1)
    scale = np.where(amax > 0.0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(xf / scale[..., None]), -127.0, 127.0)
    return q.astype(np.int8), scale


def dequantize_kv_np(q, scale, dtype=np.float32):
    """Host mirror of :func:`dequantize_kv`."""
    return (np.asarray(q, np.float32)
            * np.asarray(scale, np.float32)[..., None]).astype(dtype)


def int8_block_bytes_per_token(n_kv_heads: int, head_dim: int) -> int:
    """Bytes one cached token position costs in the int8 block pool
    (K + V values + their scale rows)."""
    return 2 * n_kv_heads * (head_dim + 4)


def fp_block_bytes_per_token(n_kv_heads: int, head_dim: int,
                             itemsize: int) -> int:
    """Same position's cost at full precision (K + V)."""
    return 2 * n_kv_heads * head_dim * itemsize


def slot_gain(head_dim: int, fp_itemsize: int) -> float:
    """Capacity multiplier of int8 blocks vs ``fp_itemsize``-byte blocks
    at equal memory: ``itemsize * D / (D + 4)`` (the +4 is the fp32 scale
    per row). ~1.94x for bf16 at D=128, ~3.88x for fp32."""
    return fp_itemsize * head_dim / float(head_dim + 4)
