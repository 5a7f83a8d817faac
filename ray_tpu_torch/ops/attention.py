"""Attention: the flash-attention forward kernel and its plain versions.

Counterpart of ``ray_tpu/ops/attention.py``. ``flash_attention`` keeps the
JAX public layout (q [B, Lq, H, D], k/v [B, Lk, Hkv, D]). A CUDA tensor
launches the hand-written Hopper kernel (``csrc/flash_fwd.cu``) or raises;
only a tensor that lies on the CPU takes the plain PyTorch version
(``flash_attention_fwd_reference``). The kernel masks ragged edges itself,
so there is no routing by shape. This slice is forward-only: the backward
kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


def mha_reference(q, k, v, causal: bool = True, q_offset: int = 0,
                  k_offset: int = 0, scale: Optional[float] = None):
    """Plain attention: q[B,Lq,H,D], k/v[B,Lk,Hkv,D] -> [B,Lq,H,D], as the
    JAX ``mha_reference``: GQA, absolute position offsets, logits in the
    input dtype, softmax in fp32, probabilities cast to v's dtype."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = torch.arange(Lq, device=q.device) + q_offset
        kpos = torch.arange(Lk, device=q.device) + k_offset
        mask = qpos[:, None] >= kpos[None, :]
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def flash_attention_fwd_reference(q, k, v, causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: what JAX ``_fwd_kernel``
    computes, in one pass. Scores in fp32, p cast to v's dtype before the
    PV product (fp32 accumulation), o in q's dtype, lse = m + log l in fp32.
    Returns (o [B,Lq,H,D], lse [B,H,Lq])."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Lq, device=q.device)
        kpos = torch.arange(Lk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _check_kernel_inputs(q, k, v):
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes {list(KERNEL_DTYPES)}, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q[B,Lq,H,D], k/v[B,Lk,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lq, H, D = q.shape
    Bk, Lk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if Lq == 0 or Lk == 0:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                "flash_attention is forward-only in this port; the backward "
                "kernels come with the training slice (ROADMAP.md, Queue A "
                "item A1)")


def _kernel_lib():
    from ray_tpu_torch.ops import _build
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_float, i, p]
        lib.flash_fwd.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (o [B,Lq,H,D] in q's dtype, lse [B,H,Lq]
    fp32). CPU tensors take ``flash_attention_fwd_reference``; CUDA tensors
    launch ``csrc/flash_fwd.cu`` on the current stream (and count the launch
    in ``flash_attention_fwd.launches``) or raise."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    if devices != {"cuda"}:
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    _check_kernel_inputs(q, k, v)
    B, Lq, H, _ = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(KERNEL_DTYPES[q.dtype], D, q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            lse.data_ptr(), B, H, Hkv, Lq, Lk, strides,
                            scale, int(causal), stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Tiled attention forward, q[B,Lq,H,D], k/v[B,Lk,Hkv,D] (GQA ok) ->
    [B,Lq,H,D]. The scale defaults to D ** -0.5."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
