"""Attention: the flash-attention kernels and their plain versions.

Counterpart of ``ray_tpu/ops/attention.py``. ``flash_attention`` keeps the
JAX public layout (q [B, Lq, H, D], k/v [B, Lk, Hkv, D]) and is
differentiable: a ``torch.autograd.Function`` over the forward kernel
(``csrc/flash_fwd.cu``, JAX ``_fwd_kernel``) and the two backward kernels
(``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``, JAX
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), as JAX's ``custom_vjp``. A
CUDA tensor launches the hand-written Hopper kernels or raises; only a
tensor that lies on the CPU takes the plain PyTorch versions
(``flash_attention_fwd_reference``, ``flash_attention_bwd_reference``).
The kernels mask ragged edges themselves, so there is no routing by shape.
In bf16 all three kernels run on the tensor cores (wgmma) and read their
operands through TMA tensor maps, so their wrappers refuse (ValueError) an
operand TMA cannot read: see ``tma_layout_error``; fp32 keeps FMA code
that takes any strides with a contiguous head dim. Each kernel's wrapper
(``flash_attention_fwd``, ``flash_attention_bwd_dq``,
``flash_attention_bwd_dkv``) counts its launches in ``.launches``.

Each wrapper also reports its call's FLOPs (``attention_flops``) to the
listeners a step's FLOP count registers (``util/profiling.count_flops``):
a dispatch mode sees neither a ctypes launch nor a causal mask, and on the
CPU it would count the plain version's unmasked products, which
``plain_running`` tells it to skip.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, List, Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


# what a kernel computes per (query, key) pair its mask keeps: 2*D FLOPs
# for each product: s and o in the forward; s, dp and dq for dQ; s, dp,
# dv and dk for dK/dV
KERNEL_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}

_flop_listeners: List[Callable[[float], None]] = []
# >0 while a plain version runs with listeners registered (every thread:
# the autograd engine runs a CUDA backward on a thread of its own)
_plain_depth = 0


def kept_pairs(B: int, Lq: int, Lk: int, H: int, causal: bool) -> float:
    """(query, key) pairs the mask keeps, over batch and query heads: row i
    of a causal call sees keys 0..i."""
    if not causal:
        return float(B * H * Lq * Lk)
    n = min(Lq, Lk)
    return float(B * H * (n * (n + 1) // 2 + (Lq - n) * Lk))


def attention_flops(kernel: str, q, k, causal: bool) -> float:
    """FLOPs of one call of ``kernel`` on q [B,Lq,H,D], k [B,Lk,Hkv,D]."""
    B, Lq, H, D = q.shape
    return (2.0 * D * KERNEL_PRODUCTS[kernel]
            * kept_pairs(B, Lq, k.shape[1], H, causal))


def add_flop_listener(fn: Callable[[float], None]) -> None:
    _flop_listeners.append(fn)


def remove_flop_listener(fn: Callable[[float], None]) -> None:
    _flop_listeners.remove(fn)


def plain_running() -> bool:
    """Whether a plain version runs for a counted call now."""
    return _plain_depth > 0


def _count(kernel: str, q, k, causal: bool) -> None:
    if _flop_listeners:
        flops = attention_flops(kernel, q, k, causal)
        for fn in list(_flop_listeners):
            fn(flops)


@contextlib.contextmanager
def _plain(kernel: str, q, k, causal: bool):
    """Around a plain version: count the call, and hide its own products
    from a FLOP counter."""
    global _plain_depth
    if not _flop_listeners:
        yield
        return
    _count(kernel, q, k, causal)
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


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


def tma_layout_error(strides, ptr: int, elem_size: int) -> Optional[str]:
    """Why a [B, L, H, D] tensor cannot be read or written through a TMA
    tensor map, or None if it can: the base address must be 16-byte
    aligned, the head dim contiguous, and every other stride a multiple of
    16 bytes. Strides in elements, the address in bytes."""
    if ptr % 16:
        return f"base address {ptr:#x} is not 16-byte aligned"
    if strides[-1] != 1:
        return "the head dim is not contiguous"
    for dim, st in enumerate(strides[:-1]):
        if (st * elem_size) % 16:
            return (f"stride {st} of dim {dim} is {st * elem_size} bytes, "
                    f"not a multiple of 16")
    return None


def _check_tma(**tensors):
    """Raise ValueError for a bf16 kernel operand that TMA cannot take."""
    for name, t in tensors.items():
        why = tma_layout_error(t.stride(), t.data_ptr(), t.element_size())
        if why:
            raise ValueError(f"{name} {tuple(t.shape)} with strides "
                             f"{t.stride()}: {why} (the bf16 kernels read "
                             f"it through TMA)")


def _check_bwd_inputs(q, do, lse, delta):
    """What the backward kernels take beyond ``_check_kernel_inputs``:
    dO like q with a contiguous head dim, lse and delta [B, H, Lq] fp32
    contiguous, all on q's device."""
    B, Lq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or do.stride(-1) != 1:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} on {do.device}, "
                         f"strides {do.stride()}; want q's {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}, head dim contiguous")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Lq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}; want a "
                             f"contiguous fp32 [B, H, Lq] = {(B, H, Lq)} on "
                             f"{q.device}")


# ctypes types of each kernel's C entry point, by position (i int,
# p pointer, S int64 strides, f float): dtype, D, the tensors' pointers,
# B, H, Hkv, Lq, Lk, strides, scale, causal, stream. The pointers are
# q k v o lse (flash_fwd), q k v do lse delta dq (flash_bwd_dq) and
# q k v do lse delta dk dv (flash_bwd_dkv).
_KERNEL_ARGS = {
    "flash_fwd": "ii" + "p" * 5 + "i" * 5 + "Sfip",
    "flash_bwd_dq": "ii" + "p" * 7 + "i" * 5 + "Sfip",
    "flash_bwd_dkv": "ii" + "p" * 8 + "i" * 5 + "Sfip",
}
_CTYPES = {"i": ctypes.c_int, "p": ctypes.c_void_p, "f": ctypes.c_float,
           "S": ctypes.POINTER(ctypes.c_int64)}


def _kernel(name):
    """The C entry point of ``csrc/<name>.cu``, built and loaded on first
    use, with its argument types declared."""
    from ray_tpu_torch.ops import _build
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        errs = getattr(lib, f"{name}_error_string")
        errs.argtypes = [ctypes.c_int]
        errs.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in _KERNEL_ARGS[name]]
    return lib, fn


def _launch(name, q, *args):
    """Launch kernel ``name`` on q's device's current stream; raise with
    CUDA's message if the launch was refused."""
    lib, fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())


def _strides(*tensors):
    """(batch, seq, head) strides of each [B, L, H, D] tensor, in order."""
    return (ctypes.c_int64 * (3 * len(tensors)))(*(
        s for t in tensors for s in t.stride()[:3]))


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (o [B,Lq,H,D] in q's dtype, lse [B,H,Lq]
    fp32). CPU tensors take ``flash_attention_fwd_reference``; CUDA tensors
    launch ``csrc/flash_fwd.cu`` on the current stream (and count the launch
    in ``flash_attention_fwd.launches``) or raise. In bf16, q, k and v must
    meet ``tma_layout_error``'s rule."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        with _plain("flash_fwd", q, k, causal):
            return flash_attention_fwd_reference(q, k, v, causal, scale)
    if devices != {"cuda"}:
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    _check_kernel_inputs(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_tma(q=q, k=k, v=v)
    B, Lq, H, _ = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, KERNEL_DTYPES[q.dtype], D, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H,
            Hkv, Lq, Lk, _strides(q, k, v, o), scale, int(causal))
    flash_attention_fwd.launches += 1
    _count("flash_fwd", q, k, causal)
    return o, lse


flash_attention_fwd.launches = 0


def _bwd_scores(q, k, v, do, lse, delta, causal, scale):
    """The backward's recomputed tiles, whole: (k and v repeated to the
    query heads in fp32, p, ds), p and ds [B,H,Lq,Lk] in fp32."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Hkv, dim=2).float()
    vr = v.repeat_interleave(H // Hkv, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if causal:
        qpos = torch.arange(Lq, device=q.device)
        kpos = torch.arange(Lk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    p = torch.exp(s - lse[..., None])          # masked: exp(-1e30 - lse) = 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    return kr, p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                     causal: bool = True,
                                     scale: Optional[float] = None):
    """Plain version of the dQ kernel (JAX ``_bwd_dq_kernel``): scores in
    fp32 under the top-left causal mask, p = exp(s - lse), dp = dO . V^T,
    ds = p * (dp - delta), dq = scale * ds . K with ds rounded to k's
    dtype and fp32 accumulation. lse, delta [B,H,Lq] fp32. Returns dq
    [B,Lq,H,D] in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kr, _, ds = _bwd_scores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr)
    return (dq * scale).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal: bool = True,
                                      scale: Optional[float] = None):
    """Plain version of the dK/dV kernel (JAX ``_bwd_dkv_kernel``):
    dv = p^T . dO with p rounded to dO's dtype, dk = scale * ds^T . Q with
    ds rounded to q's dtype, fp32 accumulation, each summed in fp32 over
    the G = H / Hkv query heads of its kv head. Returns (dk, dv
    [B,Lk,Hkv,D] in k's dtype)."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    _, p, ds = _bwd_scores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return (dk.reshape(B, Lk, Hkv, H // Hkv, D).sum(3).to(k.dtype),
            dv.reshape(B, Lk, Hkv, H // Hkv, D).sum(3).to(k.dtype))


def _delta(o, do):
    """rowsum(dO * O) in fp32, [B,H,Lq] (JAX ``_flash_bwd``, outside its
    kernels)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of the whole backward: delta = rowsum(dO * O), then
    the two kernels' plain versions. Returns (dq [B,Lq,H,D] in q's dtype,
    dk, dv [B,Lk,Hkv,D] in k's dtype)."""
    delta = _delta(o, do)
    return (flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                             causal, scale),
            *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, scale))


def _bwd_devices(q, k, v, do, lse, delta):
    """'cpu' or 'cuda' for a backward call; raises on a mix."""
    devices = {t.device.type for t in (q, k, v, do, lse, delta)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{sorted(devices)}")
    if devices == {"cuda"}:
        _check_kernel_inputs(q, k, v)
        _check_bwd_inputs(q, do, lse, delta)
    return devices.pop()


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dQ of flash attention, given lse and delta [B,H,Lq] fp32. CPU
    tensors take ``flash_attention_bwd_dq_reference``; CUDA tensors launch
    ``csrc/flash_bwd_dq.cu`` on the current stream (and count the launch
    in ``flash_attention_bwd_dq.launches``) or raise. dO's head dim must be
    contiguous; in bf16, q, k, v and dO must meet ``tma_layout_error``'s
    rule."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    if _bwd_devices(q, k, v, do, lse, delta) == "cpu":
        with _plain("flash_bwd_dq", q, k, causal):
            return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                    causal, scale)
    if q.dtype == torch.bfloat16:
        _check_tma(q=q, k=k, v=v, do=do)
    B, Lq, H, _ = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", q, KERNEL_DTYPES[q.dtype], D, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, H, Hkv, Lq, Lk,
            _strides(q, k, v, do, dq), scale, int(causal))
    flash_attention_bwd_dq.launches += 1
    _count("flash_bwd_dq", q, k, causal)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention, summed over each kv head's query heads,
    given lse and delta [B,H,Lq] fp32. CPU tensors take
    ``flash_attention_bwd_dkv_reference``; CUDA tensors launch
    ``csrc/flash_bwd_dkv.cu`` on the current stream (and count the launch
    in ``flash_attention_bwd_dkv.launches``) or raise. dO's head dim must
    be contiguous; in bf16, q, k, v and dO must meet
    ``tma_layout_error``'s rule."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    if _bwd_devices(q, k, v, do, lse, delta) == "cpu":
        with _plain("flash_bwd_dkv", q, k, causal):
            return flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                     delta, causal, scale)
    if q.dtype == torch.bfloat16:
        _check_tma(q=q, k=k, v=v, do=do)
    B, Lq, H, _ = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty((B, Lk, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Lk, Hkv, D), dtype=k.dtype, device=q.device)
    _launch("flash_bwd_dkv", q, KERNEL_DTYPES[q.dtype], D, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Lq,
            Lk, _strides(q, k, v, do, dk, dv), scale, int(causal))
    flash_attention_bwd_dkv.launches += 1
    _count("flash_bwd_dkv", q, k, causal)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward: (dq [B,Lq,H,D], dk, dv [B,Lk,Hkv,D]) from
    the forward's inputs, its o and lse, and dO (any strides). Computes
    delta = rowsum(dO * O) in PyTorch, as JAX does outside its kernels,
    then runs the dQ and the dK/dV kernels (their plain versions on CPU
    tensors)."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the two backward kernels as its gradient
    (JAX's ``_flash_core`` custom_vjp). Saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Tiled attention, differentiable, q[B,Lq,H,D], k/v[B,Lk,Hkv,D] (GQA
    ok) -> [B,Lq,H,D]. The scale defaults to D ** -0.5. With grad enabled
    and an input that requires it, the backward runs the backward kernels
    (their plain version on CPU tensors)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal, scale)[0]
