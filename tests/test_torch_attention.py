"""ray_tpu_torch's attention against ray_tpu's on the CPU (the Hopper
kernel against its plain version on the card is test_torch_kernels.py).

Inputs are made with numpy from a seed and handed to both packages. The
JAX flash forward runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _flash_fwd
from ray_tpu.ops.attention import mha_reference as jax_mha
from ray_tpu_torch.ops import attention as ops
from ray_tpu_torch.ops.dispatch import attention as dispatch


def _qkv(seed, B, Lq, Lk, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk,q_off,k_off", [(32, 32, 0, 0),
                                               (16, 48, 32, 0),
                                               (40, 24, 3, 17)])
def test_mha_reference_matches_jax(causal, Lq, Lk, q_off, k_off):
    """GQA (H=4 over Hkv=2), D=64, offsets, fp32: the same arithmetic, so
    held at atol 1e-5."""
    q, k, v = _qkv(0, 2, Lq, Lk, 4, 2, 64)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                   q_off, k_off)
    got = ops.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal, q_off, k_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_matches_jax_kernel(causal):
    """The kernel's plain version (o, lse) against the JAX forward kernel
    in interpret mode at BH=4, L=256, D=128, blocks of 128. Tolerance
    rtol = atol = 2e-3, the bound the JAX package holds its own kernel to
    (tests/test_model_parallel.py)."""
    B, H, L, D = 2, 2, 256, 128
    q, k, v = _qkv(1, B, L, L, H, H, D)
    qf, kf, vf = (jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, L, D))
                  for x in (q, k, v))
    o, (_, _, _, _, lse) = _flash_fwd(causal, 128, 128, D ** -0.5, True,
                                      qf, kf, vf)
    want_o = np.asarray(o).reshape(B, H, L, D).transpose(0, 2, 1, 3)
    want_lse = np.asarray(lse).reshape(B, H, L)
    got_o, got_lse = ops.flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-3,
                               atol=2e-3)


def test_flash_attention_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing; ragged
    lengths, Lq != Lk, GQA and any head dim are taken."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 37, 53, 4, 2, 16))
    before = ops.flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, causal=True)
    o, lse = ops.flash_attention_fwd_reference(q, k, v, True)
    assert torch.equal(got, o) and lse.shape == (1, 4, 37)
    assert ops.flash_attention_fwd.launches == before
    # the causal mask is top-left aligned: row 0 sees key 0 only
    np.testing.assert_allclose(got[0, 0].numpy(),
                               v[0, 0].repeat_interleave(2, 0).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_dispatch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 8, 8, 2, 2, 8))
    assert torch.equal(dispatch(q, k, v), ops.flash_attention(q, k, v))
    assert torch.equal(dispatch(q, k, v, impl="reference"),
                       ops.mha_reference(q, k, v))
    for impl in ("ring", "sharded_local"):
        # as in the JAX dispatch: the sharded impls need use_mesh(...)
        with pytest.raises(ValueError, match="needs a mesh"):
            dispatch(q, k, v, impl=impl)
    with pytest.raises(ValueError):
        dispatch(q, k, v, impl="nope")


def test_mixed_devices_raise():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.flash_attention(q.to("meta"), k, v)


@pytest.mark.parametrize("change,err", [
    (dict(D=96), ValueError),                    # head dim the kernel lacks
    (dict(dtype=torch.float16), TypeError),
    (dict(Hkv=3), ValueError),                   # H not a multiple of Hkv
    (dict(Lq=0), ValueError),
    (dict(strided=True), ValueError),            # head dim not contiguous
])
def test_kernel_input_checks(change, err):
    """What the CUDA wrapper refuses before it launches: checked here on
    CPU tensors, since the checks look only at shapes, dtypes, strides."""
    c = dict(B=1, Lq=8, Lk=8, H=4, Hkv=2, D=64, dtype=torch.bfloat16)
    c.update(change)
    q = torch.zeros(c["B"], c["Lq"], c["H"], c["D"], dtype=c["dtype"])
    k = torch.zeros(c["B"], c["Lk"], c["Hkv"], c["D"], dtype=c["dtype"])
    v = k.clone()
    if c.get("strided"):
        q = torch.zeros(c["B"], c["Lq"], c["H"], 2 * c["D"],
                        dtype=c["dtype"])[..., ::2]
    with pytest.raises(err):
        ops._check_kernel_inputs(q, k, v)
    ops._check_kernel_inputs(*(torch.zeros(1, 8, 4, 64, dtype=torch.float32)
                               for _ in range(3)))


@pytest.mark.parametrize("strides,ptr,why", [
    # contiguous [2, 200, 8, 128] and [1, 17, 1, 64] bf16, and a view of a
    # fused [2, 200, 10, 64] projection: every stride a multiple of 16 bytes
    ((204800, 1024, 128, 1), 0x7f0000000000, None),
    ((1088, 64, 64, 1), 0x7f0000000010, None),
    ((128000, 640, 64, 1), 0x7f0000000080, None),
    ((2048, 256, 64, 1), 0x7f0000000008, "16-byte aligned"),
    ((4160, 520, 130, 1), 0x7f0000000000, "dim 2"),
    ((4160, 260, 64, 1), 0x7f0000000000, "dim 1"),
    ((2049, 256, 64, 1), 0x7f0000000000, "dim 0"),
    ((4096, 512, 128, 2), 0x7f0000000000, "contiguous"),
])
def test_tma_layout_rule(strides, ptr, why):
    """The rule the bf16 wrappers hold an operand to before a TMA tensor
    map is made of it (base 16-byte aligned, head dim contiguous, every
    other stride a multiple of 16 bytes), fed strides and addresses made
    up by hand."""
    got = ops.tma_layout_error(strides, ptr, 2)
    if why is None:
        assert got is None
    else:
        assert got is not None and why in got, got
