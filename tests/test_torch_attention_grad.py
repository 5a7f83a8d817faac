"""ray_tpu_torch's attention gradients against ray_tpu's on the CPU.

The plain version of the backward kernels (``flash_attention_bwd_reference``)
is held against ``jax.grad`` through the JAX flash attention, whose
``custom_vjp`` runs its Pallas backward kernels in interpret mode, as the
JAX package's own tests run them on the CPU. The autograd Function that
joins the port's kernels is held against torch autograd through the port's
plain attention. Inputs are made with numpy from a seed. (The CUDA kernels
against their plain version, on the card, are in test_torch_kernels.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import flash_attention as jax_flash
from ray_tpu_torch.ops import attention as ops


def _arrays(seed, B, Lq, Lk, H, Hkv, D):
    """q, k, v and the output cotangent dO."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32),
            rng.randn(B, Lq, H, D).astype(np.float32))


JAX_GRAD_SHAPE = (2, 256, 256, 4, 2, 64)   # B, Lq, Lk, H, Hkv, D


@pytest.fixture(scope="module")
def jax_grads():
    """dq, dk, dv of sum(out * dO) through the JAX flash attention, causal
    and not, from one jitted computation: the interpret-mode Pallas
    backward is traced once for the file."""
    q, k, v, do = map(jnp.asarray, _arrays(0, *JAX_GRAD_SHAPE))

    def grads(causal):
        def loss(q, k, v):
            out = jax_flash(q, k, v, causal=causal, block_q=128,
                            block_k=128, interpret=True)
            return jnp.sum(out * do)
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    both = jax.jit(lambda: {c: grads(c) for c in (True, False)})()
    return {c: tuple(map(np.asarray, g)) for c, g in both.items()}


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_version_matches_jax_kernels(causal, jax_grads):
    """dq, dk, dv at the JAX package's own gradient test shape
    (tests/test_model_parallel.py: B=2, L=256, H=4 over Hkv=2, D=64, fp32,
    blocks of 128). Both sides compute the same fp32 arithmetic (JAX pads D
    to 128 with zeros, which adds nothing) and differ in summation order
    and in how the GQA sum is taken, so the bound is rtol = atol = 1e-4,
    tighter than the 2e-2 that package holds its kernels to."""
    q, k, v, do = map(torch.from_numpy, _arrays(0, *JAX_GRAD_SHAPE))
    o, lse = ops.flash_attention_fwd_reference(q, k, v, causal)
    got = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    for g, w, name in zip(got, jax_grads[causal], ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


AUTOGRAD_CASES = [  # B, Lq, Lk, H, Hkv, D, causal
    (2, 32, 32, 4, 2, 16, True),      # GQA
    (2, 32, 32, 4, 2, 16, False),
    (1, 37, 53, 6, 2, 8, True),       # ragged, Lq < Lk
    (1, 53, 37, 4, 1, 8, True),       # Lq > Lk, one kv head
    (1, 40, 24, 4, 4, 8, False),      # no GQA
]


@pytest.mark.parametrize("case", AUTOGRAD_CASES,
                         ids=lambda c: "B{}-Lq{}-Lk{}-H{}-Hkv{}-D{}-{}".format(
                             *c[:6], "causal" if c[6] else "full"))
def test_flash_attention_grad_matches_autograd_of_plain_attention(case):
    """flash_attention's autograd Function on CPU tensors (plain forward,
    plain backward) against torch autograd through ``mha_reference``,
    fp32: the same function differentiated two ways, held at
    rtol = atol = 1e-5."""
    B, Lq, Lk, H, Hkv, D, causal = case
    arrays = _arrays(1, B, Lq, Lk, H, Hkv, D)
    grads = []
    for fn in (ops.flash_attention, ops.mha_reference):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in arrays[:3])
        out = fn(q, k, v, causal=causal)
        grads.append(torch.autograd.grad(out, (q, k, v),
                                         torch.from_numpy(arrays[3])))
    for g, w, name in zip(*grads, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_cpu_backward_is_the_plain_version_and_launches_nothing():
    q, k, v, do = map(torch.from_numpy, _arrays(2, 1, 24, 24, 4, 2, 16))
    o, lse = ops.flash_attention_fwd_reference(q, k, v, True)
    counts = (ops.flash_attention_bwd_dq.launches,
              ops.flash_attention_bwd_dkv.launches)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ops.flash_attention_bwd_dq.launches,
            ops.flash_attention_bwd_dkv.launches) == counts
    # under the top-left causal mask only the last query row sees the last
    # key: its dv is that row's p times dO, summed over the two query heads
    # of each kv head (scale = 16 ** -0.5)
    s_last = torch.einsum("hd,hd->h", q[0, -1],
                          k[0, -1].repeat_interleave(2, 0)) / 4.0
    p_last = torch.exp(s_last - lse[0, :, -1])
    want_dv = (p_last[:, None] * do[0, -1]).reshape(2, 2, 16).sum(1)
    torch.testing.assert_close(got[2][0, -1], want_dv, rtol=1e-5,
                               atol=1e-6)


def test_no_grad_forward_builds_no_graph():
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays(3, 1, 8, 8, 2, 2, 8))
    q.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.flash_attention(q, k, v).grad_fn is not None


@pytest.mark.parametrize("change", ["do_shape", "do_dtype", "do_strided",
                                    "lse_shape", "lse_dtype", "delta_strided"])
def test_bwd_input_checks(change):
    """What the CUDA backward wrappers refuse before they launch, beyond
    the forward's checks: checked on CPU tensors, since the checks look
    only at shapes, dtypes and strides."""
    B, L, H, D = 1, 8, 4, 64
    q = torch.zeros(B, L, H, D, dtype=torch.bfloat16)
    do = q.clone()
    lse, delta = torch.zeros(B, H, L), torch.zeros(B, H, L)
    ops._check_bwd_inputs(q, do, lse, delta)
    if change == "do_shape":
        do = torch.zeros(B, L + 1, H, D, dtype=torch.bfloat16)
    elif change == "do_dtype":
        do = do.float()
    elif change == "do_strided":
        do = torch.zeros(B, L, H, 2 * D, dtype=torch.bfloat16)[..., ::2]
    elif change == "lse_shape":
        lse = torch.zeros(B, L, H)
    elif change == "lse_dtype":
        lse = lse.bfloat16()
    else:
        delta = torch.zeros(B, H, 2 * L)[..., ::2]
    with pytest.raises(ValueError):
        ops._check_bwd_inputs(q, do, lse, delta)
