"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a machine without a CUDA card. This file
imports neither JAX nor ray_tpu, so it runs on the card's machine:
``python -m pytest -m cuda tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as ops


def _qkv(seed, B, Lq, Lk, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32))


# tpu-7b prefill, llama-1b (D=64), ragged L, Lq != Lk both ways, fp32
CARD_CASES = [
    dict(B=2, Lq=512, Lk=512, H=32, Hkv=8, D=128, dtype=torch.bfloat16,
         causal=True),
    dict(B=2, Lq=256, Lk=256, H=32, Hkv=8, D=64, dtype=torch.bfloat16,
         causal=True),
    dict(B=2, Lq=200, Lk=200, H=8, Hkv=2, D=128, dtype=torch.bfloat16,
         causal=True),
    dict(B=1, Lq=130, Lk=300, H=4, Hkv=2, D=64, dtype=torch.bfloat16,
         causal=False),
    dict(B=1, Lq=300, Lk=130, H=4, Hkv=2, D=128, dtype=torch.bfloat16,
         causal=True),
    dict(B=2, Lq=200, Lk=200, H=4, Hkv=1, D=64, dtype=torch.float32,
         causal=True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version_on_card(case):
    """On the card: the CUDA kernel against its plain version. fp32 at
    rtol = atol = 2e-3 (the JAX package's kernel bound); bf16 o at 2e-2,
    since o is stored in bf16 (one ulp is 2**-7 near 1) and p is rounded to
    bf16 against the running max in the kernel and the final max in the
    plain version; lse is fp32 in both, at 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = dict(case)
    dtype, causal = c.pop("dtype"), c.pop("causal")
    q, k, v = (torch.from_numpy(x).to("cuda", dtype)
               for x in _qkv(5, c["B"], c["Lq"], c["Lk"], c["H"], c["Hkv"],
                             c["D"]))
    before = ops.flash_attention_fwd.launches
    o, lse = ops.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == before + 1
    ro, rlse = ops.flash_attention_fwd_reference(q, k, v, causal)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rlse, rtol=2e-3, atol=2e-3)
