from ray_tpu_torch.ops.attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_fwd_reference, mha_reference)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "mha_reference"]
