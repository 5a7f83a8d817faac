from ray_tpu_torch.ops.attention import (flash_attention, flash_attention_fwd,
                                         flash_attention_fwd_reference,
                                         mha_reference)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_reference", "mha_reference"]
