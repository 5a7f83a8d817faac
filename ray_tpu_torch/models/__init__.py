from ray_tpu_torch.models.transformer import (BlockStage, TransformerConfig,
                                              TransformerLM, count_params,
                                              init_cache)

# The same configurations as ray_tpu.models.MODEL_REGISTRY.
MODEL_REGISTRY = {
    "llama-debug": TransformerConfig(
        vocab_size=1024, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=512, max_seq_len=512),
    "llama-125m": TransformerConfig(
        vocab_size=32000, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
        d_ff=2048, max_seq_len=2048),
    "llama-350m": TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=24, n_heads=16,
        n_kv_heads=16, d_ff=2816, max_seq_len=2048),
    "llama-1b": TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        d_ff=5632, max_seq_len=4096),
    "llama-7b": TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        d_ff=11008, max_seq_len=4096),
    # head_dim=128 geometry
    "tpu-125m": TransformerConfig(
        vocab_size=32000, d_model=768, n_layers=12, n_heads=6, n_kv_heads=6,
        d_ff=2048, max_seq_len=2048),
    "tpu-350m": TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=24, n_heads=8, n_kv_heads=8,
        d_ff=2816, max_seq_len=2048),
    "tpu-1b": TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, d_ff=5632, max_seq_len=4096),
    # head_dim=128 with 4:1 GQA
    "tpu-3b": TransformerConfig(
        vocab_size=32000, d_model=3072, n_layers=24, n_heads=24,
        n_kv_heads=8, d_ff=8192, max_seq_len=4096),
    "tpu-7b": TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=11264, max_seq_len=4096),
    # MoE family (models/moe.py)
    "moe-debug": TransformerConfig(
        vocab_size=1024, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=512, max_seq_len=512, n_experts=4, expert_top_k=2),
    "mixtral-8x7b": TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=4096, n_experts=8, expert_top_k=2),
}

from ray_tpu_torch.models.convert import (  # noqa: E402
    block_params_from_jax, init_params, jax_leaf_groups, params_from_jax,
    rl_params_from_jax, stage_state_dict)
from ray_tpu_torch.models.generate import make_generate_fn  # noqa: E402
from ray_tpu_torch.models.sampling import (sample_logits,  # noqa: E402
                                           sample_logits_dynamic)

__all__ = ["BlockStage", "TransformerConfig", "TransformerLM",
           "MODEL_REGISTRY", "block_params_from_jax", "count_params",
           "init_cache", "init_params", "jax_leaf_groups", "make_generate_fn",
           "params_from_jax", "rl_params_from_jax", "sample_logits",
           "sample_logits_dynamic", "stage_state_dict"]
