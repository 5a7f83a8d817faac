"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model, training step
and serving path, for an NVIDIA H100.

It stands beside ``ray_tpu`` (the JAX reference, which it never imports).
Plain tensor code is PyTorch; each Pallas kernel of ``ray_tpu`` becomes a
kernel written by hand for Hopper under ``ops/csrc``, built at first use.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch.inference import (EngineConfig, InferenceEngine,
                                     SpecDecodeConfig)
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerConfig,
                                  TransformerLM, init_cache, init_params,
                                  make_generate_fn, params_from_jax)
from ray_tpu_torch.ops import flash_attention
from ray_tpu_torch.parallel import (TrainState, adafactor, adamw,
                                    make_train_fns)

__all__ = ["EngineConfig", "InferenceEngine", "MODEL_REGISTRY",
           "SpecDecodeConfig", "TrainState", "TransformerConfig",
           "TransformerLM", "adafactor", "adamw", "flash_attention",
           "init_cache", "init_params", "make_generate_fn", "make_train_fns",
           "params_from_jax"]
