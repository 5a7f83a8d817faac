"""Continuous-batching LLM inference on one device (slot-pool KV cache,
chunked prefill under a token budget, persistent decode loop, per-request
token streaming, radix prefix cache, int8 KV blocks, KV span hand-off,
speculative decoding). See engine.py."""

from ray_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.inference.prefix_cache import RadixPrefixCache
from ray_tpu_torch.inference.scheduler import (FINISH_CANCELLED,
                                               FINISH_DEADLINE, FINISH_EOS,
                                               FINISH_LENGTH, Request,
                                               RequestHandle, Scheduler)
from ray_tpu_torch.inference.spec_decode import SpecDecodeConfig

__all__ = ["EngineConfig", "InferenceEngine", "RadixPrefixCache", "Request",
           "RequestHandle", "Scheduler", "SpecDecodeConfig",
           "FINISH_CANCELLED", "FINISH_DEADLINE", "FINISH_EOS",
           "FINISH_LENGTH"]
