"""Continuous-batching LLM inference on one device (slot-pool KV cache,
chunked prefill under a token budget, persistent decode loop, per-request
token streaming, radix prefix cache, int8 KV blocks, KV span hand-off,
speculative decoding). See engine.py for the engine, api.py for its Serve
deployment (``LLMDeployment``, exported lazily: it imports the Serve
layer's weight plane only when a replica builds one)."""

from ray_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.inference.prefix_cache import RadixPrefixCache
from ray_tpu_torch.inference.scheduler import (FINISH_CANCELLED,
                                               FINISH_DEADLINE, FINISH_EOS,
                                               FINISH_LENGTH, Request,
                                               RequestHandle, Scheduler)
from ray_tpu_torch.inference.spec_decode import SpecDecodeConfig

__all__ = ["EngineConfig", "InferenceEngine", "LLMDeployment",
           "RadixPrefixCache", "Request",
           "RequestHandle", "Scheduler", "SpecDecodeConfig",
           "FINISH_CANCELLED", "FINISH_DEADLINE", "FINISH_EOS",
           "FINISH_LENGTH"]


def __getattr__(name):
    if name == "LLMDeployment":
        from ray_tpu_torch.inference.api import LLMDeployment
        return LLMDeployment
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
