"""Continuous-batching LLM inference on one device (slot-pool KV cache,
chunked prefill under a token budget, persistent decode loop, per-request
token streaming). See engine.py."""

from ray_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.inference.scheduler import (FINISH_CANCELLED,
                                               FINISH_DEADLINE, FINISH_EOS,
                                               FINISH_LENGTH, Request,
                                               RequestHandle, Scheduler)

__all__ = ["EngineConfig", "InferenceEngine", "Request", "RequestHandle",
           "Scheduler", "FINISH_CANCELLED", "FINISH_DEADLINE", "FINISH_EOS",
           "FINISH_LENGTH"]
