"""Train config (counterpart of ``ray_tpu/train/config.py``): the failure
budget the MPMD pipeline trainer recovers under. ``ScalingConfig``,
``RunConfig`` and the rest configure the gang trainer, which sits on the
train executor (ROADMAP.md, Queue A item A3c) and is not ported yet."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FailureConfig:
    """Failure budget + restart granularity for training runs.

    restart_policy:
      "job"   — any worker death restarts the WHOLE gang from the latest
                checkpoint.
      "stage" — only the dead party restarts: the MPMD pipeline trainer
                replaces the lost STAGE (park → restore shard → replay)
                while survivors keep their state.
    restart_backoff_s: delay before any restart/replace attempt.
    """
    max_failures: int = 0
    restart_policy: str = "job"
    restart_backoff_s: float = 1.0

    def __post_init__(self):
        if self.restart_policy not in ("job", "stage"):
            raise ValueError(
                f"restart_policy must be 'job' or 'stage', "
                f"got {self.restart_policy!r}")
        if self.restart_backoff_s < 0:
            raise ValueError("restart_backoff_s must be >= 0")
