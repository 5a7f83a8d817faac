"""AlgorithmConfig: fluent builder (reference:
rllib/algorithms/algorithm_config.py — .environment().env_runners()
.training() chaining, new API stack).

The port's config adds one field, the learner's device (``learner_device``,
set with ``.learners(device=...)``): "cuda" by default, resolved by
``ray_tpu_torch.device.resolve_device`` where a learner is built, so a
learner without a card raises unless it is asked for the CPU. Env runners
run their policy on the CPU whatever it says (rl/env_runner.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class AlgorithmConfig:
    env: Optional[str] = None
    env_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 4
    rollout_fragment_length: int = 64
    train_batch_size: int = 512
    minibatch_size: int = 128
    num_epochs: int = 4
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 0.5
    hidden_sizes: tuple = (64, 64)
    num_learners: int = 1
    # where the learners update the policy (the env runners stay on the
    # CPU): "cuda" by default; "cpu" only when asked for
    learner_device: str = "cuda"
    seed: int = 0
    # env-to-module connector pipeline, e.g.
    # [("frame_stack", {"k": 4}), ("normalize_obs", {})]
    connectors: tuple = ()
    # off-policy knobs (DQN / SAC)
    replay_capacity: int = 50_000
    tau: float = 0.005              # polyak target coefficient
    initial_alpha: float = 0.2      # SAC entropy temperature (auto-tuned)
    target_entropy: Optional[float] = None   # default: -action_dim
    updates_per_step: float = 1.0   # grad updates per env step (SAC)
    # replay buffer selection (reference: replay_buffer_config) —
    # {"type": "uniform"} or {"type": "prioritized", "alpha": .., "beta": ..}
    replay_buffer_config: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"type": "uniform"})
    # recurrent policy (reference: model_config use_lstm) — IMPALA/APPO
    use_lstm: bool = False
    # APPO: learner steps between hard target-network syncs
    target_update_freq: int = 2
    # env-runner fault tolerance (reference: AlgorithmConfig
    # .fault_tolerance(restart_failed_env_runners=True) +
    # rllib/utils/actor_manager.py): dead runners are replaced in-slot
    # mid-training, current weights re-pushed, their round dropped
    restart_failed_env_runners: bool = True
    max_env_runner_restarts: int = 3

    # fluent builder API (reference: AlgorithmConfig chaining)
    def environment(self, env: str, env_config: Optional[Dict] = None):
        self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, num_learners: Optional[int] = None,
                 device: Optional[str] = None):
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.learner_device = str(device)
        return self

    def build(self):
        from ray_tpu_torch.rl.algorithm import PPO
        return PPO(self)
