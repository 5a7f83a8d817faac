"""Algorithm: the RL training driver (reference:
rllib/algorithms/algorithm.py:228 — step() :881; PPO training_step
rllib/algorithms/ppo/ppo.py:403: parallel EnvRunner.sample() →
LearnerGroup.update → weight sync → metrics). The env runners are CPU
actors on the port's runtime; the learner group updates on the config's
``learner_device``."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfig


def learner_config(config: AlgorithmConfig, obs_shape, action_spec) -> Dict:
    """The dict a learner (and each env runner) is built from: the
    config's fields with the connected observation shape and the action
    spec of the env."""
    cfg = dataclasses.asdict(config)
    cfg["obs_shape"] = list(obs_shape)
    cfg["action_spec"] = action_spec
    return cfg


class Algorithm:
    # recurrent (use_lstm) policies need time-major trajectory learning;
    # only the V-trace family implements it (IMPALA/APPO set this True)
    supports_recurrence = False

    def __init__(self, config: AlgorithmConfig):
        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.rl import envs as _envs
        from ray_tpu_torch.rl.env_runner import EnvRunner
        from ray_tpu_torch.rl.rl_module import action_spec_of
        _envs.register_envs()
        if getattr(config, "use_lstm", False) \
                and not self.supports_recurrence:
            raise ValueError(
                f"use_lstm is not supported by "
                f"{type(self).__name__}; use IMPALA or APPO (their "
                f"time-major V-trace losses carry the LSTM state)")
        self.config = config
        # a learner that cannot be built fails before any runner starts
        resolve_device(config.learner_device)
        probe = gym.make(config.env, **config.env_config)
        from ray_tpu_torch.rl.connectors import pipeline_output_shape
        # the learner's module sees CONNECTED observations
        obs_shape = pipeline_output_shape(config.connectors or (),
                                          probe.observation_space.shape)
        obs_dim = int(np.prod(obs_shape))
        spec = action_spec_of(probe.action_space)
        action_dim = spec.get("n") or spec["dim"]
        probe.close()

        cfg_dict = learner_config(config, obs_shape, spec)
        runner_cls = rt.remote(EnvRunner)
        from ray_tpu_torch.rl.actor_manager import FaultTolerantRunnerSet
        self.env_runners = FaultTolerantRunnerSet(
            lambda i: runner_cls.remote({**cfg_dict, "runner_index": i}),
            config.num_env_runners,
            max_restarts=config.max_env_runner_restarts,
            restart_enabled=config.restart_failed_env_runners)
        self._build_learner(cfg_dict, obs_dim, action_dim)
        # restarted runners immediately receive the CURRENT weights (a
        # fresh actor would otherwise sample one round at init weights);
        # the re-push rides the broadcast plane — the blob is already on
        # the restart node's arena, so set_weights resolves locally
        self.env_runners.set_on_restart(
            lambda r: rt.get(
                r.set_weights.remote(
                    self.env_runners.broadcast_weights(self.get_weights())),
                timeout=300))
        self.iteration = 0
        self._sync_weights()

    def _build_learner(self, cfg_dict, obs_dim, action_dim):
        from ray_tpu_torch.rl.learner import LearnerGroup
        self.learner_group = LearnerGroup(cfg_dict, obs_dim, action_dim)

    def _sync_weights(self):
        # one broadcast instead of num_env_runners point-to-point pulls:
        # every runner's set_weights arg is already in its node's arena
        weights_ref = self.env_runners.broadcast_weights(
            self.learner_group.get_weights())
        self.env_runners.foreach("set_weights", weights_ref, timeout=300)

    def training_step(self) -> Dict:
        t0 = time.perf_counter()
        # dead runners are replaced in-slot; the round proceeds on the
        # survivors' batches (reference: restart_failed_env_runners)
        batches = self.env_runners.foreach("sample", timeout=600)
        sample_time = time.perf_counter() - t0
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in batches[0]}
        t1 = time.perf_counter()
        learn_metrics = self.learner_group.update_from_batch(batch)
        learn_time = time.perf_counter() - t1
        self._sync_weights()
        runner_metrics = self.env_runners.foreach("get_metrics",
                                                  timeout=120)
        returns = [m["episode_return_mean"] for m in runner_metrics
                   if m["episode_return_mean"] is not None]
        steps = len(batch["obs"])
        return {
            "episode_return_mean":
                float(np.mean(returns)) if returns else None,
            "num_env_steps_sampled": steps,
            "env_steps_per_s": steps / max(1e-9, sample_time),
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
            **learn_metrics,
        }

    def train(self) -> Dict:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self):
        import ray_tpu_torch as rt
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:
                pass
        self.env_runners = []


class PPO(Algorithm):
    """Clipped-surrogate PPO with GAE (the loss lives in TorchLearner)."""
