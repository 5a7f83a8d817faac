"""SAC: soft actor-critic for continuous control (reference:
rllib/algorithms/sac/ — squashed-Gaussian policy, twin Q with a min
target, polyak-averaged target networks, auto-tuned entropy temperature;
target sync by tau each step).

Every grad update (both critics, then the actor against the UPDATED
critics, then alpha from the actor's log-probs, then the polyak step) is
one call of SACLearner.update on the learner's device. The JAX package
draws the update's two normal draws inside its jitted step from
``split(key)``; here the update takes them as tensors (the driver draws
them from its own ``torch.Generator``), so the same draws can be fed to
both. The runners' policies run on the CPU (rl/env_runner.py says why)."""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import make_adam, to_device
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            make_replay_buffer)
from ray_tpu_torch.rl.rl_module import dense, load_weights, weights_of

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _relu_mlp(sizes, g) -> nn.ModuleList:
    return nn.ModuleList(dense(a, b, g) for a, b in zip(sizes[:-1],
                                                          sizes[1:]))


class Policy(nn.Module):
    """ReLU MLP -> (mean, log_std clipped to [-20, 2]) (flax:
    Dense_0..k-1 hidden, Dense_k mean, Dense_k+1 log_std)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int], generator: torch.Generator):
        super().__init__()
        sizes = [obs_dim, *hidden_sizes]
        self.hidden = _relu_mlp(sizes, generator)
        self.mean = dense(sizes[-1], action_dim, generator)
        self.log_std = dense(sizes[-1], action_dim, generator)

    def forward(self, obs):
        x = obs
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN,
                                         LOG_STD_MAX)


class TwinQ(nn.Module):
    """Two ReLU-MLP critics over [obs, action] (flax numbers both heads'
    layers in one sequence: q1's Dense_0..k, then q2's)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int], generator: torch.Generator):
        super().__init__()
        sizes = [obs_dim + action_dim, *hidden_sizes]
        self.q1 = _relu_mlp(sizes, generator)
        self.q1_out = dense(sizes[-1], 1, generator)
        self.q2 = _relu_mlp(sizes, generator)
        self.q2_out = dense(sizes[-1], 1, generator)

    def forward(self, obs, action):
        x = torch.cat([obs, action], -1)
        qs = []
        for layers, out in ((self.q1, self.q1_out), (self.q2, self.q2_out)):
            h = x
            for layer in layers:
                h = torch.relu(layer(h))
            qs.append(out(h)[..., 0])
        return qs[0], qs[1]


def make_nets(obs_dim: int, action_dim: int, hidden_sizes: Sequence[int],
              seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (Policy(obs_dim, action_dim, tuple(hidden_sizes), g),
            TwinQ(obs_dim, action_dim, tuple(hidden_sizes), g))


def squashed_sample(mean, log_std, noise):
    """a = tanh(u), u = mean + std * noise; returns (action, logp) with
    the tanh change-of-variables correction (SAC paper appendix C)."""
    std = torch.exp(log_std)
    u = mean + std * noise
    logp_u = (-0.5 * ((u - mean) / std) ** 2 - log_std
              - 0.5 * math.log(2 * math.pi)).sum(-1)
    a = torch.tanh(u)
    logp = logp_u - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a, logp


class SacEnvRunner:
    """Stochastic transition collector; actions squashed to [-1,1] and
    affine-mapped to the env's Box bounds."""

    def __init__(self, config: Dict):
        from ray_tpu_torch.rl.env_runner import (make_vector_env,
                                                 one_thread_in_actor)
        one_thread_in_actor()
        self.cfg = config
        self.n_envs = config["num_envs_per_env_runner"]
        # SAME_STEP autoreset (see rl/env_runner.py) — the done step
        # returns the reset obs; the TRUE final obs rides in infos and
        # patches next_obs so Q targets never bootstrap across episodes.
        # The policy runs on the CPU, as every env runner's does.
        self.envs = make_vector_env(config)
        space = self.envs.single_action_space
        self.low = np.asarray(space.low, np.float32)
        self.high = np.asarray(space.high, np.float32)
        from ray_tpu_torch.rl.connectors import (apply_pipeline,
                                                 build_pipeline,
                                                 peek_pipeline,
                                                 pipeline_output_shape)
        self._pipeline = build_pipeline(config.get("connectors") or ())
        self._apply_pipeline = apply_pipeline
        self._peek_pipeline = peek_pipeline
        obs_dim = int(np.prod(pipeline_output_shape(
            config.get("connectors") or (),
            self.envs.single_observation_space.shape)))
        action_dim = int(np.prod(space.shape))
        self.policy, _ = make_nets(obs_dim, action_dim,
                                   config.get("hidden_sizes", (64, 64)),
                                   seed=config.get("seed", 0))
        self.generator = torch.Generator().manual_seed(
            config.get("seed", 0) + config.get("runner_index", 0) * 997)
        # warmup random actions share the config.seed reproducibility
        # contract with the generator above
        self._np_rng = np.random.default_rng(
            config.get("seed", 0) + config.get("runner_index", 0) * 997 + 1)
        self.obs, _ = self.envs.reset(
            seed=config.get("seed", 0) + config.get("runner_index", 0))
        self._cobs = self._apply_pipeline(
            self._pipeline, self.obs.astype(np.float32), is_reset=True)
        self._episode_returns = []
        self._running_returns = np.zeros(self.n_envs)

    def set_weights(self, weights):
        load_weights(self.policy, weights)
        return True

    def _to_env(self, a: np.ndarray) -> np.ndarray:
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)

    def sample(self, num_steps: Optional[int] = None,
               random_actions: bool = False) -> Dict[str, np.ndarray]:
        T = num_steps or self.cfg["rollout_fragment_length"]
        N = self.n_envs
        obs_b, act_b, rew_b, done_b, next_b = [], [], [], [], []
        obs = self.obs
        cobs = self._cobs
        for _ in range(T):
            if random_actions:
                a = self._np_rng.uniform(-1, 1, (N,) + self.low.shape)
            else:
                with torch.no_grad():
                    mean, log_std = self.policy(
                        torch.as_tensor(cobs, dtype=torch.float32))
                    noise = torch.randn(mean.shape, generator=self.generator)
                    a, _ = squashed_sample(mean, log_std, noise)
                a = a.numpy()
            nxt, rew, term, trunc, info = self.envs.step(self._to_env(a))
            done = np.logical_or(term, trunc)
            # true next obs: at done steps the env already reset, the
            # actual final observation is in infos (SAME_STEP mode)
            true_next = nxt.astype(np.float32)
            if done.any() and "final_obs" in info:
                true_next = true_next.copy()
                mask = info.get("_final_obs", done)
                for i in np.nonzero(mask)[0]:
                    true_next[i] = info["final_obs"][i]
            cnext = self._peek_pipeline(self._pipeline, true_next)
            obs_b.append(cobs.copy())
            act_b.append(a)
            rew_b.append(rew)
            done_b.append(term.astype(np.float32))  # bootstrap truncation
            next_b.append(cnext)
            self._running_returns += rew
            for i, d in enumerate(done):
                if d:
                    self._episode_returns.append(self._running_returns[i])
                    self._running_returns[i] = 0.0
            obs = nxt
            cobs = self._apply_pipeline(self._pipeline,
                                        nxt.astype(np.float32),
                                        reset_mask=done)
        self.obs = obs
        self._cobs = cobs
        cat = lambda xs: np.concatenate(xs, 0)  # noqa: E731
        return {"obs": cat(obs_b).astype(np.float32),
                "actions": cat(act_b).astype(np.float32),
                "rewards": cat(rew_b).astype(np.float32),
                "dones": cat(done_b).astype(np.float32),
                "next_obs": cat(next_b).astype(np.float32)}

    def get_metrics(self) -> Dict:
        return {"episode_return_mean":
                float(np.mean(self._episode_returns[-20:]))
                if self._episode_returns else None,
                "num_episodes": len(self._episode_returns)}


class SACLearner:
    """The policy, the twin Q and its polyak target, log alpha and their
    three Adams on the learner's device."""

    def __init__(self, config: Dict, obs_dim: int, action_dim: int):
        self.device = resolve_device(config.get("learner_device", "cuda"))
        self.action_dim = action_dim
        pi, q = make_nets(obs_dim, action_dim,
                          config.get("hidden_sizes", (64, 64)),
                          seed=config.get("seed", 0))
        self.pi, self.q = pi.to(self.device), q.to(self.device)
        self.q_target = copy.deepcopy(self.q).requires_grad_(False)
        self.log_alpha = torch.tensor(
            math.log(config["initial_alpha"]), device=self.device,
            requires_grad=True)
        self.pi_params = list(self.pi.parameters())
        self.q_params = list(self.q.parameters())
        lr = config["lr"]
        self.opt = {"pi": make_adam(self.pi_params, lr),
                    "q": make_adam(self.q_params, lr),
                    "alpha": make_adam([self.log_alpha], lr)}
        self.gamma = config["gamma"]
        self.tau = config["tau"]
        self.target_entropy = (config["target_entropy"]
                               if config.get("target_entropy") is not None
                               else -float(action_dim))

    def update(self, batch: Dict[str, torch.Tensor], weights: torch.Tensor,
               noise_q: torch.Tensor, noise_pi: torch.Tensor):
        """One SAC step on a minibatch of device tensors. ``noise_q`` and
        ``noise_pi`` are the standard normal draws ([B, action_dim]) of
        the next-state action in the critics' target and of the actor's
        action. Returns (metrics as tensors, td errors)."""
        gamma, tau = self.gamma, self.tau
        # critics first
        with torch.no_grad():
            mean, log_std = self.pi(batch["next_obs"])
            a2, logp2 = squashed_sample(mean, log_std, noise_q)
            tq1, tq2 = self.q_target(batch["next_obs"], a2)
            alpha = torch.exp(self.log_alpha)
            target = batch["rewards"] + gamma * (1 - batch["dones"]) * (
                torch.minimum(tq1, tq2) - alpha * logp2)
        for p in self.q_params:
            p.grad = None
        q1, q2 = self.q(batch["obs"], batch["actions"])
        # per-sample IS weights (prioritized replay; ones = uniform)
        td = 0.5 * (torch.abs(q1 - target) + torch.abs(q2 - target))
        q_loss = (weights * ((q1 - target) ** 2
                             + (q2 - target) ** 2)).mean()
        q_loss.backward()
        self.opt["q"].step()
        # the actor against the UPDATED critics
        for p in self.pi_params:
            p.grad = None
        mean, log_std = self.pi(batch["obs"])
        a, logp = squashed_sample(mean, log_std, noise_pi)
        q1, q2 = self.q(batch["obs"], a)
        alpha = torch.exp(self.log_alpha).detach()
        pi_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        pi_loss.backward(inputs=self.pi_params)
        self.opt["pi"].step()
        # alpha from the actor loss's log-probs
        self.log_alpha.grad = None
        alpha_loss = (-torch.exp(self.log_alpha)
                      * (logp.detach() + self.target_entropy)).mean()
        alpha_loss.backward()
        self.opt["alpha"].step()
        # polyak last
        with torch.no_grad():
            for t, q in zip(self.q_target.parameters(), self.q_params):
                t.copy_((1 - tau) * t + tau * q)
        return ({"q_loss": q_loss.detach(), "pi_loss": pi_loss.detach(),
                 "alpha": torch.exp(self.log_alpha).detach()},
                td.detach())

    def get_weights(self) -> Dict[str, np.ndarray]:
        return weights_of(self.pi)


class SAC:
    """Driver: replay collection + one SACLearner.update (critics, actor,
    alpha, polyak) per minibatch on the learner's device."""

    def __init__(self, config: AlgorithmConfig):
        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.rl import envs as _envs
        _envs.register_envs()
        self.config = config
        cfg = dataclasses.asdict(config)
        resolve_device(config.learner_device)
        probe = gym.make(config.env, **config.env_config)
        from ray_tpu_torch.rl.connectors import pipeline_output_shape
        obs_dim = int(np.prod(pipeline_output_shape(
            config.connectors or (), probe.observation_space.shape)))
        action_dim = int(np.prod(probe.action_space.shape))
        probe.close()

        runner_cls = rt.remote(SacEnvRunner)
        from ray_tpu_torch.rl.actor_manager import FaultTolerantRunnerSet
        self.env_runners = FaultTolerantRunnerSet(
            lambda i: runner_cls.remote({**cfg, "runner_index": i}),
            config.num_env_runners,
            max_restarts=config.max_env_runner_restarts,
            restart_enabled=config.restart_failed_env_runners,
            on_restart=lambda r: rt.get(
                r.set_weights.remote(self._current_weights_ref()),
                timeout=300))
        self.buffer = make_replay_buffer(config.replay_buffer_config,
                                         config.replay_capacity,
                                         seed=config.seed)
        self.learner = SACLearner(cfg, obs_dim, action_dim)
        self._gen = torch.Generator(device=self.learner.device).manual_seed(
            config.seed + 7)
        self.iteration = 0
        self._warmup = True
        self._sync_runner_weights()

    def _current_weights_ref(self):
        import ray_tpu_torch as rt
        return rt.put(self.learner.get_weights())

    def _sync_runner_weights(self):
        self.env_runners.foreach("set_weights",
                                 self._current_weights_ref(), timeout=300)

    def training_step(self) -> Dict:
        cfg = self.config
        dev = self.learner.device
        shape = (cfg.minibatch_size, self.learner.action_dim)
        t0 = time.perf_counter()
        batches = self.env_runners.foreach(
            "sample", random_actions=self._warmup, timeout=600)
        self._warmup = False
        steps = 0
        for b in batches:
            self.buffer.add(b)
            steps += len(b["obs"])
        metrics = {}
        if len(self.buffer) >= cfg.minibatch_size:
            prioritized = isinstance(self.buffer, PrioritizedReplayBuffer)
            n_updates = max(1, int(steps * cfg.updates_per_step))
            for _ in range(n_updates):
                mb = self.buffer.sample(cfg.minibatch_size)
                indices = mb.pop("indices", None)
                weights = mb.pop("weights", None)
                w = (torch.as_tensor(weights, device=dev)
                     if weights is not None
                     else torch.ones(cfg.minibatch_size, device=dev))
                noise = [torch.randn(shape, generator=self._gen, device=dev)
                         for _ in range(2)]
                metrics, td = self.learner.update(to_device(mb, dev), w,
                                                  *noise)
                if prioritized:
                    self.buffer.update_priorities(indices, td.cpu().numpy())
            metrics = {k: float(v) for k, v in metrics.items()}
        self._sync_runner_weights()
        wall = time.perf_counter() - t0
        runner_metrics = self.env_runners.foreach("get_metrics",
                                                  timeout=120)
        returns = [m["episode_return_mean"] for m in runner_metrics
                   if m["episode_return_mean"] is not None]
        return {"episode_return_mean":
                float(np.mean(returns)) if returns else None,
                "num_env_steps_sampled": steps,
                "env_steps_per_s": steps / max(1e-9, wall),
                "replay_size": len(self.buffer), **metrics}

    def train(self) -> Dict:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        import ray_tpu_torch as rt
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:
                pass
        self.env_runners = []
