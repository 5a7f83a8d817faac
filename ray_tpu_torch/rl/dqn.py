"""DQN: off-policy Q-learning with replay and a target network
(reference: rllib/algorithms/dqn/ — double-DQN target, epsilon-greedy
exploration; the Q update is one function on the learner's device, target
sync by period). The runners' Q nets run on the CPU (rl/env_runner.py says
why); the update runs in process on ``learner_device`` (DQNLearner).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import to_device
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            make_replay_buffer)
from ray_tpu_torch.rl.rl_module import dense, load_weights, weights_of


class QEnvRunner:
    """Epsilon-greedy transition collector over gym vector envs."""

    def __init__(self, config: Dict):
        from ray_tpu_torch.rl.connectors import (apply_pipeline,
                                                 build_pipeline,
                                                 peek_pipeline,
                                                 pipeline_output_shape)
        from ray_tpu_torch.rl.env_runner import (make_vector_env,
                                                 one_thread_in_actor)
        one_thread_in_actor()
        self.cfg = config
        self.n_envs = config["num_envs_per_env_runner"]
        # SAME_STEP autoreset + final-obs patching (see rl/sac.py); the Q
        # net runs on the CPU, as every env runner's policy does
        self.envs = make_vector_env(config)
        self._pipeline = build_pipeline(config.get("connectors") or ())
        self._apply_pipeline = apply_pipeline
        self._peek_pipeline = peek_pipeline
        obs_dim = int(np.prod(pipeline_output_shape(
            config.get("connectors") or (),
            self.envs.single_observation_space.shape)))
        self.action_dim = self.envs.single_action_space.n
        self.net = QNet(obs_dim, self.action_dim,
                        tuple(config.get("hidden_sizes", (64, 64))),
                        seed=config.get("seed", 0))
        self.rng = np.random.default_rng(
            config.get("seed", 0) + config.get("runner_index", 0) * 1000)
        self.obs, _ = self.envs.reset(
            seed=config.get("seed", 0) + config.get("runner_index", 0))
        self._cobs = self._apply_pipeline(
            self._pipeline, self.obs.astype(np.float32), is_reset=True)
        self._episode_returns = []
        self._running_returns = np.zeros(self.n_envs)

    def set_weights(self, weights):
        load_weights(self.net, weights)
        return True

    def sample(self, num_steps: Optional[int] = None,
               epsilon: float = 0.1) -> Dict[str, np.ndarray]:
        T = num_steps or self.cfg["rollout_fragment_length"]
        N = self.n_envs
        obs_b, act_b, rew_b, done_b, next_b = [], [], [], [], []
        obs = self.obs
        cobs = self._cobs
        for _ in range(T):
            with torch.no_grad():
                q = self.net(torch.as_tensor(cobs, dtype=torch.float32))
            q = q.numpy()
            greedy = q.argmax(-1)
            random_a = self.rng.integers(0, self.action_dim, N)
            explore = self.rng.random(N) < epsilon
            action = np.where(explore, random_a, greedy)
            nxt, rew, term, trunc, info = self.envs.step(action)
            done = np.logical_or(term, trunc)
            true_next = nxt.astype(np.float32)
            if done.any() and "final_obs" in info:
                true_next = true_next.copy()
                mask = info.get("_final_obs", done)
                for i in np.nonzero(mask)[0]:
                    true_next[i] = info["final_obs"][i]
            obs_b.append(cobs.copy())
            act_b.append(action)
            rew_b.append(rew)
            # bootstrap through time-limit truncation, not termination
            done_b.append(term.astype(np.float32))
            next_b.append(self._peek_pipeline(self._pipeline, true_next))
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
                "actions": cat(act_b).astype(np.int64),
                "rewards": cat(rew_b).astype(np.float32),
                "dones": cat(done_b).astype(np.float32),
                "next_obs": cat(next_b).astype(np.float32)}

    def get_metrics(self) -> Dict:
        return {"episode_return_mean":
                float(np.mean(self._episode_returns[-20:]))
                if self._episode_returns else None,
                "num_episodes": len(self._episode_returns)}


class QNet(nn.Module):
    """ReLU MLP -> one Q value per action (flax: Dense_0..Dense_k)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int], seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        sizes = [obs_dim, *hidden_sizes]
        self.hidden = nn.ModuleList(dense(a, b, g) for a, b in
                                    zip(sizes[:-1], sizes[1:]))
        self.out = dense(sizes[-1], action_dim, g)

    def forward(self, obs):
        x = obs
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.out(x)


class DQNLearner:
    """The Q net, its target copy and Adam on the learner's device; one
    double-DQN step per ``update``."""

    def __init__(self, config: Dict, obs_dim: int, action_dim: int):
        from ray_tpu_torch.rl.learner import make_adam
        self.device = resolve_device(config.get("learner_device", "cuda"))
        self.gamma = config["gamma"]
        self.net = QNet(obs_dim, action_dim,
                        tuple(config.get("hidden_sizes", (64, 64))),
                        seed=config.get("seed", 0)).to(self.device)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.params = list(self.net.parameters())
        self.optimizer = make_adam(self.params, config["lr"])

    def sync_target(self) -> None:
        self.target_net.load_state_dict(self.net.state_dict())

    def update(self, batch: Dict[str, torch.Tensor], weights: torch.Tensor):
        """One step on a minibatch of device tensors; ``weights`` are the
        per-sample importance weights (prioritized replay's IS correction;
        all ones under the uniform buffer). Returns (loss, td errors)."""
        for p in self.params:
            p.grad = None
        q = self.net(batch["obs"])
        q_a = q.gather(1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            # double DQN: the online net picks (first maximum, as
            # jnp.argmax), the target net values the pick
            best = self.net(batch["next_obs"]).argmax(-1)
            q_best = self.target_net(batch["next_obs"]).gather(
                1, best[:, None])[:, 0]
            target = batch["rewards"] + self.gamma \
                * (1 - batch["dones"]) * q_best
        td = q_a - target
        loss = (weights * td ** 2).mean()
        loss.backward()
        self.optimizer.step()
        return loss.detach(), td.detach()

    def get_weights(self) -> Dict[str, np.ndarray]:
        return weights_of(self.net)


class DQN:
    """Driver: epsilon-annealed sampling into a replay buffer, double-DQN
    updates, periodic target sync."""

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
        action_dim = probe.action_space.n
        probe.close()

        runner_cls = rt.remote(QEnvRunner)
        from ray_tpu_torch.rl.actor_manager import FaultTolerantRunnerSet
        self.env_runners = FaultTolerantRunnerSet(
            lambda i: runner_cls.remote({**cfg, "runner_index": i}),
            config.num_env_runners,
            max_restarts=config.max_env_runner_restarts,
            restart_enabled=config.restart_failed_env_runners,
            on_restart=lambda r: rt.get(
                r.set_weights.remote(self._current_weights_ref()),
                timeout=300))
        self.buffer = make_replay_buffer(
            config.replay_buffer_config, cfg.get("replay_capacity", 50_000),
            seed=config.seed)
        self.learner = DQNLearner(cfg, obs_dim, action_dim)
        self.iteration = 0
        self._grad_steps = 0
        self.epsilon = 1.0
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
        t0 = time.perf_counter()
        batches = self.env_runners.foreach(
            "sample", epsilon=self.epsilon, timeout=600)
        steps = 0
        for b in batches:
            self.buffer.add(b)
            steps += len(b["obs"])
        self.epsilon = max(0.05, self.epsilon * 0.95)

        loss = float("nan")
        if len(self.buffer) >= cfg.minibatch_size:
            prioritized = isinstance(self.buffer, PrioritizedReplayBuffer)
            for _ in range(cfg.num_epochs * 4):
                mb = self.buffer.sample(cfg.minibatch_size)
                indices = mb.pop("indices", None)
                weights = mb.pop("weights", None)
                w = (torch.as_tensor(weights, device=dev)
                     if weights is not None
                     else torch.ones(cfg.minibatch_size, device=dev))
                loss, td = self.learner.update(to_device(mb, dev), w)
                if prioritized:
                    self.buffer.update_priorities(indices, td.cpu().numpy())
                self._grad_steps += 1
                if self._grad_steps % 100 == 0:
                    self.learner.sync_target()
            loss = float(loss)
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
                "td_loss": loss, "epsilon": self.epsilon,
                "replay_size": len(self.buffer)}

    def train(self) -> Dict:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def stop(self):
        import ray_tpu_torch as rt
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:
                pass
        self.env_runners = []
