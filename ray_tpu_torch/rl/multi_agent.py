"""Multi-agent RL: env API, env runner with policy mapping, and a
multi-policy PPO driver (reference: rllib/env/multi_agent_env.py,
rllib/env/multi_agent_env_runner.py, multi-module RLModule spec in
rllib/core/rl_module/ — policies train independently or shared via the
policy_mapping_fn, each on its own TorchLearner, on the config's
``learner_device``; the runners' policies run on the CPU).

Env contract (reference MultiAgentEnv):
    reset(seed) -> (obs: {agent_id: ob}, info)
    step(actions: {agent_id: act}) ->
        (obs, rewards, terminateds, truncateds, info)   # all keyed dicts;
        terminateds/truncateds carry "__all__" for episode end
    agents -> list of agent ids; observation/action spaces per agent via
    observation_space(agent), action_space(agent).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class MultiAgentEnv:
    """Base class; subclass and implement reset/step/spaces."""

    agents: List[str] = []

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        raise NotImplementedError

    def observation_space(self, agent_id: str):
        raise NotImplementedError

    def action_space(self, agent_id: str):
        raise NotImplementedError


@dataclasses.dataclass
class MultiAgentConfig:
    env_maker: Callable[[], MultiAgentEnv] = None
    # agent_id -> policy_id; shared policies = many agents -> one id
    policy_mapping_fn: Callable[[str], str] = lambda aid: aid
    num_env_runners: int = 2
    rollout_fragment_length: int = 64
    num_epochs: int = 4
    minibatch_size: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 0.5
    hidden_sizes: tuple = (64, 64)
    seed: int = 0
    # where each policy's learner updates: "cuda" unless asked for "cpu"
    learner_device: str = "cuda"
    # fault tolerance: dead/hung env runners are replaced in their slot
    # mid-training with current weights pushed to the replacement
    restart_failed_env_runners: bool = True
    max_runner_restarts: int = 3


class MultiAgentEnvRunner:
    """Steps one multi-agent env; groups per-agent trajectories by policy
    and computes GAE per agent stream (the role the reference's
    connector pipelines + MultiAgentEpisode play)."""

    def __init__(self, cfg: Dict, runner_index: int = 0):
        import torch

        from ray_tpu_torch.rl.env_runner import one_thread_in_actor
        from ray_tpu_torch.rl.rl_module import DiscreteRLModule
        one_thread_in_actor()
        self.cfg = cfg
        self.env = cfg["env_maker"]()
        self.mapping = cfg["policy_mapping_fn"]
        self.policies: Dict[str, DiscreteRLModule] = {}
        for aid in self.env.agents:
            pid = self.mapping(aid)
            if pid not in self.policies:
                obs_dim = int(np.prod(
                    self.env.observation_space(aid).shape))
                act_dim = self.env.action_space(aid).n
                self.policies[pid] = DiscreteRLModule(
                    obs_dim, act_dim, cfg.get("hidden_sizes", (64, 64)),
                    seed=cfg.get("seed", 0))
        # policies on the CPU (rl/env_runner.py says why), sampled from a
        # generator seeded as the JAX runner seeds its PRNGKey
        self.generator = torch.Generator().manual_seed(
            cfg.get("seed", 0) + runner_index * 1000)
        self.obs, _ = self.env.reset(seed=cfg.get("seed", 0) + runner_index)
        self.gamma = cfg["gamma"]
        self.lam = cfg["lambda_"]
        self._episode_return = 0.0
        self._episode_returns: List[float] = []

    def policy_ids(self) -> List[str]:
        return sorted(self.policies)

    def set_weights(self, weights: Dict[str, Any]):
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)
        return True

    def sample(self, num_steps: Optional[int] = None) -> Dict[str, Dict]:
        """Run `num_steps` env steps; returns {policy_id: flat batch with
        obs/actions/logp/advantages/value_targets}."""
        T = num_steps or self.cfg["rollout_fragment_length"]
        # per-agent trajectory buffers
        traj: Dict[str, Dict[str, list]] = {
            aid: {"obs": [], "act": [], "logp": [], "rew": [], "val": [],
                  "done": []}
            for aid in self.env.agents}
        for _ in range(T):
            actions = {}
            for aid, ob in self.obs.items():
                pol = self.policies[self.mapping(aid)]
                a, logp, v = pol.sample_actions(
                    np.asarray(ob, np.float32)[None], self.generator)
                actions[aid] = int(a[0])
                t = traj[aid]
                t["obs"].append(np.asarray(ob, np.float32))
                t["act"].append(int(a[0]))
                t["logp"].append(float(logp[0]))
                t["val"].append(float(v[0]))
            obs, rews, terms, truncs, _ = self.env.step(actions)
            done = bool(terms.get("__all__")) or bool(truncs.get("__all__"))
            for aid in actions:
                traj[aid]["rew"].append(float(rews.get(aid, 0.0)))
                traj[aid]["done"].append(1.0 if done else 0.0)
            self._episode_return += sum(rews.values())
            if done:
                self._episode_returns.append(self._episode_return)
                self._episode_return = 0.0
                obs, _ = self.env.reset()
            self.obs = obs

        out: Dict[str, Dict[str, list]] = {}
        for aid, t in traj.items():
            pid = self.mapping(aid)
            pol = self.policies[pid]
            # bootstrap with the value of the agent's current obs unless
            # the stream ended with a terminal
            if t["done"] and t["done"][-1] > 0:
                last_val = 0.0
            else:
                ob = np.asarray(self.obs[aid], np.float32)[None]
                _, v = pol.forward(ob)
                last_val = float(v[0])
            n = len(t["obs"])
            adv = np.zeros(n, np.float32)
            lastgaelam = 0.0
            for i in reversed(range(n)):
                nonterminal = 1.0 - t["done"][i]
                next_value = t["val"][i + 1] if i + 1 < n else last_val
                delta = t["rew"][i] + self.gamma * next_value * nonterminal \
                    - t["val"][i]
                lastgaelam = delta + self.gamma * self.lam * nonterminal \
                    * lastgaelam
                adv[i] = lastgaelam
            targets = adv + np.asarray(t["val"], np.float32)
            dst = out.setdefault(pid, {"obs": [], "actions": [], "logp": [],
                                       "advantages": [],
                                       "value_targets": []})
            dst["obs"].extend(t["obs"])
            dst["actions"].extend(t["act"])
            dst["logp"].extend(t["logp"])
            dst["advantages"].extend(adv.tolist())
            dst["value_targets"].extend(targets.tolist())
        return {pid: {"obs": np.asarray(b["obs"], np.float32),
                      "actions": np.asarray(b["actions"], np.int64),
                      "logp": np.asarray(b["logp"], np.float32),
                      "advantages": np.asarray(b["advantages"], np.float32),
                      "value_targets": np.asarray(b["value_targets"],
                                                  np.float32)}
                for pid, b in out.items()}

    def get_metrics(self) -> Dict:
        out = {"episode_return_mean":
               float(np.mean(self._episode_returns[-20:]))
               if self._episode_returns else None,
               "episodes": len(self._episode_returns)}
        return out


class MultiAgentPPO:
    """PPO over a policy map: each policy updates on the experience of the
    agents mapped to it (reference: multi-agent training_step in
    algorithm.py + LearnerGroup with a module per policy)."""

    def __init__(self, config: MultiAgentConfig):
        import ray_tpu_torch as rt
        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl.actor_manager import FaultTolerantRunnerSet
        from ray_tpu_torch.rl.learner import TorchLearner

        self.config = config
        cfg_dict = dataclasses.asdict(config)
        cfg_dict["env_maker"] = config.env_maker
        cfg_dict["policy_mapping_fn"] = config.policy_mapping_fn
        resolve_device(config.learner_device)
        runner_cls = rt.remote(num_cpus=0.25)(MultiAgentEnvRunner)
        # fault-tolerant runner set: slot i is always runner_index=i, so a
        # restart preserves seeding/sharding; the on_restart hook (below,
        # once learners exist) pushes the CURRENT per-policy weights so a
        # replacement rejoins mid-training at the live optimum
        self.env_runners = FaultTolerantRunnerSet(
            lambda i: runner_cls.remote(cfg_dict, i),
            config.num_env_runners,
            max_restarts=config.max_runner_restarts,
            restart_enabled=config.restart_failed_env_runners)
        # learners are built from the env's spaces, one per policy
        probe = config.env_maker()
        self.learners: Dict[str, TorchLearner] = {}
        for aid in probe.agents:
            pid = config.policy_mapping_fn(aid)
            if pid not in self.learners:
                obs_dim = int(np.prod(probe.observation_space(aid).shape))
                act_dim = probe.action_space(aid).n
                self.learners[pid] = TorchLearner(cfg_dict, obs_dim, act_dim)
        self.env_runners.set_on_restart(self._restore_runner)
        self.iteration = 0
        self._sync_weights()

    def _restore_runner(self, runner):
        import ray_tpu_torch as rt
        weights = {pid: ln.get_weights()
                   for pid, ln in self.learners.items()}
        rt.get(runner.set_weights.remote(rt.put(weights)), timeout=60.0)

    def _sync_weights(self):
        weights = {pid: ln.get_weights()
                   for pid, ln in self.learners.items()}
        import ray_tpu_torch as rt
        ref = rt.put(weights)
        self.env_runners.foreach("set_weights", ref, timeout=120.0)

    def training_step(self) -> Dict:
        batches = self.env_runners.foreach("sample")
        merged: Dict[str, Dict[str, np.ndarray]] = {}
        for b in batches:
            for pid, pb in b.items():
                dst = merged.setdefault(pid, {})
                for k, v in pb.items():
                    dst.setdefault(k, []).append(v)
        stats = {}
        for pid, pb in merged.items():
            batch = {k: np.concatenate(v) for k, v in pb.items()}
            stats[pid] = self.learners[pid].update_from_batch(batch)
        self._sync_weights()
        self.iteration += 1
        return stats

    def train(self) -> Dict:
        stats = self.training_step()
        metrics = self.env_runners.foreach("get_metrics")
        returns = [m["episode_return_mean"] for m in metrics
                   if m["episode_return_mean"] is not None]
        return {"iteration": self.iteration,
                "episode_return_mean":
                    float(np.mean(returns)) if returns else None,
                "learners": stats}
