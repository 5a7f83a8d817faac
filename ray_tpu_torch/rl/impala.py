"""IMPALA: async actor-learner RL with V-trace off-policy correction
(reference: rllib/algorithms/impala/impala.py — async EnvRunner sampling
with aggregator-style batching :617, vtrace loss; re-designed: the learner
update is one function and asynchrony comes from the runtime's ``wait``
over in-flight sample futures rather than dedicated aggregator actors —
re-issue a runner's next fragment before learning on its last one)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import (clip_by_global_norm_, make_adam,
                                      to_device)


def _seq_forward(module, batch, net=None):
    """(dist, values [T,B]) for a time-major trajectory batch, where
    dist is the module family's distribution parameters (logits for
    categorical, (mean, log_std) for Gaussian — consumed by the module's
    `seq_logp_entropy`). ``net`` is the module's own net unless given
    (APPO's lagged target). Recurrent- and conv-aware: feedforward modules
    flatten time into the batch; recurrent modules re-derive every LSTM
    state with an unroll from the fragment's initial carry, resetting
    exactly where the runner's episodes did (connector state
    discipline)."""
    T, B = batch["dones"].shape
    if module.is_recurrent:
        resets = torch.cat([torch.zeros_like(batch["dones"][:1]),
                            batch["dones"][:-1]], dim=0)
        carry0 = (batch["initial_state_c"], batch["initial_state_h"])
        dist, values, _ = module.forward_seq(batch["obs"], resets, carry0,
                                             net)
        return dist, values
    obs = batch["obs"].reshape((T * B,) + tuple(batch["obs"].shape[2:]))
    dist, values = module.dist_values(obs, net)
    unflat = lambda a: a.reshape((T, B) + tuple(a.shape[1:]))  # noqa: E731
    dist = (tuple(unflat(a) for a in dist) if isinstance(dist, tuple)
            else unflat(dist))
    return dist, values.reshape(T, B)


class ImpalaLearner:
    """Policy-gradient learner with a V-trace-corrected baseline.
    Modules come from the catalog factory, so IMPALA trains MLP, CNN
    (pixel envs) and LSTM (use_lstm) policies with one loss."""

    def __init__(self, config: Dict, obs_dim: int, action_dim: int):
        from ray_tpu_torch.rl.rl_module import make_rl_module

        self.cfg = config
        self.device = resolve_device(config.get("learner_device", "cuda"))
        obs_shape = tuple(config.get("obs_shape") or (obs_dim,))
        action_spec = (config.get("action_spec")
                       or {"type": "discrete", "n": action_dim})
        self.module = make_rl_module(
            obs_shape, action_spec, config.get("hidden_sizes", (64, 64)),
            seed=config.get("seed", 0),
            use_lstm=config.get("use_lstm", False), device=self.device)
        self.params = list(self.module.net.parameters())
        # adam rather than the paper's rmsprop(eps=0.1): at small-batch
        # scale the 0.1 epsilon floors the preconditioner and crushes the
        # effective step (no learning on CartPole-size nets); adam's 1e-8
        # epsilon keeps step sizes honest at every scale
        self.optimizer = make_adam(self.params, config["lr"])
        self.grad_clip = config.get("grad_clip", 40.0)

    def _loss(self, batch):
        from ray_tpu_torch.rl.vtrace import vtrace
        gamma = self.cfg["gamma"]
        module = self.module
        dist, values = _seq_forward(module, batch)
        tgt_logp, entropy = module.seq_logp_entropy(dist, batch["actions"])
        discounts = gamma * (1.0 - batch["dones"])
        vt = vtrace(batch["behavior_logp"], tgt_logp, batch["rewards"],
                    discounts, values, batch["bootstrap_value"])
        pg_loss = -(tgt_logp * vt.pg_advantages).mean()
        vf_loss = ((values - vt.vs) ** 2).mean()
        entropy = entropy.mean()
        total = pg_loss + self.cfg["vf_loss_coeff"] * vf_loss \
            - self.cfg["entropy_coeff"] * entropy
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def _update(self, batch):
        for p in self.params:
            p.grad = None
        loss, aux = self._loss(batch)
        loss.backward()
        clip_by_global_norm_(self.params, self.grad_clip)
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def update_from_trajectory(self, traj: Dict[str, np.ndarray]) -> Dict:
        batch = to_device({k: v for k, v in traj.items()
                           if k != "bootstrap_obs"}, self.device)
        # num_epochs passes per fragment: V-trace recomputes the
        # target-policy term each pass, so the rho/c clips absorb the
        # growing off-policyness — sample efficiency without aggregator
        # replay (reference IMPALA replays fragments via its aggregator
        # buffer for the same reason)
        for _ in range(max(1, int(self.cfg.get("num_epochs", 1)))):
            loss, aux = self._update(batch)
        out = {k: float(v) for k, v in aux.items()}
        out["total_loss"] = float(loss)
        return out

    def get_weights(self):
        return self.module.get_weights()


class IMPALA(Algorithm):
    """Async training_step: learn on fragments as they complete, re-issue
    sampling immediately, sync weights after every learner step."""

    supports_recurrence = True

    def __init__(self, config: AlgorithmConfig):
        self._inflight: Dict = {}
        super().__init__(config)

    def _build_learner(self, cfg_dict, obs_dim, action_dim):
        self.learner = ImpalaLearner(cfg_dict, obs_dim, action_dim)

    def _sync_weights(self):
        import ray_tpu_torch as rt
        ref = rt.put(self.learner.get_weights())
        self.env_runners.foreach("set_weights", ref, timeout=300)

    def training_step(self) -> Dict:
        import ray_tpu_torch as rt
        t0 = time.perf_counter()
        if not self._inflight:
            for r in self.env_runners:
                self._inflight[r.sample_trajectory.remote()] = r

        n_updates = 0
        steps = 0
        metrics: Dict = {}
        # learn on a full round of fragments, keeping the pipe full
        target = len(self.env_runners)
        while n_updates < target:
            ready, _ = rt.wait(list(self._inflight), num_returns=1,
                               timeout=600)
            ref = ready[0]
            runner = self._inflight.pop(ref)
            try:
                traj = rt.get(ref)
            except rt.ActorDiedError:
                # dead runner: replace in-slot (on_restart pushes current
                # weights) and put the replacement to work; this round
                # learns one fewer fragment. replace() returns None when
                # a foreach (e.g. weight sync) already replaced it — the
                # replacement is then the idle runner with no in-flight
                # work, so schedule that one.
                fresh = self.env_runners.replace(runner)
                if fresh is None:
                    busy = {id(r) for r in self._inflight.values()}
                    idle = [r for r in self.env_runners
                            if id(r) not in busy]
                    fresh = idle[0] if idle else None
                if fresh is not None:
                    self._inflight[fresh.sample_trajectory.remote()] = fresh
                n_updates += 1
                continue
            # re-issue before learning: sampling overlaps the update
            self._inflight[runner.sample_trajectory.remote()] = runner
            metrics = self.learner.update_from_trajectory(traj)
            # rewards is [T, N] for every action space; actions would
            # over-count by action_dim on Box envs
            steps += traj["rewards"].size
            n_updates += 1
        self._sync_weights()
        wall = time.perf_counter() - t0
        runner_metrics = self.env_runners.foreach("get_metrics",
                                                  timeout=120)
        returns = [m["episode_return_mean"] for m in runner_metrics
                   if m["episode_return_mean"] is not None]
        return {
            "episode_return_mean":
                float(np.mean(returns)) if returns else None,
            "num_env_steps_sampled": steps,
            "env_steps_per_s": steps / max(1e-9, wall),
            **metrics,
        }

    def get_weights(self):
        return self.learner.get_weights()
