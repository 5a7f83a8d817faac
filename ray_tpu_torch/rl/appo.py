"""APPO: asynchronous PPO — IMPALA's async actor-learner machinery with
a PPO clipped-surrogate policy loss and a periodically-synced target
network supplying the V-trace targets (reference:
rllib/algorithms/appo/appo.py + appo_learner — clip param, target
network update period `target_network_update_freq`; re-designed on this
package's IMPALA skeleton rather than a translated loss graph).

Why the target network: the surrogate clips the ratio pi/behavior, but
the value targets must stay fixed while the policy takes several async
steps off one behavior distribution — computing V-trace targets from a
lagged copy keeps them stable (the reference's argument verbatim)."""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.impala import IMPALA, ImpalaLearner, _seq_forward
from ray_tpu_torch.rl.learner import to_device


class AppoLearner(ImpalaLearner):
    """IMPALA learner + clipped surrogate + lagged value-target net."""

    def __init__(self, config: Dict, obs_dim: int, action_dim: int):
        super().__init__(config, obs_dim, action_dim)
        self.target_net = copy.deepcopy(self.module.net).requires_grad_(False)
        self.target_update_freq = int(config.get("target_update_freq", 2))
        self._steps_since_target = 0

    def sync_target(self) -> None:
        self.target_net.load_state_dict(self.module.net.state_dict())

    def _loss(self, batch):
        from ray_tpu_torch.rl.vtrace import vtrace
        cfg = self.cfg
        clip = cfg.get("clip_param", 0.2)
        module = self.module
        dist, values = _seq_forward(module, batch)
        cur_logp, entropy = module.seq_logp_entropy(dist, batch["actions"])
        # lagged copy: value targets + the off-policy correction's
        # target-policy term both come from the frozen net
        with torch.no_grad():
            t_dist, t_values = _seq_forward(module, batch, self.target_net)
            t_logp, _ = module.seq_logp_entropy(t_dist, batch["actions"])
        discounts = cfg["gamma"] * (1.0 - batch["dones"])
        vt = vtrace(batch["behavior_logp"], t_logp, batch["rewards"],
                    discounts, t_values, batch["bootstrap_value"])
        ratio = torch.exp(cur_logp - batch["behavior_logp"])
        adv = vt.pg_advantages
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pg_loss = -surr.mean()
        vf_loss = ((values - vt.vs) ** 2).mean()
        entropy = entropy.mean()
        total = pg_loss + cfg["vf_loss_coeff"] * vf_loss \
            - cfg["entropy_coeff"] * entropy
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_ratio": ratio.mean()}

    def update_from_trajectory(self, traj: Dict[str, np.ndarray]) -> Dict:
        batch = to_device({k: v for k, v in traj.items()
                           if k != "bootstrap_obs"}, self.device)
        # multiple surrogate passes per fragment are exactly what the
        # PPO-style clip is for (reference APPO num_sgd_iter); the
        # lagged target keeps the V-trace targets fixed across passes
        for _ in range(max(1, int(self.cfg.get("num_epochs", 1)))):
            loss, aux = self._update(batch)
        self._steps_since_target += 1
        if self._steps_since_target >= self.target_update_freq:
            self.sync_target()
            self._steps_since_target = 0
        out = {k: float(v) for k, v in aux.items()}
        out["total_loss"] = float(loss)
        return out


class APPO(IMPALA):
    """Async PPO driver: identical async sampling/weight-sync loop as
    IMPALA, APPO learner update."""

    def _build_learner(self, cfg_dict, obs_dim, action_dim):
        self.learner = AppoLearner(cfg_dict, obs_dim, action_dim)


def appo_config() -> AlgorithmConfig:
    """AlgorithmConfig preset tuned like the reference's APPO defaults."""
    return AlgorithmConfig().training(lr=5e-4, grad_clip=40.0,
                                      entropy_coeff=0.01)
