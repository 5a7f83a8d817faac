"""Offline RL: dataset recording + behavior cloning from a dataset
(reference: rllib/offline/ — dataset reader/writer, BC in
rllib/algorithms/bc/). Experiences are rows ({"obs": [...], "action": i,
"reward": r, "done": b}) so any Data source/sink (json, parquet) works.
BC reads any dataset with ``iter_batches(batch_size=...,
batch_format="numpy")`` (the JAX package's Data library has it; the port
has no Data library yet) and trains on ``BCConfig.device``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch


def record_experiences(env_maker, policy=None, num_steps: int = 1000,
                       seed: int = 0):
    """Roll a (random or given) policy in a gymnasium env and return the
    experience rows — feed to a Data library's from_items or write_json
    for later offline training (reference: offline dataset writer,
    rllib/offline/output_writer.py)."""
    import gymnasium as gym
    env = env_maker() if callable(env_maker) else gym.make(env_maker)
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    obs, _ = env.reset(seed=seed)
    for _ in range(num_steps):
        if policy is None:
            action = int(rng.integers(env.action_space.n))
        else:
            a, _, _ = policy.sample_actions(
                np.asarray(obs, np.float32)[None], _np_key(rng))
            action = int(a[0])
        nxt, rew, term, trunc, _ = env.step(action)
        rows.append({"obs": np.asarray(obs, np.float32).tolist(),
                     "action": action, "reward": float(rew),
                     "done": bool(term or trunc)})
        obs = nxt
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    return rows


def _np_key(rng):
    import torch
    return torch.Generator().manual_seed(int(rng.integers(2**31)))


@dataclasses.dataclass
class BCConfig:
    dataset: object = None          # a Dataset of experience rows
    obs_dim: int = 0
    action_dim: int = 0
    lr: float = 1e-3
    train_batch_size: int = 256
    num_epochs: int = 1
    hidden_sizes: tuple = (64, 64)
    seed: int = 0
    # where the policy trains: "cuda" by default, "cpu" when asked for
    device: str = "cuda"


class BC:
    """Behavior cloning: supervised log-likelihood of recorded actions
    (reference: rllib BC on the new API stack — an offline Learner over a
    dataset reader)."""

    def __init__(self, config: BCConfig):
        from ray_tpu_torch.rl.learner import make_adam
        from ray_tpu_torch.rl.rl_module import DiscreteRLModule
        self.config = config
        self.module = DiscreteRLModule(config.obs_dim, config.action_dim,
                                       config.hidden_sizes,
                                       seed=config.seed, device=config.device)
        self.params = list(self.module.net.parameters())
        self.optimizer = make_adam(self.params, config.lr)
        self.iteration = 0

    def _update(self, obs, actions):
        import torch.nn.functional as F
        for p in self.params:
            p.grad = None
        logits, _ = self.module.net(obs)
        logp = F.log_softmax(logits, dim=-1)
        loss = -logp.gather(1, actions[:, None])[:, 0].mean()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self) -> Dict:
        """One pass over the dataset in batches."""
        losses = []
        it = self.config.dataset.iter_batches(
            batch_size=self.config.train_batch_size, batch_format="numpy")
        for batch in it:
            obs = np.asarray([np.asarray(o, np.float32)
                              for o in batch["obs"]])
            obs = self.module.tensor(obs)
            actions = self.module.tensor(
                np.asarray(batch["action"], np.int64), dtype=torch.int64)
            for _ in range(self.config.num_epochs):
                loss = self._update(obs, actions)
            losses.append(float(loss))
        self.iteration += 1
        return {"iteration": self.iteration,
                "loss": float(np.mean(losses)) if losses else None,
                "num_batches": len(losses)}

    def action_accuracy(self, dataset=None) -> float:
        """Fraction of dataset actions the greedy policy reproduces."""
        ds = dataset or self.config.dataset
        total = hit = 0
        for batch in ds.iter_batches(batch_size=512,
                                     batch_format="numpy"):
            obs = np.asarray([np.asarray(o, np.float32)
                              for o in batch["obs"]])
            actions = np.asarray(batch["action"], np.int64)
            logits, _ = self.module.forward(obs)
            pred = logits.argmax(dim=1).cpu().numpy()
            hit += int((pred == actions).sum())
            total += len(actions)
        return hit / max(total, 1)
