"""TorchLearner + LearnerGroup (reference: rllib/core/learner/learner.py,
torch_learner.py:64 compute/apply gradients, learner_group.py:80).

The PPO update is one function (loss, backward, global-norm clip, Adam
step) over a minibatch; the minibatch epochs are a host loop. It runs on
the learner's device (``learner_device``, "cuda" unless the caller asks
for the CPU), where the whole train batch is moved once per update.
Multi-learner data parallelism runs the IDENTICAL epoch/minibatch
schedule on every learner with per-minibatch gradient averaging — the
same algorithm as n=1, just with an n-times-larger effective minibatch
(reference: learner_group.py DDP semantics — every learner executes the
same update loop with synced grads).

The optimizer is optax's ``chain(clip_by_global_norm(c), adam(lr))``:
the gradients are scaled by c / norm only when the global norm is at
least c, with no epsilon (``torch.nn.utils.clip_grad_norm_`` divides by
norm + 1e-6), then Adam with optax's defaults (``parallel.optim.adamw``
without weight decay)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device


def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the params' ``.grad``, in place:
    g <- g / norm * max_norm when norm >= max_norm. Returns the norm. No
    host sync: the choice is a ``torch.where`` on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def make_adam(params, lr: float) -> torch.optim.Optimizer:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat)."""
    from ray_tpu_torch.parallel.optim import adamw
    return adamw(lr, weight_decay=0.0)(params)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device`` (copies: arrays
    that arrive through the object store are read-only views)."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def ppo_loss(module, batch, clip: float, vf_coeff: float, ent_coeff: float):
    """Clipped-surrogate PPO loss with per-minibatch advantage
    normalisation (population std, as ``jnp.std``)."""
    logp, entropy, values = module.logp_entropy_value(
        batch["obs"], batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()
    vf_loss = ((values - batch["value_targets"]) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + vf_coeff * vf_loss - ent_coeff * ent
    return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": ent}


class TorchLearner:
    def __init__(self, config: Dict, obs_dim: int, action_dim: int):
        from ray_tpu_torch.rl.rl_module import make_rl_module
        from ray_tpu_torch.util.profiling import StepProfiler

        self.cfg = config
        self.device = resolve_device(config.get("learner_device", "cuda"))
        obs_shape = tuple(config.get("obs_shape") or (obs_dim,))
        action_spec = (config.get("action_spec")
                       or {"type": "discrete", "n": action_dim})
        self.module = make_rl_module(
            obs_shape, action_spec,
            config.get("hidden_sizes", (64, 64)),
            seed=config.get("seed", 0), device=self.device)
        self.params = list(self.module.net.parameters())
        self.optimizer = make_adam(self.params, config["lr"])
        self.grad_clip = config.get("grad_clip", 0.5)
        self.num_updates = 0
        self._shard: Optional[Dict[str, torch.Tensor]] = None
        # per-minibatch time/FLOP attribution: wrap_step counts each
        # minibatch shape's FLOPs once and the update loop marks
        # data-build vs compute, so the learner emits runtime_rl_update_mfu
        # + phase gauges into /metrics and the GCS time-series plane
        # (util/profiling.py)
        self.profiler = StepProfiler("rl_update", emit_span=False,
                                     emit_every=8)
        self._update_profiled = self.profiler.wrap_step(self._update)

    def _loss(self, batch):
        c = self.cfg
        return ppo_loss(self.module, batch, c["clip_param"],
                        c["vf_loss_coeff"], c["entropy_coeff"])

    def _grads(self, batch):
        for p in self.params:
            p.grad = None
        loss, aux = self._loss(batch)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def _apply(self):
        clip_by_global_norm_(self.params, self.grad_clip)
        self.optimizer.step()

    def _update(self, batch):
        loss, aux = self._grads(batch)
        self._apply()
        return loss, aux

    def update_from_batch(self, batch: Dict[str, np.ndarray]) -> Dict:
        n = len(batch["obs"])
        mb = self.cfg["minibatch_size"]
        data = to_device(batch, self.device)
        rng = np.random.default_rng(0)
        for _ in range(self.cfg["num_epochs"]):
            idx = torch.as_tensor(rng.permutation(n), device=self.device)
            for start in range(0, n, mb):
                with self.profiler.step(tokens=min(mb, n - start)) as sc:
                    sel = idx[start:start + mb]
                    mini = {k: v[sel] for k, v in data.items()}
                    sc.data_ready()
                    loss, aux = self._update_profiled(mini)
                    sc.block(loss)
                self.num_updates += 1
        metrics = {k: float(v) for k, v in aux.items()}
        metrics["total_loss"] = float(loss)
        metrics["num_minibatch_updates"] = self.num_updates
        return metrics

    # ------------------------------------------------- multi-learner path
    def set_batch(self, shard: Dict[str, np.ndarray]) -> int:
        """Stage this learner's shard for the epoch/minibatch schedule."""
        self._shard = to_device(shard, self.device)
        return len(self._shard["obs"])

    def minibatch_gradients(self, epoch: int, mb_index: int):
        """Gradients for minibatch `mb_index` of epoch `epoch` over the
        staged shard — every learner runs the SAME schedule; the group
        averages these per minibatch (reference DDP semantics)."""
        n = len(self._shard["obs"])
        mb = min(self.cfg["minibatch_size"], n)
        idx = np.random.default_rng(epoch).permutation(n)
        sel = idx[(mb_index * mb) % n:(mb_index * mb) % n + mb]
        sel = torch.as_tensor(sel, device=self.device)
        loss, aux = self._grads({k: v[sel] for k, v in self._shard.items()})
        return (self._grad_arrays(), float(loss),
                {k: float(v) for k, v in aux.items()})

    def _grad_arrays(self) -> Dict[str, np.ndarray]:
        return {name: p.grad.detach().cpu().numpy()
                for name, p in self.module.net.named_parameters()}

    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        loss, _ = self._grads(to_device(batch, self.device))
        return self._grad_arrays(), float(loss)

    def apply_gradients(self, grads: Dict[str, np.ndarray]):
        for name, p in self.module.net.named_parameters():
            p.grad = torch.tensor(grads[name], device=self.device)
        self._apply()
        self.num_updates += 1
        return self.num_updates

    def get_weights(self):
        return self.module.get_weights()

    def set_weights(self, weights):
        self.module.set_weights(weights)
        return True


class LearnerGroup:
    """Data-parallel learners as actors; single-learner runs in-process
    (reference: learner_group.py local mode vs remote learner actors).
    Remote learners on the card share it: each asks for 1/n GPU."""

    def __init__(self, config: Dict, obs_dim: int, action_dim: int):
        import ray_tpu_torch as rt
        self.cfg = config
        self.n = config.get("num_learners", 1)
        self.num_updates = 0
        if self.n <= 1:
            self.local = TorchLearner(config, obs_dim, action_dim)
            self.remote = []
        else:
            self.local = None
            gpus = (1.0 / self.n if torch.device(
                config.get("learner_device", "cuda")).type == "cuda"
                else 0)
            cls = rt.remote(num_gpus=gpus)(TorchLearner)
            self.remote = [cls.remote(config, obs_dim, action_dim)
                           for _ in range(self.n)]

    def update_from_batch(self, batch: Dict[str, np.ndarray]) -> Dict:
        import ray_tpu_torch as rt
        if self.local is not None:
            m = self.local.update_from_batch(batch)
            self.num_updates = m["num_minibatch_updates"]
            return m
        # n>1 runs the SAME minibatch-epoch PPO as n=1: each learner
        # holds a shard, every (epoch, minibatch) step computes local
        # grads which are averaged and applied everywhere — NOT one giant
        # step on split shards
        shards = {k: np.array_split(v, self.n) for k, v in batch.items()}
        per = [{k: shards[k][i] for k in batch} for i in range(self.n)]
        rows = rt.get(
            [l.set_batch.remote(p) for l, p in zip(self.remote, per)],
            timeout=300)
        mb = self.cfg["minibatch_size"]
        # ceil: the tail minibatch is included, same as the n=1 loop's
        # range(0, n, mb) (a floor would silently drop up to mb-1 rows
        # of experience per shard per epoch)
        n_mb = max(1, -(-min(rows) // max(1, mb)))
        losses: List[float] = []
        aux: Dict = {}
        for epoch in range(self.cfg["num_epochs"]):
            for j in range(n_mb):
                outs = rt.get(
                    [l.minibatch_gradients.remote(epoch, j)
                     for l in self.remote], timeout=300)
                losses = [l for _, l, _ in outs]
                aux = outs[0][2]
                avg = {k: np.mean(np.stack([g[k] for g, _, _ in outs]),
                                  axis=0) for k in outs[0][0]}
                avg_ref = rt.put(avg)
                self.num_updates = rt.get(
                    [l.apply_gradients.remote(avg_ref)
                     for l in self.remote], timeout=300)[0]
        return {**aux, "total_loss": float(np.mean(losses)),
                "num_minibatch_updates": self.num_updates}

    def get_weights(self):
        import ray_tpu_torch as rt
        if self.local is not None:
            return self.local.get_weights()
        return rt.get(self.remote[0].get_weights.remote(), timeout=120)
