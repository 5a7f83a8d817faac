"""Uniform transition replay buffer (reference:
rllib/utils/replay_buffers/ — the new-stack EpisodeReplayBuffer role,
simplified to flat transition storage in preallocated numpy rings).

The port's own copy of the JAX package's module (numpy only): given the
same seed, its samples are the same bits."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Add a batch of transitions {key: [N, ...]}."""
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()}
        i = self._idx
        if i + n <= self.capacity:
            for k, v in batch.items():
                self._store[k][i:i + n] = v
        else:
            first = self.capacity - i
            for k, v in batch.items():
                self._store[k][i:] = v[:first]
                self._store[k][:n - first] = v[first:]
        self._idx = (i + n) % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._store.items()}


class SumTree:
    """Flat-array binary sum tree over `capacity` leaves: O(log n)
    priority updates and prefix-sum sampling (reference:
    rllib/utils/replay_buffers/prioritized_episode_buffer.py's
    segment-tree machinery, re-derived — leaves at [capacity-1,
    2*capacity-1), internal node i sums children 2i+1, 2i+2)."""

    def __init__(self, capacity: int):
        # round up to a power of two so the leaf layer is contiguous
        self.capacity = 1
        while self.capacity < capacity:
            self.capacity *= 2
        self._tree = np.zeros(2 * self.capacity - 1, np.float64)

    @property
    def total(self) -> float:
        return float(self._tree[0])

    def set(self, leaf_idx: np.ndarray, values: np.ndarray) -> None:
        """Vectorized leaf assignment + ancestor re-sum (all leaves sit
        at one depth, so each climb step handles exactly one level)."""
        leaf_idx = np.asarray(leaf_idx, np.int64)
        idx = leaf_idx + self.capacity - 1
        self._tree[idx] = values
        while idx[0] > 0:
            idx = np.unique((idx - 1) // 2)
            self._tree[idx] = self._tree[2 * idx + 1] + \
                self._tree[2 * idx + 2]

    def get(self, leaf_idx: np.ndarray) -> np.ndarray:
        return self._tree[np.asarray(leaf_idx, np.int64)
                          + self.capacity - 1]

    def find(self, prefix_sums: np.ndarray) -> np.ndarray:
        """leaf indices whose cumulative-priority interval contains each
        prefix sum (vectorized descent, one level per iteration)."""
        s = np.asarray(prefix_sums, np.float64).copy()
        idx = np.zeros(len(s), np.int64)
        while idx[0] < self.capacity - 1:     # all leaves reached together
            left = 2 * idx + 1
            left_sum = self._tree[left]
            go_right = s > left_sum
            s = np.where(go_right, s - left_sum, s)
            idx = np.where(go_right, left + 1, left)
        return idx - (self.capacity - 1)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized experience replay (reference:
    rllib/utils/replay_buffers/prioritized_episode_buffer.py; Schaul et
    al. 2016): P(i) ∝ (|td_i| + eps)^alpha, importance-sampling weights
    w_i = (N * P(i))^-beta normalized by max. New transitions enter at
    the current max priority so everything is trained on at least once.

    sample() returns the batch plus `indices` (pass back to
    update_priorities with the new TD errors) and `weights` (multiply
    into the per-sample loss)."""

    def __init__(self, capacity: int, seed: int = 0, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6):
        super().__init__(capacity, seed)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self._tree = SumTree(capacity)
        self._max_prio = 1.0

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        start = self._idx
        super().add(batch)
        idx = (start + np.arange(n)) % self.capacity
        self._tree.set(idx, np.full(n, self._max_prio ** self.alpha))

    def sample(self, batch_size: int,
               beta: Optional[float] = None) -> Dict[str, np.ndarray]:
        beta = self.beta if beta is None else float(beta)
        total = self._tree.total
        # stratified prefix sums: one uniform draw per equal segment
        seg = total / batch_size
        s = (np.arange(batch_size) + self._rng.random(batch_size)) * seg
        idx = self._tree.find(np.minimum(s, total * (1 - 1e-12)))
        # guard: never hand out a slot that has no data yet
        idx = np.minimum(idx, self._size - 1)
        prios = self._tree.get(idx)
        probs = prios / max(total, 1e-12)
        weights = (self._size * probs) ** -beta
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._store.items()}
        out["indices"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prios = np.abs(np.asarray(td_errors, np.float64)) + self.eps
        self._max_prio = max(self._max_prio, float(prios.max()))
        self._tree.set(np.asarray(indices, np.int64), prios ** self.alpha)


def make_replay_buffer(config: Dict, capacity: int,
                       seed: int = 0) -> ReplayBuffer:
    """Buffer factory from AlgorithmConfig.replay_buffer_config
    (reference: rllib replay_buffer_config {"type": ...})."""
    cfg = dict(config or {})
    kind = cfg.pop("type", "uniform")
    if kind in ("uniform", "ReplayBuffer"):
        return ReplayBuffer(capacity, seed=seed)
    if kind in ("prioritized", "PrioritizedReplayBuffer"):
        return PrioritizedReplayBuffer(capacity, seed=seed, **cfg)
    raise ValueError(f"unknown replay buffer type {kind!r}")
