"""Env-to-module connector pipeline (reference: rllib/connectors/ —
observation transforms that sit between the env and the RLModule on
every env runner; the learner trains on the CONNECTED observations, so
the module's input shape is derived through the pipeline).

Built-ins: frame stacking and running-statistics observation
normalization — the two transforms rllib's default pipelines apply most
often. Specs are (name, kwargs) pairs so they serialize into the actor
config untouched.

The port's own copy of the JAX package's module (numpy only): the port
imports nothing of ray_tpu."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class Connector:
    """Per-runner stateful transform over BATCHED observations [N, ...].
    `reset_mask[i]` marks envs whose episode just reset — stateful
    connectors drop env i's history (reference: rllib connectors are
    episode-scoped for the same reason)."""

    def output_shape(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(input_shape)

    def reset(self, obs: np.ndarray) -> None:
        """Called once with the first observation batch after env reset."""

    def __call__(self, obs: np.ndarray,
                 reset_mask: "np.ndarray" = None) -> np.ndarray:
        raise NotImplementedError

    def peek(self, obs: np.ndarray) -> np.ndarray:
        """Transform WITHOUT advancing connector state — used to connect
        a done step's true final observation (off-policy next_obs) while
        the live stream resets."""
        return self(obs)


class FrameStack(Connector):
    """Concatenate the last k observations along the last axis (flat
    obs) or the channel axis (image obs) — gives feedforward policies
    short-term memory (reference: rllib frame-stacking connector)."""

    def __init__(self, k: int = 4):
        self.k = int(k)
        self._buf: List[np.ndarray] = []

    def output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (input_shape[-1] * self.k,)

    def reset(self, obs):
        self._buf = [obs.copy() for _ in range(self.k)]

    def __call__(self, obs, reset_mask=None):
        if not self._buf:
            self.reset(obs)
        self._buf.pop(0)
        self._buf.append(obs)
        if reset_mask is not None and reset_mask.any():
            # fresh episodes must not see the dead episode's frames
            for frame in self._buf:
                frame[reset_mask] = obs[reset_mask]
        return np.concatenate(self._buf, axis=-1)

    def peek(self, obs):
        if not self._buf:
            return np.concatenate([obs] * self.k, axis=-1)
        return np.concatenate(self._buf[1:] + [obs], axis=-1)


class NormalizeObs(Connector):
    """Running mean/std normalization (Chan's parallel batch merge of
    mean/M2 — one vectorized update per observation batch; reference:
    rllib MeanStdFilter connector). Each runner tracks its own
    statistics — they converge to the same distribution, and weight
    syncs stay stat-free."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self.count = 0.0
        self.mean = None
        self.m2 = None

    def __call__(self, obs, reset_mask=None):
        obs = obs.astype(np.float32)
        flat = obs.reshape(len(obs), -1)
        n = float(len(flat))
        b_mean = flat.mean(0, dtype=np.float64)
        b_m2 = ((flat - b_mean) ** 2).sum(0, dtype=np.float64)
        if self.mean is None:
            self.mean = b_mean
            self.m2 = b_m2
            self.count = n
        else:
            delta = b_mean - self.mean
            tot = self.count + n
            self.mean = self.mean + delta * (n / tot)
            self.m2 = self.m2 + b_m2 + delta ** 2 * (self.count * n / tot)
            self.count = tot
        var = self.m2 / max(1.0, self.count - 1)
        std = np.sqrt(var + self.eps)
        out = (flat - self.mean) / std
        return np.clip(out, -self.clip, self.clip) \
            .reshape(obs.shape).astype(np.float32)

    def peek(self, obs):
        obs = obs.astype(np.float32)
        if self.mean is None:
            return obs
        flat = obs.reshape(len(obs), -1)
        std = np.sqrt(self.m2 / max(1.0, self.count - 1) + self.eps)
        out = (flat - self.mean) / std
        return np.clip(out, -self.clip, self.clip) \
            .reshape(obs.shape).astype(np.float32)


_REGISTRY = {"frame_stack": FrameStack, "normalize_obs": NormalizeObs}


def build_pipeline(specs: Sequence) -> List[Connector]:
    """[(name, kwargs), ...] -> connector instances, in order."""
    out = []
    for spec in specs or ():
        if isinstance(spec, str):
            name, kwargs = spec, {}
        else:
            name, kwargs = spec[0], dict(spec[1] or {})
        if name not in _REGISTRY:
            raise ValueError(f"unknown connector {name!r}; "
                             f"have {sorted(_REGISTRY)}")
        out.append(_REGISTRY[name](**kwargs))
    return out


def pipeline_output_shape(specs: Sequence,
                          input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    shape = tuple(input_shape)
    for c in build_pipeline(specs):
        shape = c.output_shape(shape)
    return shape


def apply_pipeline(pipeline: List[Connector], obs: np.ndarray,
                   is_reset: bool = False,
                   reset_mask: np.ndarray = None) -> np.ndarray:
    for c in pipeline:
        if is_reset:
            c.reset(obs)
        obs = c(obs, reset_mask=reset_mask)
    return obs


def peek_pipeline(pipeline: List[Connector], obs: np.ndarray) -> np.ndarray:
    for c in pipeline:
        obs = c.peek(obs)
    return obs
