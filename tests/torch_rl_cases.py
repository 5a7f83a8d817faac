"""A multi-agent env for tests/test_torch_rl_algos.py. The env runners'
worker processes import this module to rebuild the env maker, so it
imports no JAX."""

import numpy as np

from ray_tpu_torch.rl.multi_agent import MultiAgentEnv


class _Box:
    def __init__(self, shape):
        self.shape = shape


class _Disc:
    def __init__(self, n):
        self.n = n


class MatchEnv(MultiAgentEnv):
    """Two agents each see one random bit; both are paid when each action
    equals its own bit (tests/test_rl_multi_agent.py's env)."""

    agents = ["a0", "a1"]

    def __init__(self, episode_len=16):
        self._len = episode_len
        self._t = 0
        self._rng = np.random.default_rng(0)
        self._bits = None

    def observation_space(self, agent_id):
        return _Box((2,))

    def action_space(self, agent_id):
        return _Disc(2)

    def _obs(self):
        return {aid: np.eye(2, dtype=np.float32)[self._bits[i]]
                for i, aid in enumerate(self.agents)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bits = self._rng.integers(0, 2, size=2)
        return self._obs(), {}

    def step(self, actions):
        rew_each = float(actions["a0"] == self._bits[0]) \
            + float(actions["a1"] == self._bits[1])
        rewards = {aid: rew_each / 2.0 for aid in self.agents}
        self._t += 1
        self._bits = self._rng.integers(0, 2, size=2)
        done = self._t >= self._len
        terms = {aid: done for aid in self.agents}
        terms["__all__"] = done
        return self._obs(), rewards, terms, {"__all__": False}, {}


def shared(agent_id):
    return "shared"
