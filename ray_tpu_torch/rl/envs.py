"""Built-in test/benchmark environments (reference: rllib's tuned
examples lean on Atari/MuJoCo, which need ROMs/licenses; this package
ships a dependency-free pixel env so the conv-module path has a
regression gate that runs anywhere).

The port registers them under its own ids, ``ray_tpu_torch/<Name>-v0``,
so both packages' envs can be registered in one process: the ids live in
different gymnasium namespaces and each names its own package's class.
gymnasium is optional here: without it the classes are plain objects and
``register_envs`` does nothing."""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import gymnasium as gym
    _BASE = gym.Env
except Exception:          # pragma: no cover - gymnasium is baked in
    gym = None
    _BASE = object


class GridTargetEnv(_BASE):
    """Pixel observation task: an 8x8 single-channel image shows the
    agent (1.0) and a fixed center target (0.5). Four actions move the
    agent; reaching the target pays +1 and ends the episode, every step
    costs -0.05. Solvable by a small CNN in a few thousand steps —
    random policy averages ~-0.5, a greedy policy ~ +0.6."""

    SIZE = 8
    MAX_STEPS = 24

    def __init__(self, render_mode: Optional[str] = None):
        self.observation_space = gym.spaces.Box(
            0.0, 1.0, (self.SIZE, self.SIZE, 1), np.float32)
        self.action_space = gym.spaces.Discrete(4)
        self.render_mode = render_mode
        self._rng = np.random.default_rng(0)
        self._pos = (0, 0)
        self._t = 0

    def _obs(self):
        img = np.zeros((self.SIZE, self.SIZE, 1), np.float32)
        c = self.SIZE // 2
        img[c, c, 0] = 0.5
        img[self._pos[0], self._pos[1], 0] = 1.0
        return img

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        while True:
            pos = tuple(self._rng.integers(0, self.SIZE, 2))
            if pos != (self.SIZE // 2, self.SIZE // 2):
                break
        self._pos = pos
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        dr, dc = [(-1, 0), (1, 0), (0, -1), (0, 1)][int(action)]
        r = min(max(self._pos[0] + dr, 0), self.SIZE - 1)
        c = min(max(self._pos[1] + dc, 0), self.SIZE - 1)
        self._pos = (r, c)
        self._t += 1
        at_goal = self._pos == (self.SIZE // 2, self.SIZE // 2)
        reward = 1.0 if at_goal else -0.05
        terminated = at_goal
        truncated = self._t >= self.MAX_STEPS
        return self._obs(), reward, terminated, truncated, {}


class StatelessCartPole(_BASE):
    """CartPole with the velocity components masked out — the classic
    partially-observable recurrence gate (reference:
    rllib/examples/envs/classes/stateless_cartpole.py): a feedforward
    policy plateaus near random because [position, angle] alone don't
    determine the optimal action; an LSTM recovers the velocities from
    its memory."""

    def __init__(self, render_mode: Optional[str] = None):
        self._env = gym.make("CartPole-v1")
        self.observation_space = gym.spaces.Box(
            -np.inf, np.inf, (2,), np.float32)
        self.action_space = self._env.action_space
        self.render_mode = render_mode

    @staticmethod
    def _mask(obs):
        return np.asarray([obs[0], obs[2]], np.float32)

    def reset(self, *, seed=None, options=None):
        obs, info = self._env.reset(seed=seed, options=options)
        return self._mask(obs), info

    def step(self, action):
        obs, rew, term, trunc, info = self._env.step(action)
        return self._mask(obs), rew, term, trunc, info


class RepeatAfterMeEnv(_BASE):
    """Memory probe (reference:
    rllib/examples/envs/classes/repeat_after_me_env.py): each step shows
    a random one-hot token; the reward pays +1 for echoing the PREVIOUS
    step's token. A memoryless policy can't beat chance (~half of
    MAX_STEPS); an LSTM solves it almost perfectly — a crisp, fast
    recurrence gate."""

    MAX_STEPS = 32

    def __init__(self, render_mode: Optional[str] = None):
        self.observation_space = gym.spaces.Box(0.0, 1.0, (2,), np.float32)
        self.action_space = gym.spaces.Discrete(2)
        self.render_mode = render_mode
        self._rng = np.random.default_rng(0)
        self._prev = 0
        self._t = 0

    def _obs(self, tok: int):
        o = np.zeros(2, np.float32)
        o[tok] = 1.0
        return o

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        # prev = token shown one obs ago (what the action must echo);
        # cur = token in the obs the agent is looking at right now
        self._prev = None
        self._cur = int(self._rng.integers(0, 2))
        return self._obs(self._cur), {}

    def step(self, action):
        # the current obs shows a NEW token, so echoing what the agent
        # sees scores chance — only memory of the previous obs pays
        reward = float(self._prev is not None
                       and int(action) == self._prev)
        self._t += 1
        self._prev = self._cur
        self._cur = int(self._rng.integers(0, 2))
        return (self._obs(self._cur), reward, False,
                self._t >= self.MAX_STEPS, {})


class ContinuousRepeatAfterMeEnv(_BASE):
    """Continuous-action memory probe — the Box-action sibling of
    RepeatAfterMeEnv (reference: rllib repeat_after_me + its tuned
    continuous variants): each step shows a random target in [-1, 1];
    the reward pays 1 - |action - PREVIOUS step's target|. A memoryless
    policy's best play is action=0 (E|target| = 0.5 → ~15.5 of 31);
    carrying the previous observation approaches 31."""

    MAX_STEPS = 32

    def __init__(self, render_mode: Optional[str] = None):
        self.observation_space = gym.spaces.Box(-1.0, 1.0, (1,),
                                                np.float32)
        self.action_space = gym.spaces.Box(-1.0, 1.0, (1,), np.float32)
        self.render_mode = render_mode
        self._rng = np.random.default_rng(0)
        self._prev = None
        self._cur = 0.0
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._prev = None
        self._cur = float(self._rng.uniform(-1.0, 1.0))
        return np.array([self._cur], np.float32), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).ravel()[0], -1.0, 1.0))
        reward = (0.0 if self._prev is None
                  else 1.0 - abs(a - self._prev))
        self._t += 1
        self._prev = self._cur
        self._cur = float(self._rng.uniform(-1.0, 1.0))
        return (np.array([self._cur], np.float32), reward, False,
                self._t >= self.MAX_STEPS, {})


def register_envs():
    """Idempotently register the built-in envs with gymnasium."""
    if gym is None:
        return
    for name, cls in _ENVS:
        env_id = f"ray_tpu_torch/{name}-v0"
        try:
            gym.spec(env_id)
        except Exception:
            gym.register(id=env_id,
                         entry_point=f"ray_tpu_torch.rl.envs:{cls}")


_ENVS = (("GridTarget", "GridTargetEnv"),
         ("StatelessCartPole", "StatelessCartPole"),
         ("RepeatAfterMe", "RepeatAfterMeEnv"),
         ("ContinuousRepeatAfterMe", "ContinuousRepeatAfterMeEnv"))


register_envs()
