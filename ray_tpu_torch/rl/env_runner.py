"""EnvRunner: actor sampling episodes from gymnasium vector envs
(reference: rllib/env/single_agent_env_runner.py:63 — sample :133; module
forward for action selection runs inside the runner; GAE advantages are
computed here at fragment end so the learner gets ready batches, the role
the reference's learner connector pipeline plays)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def make_vector_env(config: Dict):
    """``num_envs_per_env_runner`` copies of the config's env. SAME_STEP
    autoreset: a done step returns the RESET observation (the true final
    obs rides in infos), so every recorded transition is real —
    gymnasium >=1.0's default NextStep mode would interleave a bogus
    action-ignored reset step into the rollout (stale obs, reward 0) that
    GAE/vtrace would train on."""
    import gymnasium as gym

    from ray_tpu_torch.rl import envs as _envs   # registers built-in envs
    _envs.register_envs()
    return gym.vector.SyncVectorEnv(
        [lambda: gym.make(config["env"], **config.get("env_config", {}))
         for _ in range(config["num_envs_per_env_runner"])],
        autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)


def one_thread_in_actor() -> None:
    """In an actor's own process, run torch's CPU ops on one thread. A
    runner's forward is a handful of rows; each runner process spinning an
    intra-op pool as wide as the machine oversubscribes the cores beside
    the other runners and the learner (a CartPole fragment of 4 x 64
    steps took ~1.2 s instead of ~35 ms with two runners on 8 CPU cores).
    A runner built in the caller's own process leaves its threads alone."""
    import torch

    import ray_tpu_torch as rt
    if rt.is_initialized() and \
            rt.get_runtime_context()["actor_id"] is not None:
        torch.set_num_threads(1)


class EnvRunner:
    def __init__(self, config: Dict):
        # Rollout workers run their policy on the CPU, by the reference's
        # design (ray_tpu/rl/env_runner.py:16-27; rllib's env runners are
        # CPU actors, only Learner workers get accelerators): a per-step
        # forward for a handful of envs is latency-bound, and a round trip
        # through the card per env step would cost more than the forward.
        # The learner is where the accelerator belongs.
        import torch
        one_thread_in_actor()

        from ray_tpu_torch.rl.connectors import (apply_pipeline,
                                                 build_pipeline,
                                                 pipeline_output_shape)
        from ray_tpu_torch.rl.rl_module import action_spec_of, make_rl_module
        self.cfg = config
        self.n_envs = config["num_envs_per_env_runner"]
        self.envs = make_vector_env(config)
        raw_shape = self.envs.single_observation_space.shape
        self._pipeline = build_pipeline(config.get("connectors") or ())
        self._apply_pipeline = apply_pipeline
        obs_shape = pipeline_output_shape(config.get("connectors") or (),
                                          raw_shape)
        self.action_spec = action_spec_of(self.envs.single_action_space)
        self.module = make_rl_module(
            obs_shape, self.action_spec,
            config.get("hidden_sizes", (64, 64)),
            seed=config.get("seed", 0),
            use_lstm=config.get("use_lstm", False), device="cpu")
        # recurrent modules: per-env LSTM carry, zeroed on episode reset
        # (the connector state discipline — rl_module docstring)
        self._state = (self.module.initial_state(self.n_envs)
                       if self.module.is_recurrent else None)
        # seeded as the JAX runner seeds its PRNGKey
        self.generator = torch.Generator().manual_seed(
            config.get("seed", 0) + config.get("runner_index", 0) * 1000)
        self.obs, _ = self.envs.reset(seed=config.get("seed", 0)
                                      + config.get("runner_index", 0))
        # connected view of the current obs: the module (and therefore
        # the learner's batches) only ever sees pipeline output
        self._cobs = self._apply_pipeline(
            self._pipeline, self.obs.astype(np.float32), is_reset=True)
        self.gamma = config["gamma"]
        self.lam = config["lambda_"]
        self._episode_returns = []
        self._running_returns = np.zeros(self.n_envs)

    def set_weights(self, weights):
        self.module.set_weights(weights)
        return True

    def _step_envs(self, action, t, bufs):
        """Step every env with the (clipped) action and record step t;
        returns the done flags."""
        env_action = (self.module.clip_actions(action)
                      if hasattr(self.module, "clip_actions") else action)
        nxt, rew, term, trunc, _ = self.envs.step(env_action)
        done = np.logical_or(term, trunc)
        bufs["rew"][t] = rew
        bufs["done"][t] = done.astype(np.float32)
        self._running_returns += rew
        for i, d in enumerate(done):
            if d:
                self._episode_returns.append(self._running_returns[i])
                self._running_returns[i] = 0.0
        self.obs = nxt
        return done

    def _buffers(self, T):
        N = self.n_envs
        return {"obs": np.zeros((T, N) + self._cobs.shape[1:], np.float32),
                "act": np.zeros((T, N) + self.module.action_event_shape,
                                self.module.action_np_dtype),
                "logp": np.zeros((T, N), np.float32),
                "rew": np.zeros((T, N), np.float32),
                "done": np.zeros((T, N), np.float32),
                "val": np.zeros((T, N), np.float32)}

    def sample(self, num_steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Collect a fragment of num_steps per env; returns flat batch with
        GAE advantages and value targets."""
        T = num_steps or self.cfg["rollout_fragment_length"]
        N = self.n_envs
        b = self._buffers(T)
        for t in range(T):
            cobs = self._cobs.astype(np.float32)
            action, logp, value = self.module.sample_actions(
                cobs, self.generator)
            b["obs"][t] = cobs
            b["act"][t] = action
            b["logp"][t] = logp
            b["val"][t] = value
            done = self._step_envs(action, t, b)
            self._cobs = self._apply_pipeline(
                self._pipeline, self.obs.astype(np.float32),
                reset_mask=done)

        # bootstrap value for the final obs
        _, last_val = self.module.forward(self._cobs.astype(np.float32))
        last_val = last_val.numpy()
        rew_buf, done_buf, val_buf = b["rew"], b["done"], b["val"]
        adv = np.zeros((T, N), np.float32)
        lastgaelam = np.zeros(N, np.float32)
        for t in reversed(range(T)):
            nonterminal = 1.0 - done_buf[t]
            next_value = val_buf[t + 1] if t + 1 < T else last_val
            delta = rew_buf[t] + self.gamma * next_value * nonterminal \
                - val_buf[t]
            lastgaelam = delta + self.gamma * self.lam * nonterminal \
                * lastgaelam
            adv[t] = lastgaelam
        targets = adv + val_buf

        flat = lambda a: a.reshape((T * N,) + a.shape[2:])  # noqa: E731
        return {"obs": flat(b["obs"]), "actions": flat(b["act"]),
                "logp": flat(b["logp"]), "advantages": flat(adv),
                "value_targets": flat(targets)}

    def sample_trajectory(self, num_steps: Optional[int] = None
                          ) -> Dict[str, np.ndarray]:
        """Time-major fragment [T, N, ...] with behavior log-probs and a
        bootstrap value — the shape V-trace consumes (IMPALA path; the
        reference's equivalent is the env-runner → aggregator episode flow,
        rllib/algorithms/impala/impala.py)."""
        T = num_steps or self.cfg["rollout_fragment_length"]
        b = self._buffers(T)
        recurrent = self._state is not None
        initial_state = (tuple(s.numpy().copy() for s in self._state)
                         if recurrent else None)
        for t in range(T):
            cobs = self._cobs.astype(np.float32)
            if recurrent:
                action, logp, _value, self._state = \
                    self.module.sample_actions(cobs, self.generator,
                                               self._state)
            else:
                action, logp, _value = self.module.sample_actions(
                    cobs, self.generator)
            # step with clipped actions; learn on the unclipped sample
            # (its logp is what the behavior distribution produced)
            b["obs"][t] = cobs
            b["act"][t] = action
            b["logp"][t] = logp
            done = self._step_envs(action, t, b)
            if recurrent and done.any():
                # fresh episodes must not see the dead episode's memory
                keep = self.module.tensor(1.0 - done.astype(np.float32))
                self._state = tuple(s * keep[:, None] for s in self._state)
            self._cobs = self._apply_pipeline(
                self._pipeline, self.obs.astype(np.float32),
                reset_mask=done)
        cobs = self._cobs.astype(np.float32)
        _, last_val = (self.module.forward(cobs, self._state) if recurrent
                       else self.module.forward(cobs))
        out = {"obs": b["obs"], "actions": b["act"],
               "behavior_logp": b["logp"], "rewards": b["rew"],
               "dones": b["done"],
               "bootstrap_obs": cobs,
               "bootstrap_value": last_val.numpy().astype(np.float32)}
        if recurrent:
            # fragment-start carry: the learner re-derives every
            # intermediate state from this + the done flags
            out["initial_state_c"] = initial_state[0]
            out["initial_state_h"] = initial_state[1]
        return out

    def get_metrics(self) -> Dict:
        out = {"episode_return_mean":
               float(np.mean(self._episode_returns[-20:]))
               if self._episode_returns else None,
               "num_episodes": len(self._episode_returns)}
        return out
