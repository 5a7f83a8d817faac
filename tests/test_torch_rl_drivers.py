"""The port's IMPALA, DQN and SAC drivers on the port's runtime, on the
CPU (learners asked for device "cpu"), as tests/test_rl_algos.py and
tests/test_rl_regression.py drive JAX's: a few iterations each, with
finite losses, the steps sampled and the replay buffer filling. Their updates are held to JAX's in
tests/test_torch_rl_learners.py and tests/test_torch_rl_offpolicy.py.
Imports no JAX."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.rl import DQN, IMPALA, SAC, AlgorithmConfig


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
    yield rt
    rt.shutdown()


def _config(env, **training):
    return (AlgorithmConfig()
            .environment(env)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(**training)
            .learners(device="cpu"))


def test_impala_async_rounds(runtime):
    algo = IMPALA(_config("CartPole-v1", lr=5e-4))
    try:
        for it in (1, 2, 3):
            out = algo.train()
            assert out["training_iteration"] == it
        # a full round of fragments: 2 runners x 2 envs x 32 steps
        assert out["num_env_steps_sampled"] == 128
        assert np.isfinite(out["total_loss"])
    finally:
        algo.stop()


def test_dqn_replay_and_epsilon(runtime):
    algo = DQN(_config("CartPole-v1", lr=1e-3, minibatch_size=64,
                       replay_buffer_config={"type": "prioritized"}))
    try:
        for _ in range(3):
            out = algo.train()
        assert out["replay_size"] == 3 * 128
        assert np.isfinite(out["td_loss"])
        assert out["epsilon"] < 1.0
        # num_epochs (4) x 4 steps a round, from the first round (128 rows
        # already fill a minibatch of 64)
        assert algo._grad_steps == 3 * 16
    finally:
        algo.stop()


def test_sac_warmup_then_updates(runtime):
    algo = SAC(_config("Pendulum-v1", minibatch_size=64,
                       updates_per_step=0.25))
    try:
        first = algo.train()            # random warm-up actions
        second = algo.train()
        assert first["replay_size"] == 128 and second["replay_size"] == 256
        for out in (first, second):
            assert np.isfinite(out["q_loss"]) and 0 < out["alpha"] < 1
        w = algo.get_weights()
        assert set(w) == {"hidden.0.weight", "hidden.0.bias",
                          "hidden.1.weight", "hidden.1.bias",
                          "mean.weight", "mean.bias", "log_std.weight",
                          "log_std.bias"}
    finally:
        algo.stop()


def test_external_ppo_learns_from_a_client(runtime):
    """An external simulator drives CartPole through the policy server
    actor's HTTP routes; one ExternalPPO step trains on its episodes
    (tests/test_rl_external.py's loop, one iteration)."""
    import threading

    import gymnasium as gym

    from ray_tpu_torch.rl import ExternalPPO, PolicyClient
    algo = ExternalPPO(AlgorithmConfig().environment("CartPole-v1")
                       .training(train_batch_size=64, minibatch_size=32,
                                 num_epochs=2).learners(device="cpu"))
    stop = threading.Event()

    def simulate():
        client = PolicyClient(algo.addresses[0])
        env = gym.make("CartPole-v1")
        obs, _ = env.reset(seed=0)
        eid = client.start_episode()
        while not stop.is_set():
            obs, rew, term, trunc, _ = env.step(client.get_action(eid, obs))
            client.log_returns(eid, rew)
            if term or trunc:
                client.end_episode(eid, obs)
                obs, _ = env.reset()
                eid = client.start_episode()

    sim = threading.Thread(target=simulate, daemon=True)
    sim.start()
    try:
        out = algo.train()
        assert out["num_env_steps_sampled"] >= 64
        assert out["num_minibatch_updates"] >= 4
        assert out["episode_return_mean"] is not None
    finally:
        stop.set()
        sim.join(timeout=30)
        algo.stop()
    assert not sim.is_alive()
