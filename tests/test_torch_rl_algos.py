"""The port's RL drivers on the port's runtime, on the CPU (env runners
are CPU actors; learners asked for device "cpu"): PPO on CartPole for two
iterations, a runner killed in the middle of training and replaced in its
slot (as tests/test_rl_fault_tolerance.py), two learner actors running
n=1's epoch/minibatch schedule (as tests/test_rl_regression.py's
test_multi_learner_same_schedule), one MultiAgentPPO iteration with a
shared policy, and a learner left on its default device without a card
refused before any runner starts. Imports no JAX."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rl import AlgorithmConfig


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
    yield rt
    rt.shutdown()


def _config(**training):
    kw = dict(train_batch_size=512, minibatch_size=128, num_epochs=4,
              lr=3e-4, entropy_coeff=0.01)
    return (AlgorithmConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(**{**kw, **training})
            .learners(device="cpu"))


@pytest.fixture(scope="module")
def ppo(runtime):
    algo = _config(num_epochs=6).build()
    yield algo
    algo.stop()


def test_ppo_trains_two_iterations(ppo):
    for it in (1, 2):
        r = ppo.train()
        assert r["training_iteration"] == it
        assert r["num_env_steps_sampled"] == 512
        assert r["num_minibatch_updates"] == 24 * it
        assert np.isfinite(r["total_loss"]) and r["env_steps_per_s"] > 0
    assert r["episode_return_mean"] is not None
    # the learner's update ran in this process, on the CPU, profiled
    local = ppo.learner_group.local
    assert local.device == torch.device("cpu")
    assert local.profiler.steps == 48


def test_runner_killed_mid_training_is_replaced(ppo):
    victim = ppo.env_runners[0]
    rt.kill(victim)
    ppo.train()                 # the victim's round drops, the slot refills
    assert ppo.env_runners.num_restarts == 1
    assert len(ppo.env_runners) == 2
    assert ppo.env_runners[0] is not victim
    r = ppo.train()             # both runners, the replacement too, sample
    assert r["num_env_steps_sampled"] == 512, r


def test_multi_learner_same_schedule(runtime):
    """n=2 learner actors run n=1's schedule: epochs * (shard rows / mb)
    applied updates — 512 / 2 = 256 rows -> 2 minibatches -> 4 x 2 = 8."""
    algo = _config().learners(num_learners=2).build()
    try:
        result = algo.train()
        assert result["num_minibatch_updates"] == 8, result
        w0, w1 = rt.get([l.get_weights.remote()
                         for l in algo.learner_group.remote], timeout=60)
        for k in w0:                # the averaged steps keep them equal
            np.testing.assert_array_equal(w0[k], w1[k])
    finally:
        algo.stop()
        for learner in algo.learner_group.remote:
            rt.kill(learner)


def test_multi_agent_ppo_shared_policy(runtime):
    from ray_tpu_torch.rl import MultiAgentConfig, MultiAgentPPO
    from tests.torch_rl_cases import MatchEnv, shared
    algo = MultiAgentPPO(MultiAgentConfig(
        env_maker=MatchEnv, policy_mapping_fn=shared, num_env_runners=1,
        rollout_fragment_length=32, num_epochs=2, minibatch_size=32,
        learner_device="cpu"))
    try:
        assert list(algo.learners) == ["shared"]
        out = algo.train()
        # 32 steps x 2 agents -> 64 rows -> 2 minibatches x 2 epochs
        assert out["learners"]["shared"]["num_minibatch_updates"] == 4
        assert out["episode_return_mean"] is not None
    finally:
        for r in algo.env_runners:
            rt.kill(r)


def test_learner_without_card_is_refused_first(runtime, monkeypatch):
    from ray_tpu_torch.util.state import list_actors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = len(list_actors())
    config = _config()
    config.learner_device = "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        config.build()
    assert len(list_actors()) == before
