"""The port's RL runtime pieces against the JAX package's, in process on
the CPU (inputs made from numpy seeds):

- the connectors and both replay buffers (and the sum tree): the same
  outputs and samples, bit for bit, from the same seeds;
- the built-in envs under the port's own gymnasium ids, registered beside
  JAX's in one process;
- EnvRunner.sample() and sample_trajectory() of both packages on CartPole,
  from the same env seed and weights, with both samplers patched here in
  the test to the same greedy choice: the observations, actions and
  rewards equal, the log-probs, values, GAE advantages and value targets
  within atol = rtol = 1e-5 (fp32 forwards summed in another order);
- record_experiences with a random policy: the same rows;
- the PolicyServer/PolicyClient protocol (as tests/test_rl_external.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.rl import connectors as jcon
from ray_tpu.rl import replay_buffer as jrb
from ray_tpu_torch.models.convert import rl_params_from_jax
from ray_tpu_torch.rl import connectors as tcon
from ray_tpu_torch.rl import replay_buffer as trb

TOL = dict(rtol=1e-5, atol=1e-5)


def _frames(seed, n=12, shape=(3, 4)):
    rng = np.random.default_rng(seed)
    return [rng.normal(2.0, 3.0, size=shape).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("specs", [
    [("frame_stack", {"k": 3})], [("normalize_obs", {})],
    [("frame_stack", {"k": 2}), ("normalize_obs", {"clip": 1.5})]],
    ids=["frame_stack", "normalize", "both"])
def test_connectors_bit_identical(specs):
    assert tcon.pipeline_output_shape(specs, (4,)) == \
        jcon.pipeline_output_shape(specs, (4,))
    pipes = [m.build_pipeline(specs) for m in (jcon, tcon)]
    frames = _frames(0)
    mask = np.array([False, True, False])
    outs = []
    for m, pipe in zip((jcon, tcon), pipes):
        seq = [m.apply_pipeline(pipe, frames[0].copy(), is_reset=True)]
        for i, f in enumerate(frames[1:]):
            seq.append(m.apply_pipeline(pipe, f.copy(),
                                        reset_mask=mask if i % 4 == 3
                                        else None))
        seq.append(m.peek_pipeline(pipe, frames[5].copy()))
        outs.append(seq)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown connector"):
        tcon.build_pipeline([("nope", {})])


def test_replay_buffers_bit_identical():
    rng = np.random.default_rng(1)
    data = [{"x": rng.normal(size=(n, 3)).astype(np.float32),
             "a": rng.integers(0, 4, n)} for n in (40, 50, 30)]
    for jcls, tcls, kw in ((jrb.ReplayBuffer, trb.ReplayBuffer, {}),
                           (jrb.PrioritizedReplayBuffer,
                            trb.PrioritizedReplayBuffer,
                            {"alpha": 0.7, "beta": 0.5})):
        jb, tb = jcls(100, seed=3, **kw), tcls(100, seed=3, **kw)
        for d in data:                      # the last add wraps the ring
            jb.add(d)
            tb.add(d)
            js, ts = jb.sample(16), tb.sample(16)
            assert set(js) == set(ts)
            for k in js:
                np.testing.assert_array_equal(ts[k], js[k])
            if "indices" in js:
                td = rng.normal(size=16)
                jb.update_priorities(js["indices"], td)
                tb.update_priorities(ts["indices"], td)
        assert len(tb) == len(jb) == 100
    jt, tt = jrb.SumTree(10), trb.SumTree(10)
    for t in (jt, tt):
        t.set(np.arange(10), np.arange(10, dtype=np.float64) + 1)
    s = np.array([0.5, 1.5, 44.9, 54.9])
    np.testing.assert_array_equal(tt.find(s), jt.find(s))
    assert tt.total == jt.total == 55.0
    assert type(trb.make_replay_buffer({"type": "uniform"}, 10)) is \
        trb.ReplayBuffer
    b = trb.make_replay_buffer({"type": "prioritized", "alpha": 0.5}, 10)
    assert isinstance(b, trb.PrioritizedReplayBuffer) and b.alpha == 0.5
    with pytest.raises(ValueError):
        trb.make_replay_buffer({"type": "nope"}, 10)


def test_envs_registered_beside_jax():
    import gymnasium as gym

    from ray_tpu.rl import envs as jenvs
    from ray_tpu_torch.rl import envs as tenvs
    jenvs.register_envs()
    tenvs.register_envs()
    tenvs.register_envs()                   # idempotent
    for name in ("GridTarget", "StatelessCartPole", "RepeatAfterMe",
                 "ContinuousRepeatAfterMe"):
        assert gym.spec(f"ray_tpu_torch/{name}-v0").entry_point \
            .startswith("ray_tpu_torch.rl.envs:")
        assert gym.spec(f"ray_tpu/{name}-v0").entry_point \
            .startswith("ray_tpu.rl.envs:")
    envs = [gym.make(f"{ns}/GridTarget-v0") for ns in ("ray_tpu",
                                                       "ray_tpu_torch")]
    assert type(envs[1].unwrapped) is tenvs.GridTargetEnv
    obs = [e.reset(seed=4)[0] for e in envs]
    np.testing.assert_array_equal(obs[0], obs[1])
    for action in (0, 3, 3, 1, 2):
        steps = [e.step(action) for e in envs]
        np.testing.assert_array_equal(steps[0][0], steps[1][0])
        assert steps[0][1:4] == steps[1][1:4]


RUNNER_CFG = {"env": "CartPole-v1", "env_config": {},
              "num_envs_per_env_runner": 4, "rollout_fragment_length": 40,
              "hidden_sizes": (32, 32), "seed": 0, "runner_index": 1,
              "gamma": 0.99, "lambda_": 0.95, "connectors": ()}


def _greedy_jax(module):
    def sample(params, obs, key):
        logits, value = module._forward(params, obs)
        action = jnp.argmax(logits, -1)
        logp = jax.nn.log_softmax(logits)[jnp.arange(len(obs)), action]
        return np.asarray(action), np.asarray(logp), np.asarray(value)
    return sample


def _greedy_port(module):
    import torch

    def sample(obs, generator):
        logits, value = module.forward(obs)
        action = logits.argmax(-1)
        logp = torch.log_softmax(logits, -1)[torch.arange(len(obs)), action]
        return action.numpy(), logp.numpy(), value.numpy()
    return sample


def test_env_runner_matches_jax():
    from ray_tpu.rl.env_runner import EnvRunner as JRunner
    from ray_tpu_torch.rl.env_runner import EnvRunner
    jr, tr = JRunner(dict(RUNNER_CFG)), EnvRunner(dict(RUNNER_CFG))
    tr.set_weights({k: v.numpy() for k, v in rl_params_from_jax(
        "PolicyValueNet", jax.tree.map(np.asarray, jr.module.params))
        .items()})
    jr.module.sample_actions = _greedy_jax(jr.module)
    tr.module.sample_actions = _greedy_port(tr.module)
    for _ in range(2):                      # the second starts mid-episode
        js, ts = jr.sample(), tr.sample()
        assert set(js) == set(ts)
        np.testing.assert_array_equal(ts["obs"], js["obs"])
        np.testing.assert_array_equal(ts["actions"], js["actions"])
        for k in ("logp", "advantages", "value_targets"):
            np.testing.assert_allclose(ts[k], js[k], err_msg=k, **TOL)
    jt, tt = jr.sample_trajectory(), tr.sample_trajectory()
    assert set(jt) == set(tt)
    for k in ("obs", "actions", "rewards", "dones", "bootstrap_obs"):
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    for k in ("behavior_logp", "bootstrap_value"):
        np.testing.assert_allclose(tt[k], jt[k], err_msg=k, **TOL)
    assert jt["dones"].any()                # episodes ended inside
    assert tr.get_metrics() == jr.get_metrics()


def test_record_experiences_matches_jax():
    from ray_tpu.rl.offline import record_experiences as jrec
    from ray_tpu_torch.rl.offline import record_experiences
    assert record_experiences("CartPole-v1", num_steps=60, seed=2) == \
        jrec("CartPole-v1", num_steps=60, seed=2)


def test_policy_server_protocol():
    """Server + client round trip without a runtime: episodes record
    per-step policy outputs, episode end produces one GAE'd fragment with
    the PPO batch contract."""
    from ray_tpu_torch.rl import PolicyClient
    from ray_tpu_torch.rl.external import PolicyServer
    cfg = {"obs_shape": [4], "action_spec": {"type": "discrete", "n": 2},
           "hidden_sizes": (16,), "seed": 0, "gamma": 0.99,
           "lambda_": 0.95}
    server = PolicyServer(cfg, port=0)
    try:
        client = PolicyClient(server.address())
        eid = client.start_episode()
        rng = np.random.default_rng(0)
        for _ in range(5):
            assert client.get_action(eid, rng.normal(size=4)) in (0, 1)
            client.log_returns(eid, 1.0)
        client.end_episode(eid, rng.normal(size=4))
        frags = server.drain()
        assert len(frags) == 1
        f = frags[0]
        assert set(f) == {"obs", "actions", "logp", "advantages",
                          "value_targets"}
        assert f["obs"].shape == (5, 4) and f["actions"].shape == (5,)
        # GAE with a terminal value of 0, from the recorded values
        val = f["value_targets"] - f["advantages"]
        adv, last = np.zeros(5, np.float32), 0.0
        for t in reversed(range(5)):
            nv = val[t + 1] if t + 1 < 5 else 0.0
            last = 1.0 + 0.99 * nv - val[t] + 0.99 * 0.95 * last
            adv[t] = last
        np.testing.assert_allclose(f["advantages"], adv, **TOL)
        assert server.drain() == []
        m = server.get_metrics()
        assert m["num_episodes"] == 1
        assert m["episode_return_mean"] == pytest.approx(5.0)
        with pytest.raises(RuntimeError):
            client.get_action("nope", np.zeros(4))
    finally:
        server._http.shutdown()
        server._http.server_close()
