"""The port's off-policy and offline updates against the JAX package's on
the same weights and minibatches (inputs made from a numpy seed), on the
CPU in fp32:

- DQN (DQNLearner vs the JAX DQN's jitted update): three double-DQN steps
  on minibatches drawn from a prioritized buffer (the port's and JAX's
  give the same indices and importance weights from the same seed), both
  buffers' priorities updated from the same td errors;
- SAC (SACLearner vs the JAX SAC's jitted update): three steps, each fed
  the two normal draws JAX makes inside its step from ``split(key)``;
- BC: one train() over a small dataset of recorded rows.

The JAX drivers are built with their env runners stubbed out in the test
(no runtime; nothing in either package is patched beyond that), and their
update functions called directly. Tolerances: losses and td errors to
atol = rtol = 1e-5 (SAC's to 1e-4, see SAC_TOL); weights after
Adam steps to atol 2e-5 (as test_torch_rl_learners.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import rl_params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
W_TOL = dict(rtol=0, atol=2e-5)
# SAC's losses and td errors: torch's and XLA's tanh differ in the last
# bit, and the tanh correction log(1 - a^2 + 1e-6), kept as the reference
# writes it, divides that by 1 - a^2 (~1e-4 for |u| ~ 5): a logp moves by
# ~1e-4, an actor loss of ~0.05 by ~2e-5 and a td error by ~5e-5, on
# weights equal to ~1e-8
SAC_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(kind, tree):
    return rl_params_from_jax(kind, _np(tree))


def _assert_net(net, kind, tree):
    want = {k: v.numpy() for k, v in _sd(kind, tree).items()}
    got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **W_TOL)


class _NoRunners(list):
    """Stands in for the JAX drivers' runner set: no actors."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def foreach(self, *args, **kwargs):
        return []

    def set_on_restart(self, fn):
        pass


@pytest.fixture
def jax_driver(monkeypatch):
    """Build a JAX DQN/SAC without a runtime: runners stubbed, weight
    pushes skipped."""
    import ray_tpu.rl.actor_manager as am
    monkeypatch.setattr(am, "FaultTolerantRunnerSet", _NoRunners)

    def build(cls, config):
        monkeypatch.setattr(cls, "_current_weights_ref", lambda self: None)
        return cls(config)
    return build


def _transitions(seed, n, obs_dim, action):
    rng = np.random.default_rng(seed)
    act = (rng.integers(0, 2, n).astype(np.int64) if action == "discrete"
           else np.tanh(rng.normal(size=(n, 1))).astype(np.float32))
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": act,
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32)}


def _buffers(data):
    from ray_tpu.rl.replay_buffer import PrioritizedReplayBuffer as JBuf
    from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer
    bufs = (JBuf(256, seed=5), PrioritizedReplayBuffer(256, seed=5))
    for b in bufs:
        b.add(data)
    return bufs


def test_dqn_update_matches_jax(jax_driver):
    """Double DQN with prioritized importance weights: the online net
    picks, the (initial) target net values the pick."""
    import jax.numpy as jnp
    from ray_tpu.rl import AlgorithmConfig as JConfig
    from ray_tpu.rl import dqn as jdqn
    from ray_tpu_torch.rl import AlgorithmConfig
    from ray_tpu_torch.rl.dqn import DQNLearner
    from ray_tpu_torch.rl.learner import to_device

    kw = dict(lr=1e-3, minibatch_size=64, hidden_sizes=(32, 32))
    jalgo = jax_driver(jdqn.DQN, JConfig().environment("CartPole-v1")
                       .training(**kw))
    cfg = AlgorithmConfig().environment("CartPole-v1").training(**kw) \
        .learners(device="cpu")
    tl = DQNLearner(dataclasses.asdict(cfg), 4, 2)
    tl.net.load_state_dict(_sd("QNet", jalgo.params))
    tl.sync_target()
    jbuf, tbuf = _buffers(_transitions(0, 200, 4, "discrete"))
    for _ in range(3):
        jmb, tmb = jbuf.sample(64), tbuf.sample(64)
        np.testing.assert_array_equal(tmb["indices"], jmb["indices"])
        np.testing.assert_array_equal(tmb["weights"], jmb["weights"])
        jidx, jw = jmb.pop("indices"), jmb.pop("weights")
        tidx, tw = tmb.pop("indices"), tmb.pop("weights")
        jalgo.params, jalgo.opt_state, jloss, jtd = jalgo._update(
            jalgo.params, jalgo.target_params, jalgo.opt_state,
            {k: jnp.asarray(v) for k, v in jmb.items()}, jnp.asarray(jw))
        tloss, ttd = tl.update(to_device(tmb, "cpu"), torch.as_tensor(tw))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
        np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), **TOL)
        # both buffers take the same priorities (the buffers' own parity
        # is held bit for bit in test_torch_rl_runtime.py)
        jbuf.update_priorities(jidx, np.asarray(jtd))
        tbuf.update_priorities(tidx, np.asarray(jtd))
    _assert_net(tl.net, "QNet", jalgo.params)
    _assert_net(tl.target_net, "QNet", jalgo.target_params)


def test_sac_update_matches_jax(jax_driver):
    """Critics, then the actor against the updated critics, alpha from the
    actor's log-probs, polyak last; the noise is JAX's own draws."""
    import jax.numpy as jnp
    from ray_tpu.rl import AlgorithmConfig as JConfig
    from ray_tpu.rl import sac as jsac
    from ray_tpu_torch.rl import AlgorithmConfig
    from ray_tpu_torch.rl.learner import to_device
    from ray_tpu_torch.rl.sac import SACLearner

    kw = dict(lr=3e-4, minibatch_size=64, hidden_sizes=(32, 32), tau=0.05)
    jalgo = jax_driver(jsac.SAC, JConfig().environment("Pendulum-v1")
                       .training(**kw))
    cfg = AlgorithmConfig().environment("Pendulum-v1").training(**kw) \
        .learners(device="cpu")
    tl = SACLearner(dataclasses.asdict(cfg), 3, 1)
    tl.pi.load_state_dict(_sd("Policy", jalgo.state["pi"]))
    tl.q.load_state_dict(_sd("TwinQ", jalgo.state["q"]))
    tl.q_target.load_state_dict(_sd("TwinQ", jalgo.state["q_target"]))
    assert float(tl.log_alpha.detach()) == pytest.approx(
        float(jalgo.state["log_alpha"]), abs=1e-7)
    data = _transitions(1, 64 * 3, 3, "box")
    for i in range(3):
        mb = {k: v[i * 64:(i + 1) * 64] for k, v in data.items()}
        w = np.linspace(0.5, 1.0, 64).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        k1, k2 = jax.random.split(key)
        noise = [torch.from_numpy(np.array(jax.random.normal(k, (64, 1))))
                 for k in (k1, k2)]
        jalgo.state, jalgo.opt_state, jm, jtd = jalgo._update(
            jalgo.state, jalgo.opt_state,
            {k: jnp.asarray(v) for k, v in mb.items()}, key, jnp.asarray(w))
        tm, ttd = tl.update(to_device(mb, "cpu"), torch.from_numpy(w),
                            *noise)
        for k in ("q_loss", "pi_loss", "alpha"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       err_msg=k, **SAC_TOL)
        np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), **SAC_TOL)
    _assert_net(tl.pi, "Policy", jalgo.state["pi"])
    _assert_net(tl.q, "TwinQ", jalgo.state["q"])
    _assert_net(tl.q_target, "TwinQ", jalgo.state["q_target"])
    np.testing.assert_allclose(float(tl.log_alpha.detach()),
                               float(jalgo.state["log_alpha"]), **W_TOL)


class _Rows:
    """A dataset of experience rows with the iter_batches BC reads."""

    def __init__(self, rows):
        self.rows = rows

    def iter_batches(self, batch_size, batch_format="numpy"):
        for i in range(0, len(self.rows), batch_size):
            chunk = self.rows[i:i + batch_size]
            yield {"obs": [r["obs"] for r in chunk],
                   "action": np.asarray([r["action"] for r in chunk])}


def test_bc_train_matches_jax():
    from ray_tpu.rl.offline import BC as JBC
    from ray_tpu.rl.offline import BCConfig as JBCConfig
    from ray_tpu_torch.rl.offline import BC, BCConfig
    rng = np.random.default_rng(1)
    rows = [{"obs": (o := rng.standard_normal(4).astype(np.float32))
             .tolist(), "action": int(o[0] > 0), "reward": 1.0,
             "done": False} for _ in range(200)]
    kw = dict(dataset=_Rows(rows), obs_dim=4, action_dim=2, num_epochs=2,
              lr=5e-3, train_batch_size=64, hidden_sizes=(32, 32))
    jbc = JBC(JBCConfig(**kw))
    tbc = BC(BCConfig(**kw, device="cpu"))
    tbc.module.set_weights(_sd("PolicyValueNet", jbc.module.params))
    jout, tout = jbc.train(), tbc.train()
    assert tout["num_batches"] == jout["num_batches"] == 4
    np.testing.assert_allclose(tout["loss"], jout["loss"], **TOL)
    _assert_net(tbc.module.net, "PolicyValueNet", jbc.module.params)
    assert tbc.action_accuracy() == jbc.action_accuracy()
