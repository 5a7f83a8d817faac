"""The port's RL nets and modules (ray_tpu_torch.rl.rl_module, the SAC and
DQN nets) against the JAX package's on the same weights: each flax net's
params, converted by models.convert.rl_params_from_jax, give the same
forward, logp_entropy_value and dist_values on inputs made from a numpy
seed, and the recurrent unroll (with episode resets mid-sequence) equals
stepwise calls and JAX's scanned unroll. All fp32 on the CPU, held to
atol = rtol = 1e-5 (a few ulps of the outputs, ~1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import rl_module as jrm
from ray_tpu_torch.models.convert import rl_params_from_jax
from ray_tpu_torch.rl import rl_module as trm

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(tol or TOL))


def _port(jmod, tmod, kind, params=None):
    """Load the JAX module's (or the given) params into the port module."""
    tmod.net.load_state_dict(rl_params_from_jax(kind, _np(
        jmod.params if params is None else params)))
    return tmod


@pytest.fixture(scope="module")
def jax_mods():
    """Each JAX module built once, the five at once in threads (flax's
    init runs op by op, compiling each op: ~13 s one after another)."""
    from concurrent.futures import ThreadPoolExecutor
    makers = {
        "disc": lambda: jrm.DiscreteRLModule(4, 2, (64, 64), seed=0),
        "cont": lambda: jrm.ContinuousRLModule(3, 2, (16, 16), seed=0),
        "conv": lambda: jrm.ConvDiscreteRLModule((8, 8, 1), 4, (64,),
                                                 seed=0),
        "discrete": lambda: jrm.RecurrentDiscreteRLModule(4, 2, (32,),
                                                          seed=0),
        "continuous": lambda: jrm.RecurrentContinuousRLModule(
            4, 2, (32,), seed=0),
    }
    with ThreadPoolExecutor(len(makers)) as ex:
        futures = {k: ex.submit(f) for k, f in makers.items()}
        return {k: f.result() for k, f in futures.items()}


def _obs(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_discrete_module_matches_jax(jax_mods):
    jm = jax_mods["disc"]
    tm = _port(jm, trm.DiscreteRLModule(4, 2, (64, 64), seed=1),
               "PolicyValueNet")
    obs = _obs(1, 32, 4)
    acts = np.random.default_rng(2).integers(0, 2, 32)
    jl, jv = jm.forward(jm.params, obs)
    tl, tv = tm.forward(obs)
    _close(tl, jl)
    _close(tv, jv)
    for got, want in zip(
            tm.logp_entropy_value(tm.tensor(obs), torch.as_tensor(acts)),
            jm.logp_entropy_value(jm.params, obs, jnp.asarray(acts))):
        _close(got, want)
    (d, v) = tm.dist_values(tm.tensor(obs))
    (jd, jv2) = jm.dist_values(jm.params, obs)
    _close(d, jd)
    _close(v, jv2)


def test_continuous_module_matches_jax(jax_mods):
    jm = jax_mods["cont"]
    params = dict(_np(jm.params))
    # a log_std off its zero init, so its broadcast is held too
    params["log_std"] = np.asarray([-0.3, 0.4], np.float32)
    tm = _port(jm, trm.ContinuousRLModule(3, 2, (16, 16)),
               "GaussianPolicyValueNet", params)
    obs = _obs(3, 16, 3)
    acts = _obs(4, 16, 2)
    (tmean, tls), tv = tm.dist_values(tm.tensor(obs))
    (jmean, jls), jv = jm.dist_values(params, obs)
    for got, want in ((tmean, jmean), (tls, jls), (tv, jv)):
        _close(got, want)
    for got, want in zip(tm.logp_entropy_value(tm.tensor(obs),
                                               tm.tensor(acts)),
                         jm.logp_entropy_value(params, obs, acts)):
        _close(got, want)
    # the recurrent-continuous module shares the same logp/entropy
    lstm = trm.make_rl_module((3,), {"type": "box", "dim": 2, "low": [-1, -1],
                                     "high": [1, 1]}, use_lstm=True)
    assert isinstance(lstm, trm.RecurrentContinuousRLModule)
    assert lstm.seq_logp_entropy is tm.seq_logp_entropy
    np.testing.assert_array_equal(
        lstm.clip_actions(np.array([[2.0, -3.0]], np.float32)),
        [[1.0, -1.0]])


def test_conv_module_matches_jax(jax_mods):
    """flax pads 'SAME' at stride 2 asymmetrically (8 -> 4 pads (0, 1))
    and flattens (H, W, C); torch's Conv2d(padding=1) and an NCHW flatten
    would each move the outputs far past the bound, which is checked
    too."""
    shape = (8, 8, 1)
    jm = jax_mods["conv"]
    tm = _port(jm, trm.ConvDiscreteRLModule(shape, 4, (64,)),
               "ConvPolicyValueNet")
    obs = np.random.default_rng(5).random((6,) + shape).astype(np.float32)
    jl, jv = jm.forward(jm.params, obs)
    tl, tv = tm.forward(obs)
    _close(tl, jl)
    _close(tv, jv)
    # the alternatives a straight translation would take are far off
    net = tm.net
    x = tm.tensor(obs).permute(0, 3, 1, 2)
    with torch.no_grad():
        sym = torch.relu(torch.nn.functional.conv2d(
            torch.relu(torch.nn.functional.conv2d(
                x, net.conv1.weight, net.conv1.bias, stride=2, padding=1)),
            net.conv2.weight, net.conv2.bias, stride=2, padding=1))
        nchw = sym.reshape(len(obs), -1)
        h = torch.relu(net.hidden[0](nchw))
        assert (net.pi_out(h) - tl).abs().max() > 100 * TOL["atol"]
        good = torch.relu(net.conv2(trm._same_pad(torch.relu(
            net.conv1(trm._same_pad(x))))))
        flat_nchw = good.reshape(len(obs), -1)
        h = torch.relu(net.hidden[0](flat_nchw))
        assert (net.pi_out(h) - tl).abs().max() > 100 * TOL["atol"]


def _dones(T, B):
    d = np.zeros((T, B), np.float32)
    d[2, 1] = 1.0
    d[4, 0] = 1.0
    return d


@pytest.mark.parametrize("recurrent", ["discrete", "continuous"])
def test_recurrent_unroll_matches_stepwise_and_jax(jax_mods, recurrent):
    """The learner's unroll re-derives the states the runner saw, with
    episode resets mid-fragment: stepwise calls (carry zeroed after a
    done), the port's unroll and JAX's scanned unroll all agree. The
    carry is (c, h) as flax orders it; torch's LSTMCell takes (h, c)."""
    T, B, D = 6, 3, 4
    jm = jax_mods[recurrent]
    if recurrent == "discrete":
        tm = _port(jm, trm.RecurrentDiscreteRLModule(D, 2, (32,)),
                   "LSTMPolicyValueNet")
    else:
        tm = _port(jm, trm.RecurrentContinuousRLModule(D, 2, (32,)),
                   "LSTMGaussianPolicyValueNet")
    obs = _obs(6, T, B, D)
    dones = _dones(T, B)
    resets = np.concatenate([np.zeros((1, B), np.float32), dones[:-1]], 0)
    # a non-zero starting carry, so its order (c, h) matters from step 0
    c0, h0 = _obs(7, B, 32) * 0.5, _obs(8, B, 32) * 0.5
    jd, jv, (jc, jh) = jm._unroll(jm.params, (c0, h0), obs, resets)
    with torch.no_grad():
        td, tv, (tc, th) = tm.forward_seq(
            tm.tensor(obs), tm.tensor(resets), (tm.tensor(c0),
                                                tm.tensor(h0)))
        state = (tm.tensor(c0), tm.tensor(h0))
        steps = []
        for t in range(T):
            state, (dist, v) = tm.step(tm.tensor(obs[t]), state)
            steps.append((dist, v))
            keep = tm.tensor(1.0 - dones[t])[:, None]
            state = (state[0] * keep, state[1] * keep)
    first = (lambda d: d[0]) if recurrent == "continuous" else \
        (lambda d: d)
    _close(first(td), first(jd))
    _close(tv, jv)
    _close(tc, jc)
    _close(th, jh)
    _close(torch.stack([first(d) for d, _ in steps]), first(td), atol=1e-6,
           rtol=1e-6)
    _close(torch.stack([v for _, v in steps]), tv, atol=1e-6, rtol=1e-6)
    if recurrent == "continuous":
        _close(td[1], jd[1])


def test_recurrent_sample_actions_carry_state(jax_mods):
    jm = jax_mods["discrete"]
    tm = _port(jm, trm.RecurrentDiscreteRLModule(4, 2, (32,)),
               "LSTMPolicyValueNet")
    obs = _obs(9, 5, 4)
    g = torch.Generator().manual_seed(0)
    a, logp, v, state = tm.sample_actions(obs, g)
    assert a.shape == (5,) and a.dtype == np.int64 and logp.shape == (5,)
    jl, jv = jm.forward(jm.params, obs)
    _close(v, jv)
    want_logp = jax.nn.log_softmax(jl)[np.arange(5), a]
    _close(logp, want_logp)
    # same generator seed, same draws
    a2, *_ = tm.sample_actions(obs, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a, a2)
    # the returned carry is the next step's (c, h)
    (jc, jh), _ = jm._step(jm.params, jm.initial_state(5), obs)
    _close(state[0], jc)
    _close(state[1], jh)


def test_q_and_sac_nets_match_jax():
    from ray_tpu.rl.dqn import QNet as JQNet
    from ray_tpu.rl.sac import make_nets as jax_nets
    from ray_tpu_torch.rl.dqn import QNet
    from ray_tpu_torch.rl.sac import make_nets

    obs = _obs(10, 12, 3)
    act = np.tanh(_obs(11, 12, 2))
    jq = JQNet(2, (16, 16))
    qp = jq.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
    tq = QNet(3, 2, (16, 16))
    tq.load_state_dict(rl_params_from_jax("QNet", _np(qp)))
    _close(tq(torch.as_tensor(obs)), jq.apply({"params": qp}, obs))

    jpi, jtq = jax_nets(2, (16, 16))
    pp = jpi.init(jax.random.PRNGKey(1), jnp.zeros((1, 3)))["params"]
    # push log_std past its upper clip for some rows
    pp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 3.0 if "Dense_3" in str(path) and
        "bias" in str(path) else x, pp)
    qq = jtq.init(jax.random.PRNGKey(2), jnp.zeros((1, 3)),
                  jnp.zeros((1, 2)))["params"]
    tpi, ttq = make_nets(3, 2, (16, 16))
    tpi.load_state_dict(rl_params_from_jax("Policy", _np(pp)))
    ttq.load_state_dict(rl_params_from_jax("TwinQ", _np(qq)))
    with torch.no_grad():
        for got, want in zip(tpi(torch.as_tensor(obs)),
                             jpi.apply({"params": pp}, obs)):
            _close(got, want)
        assert float(tpi(torch.as_tensor(obs))[1].max()) == 2.0
        for got, want in zip(ttq(torch.as_tensor(obs), torch.as_tensor(act)),
                             jtq.apply({"params": qq}, obs, act)):
            _close(got, want)


def test_converter_maps_every_leaf(jax_mods):
    """Every parameter of every port net is set by the converter, from a
    tree with the flax net's own structure."""
    cases = [
        ("PolicyValueNet", jax_mods["disc"],
         trm.DiscreteRLModule(4, 2, (64, 64))),
        ("GaussianPolicyValueNet", jax_mods["cont"],
         trm.ContinuousRLModule(3, 2, (16, 16))),
        ("ConvPolicyValueNet", jax_mods["conv"],
         trm.ConvDiscreteRLModule((8, 8, 1), 4, (64,))),
        ("LSTMPolicyValueNet", jax_mods["discrete"],
         trm.RecurrentDiscreteRLModule(4, 2, (32,))),
        ("LSTMGaussianPolicyValueNet", jax_mods["continuous"],
         trm.RecurrentContinuousRLModule(4, 2, (32,))),
    ]
    for kind, jm, tm in cases:
        sd = rl_params_from_jax(kind, _np(jm.params))
        want = tm.net.state_dict()
        assert set(sd) == set(want), kind
        for k, v in sd.items():
            assert v.shape == want[k].shape, (kind, k)
        n_jax = sum(np.asarray(x).size
                    for x in jax.tree.leaves(jm.params))
        # torch's LSTMCell has one more bias than flax's cell
        extra = want["cell.bias_ih"].numel() if "cell.bias_ih" in want else 0
        assert sum(v.numel() for v in sd.values()) == n_jax + extra, kind
    with pytest.raises(ValueError, match="unknown RL net"):
        rl_params_from_jax("Nope", {})


def test_make_rl_module_catalog_and_init(monkeypatch):
    spec = {"type": "discrete", "n": 3}
    assert isinstance(trm.make_rl_module((4,), spec),
                      trm.DiscreteRLModule)
    assert isinstance(trm.make_rl_module((8, 8, 1), spec),
                      trm.ConvDiscreteRLModule)
    assert isinstance(trm.make_rl_module((4,), spec, use_lstm=True),
                      trm.RecurrentDiscreteRLModule)
    assert isinstance(trm.make_rl_module((4,), {"type": "box", "dim": 2}),
                      trm.ContinuousRLModule)
    with pytest.raises(ValueError, match="flat observations"):
        trm.make_rl_module((8, 8, 1), spec, use_lstm=True)
    # seeded init: same seed same weights, flax's distributions (kernels
    # truncated at 2 std of 1/sqrt(fan_in), zero biases)
    a = trm.DiscreteRLModule(4, 2, (64, 64), seed=3).get_weights()
    b = trm.DiscreteRLModule(4, 2, (64, 64), seed=3).get_weights()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    w = a["pi.1.weight"]
    std = np.sqrt(1 / 64) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-6 and abs(w.std() - 1 / 8) < 0.02
    assert not a["pi.0.bias"].any()
    # weights leave as copies
    m = trm.DiscreteRLModule(4, 2, (8,))
    w = m.get_weights()
    with torch.no_grad():
        m.net.pi[0].weight.add_(1.0)
    assert not np.array_equal(w["pi.0.weight"], m.get_weights()["pi.0.weight"])
    # a module asked for the card without one raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        trm.DiscreteRLModule(4, 2, device="cuda")
