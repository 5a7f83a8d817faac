"""The port's on-policy learners against the JAX package's on the same
weights and batches (inputs made from a numpy seed), on the CPU in fp32:

- PPO (TorchLearner vs JaxLearner): one minibatch's loss, every gradient
  and the clipped Adam step, with the global-norm clip taken and not
  taken; then a whole update_from_batch, 6 epochs x 4 minibatches of the
  CartPole config, held on the final weights;
- vtrace against JAX's and against the plain Python recursion of the
  IMPALA paper's eq. 1;
- IMPALA's and APPO's update_from_trajectory, feedforward and LSTM (with
  episode ends inside the fragment), held on the weights after two
  passes.

Tolerances: a forward, a loss or a gradient to atol = rtol = 1e-5 (fp32
sums in another order); weights after Adam steps to atol 2e-5 (each step
divides by sqrt(v), so a rounding difference in a small gradient moves
its step; over these runs the weights stayed within 1.1e-6 of JAX's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import rl_params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
W_TOL = dict(rtol=0, atol=2e-5)

PPO_CFG = {"obs_shape": [4], "action_spec": {"type": "discrete", "n": 2},
           "hidden_sizes": (64, 64), "lr": 3e-4, "grad_clip": 0.5,
           "clip_param": 0.2, "vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
           "minibatch_size": 128, "num_epochs": 6, "seed": 0,
           "gamma": 0.99, "lambda_": 0.95, "learner_device": "cpu"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(kind, tree):
    return {k: v.numpy() for k, v in rl_params_from_jax(kind, _np(tree))
            .items()}


def _assert_weights(got: dict, want: dict, tol=None):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **(tol or W_TOL))


def ppo_batch(seed, n=512, obs_dim=4):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "logp": (np.log(0.5) + 0.3 * rng.normal(size=n))
            .astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_ppo():
    from ray_tpu.rl.learner import JaxLearner
    return JaxLearner(dict(PPO_CFG), 4, 2)


def _port_ppo(jl, **cfg):
    from ray_tpu_torch.rl.learner import TorchLearner
    tl = TorchLearner({**PPO_CFG, **cfg}, 4, 2)
    tl.set_weights(_sd("PolicyValueNet", jl.module.params))
    return tl


@pytest.mark.parametrize("grad_clip", [0.5, 100.0], ids=["clipped", "free"])
def test_ppo_minibatch_loss_grads_and_adam_step(jax_ppo, grad_clip):
    import optax
    jl = jax_ppo
    tl = _port_ppo(jl, grad_clip=grad_clip)
    mini = ppo_batch(1, n=128)
    grads, loss, aux = jl._grads_only(jl.module.params,
                                      {k: jnp.asarray(v)
                                       for k, v in mini.items()})
    from ray_tpu_torch.rl.learner import to_device
    tloss, taux = tl._grads(to_device(mini, "cpu"))
    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
    for k in aux:
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), **TOL)
    want = _sd("PolicyValueNet", grads)
    got = {n: p.grad.numpy() for n, p in tl.module.net.named_parameters()}
    _assert_weights(got, want, TOL)
    gnorm = float(optax.global_norm(grads))
    assert (gnorm > grad_clip) == (grad_clip == 0.5), gnorm
    # the clipped Adam step, from the optimizer's fresh state
    opt = optax.chain(optax.clip_by_global_norm(grad_clip),
                      optax.adam(PPO_CFG["lr"]))
    upd, _ = opt.update(grads, opt.init(jl.module.params), jl.module.params)
    stepped = optax.apply_updates(jl.module.params, upd)
    tl._apply()
    _assert_weights(tl.get_weights(), _sd("PolicyValueNet", stepped),
                    dict(rtol=0, atol=1e-6))


def test_ppo_update_from_batch_matches_jax(jax_ppo):
    """The whole update: 6 epochs x 4 minibatches of 128 (the CartPole
    config), permuted by default_rng(0) once per call on both sides (the
    last test of the shared JAX learner: it moves its weights)."""
    jl = jax_ppo
    tl = _port_ppo(jl)
    batch = ppo_batch(2)
    jm = jl.update_from_batch(batch)
    tm = tl.update_from_batch(batch)
    assert tm["num_minibatch_updates"] == jm["num_minibatch_updates"] == 24
    for k in ("total_loss", "policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    _assert_weights(tl.get_weights(),
                    _sd("PolicyValueNet", jl.module.params))
    # the profiler saw every minibatch and counted its FLOPs
    assert tl.profiler.steps == 24 and tl.profiler.flops > 0


def test_learner_without_card_raises(monkeypatch):
    from ray_tpu_torch.rl.learner import TorchLearner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {**PPO_CFG}
    cfg.pop("learner_device")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        TorchLearner(cfg, 4, 2)


def _vtrace_inputs(seed, T=7, B=3):
    rng = np.random.default_rng(seed)
    b_logp = rng.normal(size=(T, B)).astype(np.float32) * 0.3
    t_logp = b_logp + rng.normal(size=(T, B)).astype(np.float32) * 0.2
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    discounts = (0.9 * (rng.random((T, B)) > 0.2)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    return b_logp, t_logp, rewards, discounts, values, boot


def test_vtrace_matches_jax_and_the_recursion():
    from ray_tpu.rl.vtrace import vtrace as jax_vtrace
    from ray_tpu_torch.rl.vtrace import vtrace
    args = _vtrace_inputs(0)
    T, B = args[0].shape
    want = jax_vtrace(*map(jnp.asarray, args))
    t_args = [torch.from_numpy(a) for a in args]
    t_args[1].requires_grad_(True)
    t_args[4].requires_grad_(True)
    got = vtrace(*t_args)
    # outputs carry no gradient (stop_gradient in JAX)
    assert not got.vs.requires_grad and not got.pg_advantages.requires_grad
    np.testing.assert_allclose(got.vs.numpy(), np.asarray(want.vs), **TOL)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               np.asarray(want.pg_advantages), **TOL)
    # plain-python reference recursion (IMPALA paper eq. 1)
    b_logp, t_logp, rewards, discounts, values, boot = args
    rhos = np.minimum(1.0, np.exp(t_logp - b_logp))
    vs = np.zeros((T, B), np.float32)
    acc = np.zeros(B, np.float32)
    for t in reversed(range(T)):
        v_tp1 = values[t + 1] if t + 1 < T else boot
        delta = rhos[t] * (rewards[t] + discounts[t] * v_tp1 - values[t])
        acc = delta + discounts[t] * rhos[t] * acc
        vs[t] = acc + values[t]
    pg_adv = np.zeros((T, B), np.float32)
    for t in range(T):
        vs_tp1 = vs[t + 1] if t + 1 < T else boot
        pg_adv[t] = rhos[t] * (rewards[t] + discounts[t] * vs_tp1
                               - values[t])
    np.testing.assert_allclose(got.vs.numpy(), vs, **TOL)
    np.testing.assert_allclose(got.pg_advantages.numpy(), pg_adv, **TOL)


def trajectory(seed, T, B, obs_dim, lstm, hidden=32):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, B)) < 0.15).astype(np.float32)
    out = {"obs": rng.normal(size=(T, B, obs_dim)).astype(np.float32),
           "actions": rng.integers(0, 2, (T, B)).astype(np.int64),
           "behavior_logp": (np.log(0.5) + 0.3 * rng.normal(size=(T, B)))
           .astype(np.float32),
           "rewards": rng.normal(size=(T, B)).astype(np.float32),
           "dones": dones,
           "bootstrap_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
           "bootstrap_value": rng.normal(size=B).astype(np.float32)}
    if lstm:
        out["initial_state_c"] = (0.3 * rng.normal(size=(B, hidden))) \
            .astype(np.float32)
        out["initial_state_h"] = (0.3 * rng.normal(size=(B, hidden))) \
            .astype(np.float32)
    return out


VTRACE_CASES = [(algo, lstm) for algo in ("impala", "appo")
                for lstm in (False, True)]


def _vtrace_cfg(lstm):
    return {"obs_shape": [4], "action_spec": {"type": "discrete", "n": 2},
            "hidden_sizes": (32,) if lstm else (32, 32), "use_lstm": lstm,
            "lr": 1e-3, "grad_clip": 40.0, "gamma": 0.99, "clip_param": 0.3,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "num_epochs": 2,
            "target_update_freq": 1, "seed": 0, "learner_device": "cpu"}


def _jax_vtrace_run(algo, lstm):
    """The JAX learner's initial params, its metrics over two fragments
    and its final params (and APPO's target)."""
    from ray_tpu.rl import appo as jappo
    from ray_tpu.rl import impala as jimpala
    cls = jimpala.ImpalaLearner if algo == "impala" else jappo.AppoLearner
    jl = cls(_vtrace_cfg(lstm), 4, 2)
    out = {"init": _np(jl.module.params), "metrics": []}
    for seed in (3, 4):
        traj = trajectory(seed, T=12, B=4, obs_dim=4, lstm=lstm)
        out["metrics"].append(jl.update_from_trajectory(traj))
    out["final"] = _np(jl.module.params)
    out["target"] = _np(getattr(jl, "target_params", jl.module.params))
    return out


@pytest.fixture(scope="module")
def jax_vtrace_runs():
    """The four JAX runs at once in threads (each compiles its update)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(VTRACE_CASES)) as ex:
        futures = {c: ex.submit(_jax_vtrace_run, *c) for c in VTRACE_CASES}
        return {c: f.result() for c, f in futures.items()}


@pytest.mark.parametrize("algo,lstm", VTRACE_CASES,
                         ids=[f"{'lstm' if l else 'ff'}-{a}"
                              for a, l in VTRACE_CASES])
def test_vtrace_learners_match_jax(jax_vtrace_runs, algo, lstm):
    """Two passes of update_from_trajectory (num_epochs=2) and, for APPO,
    a target sync after the first of two fragments
    (target_update_freq=1): the losses and the weights."""
    from ray_tpu_torch.rl import appo, impala
    run = jax_vtrace_runs[(algo, lstm)]
    tcls = impala.ImpalaLearner if algo == "impala" else appo.AppoLearner
    kind = "LSTMPolicyValueNet" if lstm else "PolicyValueNet"
    tl = tcls(_vtrace_cfg(lstm), 4, 2)
    tl.module.set_weights(_sd(kind, run["init"]))
    if algo == "appo":
        tl.sync_target()
    for seed, jm in zip((3, 4), run["metrics"]):
        traj = trajectory(seed, T=12, B=4, obs_dim=4, lstm=lstm)
        tm = tl.update_from_trajectory(traj)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    _assert_weights(tl.get_weights(), _sd(kind, run["final"]))
    if algo == "appo":
        _assert_weights(
            {k: v.numpy() for k, v in tl.target_net.state_dict().items()},
            _sd(kind, run["target"]))
