"""RLModule: the framework-agnostic model API, PyTorch implementation
(reference: rllib/core/rl_module/ — policy+value modules that env runners
and learners share; the JAX package's counterpart is flax modules over a
param pytree).

Three module families (reference: rllib/models/ catalog — MLP, CNN and
continuous-action heads), each feedforward or recurrent:
- DiscreteRLModule: MLP trunk, categorical head (flat observations)
- ConvDiscreteRLModule: shared CNN encoder, categorical head (image obs)
- ContinuousRLModule: MLP trunk, diagonal-Gaussian head (Box actions,
  reference: rllib TorchDiagGaussian action dist)
- RecurrentDiscreteRLModule / RecurrentContinuousRLModule: an LSTM core
  (reference: rllib/models/torch/recurrent_net.py LSTMWrapper)

Every module exposes the same surface: ``sample_actions`` (env-runner
side, with an explicit ``torch.Generator``) and ``logp_entropy_value`` /
``dist_values`` / ``forward_seq`` (the losses' contract), so learners are
action-space agnostic. A module holds one ``nn.Module`` (``net``) on one
device; the losses may pass another net of the same shape (APPO's lagged
target). Weights leave a module as numpy arrays keyed by the net's
``state_dict`` names (``get_weights``), which is what crosses the object
store.

Each net computes what its flax counterpart computes, so a flax param tree
converted by ``models.convert.rl_params_from_jax`` gives the same outputs:
Dense kernels are transposed into ``nn.Linear`` weights; flax's 'SAME'
convolution padding, which is asymmetric at stride 2, is padded explicitly;
the conv features are flattened in flax's (H, W, C) order; the LSTM keeps
flax's carry order (c, h) around ``nn.LSTMCell``. Fresh weights follow
flax's initialisers (truncated lecun-normal kernels, zero biases,
orthogonal recurrent kernels), drawn from a ``torch.Generator`` seeded by
``seed``: the distributions are flax's, the draws are not.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device

# std of the unit normal truncated at +-2 (flax's lecun_normal divides by it)
_TRUNC_STD = 0.87962566103423978
_LOG_2PI = math.log(2 * math.pi)


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


@torch.no_grad()
def dense(n_in: int, n_out: int, g: torch.Generator,
          small_uniform: bool = False) -> nn.Linear:
    """``nn.Linear`` with flax ``nn.Dense``'s initialisers: lecun-normal
    kernel (or, for a Gaussian mean head, variance_scaling(0.01, fan_avg,
    uniform)) and a zero bias."""
    lin = nn.utils.skip_init(nn.Linear, n_in, n_out)
    if small_uniform:
        limit = math.sqrt(3 * 0.01 / ((n_in + n_out) / 2))
        lin.weight.uniform_(-limit, limit, generator=g)
    else:
        _lecun_normal_(lin.weight, n_in, g)
    lin.bias.zero_()
    return lin


@torch.no_grad()
def _conv(c_in: int, c_out: int, g: torch.Generator) -> nn.Conv2d:
    conv = nn.utils.skip_init(nn.Conv2d, c_in, c_out, 3, stride=2,
                              padding=0)
    _lecun_normal_(conv.weight, c_in * 9, g)
    conv.bias.zero_()
    return conv


@torch.no_grad()
def _lstm_cell(n_in: int, hidden: int, g: torch.Generator) -> nn.LSTMCell:
    """flax OptimizedLSTMCell's initialisers: lecun-normal input kernels,
    orthogonal recurrent kernels, one zero bias. flax's cell has one bias
    (on its hidden kernels) and torch's two add, so ``bias_ih`` is a zero
    buffer, not a parameter: trained, it would take the same gradient as
    ``bias_hh`` and move the sum twice as fast."""
    cell = nn.utils.skip_init(nn.LSTMCell, n_in, hidden)
    for k in range(4):
        _lecun_normal_(cell.weight_ih[k * hidden:(k + 1) * hidden], n_in, g)
        nn.init.orthogonal_(cell.weight_hh[k * hidden:(k + 1) * hidden],
                            generator=g)
    del cell.bias_ih
    cell.register_buffer("bias_ih", torch.zeros(4 * hidden))
    cell.bias_hh.zero_()
    return cell


def _mlp(sizes: Sequence[int], g: torch.Generator) -> nn.ModuleList:
    return nn.ModuleList(dense(a, b, g) for a, b in zip(sizes[:-1],
                                                          sizes[1:]))


def _same_pad(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax 'SAME' padding of an NCHW input: out = ceil(n / s), the total
    padding split with the odd one after (8 -> 4 pads (0, 1))."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class PolicyValueNet(nn.Module):
    """tanh MLP policy trunk + logits, and a separate tanh MLP value
    trunk (flax: Dense_0..k-1 policy, Dense_k logits, then the value's)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (64, 64),
                 generator: torch.Generator = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        sizes = [obs_dim, *hidden_sizes]
        self.pi = _mlp(sizes, g)
        self.pi_out = dense(sizes[-1], action_dim, g)
        self.vf = _mlp(sizes, g)
        self.vf_out = dense(sizes[-1], 1, g)

    def _value(self, obs):
        v = obs
        for layer in self.vf:
            v = torch.tanh(layer(v))
        return self.vf_out(v)[..., 0]

    def forward(self, obs):
        x = obs
        for layer in self.pi:
            x = torch.tanh(layer(x))
        return self.pi_out(x), self._value(obs)


class GaussianPolicyValueNet(PolicyValueNet):
    """Diagonal-Gaussian policy for Box action spaces; log_std is a free
    state-independent parameter (rllib's default for PPO)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (64, 64),
                 generator: torch.Generator = None):
        nn.Module.__init__(self)
        g = generator or torch.Generator().manual_seed(0)
        sizes = [obs_dim, *hidden_sizes]
        self.pi = _mlp(sizes, g)
        self.pi_out = dense(sizes[-1], action_dim, g, small_uniform=True)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.vf = _mlp(sizes, g)
        self.vf_out = dense(sizes[-1], 1, g)

    def forward(self, obs):
        mean, value = super().forward(obs)
        return mean, self.log_std.expand_as(mean), value


class ConvPolicyValueNet(nn.Module):
    """Small shared CNN encoder + categorical/value heads for [H,W,C]
    observations (two 3x3 stride-2 convs, 'SAME' as flax pads them)."""

    def __init__(self, obs_shape: Tuple[int, int, int], action_dim: int,
                 hidden_sizes: Sequence[int] = (64,),
                 generator: torch.Generator = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = obs_shape
        self.conv1 = _conv(c, 16, g)
        self.conv2 = _conv(16, 32, g)
        for _ in range(2):
            h, w = -(-h // 2), -(-w // 2)
        sizes = [h * w * 32, *hidden_sizes]
        self.hidden = _mlp(sizes, g)
        self.pi_out = dense(sizes[-1], action_dim, g)
        self.vf_out = dense(sizes[-1], 1, g)

    def forward(self, obs):
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + tuple(obs.shape[-3:])).permute(0, 3, 1, 2)
        x = F.relu(self.conv1(_same_pad(x)))
        x = F.relu(self.conv2(_same_pad(x)))
        # flatten in flax's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(tuple(lead) + (-1,))
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.pi_out(x), self.vf_out(x)[..., 0]


class LSTMPolicyValueNet(nn.Module):
    """Single-step recurrent policy/value core (reference:
    rllib/models/torch/recurrent_net.py LSTMWrapper — encoder → LSTM →
    categorical/value heads). forward is ONE step: (carry, obs[B,D]) ->
    (carry', (logits, value)), carry = (c, h) as flax orders it; sequence
    unrolls live in the module classes."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 64,
                 embed: int = 64, generator: torch.Generator = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.embed = dense(obs_dim, embed, g)
        self.cell = _lstm_cell(embed, hidden, g)
        self.pi_out = dense(hidden, action_dim, g)
        self.vf_out = dense(hidden, 1, g)

    def core(self, carry, obs):
        c, h = carry
        h, c = self.cell(torch.tanh(self.embed(obs)), (h, c))
        return (c, h), h

    def forward(self, carry, obs):
        carry, h = self.core(carry, obs)
        return carry, (self.pi_out(h), self.vf_out(h)[..., 0])


class LSTMGaussianPolicyValueNet(LSTMPolicyValueNet):
    """The continuous sibling of LSTMPolicyValueNet: (carry, obs) ->
    (carry', ((mean, log_std), value))."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 64,
                 embed: int = 64, generator: torch.Generator = None):
        nn.Module.__init__(self)
        g = generator or torch.Generator().manual_seed(0)
        self.embed = dense(obs_dim, embed, g)
        self.cell = _lstm_cell(embed, hidden, g)
        self.pi_out = dense(hidden, action_dim, g, small_uniform=True)
        # start at sigma=e^-1~0.37, not 1.0: recurrent value estimation
        # is slow to settle, and unit noise on a typically-[-1,1] Box
        # swamps the memory signal for the first hundred updates
        self.log_std = nn.Parameter(torch.full((action_dim,), -1.0))
        self.vf_out = dense(hidden, 1, g)

    def forward(self, carry, obs):
        carry, h = self.core(carry, obs)
        mean = self.pi_out(h)
        return carry, ((mean, self.log_std.expand_as(mean)),
                       self.vf_out(h)[..., 0])


def _categorical_logp_entropy(logits, actions):
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions.long()[..., None])[..., 0]
    entropy = -(logp_all.exp() * logp_all).sum(-1)
    return logp, entropy


def _gaussian_logp_entropy(dist, actions):
    mean, log_std = dist
    z = (actions - mean) / torch.exp(log_std)
    logp = (-0.5 * (z ** 2) - log_std - 0.5 * _LOG_2PI).sum(-1)
    entropy = (log_std + 0.5 * (1 + _LOG_2PI)).sum(-1)
    return logp, entropy


def _categorical_sample(logits, generator):
    action = torch.multinomial(torch.softmax(logits, -1), 1,
                               generator=generator)[:, 0]
    logp, _ = _categorical_logp_entropy(logits, action)
    return action, logp


def _gaussian_sample(mean, log_std, generator):
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    action = mean + torch.exp(log_std) * noise
    logp = (-0.5 * (noise ** 2) - log_std - 0.5 * _LOG_2PI).sum(-1)
    return action, logp


def weights_of(net: nn.Module) -> Dict[str, np.ndarray]:
    """A net's weights as numpy arrays keyed by ``state_dict`` name
    (copies, off the device): what crosses the object store."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in net.state_dict().items()}


def load_weights(net: nn.Module, weights) -> None:
    """Load numpy weights (``get_weights``' form) into ``net``. Copies:
    arrays that arrive through the object store are read-only views."""
    net.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in weights.items()})


def _numpy(*tensors):
    return tuple(t.detach().cpu().numpy() for t in tensors)


class _ModuleBase:
    is_recurrent = False
    net: nn.Module

    def _place(self, net: nn.Module, device) -> None:
        self.device = resolve_device(device)
        self.net = net.to(self.device)

    def _net(self, net):
        return self.net if net is None else net

    def tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def dist_values(self, obs, net: nn.Module = None):
        """(action-distribution params, values) for flat-batch obs. The
        dist is what this family's ``seq_logp_entropy`` consumes —
        logits for categorical, (mean, log_std) for Gaussian — so the
        vtrace-family losses are action-space agnostic."""
        return self._net(net)(obs)

    def logp_entropy_value(self, obs, actions, net: nn.Module = None):
        """Per-sample log-prob of ``actions``, policy entropy and value
        estimates — the learner's loss contract."""
        dist, value = self.dist_values(obs, net)
        logp, entropy = self.seq_logp_entropy(dist, actions)
        return logp, entropy, value

    def get_weights(self) -> Dict[str, np.ndarray]:
        return weights_of(self.net)

    def set_weights(self, weights) -> None:
        load_weights(self.net, weights)


class _BoxActions:
    """A Box action space's bounds; actions sample unsquashed and the env
    runner clips them at step time (rllib's default PPO setup)."""

    def _bounds(self, action_dim, low, high):
        self.action_event_shape = (action_dim,)
        self.low = None if low is None else np.asarray(low, np.float32)
        self.high = None if high is None else np.asarray(high, np.float32)

    def clip_actions(self, actions: np.ndarray) -> np.ndarray:
        if self.low is None:
            return actions
        return np.clip(actions, self.low, self.high)


class DiscreteRLModule(_ModuleBase):
    """Policy/value module for discrete action spaces (flat obs)."""

    action_np_dtype = np.int64
    action_event_shape: Tuple[int, ...] = ()
    seq_logp_entropy = staticmethod(_categorical_logp_entropy)

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (64, 64), seed: int = 0,
                 net: nn.Module = None, device="cpu"):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        g = torch.Generator().manual_seed(seed)
        if net is None:
            net = PolicyValueNet(obs_dim, action_dim, tuple(hidden_sizes), g)
        self._place(net, device)

    @torch.no_grad()
    def forward(self, obs):
        return self.net(self.tensor(obs))

    @torch.no_grad()
    def sample_actions(self, obs, generator: torch.Generator):
        """(actions, logp, values) as numpy arrays."""
        logits, value = self.net(self.tensor(obs))
        action, logp = _categorical_sample(logits, generator)
        return _numpy(action, logp, value)


class ConvDiscreteRLModule(DiscreteRLModule):
    """Discrete actions over image observations ([H,W,C])."""

    def __init__(self, obs_shape: Tuple[int, ...], action_dim: int,
                 hidden_sizes: Sequence[int] = (64,), seed: int = 0,
                 device="cpu"):
        g = torch.Generator().manual_seed(seed)
        super().__init__(int(np.prod(obs_shape)), action_dim, hidden_sizes,
                         seed, device=device,
                         net=ConvPolicyValueNet(tuple(obs_shape), action_dim,
                                                tuple(hidden_sizes), g))


class ContinuousRLModule(_BoxActions, _ModuleBase):
    """Diagonal-Gaussian policy for Box action spaces."""

    action_np_dtype = np.float32
    seq_logp_entropy = staticmethod(_gaussian_logp_entropy)

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (64, 64), seed: int = 0,
                 low=None, high=None, device="cpu"):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self._bounds(action_dim, low, high)
        g = torch.Generator().manual_seed(seed)
        self._place(GaussianPolicyValueNet(obs_dim, action_dim,
                                           tuple(hidden_sizes), g), device)

    def dist_values(self, obs, net: nn.Module = None):
        mean, log_std, value = self._net(net)(obs)
        return (mean, log_std), value

    @torch.no_grad()
    def forward(self, obs):
        mean, _log_std, value = self.net(self.tensor(obs))
        return mean, value

    @torch.no_grad()
    def sample_actions(self, obs, generator: torch.Generator):
        mean, log_std, value = self.net(self.tensor(obs))
        action, logp = _gaussian_sample(mean, log_std, generator)
        return _numpy(action, logp, value)


class RecurrentDiscreteRLModule(_ModuleBase):
    """Recurrent (LSTM) module for discrete actions. State contract
    (reference: rllib connector-managed STATE_IN/STATE_OUT):
    - env runner: carries (c, h) across steps, zeroing env i's slot when
      its episode resets (the connector-reset discipline);
    - learner: receives the fragment's initial carry + per-step done
      flags and re-derives every intermediate state with an unroll,
      resetting the carry exactly where the runner did.
    Time-major [T, B, ...] throughout — the IMPALA/APPO batch shape."""

    is_recurrent = True
    action_np_dtype = np.int64
    action_event_shape: Tuple[int, ...] = ()
    seq_logp_entropy = staticmethod(_categorical_logp_entropy)
    _net_cls = LSTMPolicyValueNet

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (64, 64), seed: int = 0,
                 device="cpu"):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = int(hidden_sizes[0]) if hidden_sizes else 64
        g = torch.Generator().manual_seed(seed)
        self._place(self._net_cls(obs_dim, action_dim, hidden=self.hidden,
                                  embed=self.hidden, generator=g), device)

    def initial_state(self, batch_size: int):
        z = torch.zeros(batch_size, self.hidden, device=self.device)
        return (z, z.clone())

    def _state(self, state, batch_size):
        if state is None:
            return self.initial_state(batch_size)
        return tuple(self.tensor(s) for s in state)

    def step(self, obs, state, net: nn.Module = None):
        """One step: (state', (dist, value))."""
        return self._net(net)(state, obs)

    @torch.no_grad()
    def sample_actions(self, obs, generator: torch.Generator, state=None):
        """One env step: (actions, logp, value) as numpy, and the new
        state."""
        obs = self.tensor(obs)
        state, (logits, value) = self.step(obs, self._state(state, len(obs)))
        action, logp = _categorical_sample(logits, generator)
        return _numpy(action, logp, value) + (state,)

    def forward_seq(self, obs_seq, resets, carry0, net: nn.Module = None):
        """Sequence forward for the learner loss: obs_seq [T,B,D], resets
        [T,B] (1.0 where the episode restarted BEFORE step t) -> (dist
        [T,B,...], values [T,B], final carry)."""
        carry = carry0
        dists, values = [], []
        for t in range(obs_seq.shape[0]):
            keep = (1.0 - resets[t])[:, None]
            carry = (carry[0] * keep, carry[1] * keep)
            carry, (dist, value) = self.step(obs_seq[t], carry, net)
            dists.append(dist)
            values.append(value)
        return self._stack(dists), torch.stack(values), carry

    @staticmethod
    def _stack(dists):
        return torch.stack(dists)

    @torch.no_grad()
    def forward(self, obs, state=None):
        obs = self.tensor(obs)
        _, (logits, value) = self.step(obs, self._state(state, len(obs)))
        return logits, value


class RecurrentContinuousRLModule(_BoxActions, RecurrentDiscreteRLModule):
    """Recurrent (LSTM) module for Box action spaces: the
    RecurrentDiscreteRLModule state contract with a diagonal-Gaussian
    head."""

    action_np_dtype = np.float32
    seq_logp_entropy = staticmethod(_gaussian_logp_entropy)
    _net_cls = LSTMGaussianPolicyValueNet

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Sequence[int] = (64, 64), seed: int = 0,
                 low=None, high=None, device="cpu"):
        super().__init__(obs_dim, action_dim, hidden_sizes, seed, device)
        self._bounds(action_dim, low, high)

    @torch.no_grad()
    def sample_actions(self, obs, generator: torch.Generator, state=None):
        obs = self.tensor(obs)
        state, ((mean, log_std), value) = self.step(
            obs, self._state(state, len(obs)))
        action, logp = _gaussian_sample(mean, log_std, generator)
        return _numpy(action, logp, value) + (state,)

    @staticmethod
    def _stack(dists):
        return (torch.stack([m for m, _ in dists]),
                torch.stack([s for _, s in dists]))

    @torch.no_grad()
    def forward(self, obs, state=None):
        obs = self.tensor(obs)
        _, ((mean, _log_std), value) = self.step(
            obs, self._state(state, len(obs)))
        return mean, value


def action_spec_of(space) -> Dict:
    """gymnasium space -> serializable action spec."""
    import gymnasium as gym
    if isinstance(space, gym.spaces.Discrete):
        return {"type": "discrete", "n": int(space.n)}
    if isinstance(space, gym.spaces.Box):
        return {"type": "box", "dim": int(np.prod(space.shape)),
                "low": np.asarray(space.low).ravel().tolist(),
                "high": np.asarray(space.high).ravel().tolist()}
    raise ValueError(f"unsupported action space: {space}")


def make_rl_module(obs_shape: Tuple[int, ...], action_spec: Dict,
                   hidden_sizes: Sequence[int] = (64, 64), seed: int = 0,
                   use_lstm: bool = False, device="cpu"):
    """Module factory keyed by obs rank + action spec (reference:
    rllib/core/rl_module/default catalog selection; use_lstm mirrors
    rllib's model_config use_lstm switch). ``device`` is where the module
    runs: env runners keep the CPU, learners pass theirs."""
    obs_shape = tuple(obs_shape)
    if use_lstm:
        if len(obs_shape) > 1:
            raise ValueError(
                f"use_lstm requires flat observations, got shape "
                f"{obs_shape}; stack a flattening connector or use the "
                f"CNN module (conv+LSTM is not implemented)")
        if action_spec["type"] == "discrete":
            return RecurrentDiscreteRLModule(
                int(np.prod(obs_shape)), action_spec["n"], hidden_sizes,
                seed=seed, device=device)
        if action_spec["type"] == "box":
            return RecurrentContinuousRLModule(
                int(np.prod(obs_shape)), action_spec["dim"], hidden_sizes,
                seed=seed, low=action_spec.get("low"),
                high=action_spec.get("high"), device=device)
        raise ValueError(f"use_lstm: unsupported action spec "
                         f"{action_spec}")
    if action_spec["type"] == "discrete":
        if len(obs_shape) == 3:
            return ConvDiscreteRLModule(obs_shape, action_spec["n"],
                                        hidden_sizes, seed=seed,
                                        device=device)
        return DiscreteRLModule(int(np.prod(obs_shape)), action_spec["n"],
                                hidden_sizes, seed=seed, device=device)
    if action_spec["type"] == "box":
        return ContinuousRLModule(int(np.prod(obs_shape)),
                                  action_spec["dim"], hidden_sizes,
                                  seed=seed, low=action_spec.get("low"),
                                  high=action_spec.get("high"),
                                  device=device)
    raise ValueError(action_spec)
