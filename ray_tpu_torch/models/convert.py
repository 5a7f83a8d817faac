"""Weights for ``TransformerLM``: from a flax tree, or made from a seed.

``jax_leaf_groups`` groups the parameters by the JAX leaf they form (the
layers' tensors stacked on a leading axis, each in its JAX shape), the
unit that optax's per-leaf rules (Adafactor's factoring and block RMS)
work on. ``params_from_jax`` maps the JAX model's param tree (unboxed, leaves as
numpy arrays; the layers stacked on a leading axis under ``layers/block``)
to this package's ``state_dict``; a gradient tree of the same structure
maps the same way, onto the parameters' names. ``init_params`` makes
random weights with the JAX model's initialisers, from a
``torch.Generator``, on the device where they will be used.
``rl_params_from_jax`` maps the flax params of the RL package's small
nets (the policy/value MLPs, the conv net, the LSTMs, DQN's Q net, SAC's
policy and twin Q) onto the ``state_dict`` of the port's nets of the same
names (``ray_tpu_torch.rl``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig

# flax lecun_normal: a normal truncated at +-2, scaled so that the variance
# is 1/fan_in; this constant is the std of the unit normal truncated there
_TRUNC_STD = 0.87962566103423978

_ATTN = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"))
_MLP = (("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))
# an expert layer's weights: bare params in the JAX tree (no "kernel")
_MOE = ("router", "gate", "up", "down")


def _linears(moe: bool):
    """(module, name) of a block's 2-D linears: an expert block has no
    ``mlp``."""
    return _ATTN if moe else _ATTN + _MLP


def _moe_shape(cfg: TransformerConfig, name: str):
    """An expert-layer weight's shape in one layer (the JAX shape too)."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": (D, E), "gate": (E, D, F), "up": (E, D, F),
            "down": (E, F, D)}[name]


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax param tree -> state_dict of CPU tensors (the leaves' dtype;
    ``load_state_dict`` casts them to the model's)."""
    blk = tree["layers"]["block"]
    n_layers = np.asarray(blk["attn_norm"]["scale"]).shape[0]
    sd = {"embed": torch.from_numpy(np.array(tree["embed"])),
          "final_norm.scale": torch.from_numpy(
              np.array(tree["final_norm"]["scale"]))}
    if "unembed" in tree:
        sd["unembed"] = torch.from_numpy(np.array(tree["unembed"]))
    for i in range(n_layers):
        for name, t in block_params_from_jax(_layer(blk, i)).items():
            sd[f"layers.{i}.{name}"] = t
    return sd


def _layer(tree, i: int):
    """Layer i of a tree whose leaves stack the layers on axis 0."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def block_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """One JAX ``Block``'s param tree (a block initialised or applied on
    its own, not stacked under ``layers``; leaves as numpy arrays) ->
    the port ``Block``'s state_dict of CPU tensors. A gradient tree of
    the same structure maps the same way."""
    moe = "moe" in tree
    sd = {}
    for mod, name in _linears(moe):
        w = np.array(tree[mod][name]["kernel"])
        if name == "o":                      # [H, D, d_model]
            w = w.reshape(-1, w.shape[-1])
        else:                                # [d_model, (H|Hkv, D) | d_ff]
            w = w.reshape(w.shape[0], -1)
        sd[f"{mod}.{name}"] = torch.from_numpy(w)
    for name in _MOE if moe else ():
        sd[f"moe.{name}"] = torch.from_numpy(np.array(tree["moe"][name]))
    for norm in ("attn_norm", "mlp_norm"):
        sd[f"{norm}.scale"] = torch.from_numpy(
            np.array(tree[norm]["scale"]))
    return sd


def stage_state_dict(state_dict: Dict[str, torch.Tensor], first: int,
                     n_blocks: int) -> Dict[str, torch.Tensor]:
    """The weights of blocks first .. first + n_blocks - 1 of a model's
    state_dict, renamed for a ``BlockStage`` of n_blocks (``layers.{i}``
    counted from the stage's first block)."""
    out = {}
    for name, t in state_dict.items():
        parts = name.split(".", 2)
        if parts[0] == "layers" and \
                first <= int(parts[1]) < first + n_blocks:
            out[f"layers.{int(parts[1]) - first}.{parts[2]}"] = t
    return out


def _linear_shape(cfg: TransformerConfig, name: str):
    """A linear's JAX kernel shape in one layer (the port stores it 2-D)."""
    E, F, H, Hkv, D = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    return {"q": (E, H, D), "k": (E, Hkv, D), "v": (E, Hkv, D),
            "o": (H, D, E), "gate": (E, F), "up": (E, F),
            "down": (F, E)}[name]


def jax_leaf_groups(model) -> List[dict]:
    """The model's parameters as one ``torch.optim`` param group per leaf of
    the JAX param tree: ``{"params": [tensors], "name": the leaf's path,
    "shape": its JAX shape}``. A leaf under ``layers/block`` stacks the
    n_layers tensors of one name on a leading axis, each tensor viewed in
    its per-layer JAX shape (``shape[1:]``); any other leaf holds one
    tensor of ``shape``."""
    cfg = model.cfg
    n = cfg.n_layers
    groups = [{"params": [model.embed], "name": "embed",
               "shape": tuple(model.embed.shape), "stacked": False}]
    for mod, name in _linears(cfg.n_experts > 0):
        groups.append({
            "params": [getattr(getattr(blk, mod), name)
                       for blk in model.layers],
            "name": f"layers/block/{mod}/{name}/kernel",
            "shape": (n,) + _linear_shape(cfg, name), "stacked": True})
    for name in _MOE if cfg.n_experts > 0 else ():
        groups.append({
            "params": [getattr(blk.moe, name) for blk in model.layers],
            "name": f"layers/block/moe/{name}",
            "shape": (n,) + _moe_shape(cfg, name), "stacked": True})
    for norm in ("attn_norm", "mlp_norm"):
        groups.append({
            "params": [getattr(blk, norm).scale for blk in model.layers],
            "name": f"layers/block/{norm}/scale",
            "shape": (n, cfg.d_model), "stacked": True})
    groups.append({"params": [model.final_norm.scale],
                   "name": "final_norm/scale", "shape": (cfg.d_model,),
                   "stacked": False})
    if model.unembed is not None:
        groups.append({"params": [model.unembed], "name": "unembed",
                       "shape": tuple(model.unembed.shape),
                       "stacked": False})
    return groups


def _lecun_normal(shape, fan_in, generator, device, dtype):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=generator)
    return w.to(dtype)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda", dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Seeded random weights as a state_dict on ``device``: lecun_normal
    kernels, normal(0.02) embed/unembed, ones for the norm scales (the JAX
    model's initialisers; a 3-D expert weight's fan-in counts its experts,
    as flax's does). Linear, expert and embedding weights in ``dtype``:
    by default ``cfg.dtype``, the serving storage; the trainer passes
    ``cfg.param_dtype`` (fp32 master weights). Norm scales and the router
    in fp32, as in the JAX model. ``generator`` lives on ``device``."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    E, F, HD = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    KD = cfg.n_kv_heads * cfg.head_dim
    shapes = {"q": (E, HD), "k": (E, KD), "v": (E, KD), "o": (HD, E),
              "gate": (E, F), "up": (E, F), "down": (F, E)}

    def normal02(shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        return w.normal_(0.0, 0.02, generator=generator).to(dtype)

    moe = cfg.n_experts > 0
    sd = {"embed": normal02((cfg.vocab_size, E))}
    for i in range(cfg.n_layers):
        for mod, name in _linears(moe):
            shape = shapes[name]
            sd[f"layers.{i}.{mod}.{name}"] = _lecun_normal(
                shape, shape[0], generator, dev, dtype)
        for name in _MOE if moe else ():
            shape = _moe_shape(cfg, name)
            sd[f"layers.{i}.moe.{name}"] = _lecun_normal(
                shape, math.prod(shape[:-1]), generator, dev,
                torch.float32 if name == "router" else dtype)
        for norm in ("attn_norm", "mlp_norm"):
            sd[f"layers.{i}.{norm}.scale"] = torch.ones(
                E, dtype=torch.float32, device=dev)
    sd["final_norm.scale"] = torch.ones(E, dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        sd["unembed"] = normal02((E, cfg.vocab_size))
    return sd


# ------------------------------------------------------------ RL networks

def _dense_sd(prefix: str, leaf) -> Dict[str, torch.Tensor]:
    """A flax Dense ({kernel [in, out], bias}) as an ``nn.Linear``'s
    weight [out, in] and bias."""
    return {f"{prefix}.weight": torch.from_numpy(
                np.array(np.asarray(leaf["kernel"]).T, order="C")),
            f"{prefix}.bias": torch.from_numpy(np.array(leaf["bias"]))}


def _n_dense(tree) -> int:
    return sum(1 for k in tree if k.startswith("Dense_"))


def _lstm_sd(prefix: str, cell) -> Dict[str, torch.Tensor]:
    """flax OptimizedLSTMCell -> ``nn.LSTMCell``: torch packs the gates
    [i, f, g, o] in its rows; flax's input kernels (ii, if, ig, io) carry
    no bias and its hidden kernels (hi, hf, hg, ho) carry the only one, so
    ``bias_ih`` is 0 and ``bias_hh`` is flax's."""
    gates = ("i", "f", "g", "o")

    def rows(kind):
        return np.concatenate([np.asarray(cell[kind + g]["kernel"]).T
                               for g in gates])

    bias = np.concatenate([np.asarray(cell["h" + g]["bias"]) for g in gates])
    return {f"{prefix}.weight_ih": torch.from_numpy(rows("i")),
            f"{prefix}.weight_hh": torch.from_numpy(rows("h")),
            f"{prefix}.bias_ih": torch.zeros(bias.shape, dtype=torch.float32),
            f"{prefix}.bias_hh": torch.from_numpy(bias)}


def _stack(prefix: str, tree, first: int, n: int) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in range(n):
        sd.update(_dense_sd(f"{prefix}.{i}", tree[f"Dense_{first + i}"]))
    return sd


def rl_params_from_jax(kind: str, tree) -> Dict[str, torch.Tensor]:
    """A flax RL net's params (numpy leaves; with or without the outer
    ``{"params": ...}``) -> the ``state_dict`` of the port's net of the
    same name (``ray_tpu_torch.rl``): ``kind`` is the net's class name.
    flax names its layers Dense_0..Dense_n in call order, so the policy
    trunk comes before the value trunk, and TwinQ's two heads share one
    numbering. A gradient tree of the same structure maps the same way."""
    tree = tree.get("params", tree)
    n = _n_dense(tree)
    sd: Dict[str, torch.Tensor] = {}
    if kind in ("PolicyValueNet", "GaussianPolicyValueNet"):
        k = (n - 2) // 2
        sd.update(_stack("pi", tree, 0, k))
        sd.update(_dense_sd("pi_out", tree[f"Dense_{k}"]))
        sd.update(_stack("vf", tree, k + 1, k))
        sd.update(_dense_sd("vf_out", tree[f"Dense_{2 * k + 1}"]))
    elif kind == "ConvPolicyValueNet":
        for i, name in enumerate(("conv1", "conv2")):
            conv = tree[f"Conv_{i}"]
            # [kh, kw, in, out] -> [out, in, kh, kw]
            sd[f"{name}.weight"] = torch.from_numpy(np.array(
                np.asarray(conv["kernel"]).transpose(3, 2, 0, 1), order="C"))
            sd[f"{name}.bias"] = torch.from_numpy(np.array(conv["bias"]))
        sd.update(_stack("hidden", tree, 0, n - 2))
        sd.update(_dense_sd("pi_out", tree[f"Dense_{n - 2}"]))
        sd.update(_dense_sd("vf_out", tree[f"Dense_{n - 1}"]))
    elif kind in ("LSTMPolicyValueNet", "LSTMGaussianPolicyValueNet"):
        sd.update(_dense_sd("embed", tree["Dense_0"]))
        sd.update(_lstm_sd("cell", tree["OptimizedLSTMCell_0"]))
        sd.update(_dense_sd("pi_out", tree["Dense_1"]))
        sd.update(_dense_sd("vf_out", tree["Dense_2"]))
    elif kind == "QNet":
        sd.update(_stack("hidden", tree, 0, n - 1))
        sd.update(_dense_sd("out", tree[f"Dense_{n - 1}"]))
    elif kind == "Policy":
        sd.update(_stack("hidden", tree, 0, n - 2))
        sd.update(_dense_sd("mean", tree[f"Dense_{n - 2}"]))
        sd.update(_dense_sd("log_std", tree[f"Dense_{n - 1}"]))
    elif kind == "TwinQ":
        k = (n - 2) // 2
        for q, first in (("q1", 0), ("q2", k + 1)):
            sd.update(_stack(q, tree, first, k))
            sd.update(_dense_sd(f"{q}_out", tree[f"Dense_{first + k}"]))
    else:
        raise ValueError(f"unknown RL net {kind!r}")
    if "log_std" in tree:
        sd["log_std"] = torch.from_numpy(np.array(tree["log_std"]))
    return sd
