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
