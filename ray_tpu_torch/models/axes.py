"""Each parameter's logical axes: the table the JAX model attaches with
``_p`` (``nn.with_partitioning``), kept here beside ``convert.py``.

The JAX tree's leaves stack the layers on a leading ``"layers"`` axis and
keep the attention projections 3-D (q is ``[n_layers, d_model, H, D]``),
where the port stores each layer's projection 2-D (q ``[d_model, H*D]``,
o ``[H*D, d_model]``). So the table holds, per port parameter, the JAX
leaf it belongs to, the leaf's logical axes and shape, and which of the
leaf's per-layer dims each of the port tensor's dims flattens
(``PORT_DIMS``). A sharding is decided on the JAX leaf's shape (so a
flattened ``H*D`` dim shards over ``tensor`` only when the heads divide,
whole heads per shard) and then carried onto the port's dims.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

from ray_tpu_torch.models.convert import (_linear_shape, _linears,
                                          _moe_shape, _MOE)

# per-layer logical axes of a block's weights, as the JAX model's _p names
# them (without the "layers" axis the scan prepends)
BLOCK_AXES = {
    ("attn", "q"): ("embed", "heads", "head_dim"),
    ("attn", "k"): ("embed", "kv_heads", "head_dim"),
    ("attn", "v"): ("embed", "kv_heads", "head_dim"),
    ("attn", "o"): ("heads", "head_dim", "embed"),
    ("mlp", "gate"): ("embed", "mlp"),
    ("mlp", "up"): ("embed", "mlp"),
    ("mlp", "down"): ("mlp", "embed"),
    ("moe", "router"): ("embed", "experts"),
    ("moe", "gate"): ("experts", "embed", "mlp"),
    ("moe", "up"): ("experts", "embed", "mlp"),
    ("moe", "down"): ("experts", "mlp", "embed"),
    ("attn_norm", "scale"): ("embed",),
    ("mlp_norm", "scale"): ("embed",),
}

# which per-layer JAX dims each port dim holds, where they differ
PORT_DIMS = {
    ("attn", "q"): ((0,), (1, 2)),
    ("attn", "k"): ((0,), (1, 2)),
    ("attn", "v"): ((0,), (1, 2)),
    ("attn", "o"): ((0, 1), (2,)),
}


class ParamAxes(NamedTuple):
    leaf: str                 # the JAX leaf's path, as jax_leaf_groups
    axes: Tuple               # the leaf's logical axes
    shape: Tuple[int, ...]    # the leaf's JAX shape
    stacked: bool             # the leaf stacks the layers on dim 0
    port_dims: Tuple          # per port dim, the per-layer leaf dims


def param_axes(cfg) -> Dict[str, ParamAxes]:
    """{state_dict name: ParamAxes} for every parameter of a
    ``TransformerLM`` of ``cfg``."""
    n, E, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    out = {"embed": ParamAxes("embed", ("vocab", "embed_lookup"), (V, E),
                              False, ((0,), (1,))),
           "final_norm.scale": ParamAxes("final_norm/scale", ("embed",),
                                         (E,), False, ((0,),))}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamAxes("unembed", ("embed_lookup", "vocab"),
                                   (E, V), False, ((0,), (1,)))
    moe = cfg.n_experts > 0
    block = [(mod, name, f"layers/block/{mod}/{name}/kernel",
              _linear_shape(cfg, name)) for mod, name in _linears(moe)]
    block += [("moe", name, f"layers/block/moe/{name}",
               _moe_shape(cfg, name)) for name in (_MOE if moe else ())]
    block += [(norm, "scale", f"layers/block/{norm}/scale", (E,))
              for norm in ("attn_norm", "mlp_norm")]
    for mod, name, leaf, shape in block:
        dims = PORT_DIMS.get((mod, name),
                             tuple((d,) for d in range(len(shape))))
        entry = ParamAxes(leaf, ("layers",) + BLOCK_AXES[(mod, name)],
                          (n,) + tuple(shape), True, dims)
        for i in range(n):
            out[f"layers.{i}.{mod}.{name}"] = entry
    return out
