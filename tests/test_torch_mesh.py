"""The port's mesh layer against the JAX package's, without a world.

``MeshConfig.resolve``, the rank layout of ``make_mesh``, the rule table
(``logical_to_mesh_axes``, ``_prune_indivisible``), the parameters'
logical-axes table (``models/axes.py``) and ``state_shardings`` are pure
functions of shapes, so a resolved ``MeshConfig`` stands in for the mesh
and each is held entry by entry against the JAX function on the 8 host
devices the test session forces (``tests/conftest.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu.parallel import train_step as jax_train
from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM
from ray_tpu_torch.models.axes import param_axes
from ray_tpu_torch.parallel import (DEFAULT_RULES, MESH_AXES, MeshConfig,
                                    logical_to_mesh_axes,
                                    make_sharding_rules, state_shardings)
from ray_tpu_torch.parallel.mesh import mesh_ranks
from ray_tpu_torch.parallel.sharding import (_prune_indivisible,
                                             spec_to_placements)
from ray_tpu_torch.parallel.train_step import logical_pspec_to_mesh

LAYOUTS = {
    "d4": dict(data=4, fsdp=1), "f4": dict(fsdp=4), "t4": dict(fsdp=1,
                                                               tensor=4),
    "f2t2": dict(fsdp=2, tensor=2), "s2t2": dict(fsdp=1, seq=2, tensor=2),
    "e2f2": dict(fsdp=2, expert=2), "d2f2t2": dict(data=2, fsdp=2,
                                                   tensor=2),
    "f8": dict(fsdp=-1), "e4f2": dict(fsdp=2, expert=4),
}


def _jax_mesh(layout):
    """JAX's mesh of the layout over its number of host devices (8 where
    an axis absorbs the rest)."""
    cfg = JaxMeshConfig(**LAYOUTS[layout])
    n = 8 if -1 in cfg.shape else int(np.prod(cfg.shape))
    return jax_make_mesh(cfg, devices=jax.devices()[:n]), n


def test_mesh_axes_are_jax_axes():
    from ray_tpu.parallel.mesh import MESH_AXES as JAX_AXES
    assert MESH_AXES == JAX_AXES
    assert DEFAULT_RULES == jax_sharding.DEFAULT_RULES


@pytest.mark.parametrize("kw,n", [
    (dict(), 8), (dict(data=2), 8), (dict(fsdp=2, tensor=2), 4),
    (dict(fsdp=1, seq=2, tensor=2), 4), (dict(fsdp=2, expert=-1), 8),
    (dict(data=-1, fsdp=-1), 8), (dict(fsdp=3), 8), (dict(data=3), 8),
    (dict(fsdp=2, tensor=2), 8), (dict(data=1, fsdp=1), 1)])
def test_resolve_matches_jax(kw, n):
    def run(cls):
        try:
            return dataclasses.asdict(cls(**kw).resolve(n))
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(MeshConfig) == run(JaxMeshConfig)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rank_layout_matches_jax_make_mesh(layout):
    """Rank r sits where JAX's make_mesh puts device r."""
    mesh, n = _jax_mesh(layout)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    ids = ids - ids.min()
    np.testing.assert_array_equal(
        mesh_ranks(MeshConfig(**LAYOUTS[layout]), n), ids)


@pytest.mark.parametrize("logical", [
    ("batch", "seq", None), ("vocab", "embed_lookup"),
    ("embed_lookup", "vocab"), ("embed", "heads", "head_dim"),
    ("experts", None, None, "embed"), ("layers", "experts", "embed", "mlp"),
    ("vocab", "embed"), ("batch", "vocab"), ("mlp", "heads"),
    (None, "batch", None, "kv_heads", None)])
def test_logical_to_mesh_axes_matches_jax(logical):
    rules = make_sharding_rules(mlp=("tensor", "seq"))
    for r in (None, rules):
        assert logical_to_mesh_axes(logical, r) == tuple(
            jax_sharding.logical_to_mesh_axes(logical, r))
        assert logical_pspec_to_mesh(logical, r or DEFAULT_RULES) == tuple(
            jax_train.logical_pspec_to_mesh(
                jax.sharding.PartitionSpec(*logical), r or DEFAULT_RULES))


@pytest.mark.parametrize("layout", ["t4", "f2t2", "s2t2", "f8"])
def test_prune_indivisible_matches_jax(layout):
    jmesh, n = _jax_mesh(layout)
    cfg = MeshConfig(**LAYOUTS[layout]).resolve(n)
    for spec, shape in [(("tensor", None), (2, 8)), (("fsdp", "tensor"),
                                                     (8, 6)),
                        ((("data", "fsdp"), "seq"), (8, 65)),
                        ((("tensor", "fsdp"), None), (1024, 4))]:
        assert _prune_indivisible(spec, shape, cfg) == tuple(
            jax_train._prune_indivisible(jax.sharding.PartitionSpec(*spec),
                                         shape, jmesh))


def _jax_params(name):
    jcfg = JAX_REGISTRY[name]
    return jax.eval_shape(
        lambda r: JaxLM(jcfg).init(r, np.zeros((1, 8), np.int32))["params"],
        jax.random.PRNGKey(0))


def _leaves(tree):
    """{'a/b/c': leaf} of a nested dict tree (boxes are leaves)."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (nn.Partitioned,
                                               jax.sharding.PartitionSpec,
                                               jax.sharding.NamedSharding)))
    for path, leaf in flat:
        out["/".join(str(k.key) for k in path)] = leaf
    return out


@pytest.mark.parametrize("name", ["llama-debug", "moe-debug", "tpu-7b"])
def test_axes_table_matches_flax_boxes(name):
    """Every port parameter's leaf, logical axes and JAX shape are those of
    the flax model's boxed params; every JAX leaf has a port parameter."""
    boxed = _jax_params(name)
    specs = _leaves(nn.get_partition_spec(boxed))
    shapes = _leaves(boxed)
    table = param_axes(MODEL_REGISTRY[name])
    assert {t.leaf for t in table.values()} == set(specs)
    for t in table.values():
        assert t.axes == tuple(specs[t.leaf]), t.leaf
        assert t.shape == tuple(shapes[t.leaf].value.shape), t.leaf


@pytest.mark.parametrize("name,layout", [
    ("llama-debug", "t4"), ("llama-debug", "f2t2"), ("llama-debug", "s2t2"),
    ("llama-debug", "d4"), ("moe-debug", "e2f2"), ("moe-debug", "e4f2"),
    ("tpu-7b", "f8"), ("tpu-7b", "d2f2t2")])
def test_state_shardings_match_jax(name, layout):
    """Each parameter's JAX spec is the JAX state_shardings' spec of its
    leaf, and its placements carry that spec onto the port's dims."""
    jmesh, n = _jax_mesh(layout)
    boxed = _jax_params(name)
    want = {k: tuple(v.spec) for k, v in _leaves(
        jax_train.state_shardings(boxed, jmesh)).items()}
    mesh = MeshConfig(**LAYOUTS[layout]).resolve(n)
    model = TransformerLM(MODEL_REGISTRY[name], device="meta")
    got = state_shardings(model, mesh)
    table = param_axes(model.cfg)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for pname, (placements, jspec) in got.items():
        info = table[pname]
        assert jspec == want[info.leaf], (pname, jspec, want[info.leaf])
        # the port tensor's placements: the JAX spec, layers dropped, the
        # leading dim of a flattened group carrying its entry
        per_layer = jspec[1:] if info.stacked else jspec
        port = tuple(per_layer[d[0]] for d in info.port_dims)
        assert placements == spec_to_placements(port, mesh)
    if name == "llama-debug" and layout == "t4":
        # 2 KV heads do not divide over tensor=4: k/v are replicated,
        # and q's 4 heads shard whole over it
        assert got["layers.0.attn.k"][0] == (Replicate(),)
        assert got["layers.0.attn.q"][0] == (Shard(1),)
    if name == "moe-debug":
        assert Shard(0) in got["layers.0.moe.gate"][0]


def test_vocab_shards_in_mesh_dim_order():
    """The vocab dim over ("tensor", "fsdp"): one Shard(0) on each mesh
    dim; DTensor nests them in the mesh's dim order (fsdp outer), where
    JAX nests them in the spec's order (tensor outer)."""
    mesh = MeshConfig(fsdp=2, tensor=2).resolve(4)
    spec = logical_to_mesh_axes(("vocab", "embed_lookup"))
    assert spec == (("tensor", "fsdp"), None)
    assert spec_to_placements(spec, mesh) == (Shard(0), Shard(0))
    assert spec_to_placements((None,), MeshConfig(fsdp=1).resolve(1)) == (
        Replicate(),)
