"""Logical-axis sharding rules -> DTensor placements.

Counterpart of ``ray_tpu/parallel/sharding.py``. Model code names the
*logical* axes of its parameters and activations; a rule table maps each
logical axis to mesh axes. A spec is kept as a plain tuple with one entry
per tensor dim (None, a mesh axis, or a tuple of mesh axes), as the JAX
package's ``PartitionSpec``, so the two compare entry by entry;
``spec_to_placements`` turns it into the DTensor placements of the port's
``DeviceMesh`` (one placement per mesh dim).

One layout differs from the JAX package's: a tensor dim sharded over two
mesh axes, such as the vocab dim over ``("tensor", "fsdp")``, is split
in the mesh's dim order by DTensor (fsdp, then tensor), where JAX splits
it in the order the spec names them (tensor, then fsdp). Every rank
holds a shard of the same size and the values computed are the same;
only which rank holds which shard differs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP,
                                         AXIS_SEQ, AXIS_TENSOR, MESH_AXES,
                                         axis_size, current_mesh,
                                         mesh_axis_names, use_mesh)

# Default rule table: logical axis -> mesh axis (or None = replicated), the
# JAX package's. Embeddings/MLP widths shard over tensor; the long "model
# dim" rows shard over fsdp (ZeRO-3); the vocab tables shard their vocab
# dim over both model axes and keep their d dim replicated.
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "seq": AXIS_SEQ,
    "vocab": (AXIS_TENSOR, AXIS_FSDP),
    "embed_lookup": None,
    "embed": AXIS_FSDP,
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "head_dim": None,
    "mlp": AXIS_TENSOR,
    "experts": AXIS_EXPERT,
    "layers": None,
    None: None,
}


def make_sharding_rules(**overrides) -> Dict[str, Optional[object]]:
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    return rules


def logical_to_mesh_axes(logical: Sequence[Optional[str]],
                         rules: Optional[Dict] = None) -> tuple:
    """Logical names -> mesh spec (a tuple, one entry per dim). A mesh axis
    is used at most once per spec: a later dim that would reuse one is
    replicated."""
    rules = rules or DEFAULT_RULES
    spec = []
    used = set()
    for name in logical:
        axis = rules.get(name)
        if axis is not None:
            key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
            if any(a in used for a in key):
                axis = None
            else:
                used.update(key)
        spec.append(tuple(axis) if isinstance(axis, list) else axis)
    return tuple(spec)


def _axes(entry) -> tuple:
    """A spec entry's mesh axes, in order."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _prune_indivisible(spec: tuple, shape, mesh) -> tuple:
    """Replicate any dimension whose size isn't divisible by its mesh axes
    (e.g. 2 KV heads on a 4-way tensor axis)."""
    if shape is None or len(spec) == 0:
        return tuple(spec)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        size = 1
        for a in _axes(entry):
            size *= axis_size(mesh, a)
        out.append(entry if size and shape[i] % size == 0 else None)
    return tuple(out)


def spec_to_placements(spec: Sequence, mesh) -> tuple:
    """Mesh spec -> one DTensor placement per dim of ``mesh`` (or of the
    mesh a resolved ``MeshConfig`` describes): ``Shard(i)`` on each mesh
    axis that tensor dim i names, ``Replicate()`` on the others (an axis
    the mesh leaves out has size 1 and shards nothing)."""
    dim_of = {}
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {a!r} in {spec}")
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh_axis_names(mesh))


def param_shardings(mesh: DeviceMesh, logical_tree: Dict[str, tuple],
                    rules: Optional[Dict] = None) -> Dict[str, tuple]:
    """{name: logical axes} -> {name: placements}."""
    return {name: spec_to_placements(logical_to_mesh_axes(axes, rules),
                                     mesh)
            for name, axes in logical_tree.items()}


def batch_sharding(mesh: DeviceMesh, rules: Optional[Dict] = None,
                   with_seq: bool = True) -> Tuple:
    """Placements of a [B, L] token batch (or [B] with ``with_seq=False``)."""
    axes = ("batch", "seq") if with_seq else ("batch",)
    return spec_to_placements(logical_to_mesh_axes(axes, rules), mesh)


def constrain(x, logical: Sequence[Optional[str]],
              rules: Optional[Dict] = None):
    """Redistribute a DTensor to the placements its logical axes name under
    the current mesh (a dim that does not divide by its mesh axes stays
    replicated). Anything else, or any tensor outside ``use_mesh``, comes
    back unchanged, as JAX's ``with_sharding_constraint`` is a no-op
    outside a mesh. Differentiable: the backward redistributes the
    gradient back."""
    if not isinstance(x, DTensor) or current_mesh() is None:
        return x
    mesh = x.device_mesh
    spec = _prune_indivisible(logical_to_mesh_axes(logical, rules),
                              tuple(x.shape), mesh)
    # a dim of size 1 stays replicated: only an axis of size 1 divides
    # it, which shards nothing, and DTensor cannot view away a sharded
    # singleton dim (a batch of one on a one-rank mesh)
    spec = tuple(None if i < x.dim() and x.shape[i] == 1 else e
                 for i, e in enumerate(spec))
    placements = spec_to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    if not torch.is_grad_enabled():
        # nothing to carry back: redistribute a detached alias of a
        # parameter, so that the redistribution's output takes no detach_
        # (which DTensor has no rule for). The mesh's serving paths run
        # under no_grad, not inference_mode, for this: an inference-mode
        # detach of a parameter fails, and a redistribution there
        # detach_es.
        x = x.detach()
    return x.redistribute(mesh, placements)


def distribute_whole(t, mesh, placements):
    """A whole tensor that every rank holds alike -> its DTensor (each rank
    keeps its own shard; no communication)."""
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def load_whole(model, sd, mesh, shardings):
    """Load a state_dict of whole tensors into ``model`` (assigned),
    distributed as ``shardings`` says when there is a mesh."""
    if mesh is not None:
        sd = {n: distribute_whole(t, mesh, shardings[n][0])
              for n, t in sd.items()}
    model.load_state_dict(sd, assign=True)


@contextlib.contextmanager
def on_mesh(mesh):
    """The context a mesh step runs in: the mesh current, and plain
    tensors (positions, masks, constants) taken as replicated where they
    meet a DTensor. Nothing without a mesh."""
    if mesh is None:
        yield
        return
    with use_mesh(mesh), implicit_replication():
        yield


def gather_whole(x):
    """A DTensor's full value on every rank; anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


__all__ = ["AXIS_DATA", "AXIS_EXPERT", "AXIS_FSDP", "AXIS_SEQ",
           "AXIS_TENSOR", "DEFAULT_RULES", "batch_sharding", "constrain",
           "distribute_whole", "gather_whole", "load_whole",
           "logical_to_mesh_axes", "make_sharding_rules", "on_mesh",
           "param_shardings", "spec_to_placements"]
