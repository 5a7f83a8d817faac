"""Attention dispatch: pick the attention for the current mesh.

Counterpart of ``ray_tpu/ops/dispatch.py``. Without a mesh, or on a mesh
of one rank, every call goes to ``flash_attention`` (the Hopper kernel on
a CUDA tensor, its plain version on a CPU tensor); ``mha_reference`` runs
only when asked for. Under a mesh of several ranks, ``"auto"`` picks
``ring`` when the ``seq`` axis is sharded and ``sharded_local`` otherwise.
Both run as a ``local_map`` island (the JAX package's ``shard_map``): the
DTensor inputs are redistributed to batch over (data, fsdp) and heads
over tensor where those divide (and sequence over seq for the ring), and
the body runs on each rank's local shards: ``flash_attention`` for
``sharded_local``, so the flash kernels launch per shard, and
``ops.ring_attention`` for ``ring``. On a mesh, q, k and v are DTensors
(and ``flash`` on DTensors is ``sharded_local``, one island over the
whole mesh). Ring falls back to ``mha_reference`` when the sequence does
not divide over ``seq``.
"""

from __future__ import annotations

import functools

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.ring_attention import ring_attention

IMPLS = ("auto", "flash", "reference", "ring", "sharded_local")


def attention(q, k, v, causal: bool = True, impl: str = "auto"):
    """q[B,L,H,D], k/v[B,L,Hkv,D]: global (logical) shapes -> [B,L,H,D]."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; expected one of {IMPLS}")
    # imported here: the parallel package imports the model, which
    # imports this module
    from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_FSDP,
                                             AXIS_SEQ, AXIS_TENSOR,
                                             axis_group, axis_size,
                                             current_mesh)
    from ray_tpu_torch.parallel.sharding import spec_to_placements
    mesh = current_mesh()
    multi = mesh is not None and mesh.size() > 1
    if impl == "auto":
        if multi and axis_size(mesh, AXIS_SEQ) > 1:
            impl = "ring"
        elif multi:
            impl = "sharded_local"
        else:
            impl = "flash"
    if not isinstance(q, DTensor) and impl in ("flash", "reference"):
        body = flash_attention if impl == "flash" else mha_reference
        return body(q, k, v, causal=causal)
    if mesh is None:
        raise ValueError("sharded attention needs a mesh (use_mesh(...))")
    if not isinstance(q, DTensor):
        raise ValueError(f"attention impl {impl!r} takes DTensors on the "
                         f"current mesh")
    B, L, H, _ = q.shape
    Hkv = k.shape[2]
    t = axis_size(mesh, AXIS_TENSOR)
    s = axis_size(mesh, AXIS_SEQ)
    bsz = axis_size(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)
    if impl == "ring" and L % s != 0:
        impl = "reference"
    batch_ax = (AXIS_DATA, AXIS_FSDP) if B % bsz == 0 else None
    # heads shard over tensor only when q AND kv head counts divide it
    # (keeps the GQA repeat factor consistent per shard)
    head_ax = AXIS_TENSOR if (H % t == 0 and Hkv % t == 0) else None
    if impl == "ring":
        spec = (batch_ax, AXIS_SEQ, head_ax, None)
        body = functools.partial(ring_attention,
                                 group=axis_group(mesh, AXIS_SEQ),
                                 causal=causal)
    else:
        # each (batch, head) shard holds the whole sequence: the flash
        # kernels (or, asked for, plain attention) run on it as they are
        spec = (batch_ax, None, head_ax, None)
        body = functools.partial(
            mha_reference if impl == "reference" else flash_attention,
            causal=causal)
    placements = spec_to_placements(spec, mesh)
    # a list: local_map reads a tuple as one placement per output
    fn = local_map(body, out_placements=list(placements),
                   in_placements=(placements,) * 3, device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)
