"""The device mesh for data/fsdp/expert/stage/seq/tensor parallelism.

Counterpart of ``ray_tpu/parallel/mesh.py``. Where the JAX package builds
one ``jax.sharding.Mesh`` over the devices of its single process, the port
builds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank per device: rank r sits at the mesh
coordinates where ``np.arange(world).reshape(config.shape)`` puts r, as
the JAX mesh puts device r (``tensor`` innermost). The DeviceMesh keeps
the axes of size above 1 (``make_mesh``); each has its process group, on
which DTensor and the port's explicit collectives (ring attention's
``ppermute``) run.

Axis convention (as the JAX package):
  data    — pure data parallel (gradient reduction)
  fsdp    — data parallel with parameter sharding (ZeRO-3)
  expert  — MoE expert parallel
  stage   — pipeline parallel
  seq     — sequence/context parallel (ring attention over this axis)
  tensor  — megatron-style tensor parallel

``init_world`` starts the default process group from an explicit store
(a ``FileStore`` for a world of several local processes, a ``HashStore``
for a world of one), so that no run needs ``MASTER_ADDR``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"

MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_STAGE, AXIS_SEQ,
             AXIS_TENSOR)


@dataclasses.dataclass
class MeshConfig:
    """How many ways each parallelism axis is sharded. -1 on one axis means
    'absorb all remaining devices'."""
    data: int = 1
    fsdp: int = -1
    expert: int = 1
    stage: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        vals = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
        wild = [k for k, v in vals.items() if v == -1]
        fixed = math.prod(v for v in vals.values() if v != -1)
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {vals}")
            vals[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh {vals} needs {fixed} devices, have {n_devices}")
        return MeshConfig(**vals)

    @property
    def shape(self):
        return (self.data, self.fsdp, self.expert, self.stage, self.seq,
                self.tensor)


def init_world(backend: Optional[str] = None, store=None, rank: int = 0,
               world_size: int = 1, device="cuda",
               timeout_s: Optional[float] = None) -> None:
    """Start the default process group from an explicit store, unless one
    is running. ``store`` defaults to a ``HashStore``, which serves a world
    of one; a world of several processes passes a ``FileStore`` (or a
    ``TCPStore``) shared by its ranks. The backend defaults to NCCL for
    ``device="cuda"`` (whose rank's card becomes the current device) and
    gloo for the CPU. ``timeout_s`` bounds each collective (torch's
    default otherwise)."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if store is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs a shared store")
        store = dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {}
    if timeout_s is not None:
        import datetime
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kw)


def mesh_ranks(config: MeshConfig, world_size: int) -> np.ndarray:
    """The ranks laid out on the six axes: rank r at the coordinates where
    ``np.asarray(devices).reshape(config.shape)`` puts device r in the JAX
    package's ``make_mesh``."""
    config = config.resolve(world_size)
    return np.arange(world_size).reshape(config.shape)


def make_mesh(config: Optional[MeshConfig] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The mesh over every rank of the default process group (started by
    ``init_world``), ``tensor`` innermost so tensor-parallel collectives
    stay among neighbouring ranks, then ``seq``, with fsdp/data outermost.

    The DeviceMesh holds the axes whose size is above 1, in ``MESH_AXES``
    order; a mesh of one rank keeps the axis the config sets to -1 (or
    ``data``), so ``MeshConfig(fsdp=1, expert=-1)`` on one card still
    shards the experts over a dim named ``expert``. An axis of size 1 shards
    nothing, and DTensor's sharding propagation enumerates the strategies
    of every mesh dim, so its cost grows exponentially with the number of
    dims. ``axis_size`` gives 1 for an axis the mesh leaves out, and a
    spec that names one is replicated there
    (``sharding.spec_to_placements``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group; "
                           "start it with init_world(...)")
    config = config or MeshConfig()
    wild = [a for a in MESH_AXES if getattr(config, a) == -1]
    ranks = mesh_ranks(config, dist.get_world_size())
    names = _kept_axes(ranks.shape, wild[0] if wild else AXIS_DATA)
    ranks = ranks.reshape([ranks.shape[MESH_AXES.index(a)] for a in names])
    return DeviceMesh(device_type, torch.from_numpy(ranks),
                      mesh_dim_names=names)


def _kept_axes(shape, alone: str = AXIS_DATA) -> tuple:
    """The axes a mesh of this six-axis shape keeps: those above 1, or
    ``alone`` by itself when every axis is 1."""
    return tuple(a for a, n in zip(MESH_AXES, shape) if n > 1) or (alone,)


def local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the world on the fsdp axis."""
    return make_mesh(MeshConfig(data=1, fsdp=-1), device_type)


def mesh_axis_names(mesh) -> tuple:
    """The named dims of a mesh, in order. A resolved ``MeshConfig`` may
    stand in for a mesh wherever only its shape matters (the sharding
    specs and placements): it names the dims ``make_mesh`` would keep."""
    if isinstance(mesh, MeshConfig):
        return _kept_axes(mesh.shape)
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """The size of one named axis (JAX's ``mesh.shape[axis]``); 1 for an
    axis the mesh leaves out. ``mesh`` may be a resolved ``MeshConfig``."""
    if isinstance(mesh, MeshConfig):
        return getattr(mesh, axis)
    names = mesh_axis_names(mesh)
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of one named axis, or None for an axis of size 1
    that the mesh leaves out."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_group(axis) if axis in names else None


# ---------------------------------------------------------------- context
# The "current mesh" lets model code open local_map islands (ring and
# sharded attention) and pin activations without threading the mesh
# through every module.
_CURRENT_MESH: list = []


class use_mesh:
    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def __enter__(self):
        _CURRENT_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _CURRENT_MESH.pop()


def current_mesh() -> Optional[DeviceMesh]:
    return _CURRENT_MESH[-1] if _CURRENT_MESH else None
