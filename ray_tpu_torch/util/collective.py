"""Collective communication between actors/tasks.

Counterpart of ``ray_tpu/util/collective.py``. API parity with the
reference's ray.util.collective (reference:
python/ray/util/collective/collective.py:40-655 — init_collective_group,
allreduce/allgather/reducescatter/broadcast/barrier/send/recv), with two
backends:

- "torch": tensor collectives over ``torch.distributed``'s default process
  group, NCCL when the process has a CUDA card and gloo otherwise. Rank 0
  starts a ``TCPStore`` and publishes its address in the GCS KV; every
  rank then joins the group (``_init_torch_distributed``, which the train
  executor's workers call too). CUDA tensors stay on the card: the
  collectives, and send/recv with their shape header, run on the device.
- "store": host-array collectives through the object store + GCS KV.
  Works anywhere, used for small host payloads and in CPU-only tests.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch._private.config import cfg

_GROUPS: Dict[str, "CollectiveGroup"] = {}
# the TCPStore rank 0 serves for the default process group
_TORCH_STORE: List = []


class CollectiveGroup:
    def __init__(self, world_size: int, rank: int, backend: str,
                 group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.group_name = group_name
        self._seq = 0


def _kv():
    from ray_tpu_torch import _get_worker
    return _get_worker()


def _kv_put(key: str, value: bytes):
    _kv().gcs_call("kv_put", ns="collective", key=key.encode(), value=value)


def _kv_get(key: str, timeout: float = 60.0) -> bytes:
    deadline = time.monotonic() + timeout
    while True:
        v = _kv().gcs_call("kv_get", ns="collective", key=key.encode())
        if v is not None:
            return v
        if time.monotonic() > deadline:
            raise TimeoutError(f"collective rendezvous timed out on {key}")
        time.sleep(cfg.wait_poll_floor_s)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "store",
                          group_name: str = "default") -> CollectiveGroup:
    if backend not in ("store", "torch"):
        raise ValueError(f"collective backend {backend!r}; expected 'store' "
                         f"or 'torch'")
    if backend == "torch":
        _init_torch_distributed(world_size, rank, group_name)
    group = CollectiveGroup(world_size, rank, backend, group_name)
    _GROUPS[group_name] = group
    return group


def _torch_device():
    import torch
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _init_torch_distributed(world_size: int, rank: int, group_name: str,
                            timeout_s: Optional[float] = None):
    """Start ``torch.distributed``'s default process group (NCCL with a
    card, gloo without) from a ``TCPStore`` that rank 0 serves on a free
    port of its host and publishes in the GCS KV. Nothing to do when the
    process group of this world already runs. ``timeout_s`` bounds each
    collective (torch's default, 30 minutes for gloo, otherwise)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_world
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (this "
                f"one {dist.get_rank()}) already runs; asked for rank "
                f"{rank} of {world_size}")
        return
    key = f"{group_name}:coordinator"
    if rank == 0:
        from ray_tpu_torch._private.rpc import node_ip_address
        host = node_ip_address()
        store = dist.TCPStore(host, 0, world_size, is_master=True,
                              wait_for_workers=False)
        _TORCH_STORE[:] = [store]
        _kv_put(key, f"{host}:{store.port}".encode())
    else:
        host, port = _kv_get(key).decode().rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world_size, is_master=False)
    init_world(store=store, rank=rank, world_size=world_size,
               device=_torch_device(), timeout_s=timeout_s)


def destroy_collective_group(group_name: str = "default"):
    group = _GROUPS.pop(group_name, None)
    if group is not None and group.backend == "torch" and not any(
            g.backend == "torch" for g in _GROUPS.values()):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _TORCH_STORE.clear()


def get_rank(group_name: str = "default") -> int:
    return _GROUPS[group_name].rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _GROUPS[group_name].world_size


def _store_exchange(group: CollectiveGroup, payload: np.ndarray,
                    tag: str) -> List[np.ndarray]:
    """All ranks publish, all ranks read all (store backend primitive).
    The trailing ack round keeps every rank's ObjectRef alive until all
    ranks have fetched it (otherwise the owner GCs the object under a
    slower reader)."""
    import cloudpickle as cp
    import ray_tpu_torch
    seq = group._seq
    group._seq += 1
    key = f"{group.group_name}:{tag}:{seq}"
    ref = ray_tpu_torch.put(payload)
    _kv_put(f"{key}:{group.rank}", cp.dumps(ref))
    outs: List[Optional[np.ndarray]] = []
    for r in range(group.world_size):
        if r == group.rank:
            outs.append(payload)
            continue
        blob = _kv_get(f"{key}:{r}")
        outs.append(ray_tpu_torch.get(cp.loads(blob)))
    _kv_put(f"{key}:ack:{group.rank}", b"1")
    for r in range(group.world_size):
        _kv_get(f"{key}:ack:{r}")
    del ref
    return outs


_REDUCERS = {"sum": np.add, "product": np.multiply,
             "min": np.minimum, "max": np.maximum}


def _reduce_op(op: str):
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "product": dist.ReduceOp.PRODUCT,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unsupported allreduce op {op!r}")
    return ops[op]


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    group = _GROUPS[group_name]
    if group.backend == "torch":
        import torch.distributed as dist
        out = tensor.clone()
        dist.all_reduce(out, op=_reduce_op(op))
        return out
    arr = np.asarray(tensor)
    parts = _store_exchange(group, arr, "ar")
    reducer = _REDUCERS[op]
    out = parts[0].copy()
    for p in parts[1:]:
        out = reducer(out, p)
    return out


def allgather(tensor, group_name: str = "default") -> List:
    group = _GROUPS[group_name]
    if group.backend == "torch":
        import torch
        import torch.distributed as dist
        outs = [torch.empty_like(tensor) for _ in range(group.world_size)]
        dist.all_gather(outs, tensor.contiguous())
        return outs
    arr = np.asarray(tensor)
    return _store_exchange(group, arr, "ag")


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """This rank's chunk of the reduced tensor, split along its first dim
    as ``np.array_split`` splits (gloo has no reduce-scatter, so the torch
    backend reduces the whole tensor on its device and keeps its chunk)."""
    group = _GROUPS[group_name]
    out = allreduce(tensor, group_name, op)
    if group.backend == "torch":
        import torch
        return torch.tensor_split(out, group.world_size)[group.rank].clone()
    chunks = np.array_split(out, group.world_size)
    return chunks[group.rank]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    group = _GROUPS[group_name]
    if group.backend == "torch":
        import torch.distributed as dist
        out = tensor.clone()
        dist.broadcast(out, src=src_rank)
        return out
    import ray_tpu_torch
    import cloudpickle as cp
    seq = group._seq
    group._seq += 1
    key = f"{group.group_name}:bc:{seq}"
    if group.rank == src_rank:
        ref = ray_tpu_torch.put(np.asarray(tensor))
        _kv_put(key, cp.dumps(ref))
        # hold the ref until every rank has fetched
        for r in range(group.world_size):
            if r != src_rank:
                _kv_get(f"{key}:ack:{r}")
        del ref
        return np.asarray(tensor)
    out = ray_tpu_torch.get(cp.loads(_kv_get(key)))
    _kv_put(f"{key}:ack:{group.rank}", b"1")
    return out


def barrier(group_name: str = "default"):
    group = _GROUPS[group_name]
    if group.backend == "torch":
        import torch.distributed as dist
        dist.barrier()
        return
    seq = group._seq
    group._seq += 1
    _kv_put(f"{group.group_name}:bar:{seq}:{group.rank}", b"1")
    for r in range(group.world_size):
        _kv_get(f"{group.group_name}:bar:{seq}:{r}")


# the torch backend's send/recv: recv takes no shape, so the sender first
# sends a fixed-size header (dtype code, ndim, dims) on the payload's device
_MAX_DIMS = 8
_DTYPES = ("float32", "float64", "float16", "bfloat16", "int8", "uint8",
           "int16", "int32", "int64", "bool")


def _torch_send(tensor, dst_rank: int):
    import torch
    import torch.distributed as dist
    if tensor.dim() > _MAX_DIMS:
        raise ValueError(f"send takes at most {_MAX_DIMS} dims")
    header = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64,
                         device=tensor.device)
    header[0] = _DTYPES.index(str(tensor.dtype).split(".")[-1])
    header[1] = tensor.dim()
    header[2:2 + tensor.dim()] = torch.tensor(tensor.shape)
    dist.send(header, dst_rank)
    dist.send(tensor.contiguous(), dst_rank)


def _torch_recv(src_rank: int):
    import torch
    import torch.distributed as dist
    dev = _torch_device()
    header = torch.empty(2 + _MAX_DIMS, dtype=torch.int64, device=dev)
    dist.recv(header, src_rank)
    code, ndim, *dims = header.tolist()
    out = torch.empty(dims[:ndim], dtype=getattr(torch, _DTYPES[code]),
                      device=dev)
    dist.recv(out, src_rank)
    return out


# the store backend's send/recv are host-mediated (object store + GCS KV)
_P2P_SEQ: Dict[tuple, int] = {}


def send(tensor, dst_rank: int, group_name: str = "default"):
    group = _GROUPS[group_name]
    if group.backend == "torch":
        _torch_send(tensor, dst_rank)
        return
    import ray_tpu_torch
    import cloudpickle as cp
    key = (group_name, group.rank, dst_rank)
    seq = _P2P_SEQ.get(key, 0)
    _P2P_SEQ[key] = seq + 1
    ref = ray_tpu_torch.put(np.asarray(tensor))
    tag = f"{group.group_name}:p2p:{seq}:{group.rank}:{dst_rank}"
    _kv_put(tag, cp.dumps(ref))
    _kv_get(f"{tag}:ack")       # hold ref until the receiver has fetched
    del ref


def recv(src_rank: int, group_name: str = "default"):
    group = _GROUPS[group_name]
    if group.backend == "torch":
        return _torch_recv(src_rank)
    import ray_tpu_torch
    import cloudpickle as cp
    key = (group_name, src_rank, group.rank)
    seq = _P2P_SEQ.get(key, 0)
    _P2P_SEQ[key] = seq + 1
    tag = f"{group.group_name}:p2p:{seq}:{src_rank}:{group.rank}"
    blob = _kv_get(tag)
    out = ray_tpu_torch.get(cp.loads(blob))
    _kv_put(f"{tag}:ack", b"1")
    return out
