"""Object serialization: cloudpickle v5 with out-of-band zero-copy buffers.

Counterpart of the reference's SerializationContext (reference:
python/ray/_private/serialization.py): pickle-5 out-of-band buffers give
zero-copy reads of numpy arrays and CPU torch tensors straight from the
shm arena, and
ObjectRefs embedded in values are detected during pickling so ownership and
reference counting can track them (the borrowing protocol's entry point,
reference: src/ray/core_worker/reference_count.h:64).

Store layout for one object:
  data region  = concat of 64-byte-aligned out-of-band buffers
  meta region  = msgpack {kind, pkl, offs, lens}
Inline objects (< INLINE_THRESHOLD) travel as (pkl, [buf bytes...]) tuples
inside RPC frames instead of the store.

Tensors (``_reduce_tensor``): a CPU ``torch.Tensor`` of any dtype (bf16
included) rides as one out-of-band buffer of its bytes, made contiguous
first, and is read back as a tensor that views the buffer (in the arena,
the view keeps the object's pin alive). A CUDA tensor is copied to the
host once and is rebuilt on the reader's current CUDA device; a reader
without one gets an error, never a CPU tensor. torch is never imported
here: the reducer is consulted only once the process has imported it.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, Callable, List, Optional, Tuple

import cloudpickle
import msgpack

INLINE_THRESHOLD = 100 * 1024
_ALIGN = 64

# Buffers at or above this size are copied into the arena through the
# native rt_write_parallel entry point (object_store.parallel_write):
# ctypes drops the GIL for the call, so concurrent putters overlap, and
# multi-core hosts additionally chunk the copy across a small pool.
PARALLEL_COPY_MIN = 4 * 1024 * 1024

_parallel_write = None     # resolved lazily; False = permanently unavailable


def _native_copy(dst_mv: memoryview, src_mv: memoryview) -> bool:
    global _parallel_write
    if _parallel_write is None:
        try:
            from ray_tpu_torch._private.object_store import parallel_write
            _parallel_write = parallel_write
        except Exception:
            _parallel_write = False
    if not _parallel_write:
        return False
    try:
        return _parallel_write(dst_mv, src_mv)
    except Exception:
        return False

KIND_PY = 0       # ordinary python object
KIND_ERR = 1      # serialized exception (raised on get)
KIND_RAW = 2      # raw bytes payload (zero pickling)
KIND_MSGPACK = 3  # msgpack payload (cross-language: C++ API frontend)


class SerializedObject:
    __slots__ = ("kind", "pkl", "buffers", "contained_refs")

    def __init__(self, kind: int, pkl: bytes, buffers: List, contained_refs: List):
        self.kind = kind
        self.pkl = pkl
        self.buffers = buffers          # list of objects with buffer protocol
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        n = len(self.pkl)
        for b in self.buffers:
            n += _ALIGN + memoryview(b).nbytes
        return n

    def is_inline(self) -> bool:
        return self.total_bytes < INLINE_THRESHOLD

    # -------- wire form (inline objects inside rpc frames)
    def to_wire(self) -> Tuple[int, bytes, List[bytes]]:
        return (self.kind, self.pkl,
                [memoryview(b).tobytes() if not isinstance(b, bytes) else b
                 for b in self.buffers])

    # -------- store form
    def write_to(self, data_mv: memoryview) -> None:
        off = 0
        for b in self.buffers:
            mv = memoryview(b).cast("B")
            n = mv.nbytes
            if n < PARALLEL_COPY_MIN or \
                    not _native_copy(data_mv[off:off + n], mv):
                data_mv[off:off + n] = mv
            off += _aligned(n)

    def store_meta(self) -> bytes:
        offs, lens = [], []
        off = 0
        for b in self.buffers:
            n = memoryview(b).nbytes
            offs.append(off)
            lens.append(n)
            off += _aligned(n)
        return msgpack.packb({"k": self.kind, "p": self.pkl,
                              "o": offs, "l": lens}, use_bin_type=True)

    def data_size(self) -> int:
        return sum(_aligned(memoryview(b).nbytes) for b in self.buffers)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _rebuild_tensor(buf, dtype: str, shape, requires_grad: bool,
                    cuda: bool):
    import torch
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "cannot deserialize a CUDA tensor: this process has no CUDA "
            "device (a CUDA tensor is rebuilt on the reader's current "
            "device, never as a CPU tensor)")
    dt = getattr(torch, dtype)
    mv = memoryview(buf)
    if mv.nbytes == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        if mv.readonly:
            # an inline (RPC-frame) copy: bytes are immutable, so the
            # tensor gets its own writable copy
            mv = memoryview(bytearray(mv))
        t = torch.frombuffer(mv, dtype=torch.uint8).view(dt).view(shape)
    if cuda:
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if requires_grad:
        t.requires_grad_(True)
    return t


def _reduce_tensor(t):
    """pickle reduction of a strided CPU or CUDA torch.Tensor: its bytes
    as one out-of-band PickleBuffer (see the module docstring)."""
    import torch
    cuda = t.device.type == "cuda"
    src = t.detach().resolve_conj().resolve_neg()
    if cuda:
        src = src.cpu()
    raw = src.contiguous().reshape(-1).view(torch.uint8)
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw.numpy()),
             str(t.dtype).removeprefix("torch."), tuple(t.shape),
             t.requires_grad, cuda))


class _Pickler(cloudpickle.Pickler):
    """cloudpickle plus the tensor reduction above (a Parameter reduces
    through torch to its data, which then takes this path)."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) is torch.Tensor
                and obj.layout == torch.strided
                and obj.device.type in ("cpu", "cuda")):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _dumps(obj, buffer_callback=None) -> bytes:
    with io.BytesIO() as f:
        _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(obj)
        return f.getvalue()


def serialize(obj: Any, ref_hook: Optional[Callable] = None) -> SerializedObject:
    """ref_hook(ref) is called for every ObjectRef encountered while pickling."""
    contained: List = []
    if isinstance(obj, bytes) and len(obj) > INLINE_THRESHOLD:
        return SerializedObject(KIND_RAW, b"", [obj], contained)
    buffers: List[pickle.PickleBuffer] = []

    def buffer_cb(pb: pickle.PickleBuffer):
        buffers.append(pb)
        return False  # out-of-band

    from ray_tpu_torch._private import object_ref  # cycle-free at call time
    prev = getattr(object_ref._ser_tls, "hook", None)
    try:
        def hook(ref):
            contained.append(ref)
            if ref_hook is not None:
                ref_hook(ref)
        object_ref._ser_tls.hook = hook
        pkl = _dumps(obj, buffer_callback=buffer_cb)
    finally:
        object_ref._ser_tls.hook = prev
    return SerializedObject(KIND_PY, pkl, buffers, contained)


def serialize_error(exc: BaseException) -> SerializedObject:
    import traceback
    try:
        pkl = cloudpickle.dumps(exc, protocol=5)
    except Exception:
        pkl = cloudpickle.dumps(
            RuntimeError(f"{type(exc).__name__}: {exc}\n"
                         + "".join(traceback.format_exception(exc))),
            protocol=5)
    return SerializedObject(KIND_ERR, pkl, [], [])


def deserialize_wire(kind: int, pkl: bytes, buffers: List[bytes]) -> Any:
    if kind == KIND_RAW:
        return buffers[0]
    if kind == KIND_MSGPACK:
        return msgpack.unpackb(buffers[0], raw=False, strict_map_key=False)
    obj = pickle.loads(pkl, buffers=[pickle.PickleBuffer(b) for b in buffers])
    if kind == KIND_ERR:
        raise TaskError(obj)
    return obj


def deserialize_from_store(data_mv: memoryview, meta: bytes) -> Any:
    m = msgpack.unpackb(meta, raw=False)
    kind = m["k"]
    bufs = [data_mv[o:o + n] for o, n in zip(m["o"], m["l"])]
    if kind == KIND_RAW:
        return bytes(bufs[0])
    if kind == KIND_MSGPACK:
        return msgpack.unpackb(bufs[0], raw=False, strict_map_key=False)
    obj = pickle.loads(m["p"], buffers=[pickle.PickleBuffer(b) for b in bufs])
    if kind == KIND_ERR:
        raise TaskError(obj)
    return obj


class TaskError(Exception):
    """Wraps an exception raised inside a remote task/actor method
    (reference: python/ray/exceptions.py RayTaskError). Raised on ray.get."""

    def __init__(self, cause: BaseException):
        self.cause = cause
        super().__init__(f"task failed: {type(cause).__name__}: {cause}")

    def __reduce__(self):
        return (TaskError, (self.cause,))


class ActorDiedError(Exception):
    pass


class ObjectLostError(Exception):
    pass


class WorkerCrashedError(Exception):
    pass


class TaskCancelledError(Exception):
    pass
