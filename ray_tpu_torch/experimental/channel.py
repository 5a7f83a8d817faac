"""Mutable shared-memory channels (python side of
ray_tpu_torch/native/mutable_channel.cpp; reference:
python/ray/experimental/channel/shared_memory_channel.py). The compiled-DAG
transport: microsecond-scale single-writer/N-reader handoff with no RPC.

Values cross a channel pickled. A CUDA tensor pickles through torch's
storage path: its bytes are copied to the host by the writer and rebuilt
on the same device index by the reader (the first rebuild in a process
initialises CUDA there), so a reader's mask must map the writer's card
to the same index. A channel's file lives under ``/dev/shm`` with the
port's prefix (``CHANNEL_PREFIX``), which no file of another runtime
carries."""

from __future__ import annotations

import ctypes
import os
import pickle
from typing import Any, Optional

from ray_tpu_torch.native.build import build

# every channel file of the port: /dev/shm/raytpu_torch_ch_<dag>_<edge>.<node>
CHANNEL_PREFIX = "/dev/shm/raytpu_torch_ch_"


class _Lib:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(build("mutable_channel"))
            lib.rtc_create.restype = ctypes.c_void_p
            lib.rtc_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_uint32]
            lib.rtc_open.restype = ctypes.c_void_p
            lib.rtc_open.argtypes = [ctypes.c_char_p]
            lib.rtc_close.argtypes = [ctypes.c_void_p]
            lib.rtc_payload.restype = ctypes.c_void_p
            lib.rtc_payload.argtypes = [ctypes.c_void_p]
            lib.rtc_max_size.restype = ctypes.c_uint64
            lib.rtc_max_size.argtypes = [ctypes.c_void_p]
            lib.rtc_write_acquire.restype = ctypes.c_int
            lib.rtc_write_acquire.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64]
            lib.rtc_write_publish.restype = ctypes.c_int
            lib.rtc_write_publish.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64]
            lib.rtc_read_acquire.restype = ctypes.c_int64
            lib.rtc_read_acquire.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rtc_read_release.restype = ctypes.c_int
            lib.rtc_read_release.argtypes = [ctypes.c_void_p,
                                             ctypes.c_uint64]
            lib.rtc_set_closed.restype = ctypes.c_int
            lib.rtc_set_closed.argtypes = [ctypes.c_void_p]
            cls._instance = super().__new__(cls)
            cls._instance.lib = lib
        return cls._instance


class ChannelClosed(Exception):
    pass


class ReaderView:
    """Zero-copy view of the current version; release() acks it."""

    __slots__ = ("data", "version", "_chan", "_released")

    def __init__(self, chan: "Channel", data: memoryview, version: int):
        self._chan = chan
        self.data = data
        self.version = version
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self.data = None
            self._chan._lib.rtc_read_release(self._chan._h, self.version)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class Channel:
    """Single-writer / num_readers-reader mutable object."""

    def __init__(self, path: str, max_size: int = 1 << 20,
                 num_readers: int = 1, create: bool = False):
        self._lib = _Lib().lib
        self.path = path
        if create:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._h = self._lib.rtc_create(path.encode(), max_size,
                                           num_readers)
        else:
            self._h = self._lib.rtc_open(path.encode())
        if not self._h:
            raise OSError(f"cannot {'create' if create else 'open'} "
                          f"channel {path}")
        base = self._lib.rtc_payload(self._h)
        size = self._lib.rtc_max_size(self._h)
        self._mem = (ctypes.c_uint8 * size).from_address(base)
        self._view = memoryview(self._mem).cast("B")
        self._last_read = 0

    # ------------------------------------------------------------- raw bytes
    def write_bytes(self, payload, timeout_s: float = 10.0):
        mv = memoryview(payload).cast("B")
        if mv.nbytes > len(self._view):
            raise ValueError(f"payload {mv.nbytes} > channel capacity")
        rc = self._lib.rtc_write_acquire(self._h, int(timeout_s * 1000))
        if rc == -1:
            raise TimeoutError("writer blocked: readers have not consumed")
        if rc == -2:
            raise ChannelClosed(self.path)
        self._view[:mv.nbytes] = mv
        self._lib.rtc_write_publish(self._h, mv.nbytes)

    def read_bytes(self, timeout_s: float = 10.0) -> ReaderView:
        size = ctypes.c_uint64()
        v = self._lib.rtc_read_acquire(self._h, self._last_read,
                                       int(timeout_s * 1000),
                                       ctypes.byref(size))
        if v == 0:
            raise TimeoutError("no new version")
        if v == -2:
            raise ChannelClosed(self.path)
        self._last_read = v
        return ReaderView(self, self._view[:size.value], v)

    # -------------------------------------------------------- python objects
    def write(self, value: Any, timeout_s: float = 10.0):
        self.write_bytes(pickle.dumps(value, protocol=5), timeout_s)

    def read(self, timeout_s: float = 10.0) -> Any:
        with self.read_bytes(timeout_s) as view:
            return pickle.loads(view.data)

    def close(self):
        if self._h:
            self._lib.rtc_set_closed(self._h)

    def destroy(self):
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __reduce__(self):
        return (Channel, (self.path,))


def node_local_path(path: str, node_id: str) -> str:
    """Physical file for a logical channel on one node. Logical channel
    ids are cluster-wide; each node materializes its own local file (on
    real clusters paths never meet, but single-machine test clusters
    share /dev/shm — without the suffix a producer's channel and its pushed
    mirror would collide on one file)."""
    return f"{path}.{node_id[:12]}"


def open_wait(path: str, timeout_s: float = 30.0) -> Channel:
    """Open a channel that a remote producer (or the node manager, for
    pushed mirrors) may not have created yet."""
    import time
    deadline = time.monotonic() + timeout_s
    while True:
        if os.path.exists(path):
            try:
                return Channel(path)
            except OSError:
                pass   # mid-creation
        if time.monotonic() > deadline:
            raise TimeoutError(f"channel {path} never appeared")
        time.sleep(0.005)


class ChannelWriter:
    """Writer side of a (possibly cross-node) compiled-DAG edge.

    Local readers share the node-local mutable channel (zero-copy);
    remote reader nodes receive each published version through the node
    managers (reference: PushMutableObject fan-out,
    experimental_mutable_object_provider.h:30). spec:
    {"path", "max_size", "local_readers": int,
     "remote": {node_id: reader_count}}.
    """

    def __init__(self, spec: dict, node_call=None):
        self.spec = spec
        self.path = spec["path"]
        self._node_call = node_call
        self.local: Optional[Channel] = None
        if spec.get("local_readers", 0) > 0:
            local_path = node_local_path(self.path, spec["producer_node"])
            os.makedirs(os.path.dirname(local_path), exist_ok=True)
            self.local = Channel(local_path, max_size=spec["max_size"],
                                 num_readers=spec["local_readers"],
                                 create=True)
        self._remote = dict(spec.get("remote") or {})

    def write(self, value: Any, timeout_s: float = 60.0):
        payload = pickle.dumps(value, protocol=5)
        if self.local is not None:
            self.local.write_bytes(payload, timeout_s=timeout_s)
        if self._remote:
            if self._node_call is None:
                from ray_tpu_torch import _get_worker
                self._node_call = _get_worker().node_call
            self._node_call(
                "channel_publish", path=self.path, payload=payload,
                targets=dict(self._remote),
                max_size=self.spec["max_size"],
                write_timeout_s=timeout_s)

    def close(self):
        if self.local is not None:
            self.local.close()
            self.local.destroy()
        if self._remote:
            try:
                if self._node_call is None:
                    from ray_tpu_torch import _get_worker
                    self._node_call = _get_worker().node_call
                self._node_call("channel_close", path=self.path,
                                targets=list(self._remote))
            except Exception:
                pass
