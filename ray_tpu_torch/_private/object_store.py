"""Node-local shared-memory object store client.

Python side of ``ray_tpu_torch/native/shm_store.cpp``. Every process on a node maps
the same file under /dev/shm; create/seal/get/release are direct
shared-memory calls into the native library — no daemon round trip on the hot
path (contrast with the reference's plasma client/server unix-socket protocol,
reference: src/ray/object_manager/plasma/client.cc).

Reads are zero-copy: ``get`` returns memoryviews over the mapped arena, kept
valid by a pin that is released when the returned buffer object is freed.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private.markers import off_loop
from ray_tpu_torch.native.build import build

ID_LEN = 20
DEFAULT_STORE_BYTES = int(os.environ.get("RAY_TPU_TORCH_OBJECT_STORE_BYTES", 2 * 1024**3))


class _Lib:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(build("shm_store"))
            lib.rt_store_create.restype = ctypes.c_void_p
            lib.rt_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                            ctypes.c_int]
            lib.rt_store_open.restype = ctypes.c_void_p
            lib.rt_store_open.argtypes = [ctypes.c_char_p]
            lib.rt_store_close.argtypes = [ctypes.c_void_p]
            lib.rt_store_base.restype = ctypes.c_void_p
            lib.rt_store_base.argtypes = [ctypes.c_void_p]
            lib.rt_store_capacity.restype = ctypes.c_uint64
            lib.rt_store_capacity.argtypes = [ctypes.c_void_p]
            lib.rt_store_total_size.restype = ctypes.c_uint64
            lib.rt_store_total_size.argtypes = [ctypes.c_void_p]
            lib.rt_create.restype = ctypes.c_int64
            lib.rt_create.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_int,
            ]
            for fn in ("rt_seal", "rt_release", "rt_contains", "rt_delete", "rt_abort"):
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_set_evictable.restype = ctypes.c_int
            lib.rt_set_evictable.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.rt_get.restype = ctypes.c_int64
            lib.rt_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int,
            ]
            lib.rt_evict.restype = ctypes.c_uint64
            lib.rt_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rt_evict_stripe.restype = ctypes.c_uint64
            lib.rt_evict_stripe.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64]
            lib.rt_gc_unsealed.restype = ctypes.c_uint64
            lib.rt_gc_unsealed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rt_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_stripe_stats.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_num_stripes.restype = ctypes.c_uint32
            lib.rt_num_stripes.argtypes = [ctypes.c_void_p]
            lib.rt_list.restype = ctypes.c_uint64
            lib.rt_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.rt_list_stripe.restype = ctypes.c_uint64
            lib.rt_list_stripe.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
                ctypes.c_uint64]
            lib.rt_write_parallel.restype = None
            lib.rt_write_parallel.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_int,
            ]
            lib.rt_max_alloc_bytes.restype = ctypes.c_uint64
            lib.rt_max_alloc_bytes.argtypes = [ctypes.c_void_p]
            lib.rt_create_spanning.restype = ctypes.c_int64
            lib.rt_create_spanning.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_int,
            ]
            lib.rt_is_span.restype = ctypes.c_int
            lib.rt_is_span.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_span_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_object_info.restype = ctypes.c_int64
            lib.rt_object_info.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_stripe_frag.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_now_sec.restype = ctypes.c_uint64
            lib.rt_now_sec.argtypes = []
            cls._instance = super().__new__(cls)
            cls._instance.lib = lib
        return cls._instance


def copy_threads() -> int:
    """Thread count for chunked arena copies (env RAY_TPU_TORCH_PUT_COPY_THREADS;
    default: min(4, cpu_count), so a 1-core host does one plain GIL-free
    memcpy with no pool handoff)."""
    global _COPY_THREADS
    if _COPY_THREADS is None:
        raw = os.environ.get("RAY_TPU_TORCH_PUT_COPY_THREADS", "")
        try:
            n = int(raw)
        except ValueError:
            n = min(4, os.cpu_count() or 1)
        _COPY_THREADS = max(1, n)
    return _COPY_THREADS


_COPY_THREADS = None


def parallel_write(dst_mv: memoryview, src_mv: memoryview) -> bool:
    """GIL-free (optionally multi-threaded) copy src_mv -> dst_mv through
    the native store library. Returns False when the fast path can't be
    taken (native lib unavailable, non-contiguous buffers) so the caller
    falls back to a plain slice assignment."""
    if not (dst_mv.contiguous and src_mv.contiguous):
        return False
    try:
        lib = _Lib().lib
        # numpy is address extraction only; no copy, handles readonly views
        import numpy as np
    except Exception:
        return False
    dst = np.frombuffer(dst_mv, dtype=np.uint8)
    src = np.frombuffer(src_mv, dtype=np.uint8)
    lib.rt_write_parallel(dst.ctypes.data, src.ctypes.data, src.nbytes,
                          copy_threads())
    return True


def store_path(session_name: str, node_id_hex: str) -> str:
    return f"/dev/shm/raytpu_torch_{session_name}_{node_id_hex[:12]}"


if sys.version_info < (3, 12):  # pragma: no cover
    raise ImportError(
        "ray_tpu_torch requires Python >= 3.12: zero-copy object reads tie shm "
        "pins to derived views via the PEP 688 __buffer__ protocol "
        "(see pyproject.toml requires-python)")


class _PinnedRegion:
    """Buffer exporter for one pinned object in the shared arena.

    Every view derived from ``memoryview(region)`` — slices, PickleBuffers,
    numpy arrays reconstructed from them — keeps this object alive through
    the CPython buffer protocol (PEP 688: the exported Py_buffer's ``obj``
    is this region). The store pin is released only when the last such view
    dies, so zero-copy reads can never be reclaimed under live user views
    (the same guarantee plasma gives by tying the pin to the client buffer,
    reference: src/ray/object_manager/plasma/client.cc).
    """

    __slots__ = ("_client", "_oid", "_mv")

    def __init__(self, client: "ObjectStoreClient", oid: bytes, mv: memoryview):
        self._client = client
        self._oid = oid
        self._mv = mv

    def __buffer__(self, flags):
        return self._mv[:]

    def __del__(self):
        try:
            self._client._release(self._oid)
        except Exception:
            pass


class SharedBuffer:
    """A pinned zero-copy read of an object's payload.

    ``close`` drops this handle's references; the underlying pin lives until
    the last view derived from ``data`` is garbage-collected.
    """

    __slots__ = ("data", "metadata", "_region")

    def __init__(self, region: _PinnedRegion, data: memoryview, metadata: bytes):
        self._region = region
        self.data = data
        self.metadata = metadata

    def close(self):
        self.data = None
        self._region = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ObjectStoreClient:
    """Maps the node's shared arena and exposes object operations.

    The arena is striped into independently locked sub-heaps (see
    shm_store.cpp): ``stripes=0`` resolves via ``RAY_TPU_TORCH_ARENA_STRIPES``
    then size-based auto-striping, so small test arenas stay
    single-stripe while production arenas spread same-node clients
    across locks.
    """

    def __init__(self, path: str, create: bool = False,
                 size: int = DEFAULT_STORE_BYTES, stripes: int = 0):
        self._lib = _Lib().lib
        self.path = path
        if create:
            self._h = self._lib.rt_store_create(path.encode(), size, stripes)
        else:
            self._h = self._lib.rt_store_open(path.encode())
        if not self._h:
            raise OSError(f"failed to {'create' if create else 'open'} object store at {path}")
        base = self._lib.rt_store_base(self._h)
        total = self._lib.rt_store_total_size(self._h)
        self._mem = (ctypes.c_uint8 * total).from_address(base)
        self._view = memoryview(self._mem).cast("B")
        # oid -> live pin count held by this client; used so close() can
        # release pins a crashed/leaked SharedBuffer would otherwise hold
        # forever, and so we never munmap while zero-copy views are live.
        # Mutated from caller threads (off-loop gets), the owner loop, and
        # GC finalizers (_PinnedRegion.__del__ runs on whatever thread
        # drops the last view) — the get/release counter updates are
        # read-modify-writes, so they hold _pins_lock.
        self._pins: dict = {}
        self._pins_lock = threading.Lock()

    # -- object ops ---------------------------------------------------------

    def _handle(self):
        """Live native handle, or a clean OSError after close(). Puts run
        on caller threads now, so a put racing shutdown must fail as a
        Python exception — never reach native code with a NULL store."""
        h = self._h
        if not h:
            raise OSError(f"object store client for {self.path} is closed")
        return h

    @off_loop(lock="_pins_lock")
    def create(self, oid: bytes, data_size: int, meta_size: int = 0,
               evictable: bool = True) -> Optional[Tuple[memoryview, memoryview]]:
        """Allocate a buffer; returns (data_view, meta_view) to write into.

        Returns None if the object already exists. Raises MemoryError if the
        arena is full even after LRU eviction.

        Objects larger than one arena stripe route to the SPANNING path
        natively (contiguous whole stripes, see shm_store.cpp): callers
        need no size awareness — the returned views simply cover the
        multi-stripe region, so sharded checkpoints / weight blobs put
        and ``recv_into`` exactly like small objects.
        """
        off = self._lib.rt_create(self._handle(), oid, data_size, meta_size,
                                  1 if evictable else 0)
        if off == -17:  # EEXIST
            return None
        if off < 0:
            raise self._arena_full(oid, data_size, off)
        data = self._view[off:off + data_size]
        meta = self._view[off + data_size:off + data_size + meta_size]
        return data, meta

    def _arena_full(self, oid: bytes, requested: int,
                    rc: int, spanning: bool = False) -> MemoryError:
        """Arena exhaustion is the event that triggers synchronous spills
        upstream — mark it on the flight-recorder timeline (so spill
        spans line up with the allocation that forced them) WITH the
        fragmentation breakdown attached, and raise a MemoryError whose
        message carries the same per-stripe live/free/largest-hole view
        so bug reports are self-diagnosing."""
        summary = self._frag_summary(requested)
        try:
            from ray_tpu_torch._private import events
            attrs = {"object_id": oid.hex()[:16], "requested": requested,
                     "rc": rc, "spanning": spanning}
            try:
                frag = self.fragmentation()
                attrs["stripes"] = [
                    [st["stripe"], st["live"], st["free"],
                     st["largest_hole"]] for st in frag["stripes"]]
                attrs["spans"] = frag["spans"]
            except Exception:
                pass
            events.record_instant("store.arena_full", category="store",
                                  **attrs)
        except Exception:
            pass
        kind = "spanning create" if spanning else "object store create"
        return MemoryError(
            f"{kind} failed (rc={rc}): {summary}" if summary
            else f"{kind} failed (rc={rc})")

    def seal(self, oid: bytes) -> None:
        rc = self._lib.rt_seal(self._handle(), oid)
        if rc != 0:
            raise KeyError(f"seal failed for {oid.hex()} rc={rc}")

    def seal_and_release(self, oid: bytes) -> None:
        # seal() resets pin_count; creator's implicit pin is consumed by it.
        self.seal(oid)

    def abort(self, oid: bytes) -> None:
        self._lib.rt_abort(self._handle(), oid)

    @off_loop(lock="_pins_lock")
    def get(self, oid: bytes) -> Optional[SharedBuffer]:
        """Zero-copy read of a sealed object; None if not present."""
        dsize = ctypes.c_uint64()
        msize = ctypes.c_uint64()
        off = self._lib.rt_get(self._handle(), oid, ctypes.byref(dsize),
                               ctypes.byref(msize), 1)
        if off < 0:
            return None
        with self._pins_lock:
            self._pins[oid] = self._pins.get(oid, 0) + 1
        region = _PinnedRegion(self, oid, self._view[off:off + dsize.value])
        meta = bytes(self._view[off + dsize.value:off + dsize.value + msize.value])
        return SharedBuffer(region, memoryview(region), meta)

    @off_loop(lock="_pins_lock")
    def _release(self, oid: bytes) -> None:
        # runs on whatever thread drops the last zero-copy view (GC
        # finalizer), so the counter decrement must hold the lock too
        with self._pins_lock:
            if not (self._h and self._pins.get(oid)):
                return
            n = self._pins[oid] - 1
            if n:
                self._pins[oid] = n
            else:
                del self._pins[oid]
        self._lib.rt_release(self._h, oid)

    def contains(self, oid: bytes) -> bool:
        return bool(self._lib.rt_contains(self._handle(), oid))

    def delete(self, oid: bytes) -> None:
        self._lib.rt_delete(self._handle(), oid)

    def set_evictable(self, oid: bytes, evictable: bool) -> None:
        """Let the store's in-create eviction drop this copy, or not."""
        self._lib.rt_set_evictable(self._handle(), oid,
                                   1 if evictable else 0)

    def evict(self, nbytes: int) -> int:
        return self._lib.rt_evict(self._handle(), nbytes)

    def evict_stripe(self, stripe: int, nbytes: int) -> int:
        """Evict up to nbytes from ONE stripe (node-manager sweep path;
        contends only with that stripe's clients)."""
        return self._lib.rt_evict_stripe(self._handle(), stripe, nbytes)

    def gc_unsealed(self, max_age_sec: int = 300) -> int:
        """Reclaim orphaned never-sealed objects (writer died before seal)."""
        return self._lib.rt_gc_unsealed(self._handle(), max_age_sec)

    @off_loop(lock="_pins_lock")
    def put_bytes(self, oid: bytes, payload, metadata: bytes = b"") -> bool:
        """Convenience: create+write+seal. False if already present."""
        payload = memoryview(payload)
        bufs = self.create(oid, payload.nbytes, len(metadata))
        if bufs is None:
            return False
        data, meta = bufs
        # same GIL-free chunked path as put's write_to (spill restores and
        # cross-node transfers land multi-MB payloads through here)
        if payload.nbytes < 4 * 1024 * 1024 or \
                not parallel_write(data, payload):
            data[:] = payload
        if metadata:
            meta[:] = metadata
        self.seal(oid)
        return True

    def stats(self) -> dict:
        """Aggregate store stats. Lock-free on the native side (seqlock
        snapshots per stripe) — polling this never queues behind a
        client's create."""
        arr = (ctypes.c_uint64 * 17)()
        self._lib.rt_stats(self._handle(), arr)
        keys = ["bytes_in_use", "capacity", "num_objects", "num_evictions",
                "bytes_evicted", "create_count", "get_hits", "get_misses",
                "poisoned", "num_stripes", "stripe_repairs",
                "create_fallbacks", "seal_count", "num_spans",
                "span_creates", "span_evictions", "span_repairs"]
        return dict(zip(keys, arr))

    def max_alloc_bytes(self) -> int:
        """Largest payload (data+meta) the per-stripe allocator holds;
        one byte more routes to the spanning path transparently."""
        return int(self._lib.rt_max_alloc_bytes(self._handle()))

    def is_span(self, oid: bytes) -> bool:
        """True when oid names a live spanning (multi-stripe) object."""
        return bool(self._lib.rt_is_span(self._handle(), oid))

    def create_spanning(self, oid: bytes, data_size: int, meta_size: int = 0,
                        evictable: bool = True):
        """Force the spanning path regardless of size (tests exercise
        span machinery without multi-GB arenas). Same contract as
        ``create``."""
        off = self._lib.rt_create_spanning(
            self._handle(), oid, data_size, meta_size,
            1 if evictable else 0)
        if off == -17:  # EEXIST
            return None
        if off < 0:
            raise self._arena_full(oid, data_size, off, spanning=True)
        data = self._view[off:off + data_size]
        meta = self._view[off + data_size:off + data_size + meta_size]
        return data, meta

    def span_stats(self) -> dict:
        """Span-plane snapshot (weight-distribution observability)."""
        arr = (ctypes.c_uint64 * 8)()
        self._lib.rt_span_stats(self._handle(), arr)
        keys = ["live_spans", "span_bytes", "stripes_claimed",
                "span_creates", "span_evictions", "span_repairs",
                "broken_slots", "max_span_bytes"]
        return dict(zip(keys, arr))

    def num_stripes(self) -> int:
        return int(self._lib.rt_num_stripes(self._handle()))

    def now_sec(self) -> int:
        """CLOCK_MONOTONIC seconds — the base of object ctime stamps, so
        `now_sec() - info["ctime_sec"]` is an object's age."""
        return int(self._lib.rt_now_sec())

    def object_info(self, oid: bytes) -> Optional[dict]:
        """Per-object probe for the observability surface: size, pin
        count, placement, age base — WITHOUT pinning, touching LRU, or
        reading the payload (contrast `get`, which does all three).
        None when the object is not live."""
        arr = (ctypes.c_uint64 * 8)()
        rc = self._lib.rt_object_info(self._handle(), oid, arr)
        if rc < 0:
            return None
        return {"data_size": int(arr[0]), "meta_size": int(arr[1]),
                "pins": int(arr[2]), "stripe": int(arr[3]),
                "ctime_sec": int(arr[4]), "is_span": bool(arr[5]),
                "sealed": bool(arr[6]), "flags": int(arr[7])}

    def stripe_frag(self, stripe: int) -> dict:
        """Free-list walk of one stripe: total free bytes, the largest
        single hole (the biggest create the stripe could serve), and
        the free-block count. Span-claimed stripes report zero free."""
        arr = (ctypes.c_uint64 * 4)()
        self._lib.rt_stripe_frag(self._handle(), stripe, arr)
        return {"free_bytes": int(arr[0]), "largest_hole": int(arr[1]),
                "free_blocks": int(arr[2]), "bytes_in_use": int(arr[3])}

    def fragmentation(self) -> dict:
        """Machine-readable occupancy breakdown: per-stripe live/free/
        largest-hole plus span residency — what an "arena full" error
        attaches so bug reports are self-diagnosing."""
        stripes = []
        for i in range(self.num_stripes()):
            ss = self.stripe_stats(i)
            fr = self.stripe_frag(i)
            stripes.append({
                "stripe": i, "capacity": int(ss["capacity"]),
                "live": int(ss["bytes_in_use"]),
                "free": fr["free_bytes"],
                "largest_hole": fr["largest_hole"],
                "free_blocks": fr["free_blocks"],
                "objects": int(ss["num_objects"])})
        return {"stripes": stripes, "spans": self.span_stats()}

    def _frag_summary(self, requested: int) -> str:
        """Compact one-line breakdown for MemoryError messages (capped
        at 8 stripes; the full dict rides the store.arena_full
        instant)."""
        try:
            frag = self.fragmentation()
        except Exception:
            return ""
        parts = [f"requested={requested}"]
        for st in frag["stripes"][:8]:
            parts.append(
                f"s{st['stripe']}[live={st['live']} free={st['free']} "
                f"hole={st['largest_hole']}]")
        if len(frag["stripes"]) > 8:
            parts.append(f"(+{len(frag['stripes']) - 8} stripes)")
        sp = frag["spans"]
        if sp.get("live_spans"):
            parts.append(f"spans[{sp['live_spans']} live, "
                         f"{sp['span_bytes']}B, "
                         f"{sp['stripes_claimed']} stripes claimed]")
        return " ".join(parts)

    def stripe_stats(self, stripe: int) -> dict:
        """Lock-free per-stripe snapshot (sweep targeting, bench
        attribution)."""
        arr = (ctypes.c_uint64 * 8)()
        self._lib.rt_stripe_stats(self._handle(), stripe, arr)
        keys = ["bytes_in_use", "capacity", "num_objects", "num_evictions",
                "bytes_evicted", "repairs", "poisoned", "seal_count"]
        return dict(zip(keys, arr))

    def list_objects(self, max_n: int = 65536) -> list:
        buf = ctypes.create_string_buffer(max_n * ID_LEN)
        n = self._lib.rt_list(self._handle(), buf, max_n)
        raw = buf.raw
        return [raw[i * ID_LEN:(i + 1) * ID_LEN] for i in range(n)]

    def list_spans(self, max_n: int = 65536) -> list:
        """Sealed spanning-object ids. rt_list appends sealed spans
        after the per-stripe listings (spans live in the header-level
        span table, not any stripe's entry segment — which is why the
        per-stripe spill sweep never sees them); filter them back out
        via the lock-free rt_is_span probe."""
        return [o for o in self.list_objects(max_n) if self.is_span(o)]

    def list_stripe(self, stripe: int, max_n: int = 65536) -> list:
        """Sealed object ids resident in one stripe."""
        buf = ctypes.create_string_buffer(max_n * ID_LEN)
        n = self._lib.rt_list_stripe(self._handle(), stripe, buf, max_n)
        raw = buf.raw
        return [raw[i * ID_LEN:(i + 1) * ID_LEN] for i in range(n)]

    @off_loop(lock="_pins_lock")
    def close(self):
        """Release this client's pins. Unmaps only when no zero-copy views
        remain — a live SharedBuffer keeps the mapping for process lifetime
        (munmap under a live view would be a use-after-free)."""
        with self._pins_lock:
            if not self._h:
                return
            h = self._h
            if self._pins:
                # Outstanding zero-copy views: drop the pins so the objects
                # stay evictable node-wide, but keep the mapping alive.
                for oid, n in list(self._pins.items()):
                    for _ in range(n):
                        self._lib.rt_release(h, oid)
                self._pins.clear()
                self._h = None
                return
            self._h = None
        self._view.release()
        self._lib.rt_store_close(h)
