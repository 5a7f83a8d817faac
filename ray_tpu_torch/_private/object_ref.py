"""ObjectRef — a future for an object owned by some worker.

Identity is a 20-byte id embedding the creating TaskID + index (ids.py,
reference: src/ray/common/id.h); `owner_address` is the RPC address of the
owning worker, carried with the ref so any holder can reach the owner for
value/location/refcount messages (reference ownership model:
src/ray/core_worker/reference_count.h:64).

Pickling a ref fires `_serialization_hook` (set by serialization.serialize)
so the runtime can track borrows; unpickling binds the ref to the local
worker runtime and registers the borrow with `_deserialization_hook`.
"""

from __future__ import annotations

import threading
from typing import Optional

# Per-thread active serialization hook (set by serialization.serialize for
# the duration of one pickling pass). Thread-local rather than a class
# attribute: puts and task submissions serialize on their CALLING threads
# concurrently, and a shared hook slot would cross-wire the contained-ref
# tracking of unrelated serializations.
_ser_tls = threading.local()


class ObjectRef:
    _deserialization_hook = None   # set by the worker runtime at startup

    __slots__ = ("id", "owner_address", "_weakly_held")

    def __init__(self, id: bytes, owner_address: str = "",
                 _register: bool = True):
        self.id = id
        self.owner_address = owner_address
        self._weakly_held = not _register
        if _register:
            hook = ObjectRef._local_ref_hook
            if hook is not None:
                hook(self)

    _local_ref_hook = None         # worker runtime: local refcount ++
    _local_unref_hook = None       # worker runtime: local refcount --

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __reduce__(self):
        hook = getattr(_ser_tls, "hook", None)
        if hook is not None:
            hook(self)
        return (_rebuild_ref, (self.id, self.owner_address))

    def __del__(self):
        if not self._weakly_held:
            unref = ObjectRef._local_unref_hook
            if unref is not None:
                try:
                    unref(self)
                except Exception:
                    pass

    # Allow `await ref` inside async actors / driver coroutines.
    def __await__(self):
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.get_async(self).__await__()

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.as_future(self)


def _rebuild_ref(id: bytes, owner_address: str) -> "ObjectRef":
    ref = ObjectRef(id, owner_address, _register=False)
    hook = ObjectRef._deserialization_hook
    if hook is not None:
        hook(ref)
        ref._weakly_held = False
    return ref
