"""Binary identifiers for jobs, nodes, workers, actors, tasks and objects.

Design follows the reference's embedded-lineage scheme (reference:
src/ray/common/id.h): an ObjectID embeds the TaskID that creates it plus a
return/put index, so ownership and lineage can be derived from the id itself.

Sizes: JobID 4, ActorID 12 (job + unique), TaskID 16 (actor/job prefix +
unique), ObjectID 20 (task + 4-byte index), NodeID/WorkerID 16 random.
"""

from __future__ import annotations

import os
import struct

# Measured on this kernel: os.urandom is vDSO-fast (~0.5us for 12
# bytes) and beats a lock+counter scheme — keep the plain random ids.
def _unique(n: int) -> bytes:
    return os.urandom(n)


def span_id() -> str:
    """Unique span id for trace propagation."""
    return os.urandom(8).hex()

JOB_ID_LEN = 4
ACTOR_ID_LEN = 12
TASK_ID_LEN = 16
OBJECT_ID_LEN = 20
UNIQUE_LEN = 16

NIL_JOB = b"\x00" * JOB_ID_LEN
NIL_ACTOR = b"\x00" * ACTOR_ID_LEN
NIL_TASK = b"\x00" * TASK_ID_LEN
NIL_OBJECT = b"\x00" * OBJECT_ID_LEN
NIL_ID = b"\x00" * UNIQUE_LEN


def random_unique() -> bytes:
    return os.urandom(UNIQUE_LEN)


def job_id_from_int(n: int) -> bytes:
    return struct.pack(">I", n)


def new_task_id(job_id: bytes, actor_id: bytes = NIL_ACTOR) -> bytes:
    """TaskID = 4-byte job | 12 unique (normal task) or actor-scoped."""
    if actor_id != NIL_ACTOR:
        return actor_id[:ACTOR_ID_LEN] + _unique(TASK_ID_LEN - ACTOR_ID_LEN)
    return job_id + _unique(TASK_ID_LEN - JOB_ID_LEN)


def new_actor_id(job_id: bytes) -> bytes:
    return job_id + os.urandom(ACTOR_ID_LEN - JOB_ID_LEN)


def actor_creation_task_id(actor_id: bytes) -> bytes:
    """Deterministic TaskID for an actor's creation task."""
    return actor_id + b"\xff" * (TASK_ID_LEN - ACTOR_ID_LEN)


def object_id_for_return(task_id: bytes, index: int) -> bytes:
    """Return values use indices 1..n; index 0 is reserved."""
    return task_id + struct.pack(">I", index)


def object_id_for_put(task_id: bytes, put_index: int) -> bytes:
    """Puts use the high bit of the index word to avoid collision."""
    return task_id + struct.pack(">I", 0x80000000 | put_index)


def task_id_of_object(object_id: bytes) -> bytes:
    return object_id[:TASK_ID_LEN]


def job_id_of(any_id: bytes) -> bytes:
    return any_id[:JOB_ID_LEN]


def new_node_id() -> bytes:
    return os.urandom(UNIQUE_LEN)


def new_worker_id() -> bytes:
    return os.urandom(UNIQUE_LEN)


def new_placement_group_id(job_id: bytes) -> bytes:
    return job_id + os.urandom(UNIQUE_LEN - JOB_ID_LEN)


def hex_short(b: bytes) -> str:
    return b.hex()[:12]
