"""An object restored from spill for a reader stays readable (the port's
runtime, ``_private/node_manager.py``): the node manager's spill sweep
drops the resident copy of an already-spilled object to relieve
pressure, and before the reader had read the copy restored for it, that
drop lost the object for the reader (``ObjectLostError: ... evicted``).
This is how phase 14 (d) lost a stage on the card: tpu-3b's 2.8 GB of
stage weights, spilled from a pressured 4 GiB stripe, were restored for
a replacement stage actor and dropped again before its get. A restored
copy now stays for ``RESTORE_GRACE_S``. Two readers restoring one
object at once (phase 14 (d)'s two stage actors read the same weights)
each find it sealed when their restore returns: before, the second
restore either failed its create of the same id or returned while the
first was still copying, and its reader found nothing. On a one-stripe
64 MiB store: a 48 MiB object spilled, restored beside an 8 MiB one, and
a sweep under pressure right after; the object stays resident, and both
read back equal. Then four restores of a spilled object at once."""

import asyncio

import numpy as np
import pytest

import ray_tpu_torch as rt


@pytest.fixture
def runtime():
    # the sweep runs only when the test asks (spill_now), so the order of
    # spill, restore and sweep is the test's
    rt.init(num_cpus=1, object_store_memory=64 * 2 ** 20,
            _system_config={"spill_check_interval_s": 3600.0})
    try:
        yield rt._get_worker().core
    finally:
        rt.shutdown()


def _call(core, method, **kw):
    return asyncio.run_coroutine_threadsafe(
        core.node_conn.call(method, **kw), core.loop).result(timeout=60)


def test_restored_copy_survives_the_next_sweep(runtime):
    core = runtime
    big = np.arange(48 * 2 ** 20, dtype=np.uint8)
    ref = rt.put(big)
    _call(core, "spill_now")               # 75% in use: it goes to disk
    assert not core.store.contains(ref.id)
    # a resident object beside it, so the arena is under pressure again
    # once the 48 MiB come back
    filler = np.full(8 * 2 ** 20, 7, dtype=np.uint8)
    fref = rt.put(filler)
    assert _call(core, "restore_object", oid=ref.id)
    assert core.store.contains(ref.id)
    _call(core, "spill_now")
    assert core.store.contains(ref.id), \
        "the sweep dropped the copy restored for its reader"
    np.testing.assert_array_equal(rt.get(ref, timeout=60), big)
    np.testing.assert_array_equal(rt.get(fref, timeout=60), filler)


def test_concurrent_restores_each_find_the_object_sealed(runtime):
    core = runtime
    big = np.arange(48 * 2 ** 20, dtype=np.uint8)
    ref = rt.put(big)
    _call(core, "spill_now")
    assert not core.store.contains(ref.id)

    async def restore():
        ok = await core.node_conn.call("restore_object", oid=ref.id)
        buf = core.store.get(ref.id)
        sealed = buf is not None
        if sealed:
            buf.close()
        return ok, sealed

    async def together():
        return await asyncio.gather(*[restore() for _ in range(4)])
    got = asyncio.run_coroutine_threadsafe(together(), core.loop).result(
        timeout=120)
    assert got == [(True, True)] * 4, got
    np.testing.assert_array_equal(rt.get(ref, timeout=60), big)


def test_create_in_a_fragmented_stripe_keeps_held_primaries(runtime):
    """A put that fits no hole of a fragmented stripe spills to make room;
    it never evicts a primary copy whose owner still holds it (Ray's rule:
    a primary stays pinned until it has been spilled). Forty 1 MiB
    objects and a 20 MiB one fill the stripe to ~94%; dropping every
    other 1 MiB object leaves twenty 1 MiB holes at ~63% in use (under
    the sweep's watermark), so an 8 MiB put fits no hole. Every held
    object reads back equal afterwards, the 8 MiB one too."""
    mib = 2 ** 20
    small = [np.full(mib, i, dtype=np.uint8) for i in range(40)]
    refs = [rt.put(a) for a in small]
    tail = np.arange(20 * mib, dtype=np.uint8)
    tref = rt.put(tail)
    held = {i: refs[i] for i in range(1, 40, 2)}
    del refs
    big = np.full(8 * mib, 0xAB, dtype=np.uint8)
    bref = rt.put(big)
    for i, ref in held.items():
        np.testing.assert_array_equal(rt.get(ref, timeout=30), small[i])
    np.testing.assert_array_equal(rt.get(tref, timeout=30), tail)
    np.testing.assert_array_equal(rt.get(bref, timeout=30), big)
