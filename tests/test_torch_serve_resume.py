"""A stream severed by its replica's death resumes on another replica even
while the router still lists the dead one (the port's
``serve/handle.py``; ROADMAP C16). The resume is one-shot: before, its
re-route could pick the dead replica again (the controller had not taken
it off the list yet, and a replica with nothing in flight scores lowest),
and the stream then raised the second ``ActorDiedError`` (2 of 20 runs of
phase 16 (d)'s CPU rehearsal, ``serve_resume_probe.py``, on a loaded
host). Here the router's view is held still with the dead replica in it
and the survivor's load above it, so the re-route picks the dead one
unless it avoids it; the stream must give every item once."""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve


class Counter:
    def __call__(self, n):
        for i in range(n):
            time.sleep(0.05)
            yield i


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=64 * 2 ** 20,
            _system_config={"serve_reconcile_period_s": 0.25})
    try:
        yield
    finally:
        serve.shutdown()
        rt.shutdown()


def test_stream_resumes_away_from_a_dead_replica_still_listed(cluster):
    handle = serve.run(serve.deployment(Counter, num_replicas=2).bind(),
                       name="count", route_prefix=None)
    router = handle._router
    deadline = time.monotonic() + 60
    while len(router.replicas) < 2 or not all(router.started[:2]):
        assert time.monotonic() < deadline, "replicas never came up"
        router.refresh(force=True)
        time.sleep(0.1)
    gen = handle.options(stream=True).remote(20)
    got = [next(gen) for _ in range(3)]
    dead = router.replicas[gen._idx]
    alive = 1 - gen._idx
    router.refresh = lambda force=False: None     # the view stays stale
    router.shared_load = {alive: 10}              # the dead one looks idle
    rt.kill(dead)
    got.extend(gen)
    assert got == list(range(20))
