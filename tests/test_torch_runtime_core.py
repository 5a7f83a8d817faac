"""The port's runtime core (ray_tpu_torch: its own GCS, node manager,
workers and shared-memory store) against the JAX package's runtime: the
counterparts of tests/test_core.py's 21 tests on a local cluster, and a
parity test that runs one driver program (tests/torch_runtime_parity.py)
on each runtime in a fresh process and requires equal output."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    ctx = rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    try:
        yield ctx
    finally:
        rt.shutdown()


@pytest.mark.parametrize("value", [
    {"a": 1, "b": [1, 2, 3]},
    np.arange(1_000_000, dtype=np.float32),
], ids=["small", "large_zero_copy"])
def test_put_get(cluster, value):
    ref = rt.put(value)
    for _ in range(2):      # a second get works too (the pin stays readable)
        out = rt.get(ref)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(out, value)
        else:
            assert out == value


def test_simple_task(cluster):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def test_task_with_ref_args(cluster):
    @rt.remote
    def double(x):
        return x * 2

    assert rt.get(double.remote(rt.put(21))) == 42


def test_task_large_return(cluster):
    @rt.remote
    def make_array(n):
        return np.ones(n, dtype=np.float64)

    out = rt.get(make_array.remote(500_000))
    assert out.shape == (500_000,) and out.sum() == 500_000


def test_task_chain(cluster):
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(10):
        ref = inc.remote(ref)
    assert rt.get(ref) == 11


def test_task_exception(cluster):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ValueError, match="kaboom"):
        rt.get(boom.remote())


def test_multiple_returns(cluster):
    @rt.remote(num_returns=2)
    def pair():
        return 1, 2

    r1, r2 = pair.remote()
    assert rt.get(r1) == 1 and rt.get(r2) == 2


def test_wait(cluster):
    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast = sleepy.remote(0.01)
    slow = sleepy.remote(1.5)
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=1.0)
    assert ready == [fast] and not_ready == [slow]


def test_actor_basic(cluster):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def get(self):
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.inc.remote()) == 11
    assert rt.get(c.inc.remote(5)) == 16
    assert rt.get(c.get.remote()) == 16


def test_actor_ordering(cluster):
    @rt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def get(self):
            return self.items

    a = Appender.remote()
    for i in range(20):
        a.add.remote(i)
    assert rt.get(a.get.remote()) == list(range(20))


def test_async_actor(cluster):
    @rt.remote
    class AsyncActor:
        async def work(self, x):
            import asyncio
            await asyncio.sleep(0.01)
            return x * 2

    a = AsyncActor.remote()
    assert rt.get([a.work.remote(i) for i in range(10)]) == \
        [i * 2 for i in range(10)]


def test_named_actor(cluster):
    @rt.remote
    class Store:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v

        def get(self, k):
            return self.d.get(k)

    s = Store.options(name="kvstore").remote()
    rt.get(s.set.remote("x", 1))
    assert rt.get(rt.get_actor("kvstore").get.remote("x")) == 1


def test_actor_handle_passing(cluster):
    @rt.remote
    class Counter2:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    @rt.remote
    def bump(c):
        return rt.get(c.inc.remote())

    c = Counter2.remote()
    assert rt.get(bump.remote(c)) == 1
    assert rt.get(bump.remote(c)) == 2


def test_kill_actor(cluster):
    @rt.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    assert rt.get(v.ping.remote()) == "pong"
    rt.kill(v)
    time.sleep(0.3)
    with pytest.raises(rt.ActorDiedError):
        rt.get(v.ping.remote())


def test_nested_tasks(cluster):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 10

    assert rt.get(outer.remote(0)) == 11


def test_cluster_resources(cluster):
    assert rt.cluster_resources().get("CPU") == 4.0


def test_actor_restart_preserves_call_order(cluster):
    """Calls racing an actor kill+restart are resent in submission order:
    the restarted actor's journal is a contiguous ascending suffix."""
    @rt.remote(max_restarts=1, max_task_retries=-1)
    class Journal:
        def __init__(self):
            self.log = []

        def append(self, i):
            time.sleep(0.05)      # keep a pipeline in flight at the kill
            self.log.append(i)
            return i

        def get_log(self):
            return list(self.log)

    j = Journal.remote()
    assert rt.get(j.append.remote(-1), timeout=60) == -1
    refs = [j.append.remote(i) for i in range(40)]
    time.sleep(0.4)           # several appends done, many in flight
    rt.kill(j, no_restart=False)
    assert rt.get(refs, timeout=120) == list(range(40))
    log = rt.get(j.get_log.remote(), timeout=60)
    assert log, "kill landed after all appends; nothing exercised"
    assert log == list(range(log[0], 40)), log
    assert log[0] > 0, "kill landed before any append completed"


def test_fast_method_using_sync_api_never_double_executes(cluster):
    """A quick actor method that calls the blocking get stays on the
    thread pool, and every call executes exactly once."""
    @rt.remote(num_cpus=0.1)
    class G:
        def __init__(self):
            self.count = 0

        def bump_and_get(self, refs):
            self.count += 1
            return self.count, rt.get(refs[0])

    g = G.remote()
    ref = rt.put(7)
    outs = rt.get([g.bump_and_get.remote([ref]) for _ in range(30)],
                  timeout=60)
    assert [c for c, _ in outs] == list(range(1, 31))
    assert all(v == 7 for _, v in outs)


@pytest.mark.parametrize("n", [50, 1000], ids=["parallel", "large_fan"])
def test_task_fan(cluster, n):
    """Many tasks at once; a 1000-task fan completes promptly because
    submissions pipeline onto a bounded set of leases. (Last of the
    cluster tests: the fan's queued lease requests hold the node's CPUs
    for seconds after it, which an actor created next would wait out.)"""
    @rt.remote
    def sq(x):
        return x * x

    t0 = time.monotonic()
    assert rt.get([sq.remote(i) for i in range(n)], timeout=120) == \
        [i * i for i in range(n)]
    assert time.monotonic() - t0 < 60


def test_parity_with_the_jax_runtime():
    """The same driver program on ray_tpu and on ray_tpu_torch, each in a
    fresh process, prints equal JSON (task and actor results, the error
    classes and messages of a failing task and of a killed actor, the
    cluster_resources keys, a named-actor lookup and the call order
    across an actor restart)."""
    env = dict(os.environ)
    # the JAX package's workers import jax only to pin this platform;
    # the program runs no JAX code
    env.pop("RAY_TPU_JAX_PLATFORMS", None)
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-m", "tests.torch_runtime_parity", pkg], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    got = {}
    for pkg, p in procs.items():
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        lines = [ln for ln in out.splitlines() if ln.startswith("PARITY ")]
        assert p.returncode == 0 and lines, (pkg, out[-2000:], err[-4000:])
        got[pkg] = json.loads(lines[-1][len("PARITY "):])
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu"]["task_error"] == ["ValueError", "kaboom"]
    assert got["ray_tpu"]["killed_actor"][0] == "ActorDiedError"
    assert got["ray_tpu"]["restart_log_is_suffix"]
