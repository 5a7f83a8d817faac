"""The port's Serve (ray_tpu_torch.serve) on its own runtime, against the
JAX package's: the cases of tests/test_serve.py (deployments, functions,
replicas, composition, methods, @serve.batch, status and scaling, HTTP
ingress, multiplexing) and tests/test_serve_rolling.py's rolling update
on a local cluster, and one program (tests/torch_serve_parity.py)
run on each runtime in a fresh process, whose printed JSON must be equal.

The HTTP proxy binds port 0 and the test reads the bound address from
serve.proxies(); the controller's reconcile period is cut for this
runtime, so the rolling update steps without long waits. The two parity
programs start with the module's cluster and run beside the other
cases."""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

ROOT = Path(__file__).resolve().parent.parent


def _start_parity():
    env = dict(os.environ)
    # the JAX package's workers import jax only to pin this platform;
    # the program runs no JAX code
    env.pop("RAY_TPU_JAX_PLATFORMS", None)
    return {pkg: subprocess.Popen(
        [sys.executable, "-m", "tests.torch_serve_parity", pkg], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}


@pytest.fixture(scope="module")
def parity_procs():
    procs = _start_parity()
    try:
        yield procs
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def cluster(parity_procs):
    ctx = rt.init(num_cpus=8, object_store_memory=128 * 1024 * 1024,
                  resources={"slot": 1.0},
                  _system_config={"serve_reconcile_period_s": 0.25})
    try:
        yield ctx
    finally:
        serve.shutdown()
        rt.shutdown()


def test_basic_deployment(cluster):
    @serve.deployment
    class Greeter:
        def __call__(self, name):
            return f"hello {name}"

    handle = serve.run(Greeter.bind(), name="greet", route_prefix=None)
    assert handle.remote("world").result(timeout=30) == "hello world"


def test_function_deployment(cluster):
    @serve.deployment
    def double(x):
        return x * 2

    handle = serve.run(double.bind(), name="fn", route_prefix=None)
    assert handle.remote(21).result(timeout=30) == 42


def test_multi_replica_distribution(cluster):
    @serve.deployment(num_replicas=3)
    class Which:
        def __init__(self):
            self.pid = os.getpid()

        def __call__(self, _):
            return self.pid

    handle = serve.run(Which.bind(), name="which", route_prefix=None)
    pids = {handle.remote(None).result(timeout=30) for _ in range(30)}
    assert len(pids) >= 2   # P2C spreads across replicas


def test_composition(cluster):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(timeout=30) * 10

    handle = serve.run(Model.bind(Preprocess.bind()), name="composed",
                       route_prefix=None)
    assert handle.remote(4).result(timeout=30) == 50


def test_method_calls(cluster):
    @serve.deployment
    class Calc:
        def add(self, a, b):
            return a + b

        def mul(self, a, b):
            return a * b

    handle = serve.run(Calc.bind(), name="calc", route_prefix=None)
    assert handle.add.remote(2, 3).result(timeout=30) == 5
    assert handle.mul.remote(2, 3).result(timeout=30) == 6


def test_batching(cluster):
    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def handle_batch(self, items):
            return [(x, len(items)) for x in items]

        async def __call__(self, x):
            return await self.handle_batch(x)

    handle = serve.run(Batched.bind(), name="batched", route_prefix=None)
    outs = [r.result(timeout=30) for r in [handle.remote(i)
                                           for i in range(8)]]
    assert [o[0] for o in outs] == list(range(8))
    assert max(o[1] for o in outs) > 1   # some calls actually batched


def _wait_running(app, dep, n, timeout_s=30):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = serve.status()[app][dep]
        if st["running"] == n:
            return st
        time.sleep(0.1)
    return serve.status()[app][dep]


def test_status_and_scale_update(cluster):
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, _):
            return 1

    serve.run(S.bind(), name="scaled", route_prefix=None)
    assert serve.status()["scaled"]["S"]["running"] == 1
    serve.run(S.options(num_replicas=2).bind(), name="scaled",
              route_prefix=None)
    assert _wait_running("scaled", "S", 2)["running"] == 2


def test_http_ingress_on_port_0(cluster):
    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return {"got": payload}

    serve.run(Echo.bind(), name="http_app", route_prefix="/echo",
              _http=True, http_port=0)
    (addr,) = [p["http"] for p in serve.proxies().values()]
    assert not addr.endswith(":0")
    req = urllib.request.Request(
        f"http://{addr}/echo", data=json.dumps({"a": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"got": {"a": 1}}


def test_model_multiplexing(cluster):
    """Many model ids share a replica pool with per-replica LRU caches
    and sticky routing."""
    @serve.deployment(num_replicas=2)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[-1])}

        async def __call__(self, x):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return x * model["scale"]

        def load_count(self):
            return len(self.loads)

    serve.run(MultiModel.bind(), name="mux")
    try:
        h = serve.get_app_handle("mux")
        h2 = h.options(multiplexed_model_id="m2")
        h3 = h.options(multiplexed_model_id="m3")
        assert h2.remote(10).result(timeout=60) == 20
        assert h3.remote(10).result(timeout=60) == 30
        # repeated calls hit the cached model on the same replica: total
        # loads across replicas stays at 2
        for _ in range(6):
            assert h2.remote(1).result(timeout=60) == 2
            assert h3.remote(1).result(timeout=60) == 3
        total = sum(rt.get(r.handle_request.remote("load_count", (), {}),
                           timeout=30)
                    for r in h._router.replicas)
        assert total == 2, total
    finally:
        serve.delete("mux")


@rt.remote
class _Inner:
    def __init__(self, a):
        self.total = float(a.sum())

    def total_of(self):
        return self.total


@rt.remote
class _Outer:
    def make(self, n):
        import numpy as np
        inner = _Inner.remote(np.ones(n, np.float32))
        return rt.get(inner.total_of.remote(), timeout=60)


@pytest.mark.parametrize("n", [10, 100_000], ids=["inline", "in_store"])
def test_actor_made_by_an_actor_reads_its_init_args(cluster, n):
    """What the controller does for every replica: an actor creates an
    actor. An argument over the inline limit rides the object store and
    stays alive until the new actor's __init__ has read it."""
    assert rt.get(_Outer.remote().make.remote(n), timeout=60) == n


@rt.remote(resources={"slot": 1.0})
class _SlowToBuild:
    def __init__(self):
        time.sleep(1.0)


def test_actor_killed_while_built_releases_its_resources(cluster):
    """What the controller does when an app is deleted while a replica
    is still being built: the kill lands during __init__, and the
    actor's resources come back once the creation returns."""
    a = _SlowToBuild.remote()
    time.sleep(0.3)
    rt.kill(a)
    deadline = time.monotonic() + 30
    while rt.available_resources().get("slot", 0.0) < 1.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


@serve.deployment(num_replicas=2)
class Tagged:
    def __init__(self, tag):
        self.tag = tag

    def __call__(self, payload):
        return self.tag


def test_rolling_update_no_downtime(cluster):
    """A redeploy with new code or config replaces replicas one at a time
    (new generation first): every request during the roll succeeds, and
    the new version answers alone at the end."""
    handle = serve.run(Tagged.bind("v1"), name="roll")
    assert handle.remote("x").result(timeout=60) == "v1"
    handle = serve.run(Tagged.bind("v2"), name="roll")
    deadline = time.monotonic() + 60
    seen, consecutive_v2 = set(), 0
    while time.monotonic() < deadline and consecutive_v2 < 3:
        tags = [handle.remote("x").result(timeout=30) for _ in range(6)]
        seen.update(tags)
        consecutive_v2 = consecutive_v2 + 1 if set(tags) == {"v2"} else 0
        time.sleep(0.25)          # one reconcile period of this runtime
    assert consecutive_v2 >= 3, f"never converged to v2: {seen}"
    for _ in range(4):
        assert handle.remote("x").result(timeout=30) == "v2"


def test_serve_parity_with_the_jax_runtime(parity_procs):
    """The same Serve program on ray_tpu and on ray_tpu_torch, each in a
    fresh process, prints equal JSON: handle results, the shape of
    serve.status(), HTTP bodies and status codes, a streamed HTTP
    response and a tenant's 429 with Retry-After."""
    got = {}
    for pkg, p in parity_procs.items():
        out, err = p.communicate(timeout=180)
        lines = [ln for ln in out.splitlines() if ln.startswith("PARITY ")]
        assert p.returncode == 0 and lines, (pkg, out[-2000:], err[-4000:])
        got[pkg] = json.loads(lines[-1][len("PARITY "):])
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu"]["tenants"] == {"first": [200, False],
                                         "second": [429, True],
                                         "untagged": [200, False]}
    assert got["ray_tpu"]["http_404"][0] == 404
