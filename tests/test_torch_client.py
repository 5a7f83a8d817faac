"""Client mode on the port (ray_tpu_torch/client, ``init("ray://...")``):
the three cases of tests/test_client.py. A host subprocess starts the
port's runtime and ``serve_proxy()``; this process connects through
``ray_tpu_torch.init("ray://<proxy>")`` (or ``client.connect``) without a
runtime of its own and drives tasks, actors, puts and waits over the one
proxy connection. A process that holds a runtime cannot also become a
client."""

import os
import subprocess
import sys
import time

import pytest

HOST_SCRIPT = """
import sys, time
import ray_tpu_torch
from ray_tpu_torch.client import serve_proxy
ray_tpu_torch.init(num_cpus=2, object_store_memory=64*1024*1024)
addr = serve_proxy()
print(f"PROXY_ADDR={addr}", flush=True)
while True:
    time.sleep(1)
"""


@pytest.fixture(scope="module")
def proxy_addr():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", HOST_SCRIPT],
                            stdout=subprocess.PIPE, text=True, env=env)
    addr = None
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            break              # host died: readline() would spin on ''
        line = proc.stdout.readline()
        if line.startswith("PROXY_ADDR="):
            addr = line.strip().split("=", 1)[1]
            break
    assert addr, "proxy did not start"
    yield addr
    proc.terminate()
    proc.wait(timeout=10)


def test_session_isolation(proxy_addr):
    """Per-connection sessions: another connection can NEITHER read nor
    free a session's refs, and the proxy survives a session's
    disconnect."""
    import asyncio

    import ray_tpu_torch as rt
    from ray_tpu_torch import client as rc
    from ray_tpu_torch._private import rpc

    # the proxy runs what its clients send, so by default it binds loopback
    assert proxy_addr.startswith("tcp:127.0.0.1:"), proxy_addr
    ctx = rt.init(f"ray://{proxy_addr}")
    try:
        assert rc.current_client() is ctx and not rt.is_initialized()
        ref = rt.put({"secret": 42})
        oid = ref.id

        # a SECOND connection probing the first session's oid must fail
        # (its session tables are its own), while the owner still reads
        async def probe():
            conn = await rpc.connect(proxy_addr, name="intruder")
            try:
                out = await conn.call("get", oids=[oid], timeout=30)
                return out
            except rpc.RpcError as e:
                return ("denied", str(e))
            finally:
                await conn.close()

        out = asyncio.run(probe())
        assert out[0] == "denied" and "KeyError" in out[1], out
        assert rt.get(ref, timeout=60) == {"secret": 42}
        with pytest.raises(RuntimeError, match="already called"):
            rt.init(f"ray://{proxy_addr}")
    finally:
        rt.shutdown()           # client mode: drops the proxy session
    assert rc.current_client() is None

    # proxy stays healthy for fresh sessions after a disconnect
    ctx2 = rc.connect(proxy_addr)
    try:
        @rt.remote
        def ping():
            return "alive"

        assert rt.get(ping.remote(), timeout=60) == "alive"
    finally:
        ctx2.disconnect()


def test_detached_actor_survives_and_reattaches(proxy_addr):
    """Detached actors outlive the creating session; a reconnecting
    client reattaches by name via get_actor."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import client as rc

    ctx = rc.connect(proxy_addr)
    try:
        @rt.remote
        class Keeper:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        k = Keeper.options(lifetime="detached", name="keeper").remote()
        assert rt.get(k.incr.remote(), timeout=60) == 1
    finally:
        ctx.disconnect()

    time.sleep(1.0)   # let disconnect reaping (of non-detached) run
    ctx2 = rc.connect(proxy_addr)
    try:
        k2 = rt.get_actor("keeper")
        # state survived the session that created it
        assert rt.get(k2.incr.remote(), timeout=60) == 2
        rt.kill(k2)
    finally:
        ctx2.disconnect()


def test_client_tasks_actors_objects(proxy_addr):
    import ray_tpu_torch as rt
    ctx = rt.init(f"ray://{proxy_addr}")
    try:
        @rt.remote
        def add(a, b):
            return a + b

        ref = add.remote(2, 3)
        assert rt.get(ref, timeout=60) == 5

        # object refs as args resolve server-side
        big = rt.put(list(range(100)))

        @rt.remote
        def total(xs):
            return sum(xs)
        assert rt.get(total.remote(big), timeout=60) == 4950

        # wait
        refs = [add.remote(i, i) for i in range(4)]
        ready, rest = rt.wait(refs, num_returns=4, timeout=60)
        assert len(ready) == 4 and not rest
        assert sorted(rt.get(ready, timeout=60)) == [0, 2, 4, 6]

        # actors
        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def incr(self, k=1):
                self.n += k
                return self.n

        c = Counter.remote(10)
        assert rt.get(c.incr.remote(), timeout=60) == 11
        assert rt.get(c.incr.remote(5), timeout=60) == 16
        rt.kill(c)

        # errors propagate
        @rt.remote
        def boom():
            raise ValueError("client boom")

        with pytest.raises(Exception, match="client boom"):
            rt.get(boom.remote(), timeout=60)

        assert ctx.cluster_resources().get("CPU") == 2.0
    finally:
        rt.shutdown()
