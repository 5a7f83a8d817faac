"""One Serve program for both runtimes, for the parity test of
tests/test_torch_serve.py:

    python -m tests.torch_serve_parity ray_tpu
    python -m tests.torch_serve_parity ray_tpu_torch

It starts a local cluster of the named package and its Serve: a class, a
function, a composition and method calls through handles, the shape of
serve.status(), and the HTTP ingress (a JSON body, a text body, an
unknown route, a streamed response, and a tenant over its concurrency
quota shed with 429 + Retry-After while an untagged request passes). It
shuts down and prints one line ``PARITY <json>`` that must be equal for
the two packages. Imports no JAX.

The HTTP port is a free one found at run time, not 0: asked for port 0,
the JAX package's proxy reports port 0 as its address.
"""

import importlib
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body, headers=None, timeout=30):
    data = body.encode() if isinstance(body, str) else json.dumps(
        body).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def run(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    serve = importlib.import_module(f"{pkg}.serve")
    # a tenant over its concurrency quota is shed at once (no queue)
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
            _system_config={"tenant_queue_max": 0})
    out = {}
    try:
        # before the proxy's first request, whose quota refresh reads it
        serve.set_tenant_quota("metered", max_concurrent=1)

        @serve.deployment
        class Greeter:
            def __call__(self, name):
                return f"hello {name}"

        @serve.deployment
        def double(x):
            return x * 2

        @serve.deployment
        class Pre:
            def __call__(self, x):
                return x + 1

        @serve.deployment
        class Model:
            def __init__(self, pre):
                self.pre = pre

            def __call__(self, x):
                return self.pre.remote(x).result(timeout=30) * 10

            def add(self, a, b):
                return a + b

        @serve.deployment
        class Echo:
            def __call__(self, payload):
                if isinstance(payload, dict) and payload.get("sleep"):
                    time.sleep(payload["sleep"])
                return {"got": payload}

        @serve.deployment
        class Counter:
            def __call__(self, n):
                for i in range(int(n)):
                    yield {"i": i}

        out["greet"] = serve.run(Greeter.bind(), name="greet",
                                 route_prefix=None).remote(
            "world").result(timeout=30)
        out["double"] = serve.run(double.bind(), name="fn",
                                  route_prefix=None).remote(
            21).result(timeout=30)
        h = serve.run(Model.bind(Pre.bind()), name="composed",
                      route_prefix=None)
        out["composed"] = h.remote(4).result(timeout=30)
        out["method"] = h.add.remote(2, 3).result(timeout=30)
        port = _free_port()
        serve.run(Echo.bind(), name="echo", route_prefix="/echo",
                  _http=True, http_port=port)
        serve.run(Counter.bind(), name="count", route_prefix="/count")
        st = serve.status()
        out["status"] = {app: {dep: sorted(row) + [row["running"],
                                                   row["target"]]
                               for dep, row in deps.items()}
                         for app, deps in st.items()}
        addr = next(iter(serve.proxies().values()))["http"]
        base = f"http://{addr}"
        js = {"Content-Type": "application/json"}
        out["http_json"] = _post(f"{base}/echo", {"a": 1}, js)[::2]
        out["http_text"] = _post(f"{base}/echo", "plain")[::2]
        out["http_404"] = _post(f"{base}/nowhere", {"a": 1}, js)[::2]
        code, _, body = _post(f"{base}/count", "4",
                              {"X-RayTPU-Stream": "1"})
        out["http_stream"] = [code, [json.loads(ln)
                                     for ln in body.splitlines()]]

        codes = {}

        def one(tag, tenant, sleep):
            hdr = dict(js, **({"X-RayTPU-Tenant": tenant} if tenant
                              else {}))
            code, headers, _ = _post(f"{base}/echo", {"sleep": sleep}, hdr)
            codes[tag] = [code, "Retry-After" in headers]

        first = threading.Thread(target=one, args=("first", "metered", 1.5))
        first.start()
        time.sleep(0.5)           # the first holds the tenant's one slot
        one("second", "metered", 0)
        one("untagged", "", 0)
        first.join(timeout=60)
        out["tenants"] = codes
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    return out


if __name__ == "__main__":
    print("PARITY " + json.dumps(run(sys.argv[1]), sort_keys=True),
          flush=True)
