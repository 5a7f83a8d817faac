"""One driver program for both runtimes, for the parity test of
tests/test_torch_runtime_core.py:

    python -m tests.torch_runtime_parity ray_tpu
    python -m tests.torch_runtime_parity ray_tpu_torch

It starts a local cluster of the named package, drives tasks, an actor,
a failing task, a killed actor, a named-actor lookup and an actor restart
under load, shuts the cluster down, and prints one line ``PARITY <json>``
that must be equal for the two packages. Ids in error messages are
replaced by ``<id>`` and the package's own name by ``<pkg>`` (a killed
actor's cause names the package's ``kill``). Imports no JAX.
"""

import importlib
import json
import re
import sys
import time


def _normalize(msg: str, pkg: str) -> str:
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", msg).replace(pkg, "<pkg>")


def run(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    rt.init(num_cpus=4, resources={"custom": 2.0},
            object_store_memory=128 * 1024 * 1024)
    out = {}
    try:
        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        def boom():
            raise ValueError("kaboom")

        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def inc(self, k=1):
                self.n += k
                return self.n

        @rt.remote
        class Victim:
            def ping(self):
                return "pong"

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

        out["tasks"] = rt.get([add.remote(i, 10 * i) for i in range(5)])
        ref = add.remote(0, 1)
        for _ in range(5):
            ref = add.remote(ref, 1)
        out["chain"] = rt.get(ref)
        c = Counter.options(name="parity-counter").remote(10)
        out["actor"] = rt.get([c.inc.remote(), c.inc.remote(5)])
        out["named"] = rt.get(rt.get_actor("parity-counter").inc.remote(0))
        try:
            rt.get(boom.remote())
            out["task_error"] = None
        except Exception as e:   # the class and message are the result
            out["task_error"] = [type(e).__name__, _normalize(str(e), pkg)]
        v = Victim.remote()
        out["victim"] = rt.get(v.ping.remote())
        rt.kill(v)
        time.sleep(0.3)
        try:
            rt.get(v.ping.remote(), timeout=30)
            out["killed_actor"] = None
        except Exception as e:   # the class and message are the result
            out["killed_actor"] = [type(e).__name__, _normalize(str(e), pkg)]
        out["resources"] = sorted(rt.cluster_resources())
        j = Journal.remote()
        rt.get(j.append.remote(-1), timeout=60)
        refs = [j.append.remote(i) for i in range(30)]
        time.sleep(0.4)           # several appends done, many in flight
        rt.kill(j, no_restart=False)
        out["restart_results"] = rt.get(refs, timeout=120)
        log = rt.get(j.get_log.remote(), timeout=60)
        # the restarted actor's journal is a contiguous ascending suffix
        out["restart_log_is_suffix"] = bool(
            log and log == list(range(log[0], 30)) and log[0] > 0)
    finally:
        rt.shutdown()
    return out


if __name__ == "__main__":
    print("PARITY " + json.dumps(run(sys.argv[1]), sort_keys=True),
          flush=True)
