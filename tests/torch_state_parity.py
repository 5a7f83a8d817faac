"""One driver program for both runtimes, for the state-API parity test of
tests/test_torch_tracing.py:

    python -m tests.torch_state_parity ray_tpu
    python -m tests.torch_state_parity ray_tpu_torch

It starts a local cluster of the named package, runs a task, a named
actor, a placement group, a flight-recorder span and a gauge, then reads
every list/summary of the package's ``util.state`` and prints one line
``PARITY <json>``: the sorted keys of each one's rows (or of its dict),
which must be equal for the two packages. Imports no JAX.
"""

import importlib
import json
import sys
import time


def _keys(rows):
    """Sorted union of the keys of a list of row dicts, or of one dict."""
    if isinstance(rows, dict):
        return sorted(rows)
    return sorted({k for r in rows for k in r})


def run(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    state = importlib.import_module(f"{pkg}.util.state")
    events = importlib.import_module(f"{pkg}._private.events")
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    util = importlib.import_module(f"{pkg}.util")
    rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    out = {}
    try:
        @rt.remote(name="parity_task")
        def task():
            return 1

        @rt.remote
        class Named:
            def ping(self):
                return "pong"

        assert rt.get(task.remote(), timeout=60) == 1
        a = Named.options(name="parity-named").remote()
        assert rt.get(a.ping.remote(), timeout=60) == "pong"
        pg = util.placement_group([{"CPU": 0.1}])
        assert pg.wait(timeout=60)
        ref = rt.put(b"x" * 200_000)
        with events.record_span("parity.span", category="parity", n=1):
            pass
        metrics.Gauge("parity_gauge", "a gauge").set(1.0)
        events.flush()
        metrics.push_once()
        # the task events and the object ledger reach the GCS on their
        # recorders' lazy flushes: wait for the rows read below
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                state.list_tasks() and state.list_runtime_events()
                and any(r["object_id"] == ref.hex()
                        for r in state.list_object_ledger())):
            time.sleep(0.2)
        out["nodes"] = _keys(state.list_nodes())
        out["actors"] = _keys(state.list_actors())
        out["jobs"] = _keys(state.list_jobs())
        out["placement_groups"] = _keys(state.list_placement_groups())
        out["tasks"] = _keys(state.list_tasks())
        out["runtime_events"] = _keys(
            state.list_runtime_events(category="parity"))
        out["summarize_runtime_events"] = {
            k: _keys(v) for k, v in state.summarize_runtime_events().items()
            if k == "parity.span"}
        out["query_metrics"] = _keys(state.query_metrics(
            "parity_gauge", window=600, agg="latest"))
        out["metric_series"] = _keys([s for s in state.list_metric_series()
                                      if s.get("name") == "parity_gauge"])
        out["control_plane_stats"] = _keys(state.control_plane_stats())
        out["named_actors"] = _keys(state.list_named_actors())
        out["objects"] = _keys([o for o in state.list_objects()
                                if o["object_id"] == ref.hex()])
        out["object_ledger"] = _keys(state.list_object_ledger())
        out["ledger_stats"] = _keys(state.ledger_stats())
        memory = state.memory_summary()
        out["memory_summary"] = _keys(memory)
        out["memory_nodes"] = _keys(memory["nodes"])
        out["summarize_tasks"] = {k: sorted(v) for k, v in
                                  state.summarize_tasks().items()
                                  if k == "parity_task"}
        out["summarize_actors"] = sorted(state.summarize_actors())
        out["cluster_summary"] = _keys(state.cluster_summary())
        rt.kill(a)
        util.remove_placement_group(pg)
    finally:
        rt.shutdown()
    return out


if __name__ == "__main__":
    print("PARITY " + json.dumps(run(sys.argv[1]), sort_keys=True),
          flush=True)
