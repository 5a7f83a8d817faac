"""ray_tpu_torch's tracing export and state API against ray_tpu's.

The same synthetic GCS task-event rows (tasks, flight-recorder spans and
instants) and gauge series go through both packages'
``task_events_to_chrome`` and ``task_events_to_otlp`` (equal JSON; the
OTLP attribute names carry each package's own prefix), a cluster-stacks
dump through both ``format_cluster_stacks``; ``ray_tpu_torch.timeline()``
on a port runtime holds a nested task's spans with their parent links;
and one driver program run on each runtime (``tests/torch_state_parity``)
shows that every ``util/state`` row of the port carries the keys JAX's
carries."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ray_tpu.util import tracing as jax_tracing
from ray_tpu_torch.util import tracing

ROOT = Path(__file__).resolve().parent.parent


def _rows():
    t0 = 1_700_000_000.0
    return [
        {"task_id": "a1b2c3d4e5f60718", "name": "outer", "type": "NORMAL_TASK",
         "state": "FINISHED", "node_id": "node0123456789", "job_id": 1,
         "worker_id": "worker0123456789", "trace_id": "f" * 32,
         "span_id": "0123456789abcdef", "parent_span_id": None,
         "state_times": {"PENDING": t0, "RUNNING": t0 + 0.5,
                         "FINISHED": t0 + 1.25}},
        {"task_id": "b1b2c3d4e5f60718", "name": "inner", "type": "NORMAL_TASK",
         "state": "FAILED", "node_id": "node9876543210",
         "worker_id": "workerabcdef0123", "trace_id": "f" * 32,
         "span_id": "fedcba9876543210", "parent_span_id": "0123456789abcdef",
         "state_times": {"RUNNING": t0 + 0.6, "FAILED": t0 + 0.9}},
        {"task_id": "c1", "name": "queued", "type": "NORMAL_TASK",
         "state": "PENDING", "state_times": {"PENDING": t0}},
        {"task_id": "d1d2", "kind": "runtime_event", "name": "engine.decode",
         "category": "engine", "type": "RUNTIME_EVENT", "event_kind": "span",
         "trace_id": "ab" * 16, "span_id": "1111222233334444",
         "parent_span_id": "fedcba9876543210", "node_id": "node0123456789",
         "worker_id": "workerabcdef0123", "state": "FINISHED",
         "attrs": {"mfu": 0.25, "slots": 3, "ok": True, "tag": "x"},
         "state_times": {"RUNNING": t0 + 0.7, "FINISHED": t0 + 0.7000001}},
        {"task_id": "e1e2", "kind": "runtime_event", "name": "engine.evict",
         "category": "engine", "type": "RUNTIME_EVENT",
         "event_kind": "instant", "trace_id": "cd" * 16,
         "span_id": "5555666677778888", "parent_span_id": None,
         "node_id": "node0123456789", "worker_id": None, "state": "RUNNING",
         "attrs": {"reason": "length"}, "state_times": {"RUNNING": t0 + 0.8}},
    ]


def _series():
    return [{"name": "runtime_train_step_mfu", "tags": {},
             "worker_id": "w1", "samples": [[1_700_000_000.5, 0.2],
                                            [1_700_000_002.5, 0.25]]},
            {"name": "runtime_train_step_phase_ms",
             "tags": {"phase": "compute", "a": "b"}, "worker_id": "w1",
             "samples": [[1_700_000_001.0, 300.0]]}]


def test_chrome_export_equals_jax():
    """Exact equality of the two event lists (tasks, runtime spans and
    instants, counter tracks, the sort and the 1 us duration floor)."""
    got = tracing.task_events_to_chrome(_rows(), gauge_series=_series())
    want = jax_tracing.task_events_to_chrome(_rows(),
                                             gauge_series=_series())
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert {e["ph"] for e in got} == {"X", "i", "C"}


def test_otlp_export_equals_jax():
    """Exact equality once the JAX payload's ``ray_tpu.`` attribute and
    scope prefix reads ``ray_tpu_torch.`` (each package names its own)."""
    got = tracing.task_events_to_otlp(_rows(), service_name="svc")
    want = jax_tracing.task_events_to_otlp(_rows(), service_name="svc")
    want = json.loads(json.dumps(want).replace('"ray_tpu.',
                                               '"ray_tpu_torch.'))
    assert got == want
    spans = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert len(spans) == 4 and spans[1]["status"]["code"] == 2


def test_format_cluster_stacks_equals_jax():
    dump = {"node0123456789abcdef": {
        "node_manager": {"pid": 11, "stacks": {"MainThread": "  f()\n"}},
        "workers": {"worker0123456789ab": {"pid": 12, "mode": "task",
                                           "stacks": {"t1": "  g()\n"}},
                    "worker9999": {"error": "timed out"}}},
        "nodedead": {"error": "unreachable"}}
    assert tracing.format_cluster_stacks(dump) == \
        jax_tracing.format_cluster_stacks(dump)


@pytest.fixture(scope="module")
def state_parity():
    """The state-API parity program on each runtime, started first so it
    runs beside the other tests of the file."""
    env = dict(os.environ)
    # the JAX package's workers import jax only to pin this platform;
    # the program runs no JAX code
    env.pop("RAY_TPU_JAX_PLATFORMS", None)
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-m", "tests.torch_state_parity", pkg], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    yield procs
    for p in procs.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def runtime(state_parity):
    import ray_tpu_torch as rt
    rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    yield rt
    rt.shutdown()


def test_timeline_holds_nested_task_spans_and_links(runtime, tmp_path):
    """driver -> outer -> inner, with a flight-recorder span inside inner:
    one trace id end to end, inner's parent span is outer's span, the
    recorded span's parent is inner's, and the export writes them as
    chrome events with those ids in their args."""
    rt = runtime

    @rt.remote(name="tl_inner")
    def inner():
        from ray_tpu_torch._private import events
        with events.record_span("tl.work", category="tltest", n=3):
            time.sleep(0.01)
        events.flush()
        return 1

    @rt.remote(name="tl_outer")
    def outer():
        return rt.get(inner.remote())

    assert rt.get(outer.remote(), timeout=60) == 1
    deadline = time.monotonic() + 30
    while True:
        evs = rt.timeline()
        by = {e["name"]: e for e in evs}
        if {"tl_outer", "tl_inner", "tl.work"} <= set(by) or \
                time.monotonic() > deadline:
            break
        time.sleep(0.3)
    o, i, w = by["tl_outer"]["args"], by["tl_inner"]["args"], \
        by["tl.work"]["args"]
    assert o["trace_id"] == i["trace_id"] == w["trace_id"]
    assert i["parent_span_id"] == o["span_id"]
    assert w["parent_span_id"] == i["span_id"] and w["n"] == 3
    assert by["tl.work"]["pid"] == "runtime:tltest"
    path = rt.timeline(str(tmp_path / "tl.json"))
    with open(path) as f:
        assert {"tl_outer", "tl_inner"} <= {e["name"] for e in json.load(f)}


def test_state_rows_carry_the_jax_keys(state_parity):
    """Every list and summary of the state API: the port's rows carry
    every key the JAX package's carry; the one extra key is the node's
    longest heartbeat silence (``max_heartbeat_gap_s``, which the port's
    GCS records)."""
    got = {}
    for pkg, p in state_parity.items():
        out, err = p.communicate(timeout=120)
        lines = [ln for ln in out.splitlines() if ln.startswith("PARITY ")]
        assert p.returncode == 0 and lines, (pkg, out[-2000:], err[-4000:])
        got[pkg] = json.loads(lines[-1][len("PARITY "):])
    jax_keys, port_keys = got["ray_tpu"], got["ray_tpu_torch"]
    assert sorted(jax_keys) == sorted(port_keys)
    extra = {}
    for what, keys in jax_keys.items():
        mine = port_keys[what]
        if isinstance(keys, dict):
            assert mine == keys, what
            continue
        assert keys and set(keys) <= set(mine), (what, keys, mine)
        if set(mine) - set(keys):
            extra[what] = sorted(set(mine) - set(keys))
    assert extra == {"nodes": ["max_heartbeat_gap_s"]}
