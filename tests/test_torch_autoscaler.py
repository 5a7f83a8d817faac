"""The port's autoscaler (ray_tpu_torch/autoscaler/) on its own runtime:
the cases of tests/test_autoscaler.py, tests/test_cluster_launcher.py,
tests/test_instance_manager.py and the five autoscaler cases of
tests/test_serve_preemption.py:395-454, plus what the port needs: a
``num_gpus=1`` task pending on a head without GPUs is ``{"GPU": 1}``
demand, which launches a GPU node whose task sees its card, and `cli up
--block` / `cli down` as processes leave nothing of the session behind.
The TPU-slice provider waits for the port's slice gangs and says so."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                      FakeMultiNodeProvider, launcher)
from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig
from ray_tpu_torch.autoscaler.instance_manager import (InstanceManager,
                                                       Status)
from ray_tpu_torch.autoscaler.node_provider import (GceVmNodeProvider,
                                                    GcpTpuNodeProvider)

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------- the loop on real local nodes

def test_scale_up_then_down():
    """A 2-CPU task on a 1-CPU head launches one node; the idle node is
    terminated after the timeout (tests/test_autoscaler.py)."""
    rt.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        provider = FakeMultiNodeProvider(
            rt.get_gcs_address(), session_name=rt._context.node.session_name)
        scaler = Autoscaler(AutoscalerConfig(
            node_types={"cpu4": NodeTypeConfig(resources={"CPU": 4.0},
                                               max_workers=2)},
            idle_timeout_s=2.0), provider)

        @rt.remote(num_cpus=2)
        def big():
            time.sleep(1)
            return 1

        ref = big.remote()
        launched = []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not launched:
            time.sleep(0.5)
            launched = scaler.step()["launched"]
        assert launched == ["cpu4"]
        assert rt.get(ref, timeout=60) == 1
        terminated = []
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline and not terminated:
            time.sleep(0.5)
            terminated = scaler.step()["terminated"]
        assert terminated
        assert provider.non_terminated_nodes() == []
    finally:
        rt.shutdown()


def test_gpu_task_demand_launches_a_gpu_node():
    """A num_gpus=1 task on a head without GPUs is {"GPU": 1} demand: the
    GPU node type is launched, the task runs there with its GPU id as its
    mask, and the idle node goes."""
    rt.init(num_cpus=1, resources={"GPU": 0},
            object_store_memory=64 * 1024 * 1024)
    try:
        provider = FakeMultiNodeProvider(
            rt.get_gcs_address(), session_name=rt._context.node.session_name)
        scaler = Autoscaler(AutoscalerConfig(
            node_types={
                "cpu_worker": NodeTypeConfig(resources={"CPU": 2.0}),
                "gpu_worker": NodeTypeConfig(
                    resources={"CPU": 1.0, "GPU": 1.0}, max_workers=1)},
            idle_timeout_s=1.0), provider)

        @rt.remote(num_gpus=1)
        def where():
            return (rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                    rt.get_runtime_context()["node_id"])

        ref = where.remote()
        demand, launched = [], []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not launched:
            time.sleep(0.5)
            demand = [d for n in rt.nodes() for d in n["pending_demand"]]
            launched = scaler.step()["launched"]
        assert demand == [{"GPU": 1.0}]
        assert launched == ["gpu_worker"]
        ids, mask, node = rt.get(ref, timeout=60)
        assert ids == ["0"] and mask == "0"
        assert node == provider.non_terminated_nodes()[0]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and provider.non_terminated_nodes():
            time.sleep(0.5)
            scaler.step()
        assert provider.non_terminated_nodes() == []
    finally:
        rt.shutdown()


# ------------------------------------------------------------ the launcher

def test_up_runs_tasks_on_every_node(tmp_path):
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text(textwrap.dedent("""\
        cluster_name: launcher-e2e
        provider:
          type: fake
        head:
          num_cpus: 1
        available_node_types:
          cpu_worker:
            resources: {CPU: 1}
            min_workers: 2
            max_workers: 4
        idle_timeout_s: 300
    """))
    handle = launcher.up(str(cfg))
    try:
        rt.init(address=handle.gcs_address)
        deadline = time.time() + 60
        while time.time() < deadline:
            if sum(1 for n in rt.nodes() if n["alive"]) >= 3:
                break
            time.sleep(0.5)
        assert len([n for n in rt.nodes() if n["alive"]]) == 3

        @rt.remote(num_cpus=1, scheduling_strategy="SPREAD")
        def where():
            time.sleep(1)
            return rt.get_runtime_context()["node_id"]

        spots = rt.get([where.remote() for _ in range(6)], timeout=120)
        assert len(set(spots)) == 3, "tasks must have spread to every node"
    finally:
        rt.shutdown()
        handle.down()


def test_config_validation(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("provider: {type: nope}\n")
    with pytest.raises(ValueError):
        launcher.load_config(str(bad))
    bad2 = tmp_path / "bad2.yaml"
    bad2.write_text("provider: {type: fake}\n"
                    "available_node_types:\n  w: {min_workers: 1}\n")
    with pytest.raises(ValueError):
        launcher.load_config(str(bad2))
    tpu = tmp_path / "tpu.yaml"
    tpu.write_text("provider: {type: gcp_tpu, project: p, zone: z}\n")
    with pytest.raises(NotImplementedError, match="A3c-2"):
        launcher.load_config(str(tpu))
    with pytest.raises(NotImplementedError, match="A3c-2"):
        GcpTpuNodeProvider("p", "z", "10.0.0.1:6379")


def _cli(*argv, env, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_up_autoscales_a_gpu_node_and_down_leaves_nothing(tmp_path):
    """`cli up --block` on a fake-provider YAML (a head without GPUs, one
    gpu_worker type at min 0, max 1): a num_gpus=1 task pends until the
    node is up and runs there; the node goes after its idle timeout, and
    `cli down` stops the reconciler and leaves no process or arena of
    the session."""
    from ray_tpu_torch.scripts.cli import stop_session
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text(textwrap.dedent("""\
        cluster_name: gpu-autoscale
        provider: {type: fake}
        head: {num_cpus: 1, resources: {GPU: 0}}
        available_node_types:
          gpu_worker:
            resources: {CPU: 1, GPU: 1}
            min_workers: 0
            max_workers: 1
        idle_timeout_s: 1
    """))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=str(ROOT))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    up = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "up", "--block",
         str(cfg)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    state = tmp_path / "raytpu_torch" / "cluster_launcher.json"
    try:
        deadline = time.monotonic() + 60
        while not state.exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        st = json.loads(state.read_text())
        assert st["pid"] == up.pid
        rt.init(address=st["gcs_address"])
        try:
            @rt.remote(num_gpus=1)
            def where():
                return os.environ.get("CUDA_VISIBLE_DEVICES")
            assert rt.get(where.remote(), timeout=60) == "0"
            assert sum(n["alive"] for n in rt.nodes()) == 2
            deadline = time.monotonic() + 30
            while sum(n["alive"] for n in rt.nodes()) > 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.5)
            assert sum(n["alive"] for n in rt.nodes()) == 1
        finally:
            rt.shutdown()
        down = _cli("down", env=env)
        assert down.returncode == 0, down.stdout + down.stderr
        assert up.wait(timeout=30) == 0
    finally:
        if up.poll() is None:
            up.kill()
            up.wait()
    assert stop_session(st["session"], timeout=0.0) == 0
    assert not list(Path("/dev/shm").glob(f"raytpu_torch_{st['session']}_*"))
    assert not state.exists()


# --------------------------------------------------- the instance manager

class FakeCloudProvider:
    """In-memory provider whose 'cloud' the test scripts directly."""

    def __init__(self):
        self.cloud = set()
        self.fail_next_create = False
        self.n = 0

    def create_node(self, node_type, resources, labels):
        if self.fail_next_create:
            self.fail_next_create = False
            raise RuntimeError("quota exceeded")
        self.n += 1
        pid = f"vm-{self.n}"
        self.cloud.add(pid)
        return pid

    def terminate_node(self, pid):
        self.cloud.discard(pid)

    def non_terminated_nodes(self):
        return list(self.cloud)


NODE_TYPES = {"cpu_worker": {"resources": {"CPU": 8.0},
                             "labels": {"team": "infra"}}}


def _ray_node(pid):
    return {"node_id": pid, "alive": True, "total": {"CPU": 8.0}}


def test_scale_up_through_states():
    prov = FakeCloudProvider()
    im = InstanceManager(prov, NODE_TYPES)
    im.set_target("cpu_worker", 2)
    assert len(im.reconcile([])["launched"]) == 2
    assert [i.status for i in im.instances.values()].count(
        Status.REQUESTED) == 2
    im.reconcile([])
    assert all(i.status == Status.ALLOCATED
               for i in im.instances.values())
    im.reconcile([_ray_node(i.provider_id) for i in im.instances.values()])
    assert all(i.status == Status.RAY_RUNNING
               for i in im.instances.values())
    acts = im.reconcile([_ray_node(i.provider_id)
                         for i in im.instances.values()])
    assert acts == {"launched": [], "terminated": [], "failed": []}


def test_allocation_failure_retries_and_history():
    prov = FakeCloudProvider()
    prov.fail_next_create = True
    im = InstanceManager(prov, NODE_TYPES)
    im.set_target("cpu_worker", 1)
    assert len(im.reconcile([])["failed"]) == 1
    failed = next(i for i in im.instances.values()
                  if i.status == Status.ALLOCATION_FAILED)
    assert any("create failed" in h[2] for h in failed.history)
    assert len(im.reconcile([])["launched"]) == 1
    assert len(im.instances) == 2


def test_vanished_instance_marked_failed():
    prov = FakeCloudProvider()
    im = InstanceManager(prov, NODE_TYPES)
    im.set_target("cpu_worker", 1)
    im.reconcile([])
    im.reconcile([])
    inst = next(iter(im.instances.values()))
    prov.cloud.clear()
    acts = im.reconcile([])
    assert inst.status == Status.ALLOCATION_FAILED
    assert acts["failed"] == [inst.instance_id]


def test_scale_down_prefers_not_yet_running():
    prov = FakeCloudProvider()
    im = InstanceManager(prov, NODE_TYPES)
    im.set_target("cpu_worker", 3)
    im.reconcile([])
    im.reconcile([])
    insts = list(im.instances.values())
    im.reconcile([_ray_node(insts[0].provider_id)])
    assert insts[0].status == Status.RAY_RUNNING
    im.set_target("cpu_worker", 1)
    acts = im.reconcile([_ray_node(insts[0].provider_id)])
    assert len(acts["terminated"]) == 2
    assert insts[0].status == Status.RAY_RUNNING
    im.reconcile([_ray_node(insts[0].provider_id)])
    sts = [i.status for i in im.instances.values()]
    assert sts.count(Status.TERMINATED) == 2
    assert im.summary()["cpu_worker"][Status.RAY_RUNNING] == 1


class FakeGceApi:
    def __init__(self):
        self.instances = {}

    def __call__(self, method, path, body=None):
        if method == "POST":
            assert body["machineType"].endswith("n2-standard-8")
            assert body["labels"]["ray-tpu-node-type"] == "cpu-worker"
            item = body["metadata"]["items"][0]
            assert item["key"] == "startup-script"
            assert "-m ray_tpu_torch.scripts.cli start" in item["value"]
            self.instances[body["name"]] = "PROVISIONING"
            return {}
        if method == "GET":
            return {"items": [{"name": n, "status": st}
                              for n, st in self.instances.items()]}
        if method == "DELETE":
            self.instances.pop(path.rsplit("/", 1)[1], None)
            return {}
        raise AssertionError(method)


def test_gce_vm_provider_lifecycle():
    api = FakeGceApi()
    p = GceVmNodeProvider("proj", "us-central1-a", "10.0.0.1:6379", api=api)
    name = p.create_node("cpu_worker", {"CPU": 8}, {"team": "ml"})
    assert p.non_terminated_nodes() == [name]
    api.instances[name] = "RUNNING"
    assert p.non_terminated_nodes() == [name]
    api.instances[name] = "TERMINATED"
    assert p.non_terminated_nodes() == []
    p.terminate_node(name)
    assert name not in api.instances


def test_instance_manager_with_gce_provider_end_to_end():
    api = FakeGceApi()
    p = GceVmNodeProvider("proj", "us-central1-a", "10.0.0.1:6379", api=api)
    im = InstanceManager(p, NODE_TYPES)
    im.set_target("cpu_worker", 2)
    im.reconcile([])
    assert len(api.instances) == 2
    for n in api.instances:
        api.instances[n] = "RUNNING"
    im.reconcile([])
    assert im.summary()["cpu_worker"][Status.ALLOCATED] == 2
    im.set_target("cpu_worker", 0)
    im.reconcile([])
    im.reconcile([])
    assert not api.instances
    assert im.summary()["cpu_worker"][Status.TERMINATED] == 2


# ------------------------------------- serve demand and the loop's backoff

class _RecordingProvider:
    def __init__(self):
        self.created = []

    def create_node(self, node_type, resources, labels):
        self.created.append(node_type)
        return f"prov-{len(self.created) - 1}"

    def terminate_node(self, provider_node_id):
        pass

    def non_terminated_nodes(self):
        return [f"prov-{i}" for i in range(len(self.created))]


def _head_node(pending=None):
    return [{"node_id": "head", "alive": True,
             "total": {"CPU": 1.0}, "available": {"CPU": 0.0},
             "pending_demand": list(pending or [])}]


GPU_HOST = {"gpu-host": NodeTypeConfig(resources={"CPU": 1.0, "GPU": 1.0},
                                       max_workers=4)}


def test_autoscaler_acquires_nodes_for_serve_replica_demand():
    demand = [{"CPU": 1.0, "GPU": 1.0}, {"CPU": 1.0, "GPU": 1.0}]
    a = Autoscaler(AutoscalerConfig(node_types=GPU_HOST),
                   _RecordingProvider(), nodes_fn=_head_node,
                   serve_demand_fn=lambda: demand)
    assert a.step()["launched"] == ["gpu-host", "gpu-host"]
    assert a.step()["launched"] == []


def test_serve_demand_dedupes_against_lease_demand():
    req = {"CPU": 1.0, "GPU": 1.0}
    a = Autoscaler(AutoscalerConfig(node_types=GPU_HOST),
                   _RecordingProvider(),
                   nodes_fn=lambda: _head_node(pending=[dict(req)]),
                   serve_demand_fn=lambda: [dict(req)])
    assert a.step()["launched"] == ["gpu-host"]


def test_serve_demand_failure_never_fails_step():
    def boom():
        raise RuntimeError("controller gone")
    a = Autoscaler(AutoscalerConfig(node_types={}), _RecordingProvider(),
                   nodes_fn=_head_node, serve_demand_fn=boom)
    assert a.step()["launched"] == []


def test_autoscaler_backoff_escalates_and_caps():
    a = Autoscaler(AutoscalerConfig(node_types={}, upscale_interval_s=2.0,
                                    max_backoff_s=30.0),
                   _RecordingProvider(), nodes_fn=_head_node)
    assert [a._step_delay(n) for n in (0, 1, 2, 4, 50)] == \
        [2.0, 4.0, 8.0, 30.0, 30.0]


def test_autoscaler_run_counts_failures_and_backs_off():
    from ray_tpu_torch.util import metrics as metrics_mod
    calls = []

    def bad_nodes():
        calls.append(time.monotonic())
        raise RuntimeError("gcs down")

    a = Autoscaler(AutoscalerConfig(node_types={}, upscale_interval_s=0.01,
                                    max_backoff_s=0.05),
                   _RecordingProvider(), nodes_fn=bad_nodes)

    def counter_value():
        for m in metrics_mod.registry_snapshot():
            if m["name"] == "autoscaler_step_failures":
                return sum(v for _, v in m["samples"])
        return 0.0

    before = counter_value()
    stop = threading.Event()
    th = threading.Thread(target=a.run, args=(stop,), daemon=True)
    th.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(calls) < 5:
        time.sleep(0.01)
    stop.set()
    th.join(timeout=5)
    assert len(calls) >= 5 and a._consecutive_failures >= 5
    assert counter_value() - before >= 5
    gaps = [b - a_ for a_, b in zip(calls, calls[1:])]
    assert max(gaps) >= 0.04
