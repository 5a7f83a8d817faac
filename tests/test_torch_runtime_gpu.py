"""GPUs as the port's accelerator (ray_tpu_torch/_private/accelerators/gpu.py
and the node manager's GPU pool), on the CPU with fake GPUs
(RAY_TPU_TORCH_FAKE_GPUS=2):

- detection order (CUDA_VISIBLE_DEVICES, the driver's /proc entries,
  nvidia-smi, the fake count) and the request rules: a fraction below 1,
  a whole number above it, never 1.5;
- whole and fractional assignment, fractions packed onto one id until
  they add up to 1, and a whole request that waits until they are gone;
- CUDA_VISIBLE_DEVICES inside tasks and actors (an actor's is set before
  its constructor runs), and unchanged for a task without GPUs after
  them: a worker serves only the mask it was spawned with;
- ids returned when an actor is killed;
- "TPU" as a plain custom resource;
- one GPU on each node of a local multi-node cluster.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.accelerators import (GPUAcceleratorManager,
                                                 GpuIdPool, detect_gpu_ids)


def test_gpu_ids_per_node_on_a_local_multi_node_cluster():
    """cluster_utils.Cluster: two node managers on this machine, one fake
    GPU each (first in the file: it runs before the module's cluster
    starts). Two num_gpus=1 tasks at once land on both nodes, each with
    its node's id 0."""
    from ray_tpu_torch.cluster_utils import Cluster
    c = Cluster(head_node_args={"num_cpus": 1, "resources": {"GPU": 1}})
    try:
        c.add_node(num_cpus=1, resources={"GPU": 1})
        rt.init(address=c.address)
        try:
            c.wait_for_nodes()
            assert rt.cluster_resources()["GPU"] == 2.0

            @rt.remote(num_gpus=1)
            def where():
                time.sleep(0.5)          # both tasks in flight at once
                return (rt.get_runtime_context()["node_id"],
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

            got = rt.get([where.remote() for _ in range(2)], timeout=60)
            assert [m for _, m in got] == ["0", "0"]
            assert len({n for n, _ in got}) == 2
        finally:
            rt.shutdown()
    finally:
        c.shutdown()


@pytest.fixture(scope="module")
def cluster():
    saved = {k: os.environ.get(k) for k in ("RAY_TPU_TORCH_FAKE_GPUS",
                                            "CUDA_VISIBLE_DEVICES")}
    os.environ["RAY_TPU_TORCH_FAKE_GPUS"] = "2"
    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    try:
        ctx = rt.init(num_cpus=4, resources={"TPU": 4.0},
                      object_store_memory=64 * 1024 * 1024)
        try:
            yield ctx
        finally:
            rt.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@rt.remote(num_gpus=1)
def _one_gpu():
    return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


@rt.remote(num_gpus=2)
def _two_gpus():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def _no_gpu():
    return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


@rt.remote(num_gpus=0.5)
class _Half:
    def __init__(self):
        self.at_init = os.environ.get("CUDA_VISIBLE_DEVICES")

    def seen(self):
        return self.at_init, os.environ.get("CUDA_VISIBLE_DEVICES")


def test_detection_order(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_FAKE_GPUS", "3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert detect_gpu_ids() == ["2", "5"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    # no driver entries and no nvidia-smi on this machine: the fake count
    assert detect_gpu_ids() == ["0", "1", "2"]


@pytest.mark.parametrize("quantity,ok", [(0.25, True), (0.5, True),
                                         (1, True), (2, True),
                                         (1.5, False), (2.5, False)])
def test_request_quantity_rule(quantity, ok):
    assert GPUAcceleratorManager.validate_resource_request_quantity(
        quantity)[0] is ok


def test_pool_packs_fractions_and_returns_ids():
    pool = GpuIdPool(["0", "1"])
    tenths = [pool.allocate(0.1) for _ in range(10)]
    assert {GpuIdPool.ids_of(c)[0] for c in tenths} == {"0"}
    assert pool.free["0"] == 0              # ten tenths add up to 1 exactly
    assert GpuIdPool.ids_of(pool.allocate(1)) == ["1"]
    assert not pool.fits(0.1)
    pool.release(tenths[0])
    assert pool.fits(0.1) and not pool.fits(1)
    for c in tenths[1:]:
        pool.release(c)
    assert pool.fits(1)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.allocate(2)


def test_whole_gpus_and_masks(cluster):
    assert rt.cluster_resources()["GPU"] == 2.0
    got = rt.get([_one_gpu.remote() for _ in range(4)])
    assert {mask for mask, _ in got} <= {"0", "1"}
    assert rt.get(_two_gpus.remote()) == "0,1"
    # a task without GPUs keeps the node's visibility, on a worker that
    # never held a mask
    mask, pid = rt.get(_no_gpu.remote())
    assert mask is None and pid not in {p for _, p in got}


def test_fractions_share_an_id_and_whole_waits(cluster):
    a, b = _Half.remote(), _Half.remote()
    seen = rt.get([a.seen.remote(), b.seen.remote()])
    # packed onto one id, the mask set before each constructor ran
    assert seen[0] == seen[1] == ("0", "0")
    c = _Half.remote()
    assert rt.get(c.seen.remote()) == ("1", "1")
    ref = _one_gpu.remote()             # id 0 full, id 1 half-used
    ready, _ = rt.wait([ref], timeout=1.5)
    assert not ready
    rt.kill(a)
    rt.kill(b)
    mask, _ = rt.get(ref, timeout=30)
    assert mask == "0"
    rt.kill(c)


def test_ids_return_when_an_actor_is_killed(cluster):
    actors = [_Half.remote() for _ in range(4)]
    rt.get([h.seen.remote() for h in actors])
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    for h in actors:
        rt.kill(h)
    deadline = time.monotonic() + 20
    while rt.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)
    assert rt.get(_two_gpus.remote(), timeout=30) == "0,1"


def test_refuses_one_and_a_half(cluster):
    with pytest.raises(ValueError, match="whole number"):
        _one_gpu.options(num_gpus=1.5).remote()


def test_tpu_is_a_plain_resource(cluster):
    assert rt.cluster_resources()["TPU"] == 4.0

    @rt.remote(num_tpus=1.5)     # fractional, no ids, no visibility
    def tpu_task():
        return (os.environ.get("TPU_VISIBLE_CHIPS"),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    assert rt.get(tpu_task.remote()) == (None, None)
