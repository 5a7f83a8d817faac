"""Ingest on the port's Data: the actor-pool map (GPU actors too) and the
streaming split with its locality dealing, against the JAX package on
the CPU (counterparts of ``tests/test_data_ingest.py`` and
``tests/test_data_split_locality.py``; ``iter_torch_batches`` is held in
``tests/test_torch_data_iter.py``).

The port runs on its own runtime with one fake GPU; the JAX package's
results come from its eager in-process run (``tests/torch_data_cases.py``).
Results are equal exactly."""

import pytest

import ray_tpu
import ray_tpu.data as rdj
import ray_tpu_torch as rt
import ray_tpu_torch.data as rdt
from ray_tpu.data.split import _SplitCoordinator as CoordJ
from ray_tpu_torch.data.split import _SplitCoordinator as CoordT
from tests.torch_data_cases import (AddState, Submitter, WhereAmI,
                                    eager_runtime, unwrap)


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, resources={"GPU": 1},
            object_store_memory=128 * 2 ** 20)
    yield
    rt.shutdown()


def test_killed_submitter_actor_returns_its_leases(runtime):
    """The node manager takes back the leases an actor held as a task
    submitter when the actor is killed: its idle leased workers do not
    keep the node's CPUs (a dropped split coordinator once left three of
    four CPUs leased, and the next split's reads waited for ever)."""
    import time
    full = rt.cluster_resources()["CPU"]
    a = rt.remote(num_cpus=0.1)(Submitter).remote()
    assert rt.get(a.run.remote(8), timeout=60) == 28
    rt.kill(a)
    deadline = time.monotonic() + 20
    while rt.available_resources().get("CPU", 0) < full:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


def test_actor_pool_map_batches_matches_jax(runtime):
    def case(rd):
        return rd.range(64, parallelism=8).map_batches(
            lambda b: {"x": b["id"]}).map_batches(
            AddState, fn_constructor_args=(100,), concurrency=2).take_all()
    with eager_runtime(ray_tpu):
        want = case(rdj)
    got = case(rdt)
    assert got == want == [{"x": 100 + i} for i in range(64)]


def test_udf_class_with_num_gpus_runs_on_a_gpu_actor(runtime):
    rows = rdt.range(8, parallelism=2).map_batches(
        lambda b: {"x": b["id"]}).map_batches(
        WhereAmI, concurrency=1, num_gpus=1).take_all()
    assert [r["x"] for r in rows] == list(range(8))
    assert {(r["mask"], r["ids"]) for r in rows} == {("0", "0")}


def _split_rows(rd, n, equal, **kw):
    shards = rd.range(35, parallelism=5).streaming_split(n, equal=equal,
                                                         **kw)
    return [[r["id"] for r in s.iter_rows()] for s in shards]


def test_streaming_split_matches_jax(runtime):
    """equal=True: exactly equal row counts (35 rows, 2 consumers: 17
    each, one dropped); without it, disjoint and complete. Consumers read
    one after the other, as in the JAX run."""
    for equal in (True, False):
        with eager_runtime(ray_tpu):
            want = _split_rows(rdj, 2, equal)
        got = _split_rows(rdt, 2, equal)
        assert got == want
        assert not set(got[0]) & set(got[1])
        if equal:
            assert [len(r) for r in got] == [17, 17]
    assert sorted(got[0] + got[1]) == list(range(35))
    me = rt._get_worker().core.node_id
    assert sorted(sum(_split_rows(rdt, 2, False,
                                  locality_hints=[me, me]), [])) == \
        list(range(35))
    with pytest.raises(ValueError, match="one entry per consumer"):
        rdt.range(4).streaming_split(2, locality_hints=[me])


def _drain(get, coord, idx):
    out = []
    while True:
        b = coord.next(idx)
        if b is None:
            return out
        if b[0] != "__wait__":
            out.append(get(b[0]).num_rows)


@pytest.mark.parametrize("where", ["alternating", "one_node"])
def test_locality_dealing_matches_jax(runtime, monkeypatch, where):
    """With block locations stubbed, each consumer gets its node's
    blocks (alternating nodes: 4 and 4 of 8) and locality yields to row
    balance beyond its slack (every block on one node), as in the JAX
    package."""
    def run(rd, coord_cls, get):
        ds = rd.range(160 if where == "alternating" else 400,
                      parallelism=8 if where == "alternating" else 16
                      ).map_batches(lambda b: b)
        seen = {}

        def locate(self, ref):
            key = getattr(ref, "id", None) or id(ref)
            if where == "one_node":
                return "nodeA"
            return seen.setdefault(key, ["nodeA", "nodeB"][len(seen) % 2])
        monkeypatch.setattr(coord_cls, "_locate", locate)
        coord = coord_cls(ds._stages, 2, False,
                          locality_hints=["nodeA", "nodeB"])
        return _drain(get, coord, 0), _drain(get, coord, 1), \
            coord.locality_stats()
    with eager_runtime(ray_tpu):
        want = run(rdj, CoordJ, unwrap)
    got = run(rdt, CoordT, rt.get)
    assert got == want
    rows0, rows1, (hits, total) = got
    if where == "alternating":
        assert (len(rows0), len(rows1), hits, total) == (4, 4, 8, 8)
        assert sum(rows0) == sum(rows1) == 80
    else:
        assert sum(rows1) > 0 and sum(rows0) - sum(rows1) <= 125
