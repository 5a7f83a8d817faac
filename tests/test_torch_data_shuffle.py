"""The port's push-based streaming shuffle (``ray_tpu_torch/data/
shuffle.py``, ``exchange.py``) against the JAX package's, on the CPU
(counterparts of ``tests/test_data_shuffle_streaming.py`` and
``tests/test_data_shuffle.py``).

The driver-side logic of both packages runs on the eager runtime of
``tests/torch_data_cases.py`` with either completion order ("fifo" hands
back the oldest map task first, "lifo" the newest): the same seed gives
the same order in both packages, exactly, whatever the order tasks
complete in. Then the port's shuffle, sort and groupby run on its own
runtime, on two nodes, and through spilling in a store smaller than the
data, each equal to the JAX package's result."""

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as rdj
import ray_tpu_torch as rt
import ray_tpu_torch.data as rdt
from ray_tpu.data import block as block_j
from ray_tpu.data import exchange as exchange_j
from ray_tpu.data import shuffle as shuffle_j
from ray_tpu_torch.data import block as block_t
from ray_tpu_torch.data import exchange as exchange_t
from ray_tpu_torch.data import shuffle as shuffle_t
from tests import torch_data_cases as cases

PKGS = {"jax": (ray_tpu, block_j, shuffle_j),
        "port": (rt, block_t, shuffle_t)}


@pytest.fixture(params=["fifo", "lifo"])
def order(request, monkeypatch):
    if request.param == "lifo":
        def lifo(refs, num_returns=1, timeout=None):
            refs = list(refs)
            return refs[-num_returns:], refs[:-num_returns]
        monkeypatch.setattr(cases, "_wait", lifo)
    return request.param


def _run(which, kind, n_blocks, rows_per, key_mod=None, **kw):
    """Rows out of ``which`` package's ShuffleStage over ``n_blocks``
    blocks of ids (and keys), with its stats."""
    pkg, block, shuffle = PKGS[which]
    with cases.eager_runtime(pkg):
        bundles = []
        for i in range(n_blocks):
            ids = np.arange(i * rows_per, (i + 1) * rows_per)
            cols = {"id": ids}
            if key_mod:
                cols["k"] = ids % key_mod
            blk = block.block_from_batch(cols)
            bundles.append((cases.Ref(blk), block.block_metadata(blk)))
        st = shuffle.ShuffleStage(kind, **kw)
        rows = [r for ref, _ in st.execute(iter(bundles))
                for r in block.block_to_rows(cases.unwrap(ref))]
    return rows, st.stats


def _both(*args, **kw):
    (got, g_st), (want, w_st) = (_run(p, *args, **kw)
                                 for p in ("port", "jax"))
    assert got == want
    for f in ("num_partitions", "map_tasks", "merge_tasks", "reduce_tasks",
              "input_blocks", "peak_live_inputs", "peak_live_partials",
              "fallback"):
        assert getattr(g_st, f) == getattr(w_st, f), f
    return got, g_st


def test_seeded_shuffle_order_equals_jax(order):
    ids, st = _both("random_shuffle", 24, 50, seed=7)
    assert sorted(r["id"] for r in ids) == list(range(1200))
    assert [r["id"] for r in ids] != list(range(1200))
    assert not st.fallback and st.map_tasks == 24
    other, _ = _run("port", "random_shuffle", 24, 50, seed=8)
    assert other != ids


def test_peak_live_refs_bounded_like_jax(order):
    rows, st = _both("random_shuffle", 64, 20, seed=1)
    assert len(rows) == 64 * 20
    assert st.peak_live_inputs <= shuffle_t.DEFAULT_MAX_MAPS
    assert st.merge_tasks > 0
    assert st.peak_live_partials <= st.num_partitions * (
        shuffle_t.DEFAULT_MAX_MAPS + 2 * shuffle_t.DEFAULT_MERGE_FACTOR)


def test_repartition_sort_groupby_equal_jax(order):
    rows, _ = _both("repartition", 10, 37, num_blocks=6)
    assert sorted(r["id"] for r in rows) == list(range(370))
    _both("sort", 16, 25, key_mod=97, key="k")
    _both("sort", 16, 25, key_mod=97, key="k", descending=True)
    rows, _ = _both("groupby_agg", 12, 40, key_mod=5, key="k",
                    aggs=[("id", "sum", "sum(id)")])
    assert {r["k"]: r["sum(id)"] for r in rows} == {
        k: sum(i for i in range(480) if i % 5 == k) for k in range(5)}


def test_small_input_fallback_and_merge_factor_equal_jax(order):
    _, st = _both("random_shuffle", 2, 30, seed=3)
    assert st.fallback
    _, st = _both("random_shuffle", 32, 10, seed=5, merge_factor=4,
                  num_partitions=4)
    assert st.merge_tasks == 4 * (32 // 4)


def test_unseeded_shuffle_permutes_afresh():
    a, _ = _run("port", "random_shuffle", 16, 40, seed=None)
    b, _ = _run("port", "random_shuffle", 16, 40, seed=None)
    assert sorted(r["id"] for r in a) == list(range(640))
    assert a != b and [r["id"] for r in a] != list(range(640))


def test_partition_functions_equal_jax():
    rng = np.random.default_rng(0)
    cols = {"id": np.arange(200), "k": rng.integers(0, 9, 200),
            "s": np.array([f"user-{i % 7}" for i in range(200)],
                          dtype=object)}
    bj, bt = block_j.block_from_batch(cols), block_t.block_from_batch(cols)
    for name, args in (("partition_random", (5, [7, 0, 3])),
                       ("partition_round_robin", (3,)),
                       ("partition_hash", ("s", 4)),
                       ("partition_hash", ("k", 4)),
                       ("partition_range", ("k", [2, 5], False)),
                       ("partition_range", ("k", [2, 5], True))):
        got = getattr(exchange_t, name)(bt, *args)
        want = getattr(exchange_j, name)(bj, *args)
        assert [p.to_pylist() for p in got] == \
            [p.to_pylist() for p in want], name
    for v in (5, np.int64(5), 5.0, "x", b"x", True, None, 2 ** 70, 1.5):
        assert exchange_t._stable_hash(v) == exchange_j._stable_hash(v)
    assert shuffle_t._derived_seed(7, 0, 3) == shuffle_j._derived_seed(7, 0, 3)
    empty = bt.slice(0, 0)
    assert block_t.concat_blocks([empty, empty]).column_names == \
        ["id", "k", "s"]


# ------------------------------------------------------- on the runtime

def _port_vs_jax(case):
    with cases.eager_runtime(ray_tpu):
        want = case(rdj)
    return case(rdt), want


def shuffle_sort_groupby(rd):
    n = 20_000
    shuffled = [r["id"] for b in rd.range(n, parallelism=8)
                .random_shuffle(seed=123).iter_batches(batch_size=5000)
                for r in ({"id": int(v)} for v in b["id"])]
    vals = np.random.default_rng(3).permutation(5000)
    ordered = [r["v"] for r in rd.from_items(
        [{"v": int(v)} for v in vals]).sort("v").take_all()]
    keys = [f"user-{i % 7}" for i in range(3000)]
    grouped = sorted((r["k"], r["sum(x)"]) for r in rd.from_items(
        [{"k": k, "x": 1.0} for k in keys], parallelism=6)
        .groupby("k").sum("x").take_all())
    return shuffled, ordered, grouped


@pytest.fixture
def two_nodes():
    from ray_tpu_torch.cluster_utils import Cluster
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2,
                                "object_store_memory": 128 * 2 ** 20})
    c.add_node(num_cpus=2, object_store_memory=128 * 2 ** 20)
    rt.init(address=c.address)
    try:
        yield c
    finally:
        rt.shutdown()
        c.shutdown()


def test_two_node_shuffle_sort_groupby_equal_jax(two_nodes):
    """On two nodes (4 CPUs, so 8 partitions as in the JAX run): the
    seeded shuffle's order, a global sort and a string-keyed groupby
    equal the JAX package's, exactly."""
    got, want = _port_vs_jax(shuffle_sort_groupby)
    assert got == want
    shuffled, ordered, grouped = got
    assert sorted(shuffled) == list(range(20_000)) and \
        shuffled != sorted(shuffled)
    assert ordered == list(range(5000))
    assert grouped == [(f"user-{i}", float(sum(
        1 for j in range(3000) if j % 7 == i))) for i in range(7)]


def test_shuffle_larger_than_the_store_completes_via_spill():
    """A seeded shuffle of ~80 MiB through a 64 MiB store: the sub-blocks
    spill and come back (no held block is lost to eviction), every row
    arrives once, in the JAX package's order, and the stage never holds
    all its input blocks."""
    rt.init(num_cpus=4, object_store_memory=64 * 2 ** 20)
    pad = b"x" * 8192

    def case(rd):
        def fatten(batch):
            return {"id": batch["id"],
                    "pad": np.array([pad] * len(batch["id"]), dtype=object)}
        ds = rd.range(10_000, parallelism=16).map_batches(fatten) \
            .random_shuffle(seed=11)
        return [int(v) for b in ds.iter_batches(batch_size=4096)
                for v in b["id"]]
    try:
        got, want = _port_vs_jax(case)
        assert got == want and sorted(got) == list(range(10_000))
        st = shuffle_t.last_shuffle_stats()
        assert not st.fallback and st.peak_live_inputs < st.input_blocks
        node = rt._get_worker().core
        import asyncio
        info = asyncio.run_coroutine_threadsafe(
            node.node_conn.call("get_node_info"), node.loop).result(60)
        assert info["store"]["spilled_objects"] > 0, info["store"]
    finally:
        rt.shutdown()
