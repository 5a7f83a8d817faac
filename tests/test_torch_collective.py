"""ray_tpu_torch.util.collective in a 2-rank world on the CPU: the
``store`` backend (host arrays through the object store and the GCS KV)
and the ``torch`` backend (``torch.distributed`` over gloo, from a
TCPStore that rank 0 publishes in the GCS KV), each rank an actor of one
port runtime. Every collective against numpy on the same seeded inputs,
exactly (a sum or product of two fp32 values is exact in any order)."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from tests import torch_train_cases as cases


@pytest.fixture(scope="module")
def ranks():
    rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        actor = rt.remote(cases.CollectiveRank)
        yield [actor.remote(), actor.remote()]
    finally:
        rt.shutdown()


@pytest.mark.parametrize("backend", ["store", "torch"])
def test_collectives_match_numpy(ranks, backend):
    got = rt.get([a.run.remote(r, backend, f"g_{backend}")
                  for r, a in enumerate(ranks)], timeout=120)
    xs = [np.random.RandomState(r).randn(5, 3).astype(np.float32)
          for r in range(2)]
    ints = [np.arange(6, dtype=np.int64).reshape(2, 3) + 10 * r
            for r in range(2)]
    want = {"allreduce_sum": xs[0] + xs[1],
            "allreduce_product": xs[0] * xs[1],
            "allreduce_min": np.minimum(xs[0], xs[1]),
            "allreduce_max": np.maximum(xs[0], xs[1]),
            "broadcast": xs[1]}
    for r, res in enumerate(got):
        assert (res["rank"], res["size"]) == (r, 2)
        for key, w in want.items():
            np.testing.assert_array_equal(res[key], w, err_msg=key)
        assert len(res["allgather"]) == 2
        for part, x in zip(res["allgather"], xs):
            np.testing.assert_array_equal(part, x)
        np.testing.assert_array_equal(
            res["reducescatter"], np.array_split(xs[0] + xs[1], 2)[r])
        np.testing.assert_array_equal(res["recv"], ints[1 - r])
        assert res["recv"].dtype == np.int64


def test_unknown_backend_raises():
    from ray_tpu_torch.util import collective
    with pytest.raises(ValueError, match="backend"):
        collective.init_collective_group(2, 0, backend="xla")
