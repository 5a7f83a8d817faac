"""``iter_torch_batches`` of the port's Data (``ray_tpu_torch/data/
iterator.py``) against the JAX package's ``iter_batches`` on the CPU
(counterpart of ``iter_jax_batches``'s cases in ``tests/test_data.py`` and
``tests/test_data_ingest.py``): with ``device="cpu"`` a batch holds the
JAX package's numpy batch as tensors, exactly; without a card,
``device="cuda"`` raises instead of yielding CPU tensors; with ``mesh=``
a batch is a DTensor laid out on the batch axes. The card's case, every
batch of a ``cuda`` run equal to the CPU run's, is in
``tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as rdj
import ray_tpu_torch as rt
import ray_tpu_torch.data as rdt
from tests.torch_data_cases import eager_runtime


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=2, object_store_memory=128 * 2 ** 20)
    yield
    rt.shutdown()


def _numpy_batches(rd, ds_fn, **kw):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in ds_fn(rd).iter_batches(**kw)]


def _tokens(rd):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 32000, (40, 9)).astype(np.int32)
    return rd.from_items([{"tokens": r, "i": i} for i, r in
                          enumerate(rows)], parallelism=6)


@pytest.mark.parametrize("drop_last", [True, False])
def test_iter_torch_batches_on_cpu_equal_jax_batches(runtime, drop_last):
    """Batch by batch, the port's CPU tensors hold the JAX package's numpy
    batches exactly: the token column as one (B, 9) tensor, cast to the
    dtype asked for; the tail batch kept or dropped as asked."""
    with eager_runtime(ray_tpu):
        want = _numpy_batches(rdj, _tokens, batch_size=16,
                              drop_last=drop_last)
    got = list(_tokens(rdt).iter_torch_batches(
        batch_size=16, device="cpu", drop_last=drop_last,
        dtypes={"tokens": torch.int64}, device_prefetch=3))
    assert [len(b["i"]) for b in got] == [len(b["i"]) for b in want] == \
        ([16, 16] if drop_last else [16, 16, 8])
    for g, w in zip(got, want):
        assert g["tokens"].dtype == torch.int64 and g["i"].dtype == \
            torch.int64 and g["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(g["tokens"].numpy(),
                                      np.stack(w["tokens"]))
        np.testing.assert_array_equal(g["i"].numpy(), w["i"])
    one = next(iter(rdt.range(8).iter_torch_batches(
        batch_size=4, device="cpu", dtypes=torch.float32)))
    assert one["id"].dtype == torch.float32


def test_iter_torch_batches_raises_without_a_card(runtime):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rdt.range(8).iter_torch_batches(batch_size=4)
    from ray_tpu_torch.data.split import DataIterator
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataIterator(None, 0).iter_torch_batches(batch_size=4)


def test_iter_torch_batches_error_reaches_the_consumer(runtime):
    def boom(batch):
        if batch["id"][0] >= 8:
            raise ValueError("bad block")
        return batch
    it = rdt.range(16, parallelism=2).map_batches(boom).iter_torch_batches(
        batch_size=4, device="cpu")
    with pytest.raises(Exception, match="bad block"):
        list(it)


def test_iter_torch_batches_on_a_mesh_lays_out_the_batch_axis(runtime):
    """With mesh=, a batch is a DTensor sharded on the mesh's batch axes
    (parallel.sharding.batch_sharding), holding the same values; here a
    gloo world of one rank."""
    from torch.distributed.tensor import DTensor, Shard

    from ray_tpu_torch import parallel
    parallel.init_world(device="cpu")
    try:
        mesh = parallel.make_mesh(parallel.MeshConfig(), device_type="cpu")
        batches = list(rdt.range(32, parallelism=4).iter_torch_batches(
            batch_size=8, device="cpu", mesh=mesh))
        assert len(batches) == 4
        for i, b in enumerate(batches):
            assert isinstance(b["id"], DTensor)
            assert all(isinstance(p, Shard) and p.dim == 0
                       for p in b["id"].placements if not p.is_replicate())
            assert b["id"].full_tensor().tolist() == list(range(8 * i,
                                                               8 * i + 8))
        with pytest.raises(ValueError, match="pass mesh="):
            rdt.range(4).iter_torch_batches(batch_size=2, device="cpu",
                                            sharding=(Shard(0),))
    finally:
        torch.distributed.destroy_process_group()


def test_step_profiler_counts_the_wait_on_batches(runtime):
    """The step profiler's data_wait phase is the time the loop waited on
    iter_torch_batches (``waiting_for_data``), here a read that sleeps
    0.1 s per block of one batch."""
    import time

    from ray_tpu_torch.util.profiling import StepProfiler

    def slow(batch):
        time.sleep(0.1)
        return batch
    prof = StepProfiler("data_wait_test", emit_span=False)
    batches = iter(rdt.range(12, parallelism=3).map_batches(slow)
                   .iter_torch_batches(batch_size=4, device="cpu",
                                       prefetch=1, device_prefetch=1))
    waits = []
    for _ in range(3):
        with prof.waiting_for_data():
            batch = next(batches)
        with prof.step(tokens=4) as s:
            s.data_ready()
            batch["id"].sum()
        waits.append(prof.last["data_wait_ms"])
    assert waits[0] >= 90, waits
    assert all(w >= 0 for w in waits) and prof.steps == 3
