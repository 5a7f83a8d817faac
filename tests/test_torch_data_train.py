"""``TorchTrainer(datasets=)`` and ``train.get_dataset_shard`` on the
port (``ray_tpu_torch/train/``), against the JAX package's rows on the
CPU (counterpart of ``tests/test_data_ingest.py::
test_trainer_dataset_ingest``): two CPU train workers each stream their
own shard of one executing Dataset through ``iter_torch_batches``, and
together read every row of the JAX package's run of the same plan once.
A worker killed mid-run is replaced with its shard pushed to the new
worker again (``restart_policy="stage"``), which reads on from where the
coordinator had got to: no row is read twice (the blocks the dead worker
had fetched but not yet read are gone with it)."""

import pytest

import ray_tpu
import ray_tpu.data as rdj
import ray_tpu_torch as rt
import ray_tpu_torch.data as rdt
from ray_tpu_torch import train
from tests.torch_data_cases import Tally, eager_runtime, ingest_loop


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, object_store_memory=128 * 2 ** 20)
    yield
    rt.shutdown()


def _plan(rd):
    return rd.range(48, parallelism=12).map_batches(
        lambda b: {"id": b["id"] * 3})


def _want():
    with eager_runtime(ray_tpu):
        return sorted(r["id"] for r in _plan(rdj).take_all())


def _fit(tmp_path, name, tally, **config):
    res = train.TorchTrainer(
        ingest_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(
            storage_path=str(tmp_path), name=name,
            failure_config=train.FailureConfig(
                max_failures=1, restart_policy="stage",
                restart_backoff_s=0.0)),
        datasets={"train": _plan(rdt)},
        dataset_config=train.DataConfig(datasets_to_split="all")).fit()
    assert res.error is None, res.error
    return rt.get(tally.get.remote(), timeout=60)


def test_two_workers_read_disjoint_complete_shards(runtime, tmp_path):
    tally = rt.remote(num_cpus=0)(Tally).options(
        name="ingest-tally").remote()
    seen = _fit(tmp_path, "ingest", tally)
    assert sorted(r for r, _, done in seen if done) == [0, 1]
    ids = {r: ids for r, ids, _ in seen}
    assert ids[0] and ids[1] and not set(ids[0]) & set(ids[1])
    assert sorted(ids[0] + ids[1]) == _want()
    rt.kill(tally)


def test_a_replaced_worker_gets_its_shard_again(runtime, tmp_path):
    tally = rt.remote(num_cpus=0)(Tally).options(
        name="ingest-tally").remote()
    seen = _fit(tmp_path, "ingest-crash", tally,
                crash_marker=str(tmp_path / "crashed"))
    dead = [ids for r, ids, done in seen if not done]
    done = {r: ids for r, ids, d in seen if d}
    assert len(dead) == 1 and dead[0] and sorted(done) == [0, 1]
    assert done[1], "the replacement read nothing of its shard"
    read = dead[0] + done[0] + done[1]
    assert len(read) == len(set(read)), "a row was read twice"
    assert set(read) <= set(_want())
    rt.kill(tally)
