"""ray_tpu_torch's train executor (TorchTrainer, the worker gang, sessions,
checkpoints) against ray_tpu's on the CPU.

``CheckpointManager`` keeps, ranks and returns the same checkpoints as
the JAX package's for the same sequence of metrics; ``TorchTrainer`` with
2 CPU workers reports, checkpoints and survives a crash as
tests/test_train.py holds ``JaxTrainer`` to; and a llama-debug loop in a
train worker, from weights made by the JAX initialisers
(``params_from_jax``), gives JAX ``make_train_fns``'s per-step losses and
the port's in-process bits. One port runtime serves the file; the loops
live in the JAX-free ``tests/torch_train_cases.py``, which the workers
import."""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

import ray_tpu_torch as rt
from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel import train_step as jax_train
from ray_tpu.train import checkpoint as jax_checkpoint
from ray_tpu_torch import train
from ray_tpu_torch.models import MODEL_REGISTRY, params_from_jax
from ray_tpu_torch.train import checkpoint
from tests import torch_train_cases as cases

# (loss, acc) reported at each registration; None = the metric missing
METRICS = [(5.0, 0.1), (3.0, 0.4), (None, 0.2), (4.0, 0.9), (2.5, None),
           (6.0, 0.3)]


def _manager_trace(mod, root, **kw):
    """Register METRICS in order; after each, the kept (score, name,
    metrics), the best and the latest checkpoint's name and data."""
    mgr = mod.CheckpointManager(str(root), **kw)
    out = []
    for i, (loss, acc) in enumerate(METRICS):
        metrics = {"step": i}
        if loss is not None:
            metrics["loss"] = loss
        if acc is not None:
            metrics["acc"] = acc
        mgr.register(mod.Checkpoint.from_dict({"i": i}), metrics)
        best, latest = mgr.best_checkpoint(), mgr.latest_checkpoint()
        out.append(([(s, os.path.basename(p), m)
                     for s, p, m in mgr.checkpoints],
                    os.path.basename(best.path), best.to_dict(),
                    os.path.basename(latest.path), latest.to_dict(),
                    sorted(os.listdir(root))))
    return out


@pytest.mark.parametrize("kw", [
    dict(num_to_keep=2, score_attribute="loss", order="min"),
    dict(num_to_keep=3, score_attribute="acc", order="max"),
    dict(num_to_keep=2),
    dict()], ids=["loss_min", "acc_max", "fifo", "keep_all"])
def test_checkpoint_manager_equals_jax(tmp_path, kw):
    """Retention (top-k by score, unscored ranked last, FIFO without a
    score), best and latest: equal after every registration, on disk
    too."""
    got = _manager_trace(checkpoint, tmp_path / "port", **kw)
    want = _manager_trace(jax_checkpoint, tmp_path / "jax", **kw)
    assert got == want


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield rt
    rt.shutdown()


def test_trainer_reports_and_checkpoints(runtime, tmp_path):
    """2 workers: rank 0's reports form the history, its checkpoints are
    kept top-2 by the lowest loss, and the best is the last step's."""
    result = train.TorchTrainer(
        cases.report_loop, train_loop_config={},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(
            storage_path=str(tmp_path), name="ckpt",
            checkpoint_config=train.CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="loss",
                checkpoint_score_order="min"))).fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == 3 and result.metrics["world"] == 2
    assert result.metrics["rank"] == 0
    assert len(result.metrics_history) == 4
    assert result.checkpoint.to_dict()["model"] == 30
    assert len(os.listdir(tmp_path / "ckpt" / "checkpoints")) == 2


def test_trainer_survives_one_crash(runtime, tmp_path):
    """Rank 0 exits after step 1's report once; with max_failures=1 the
    gang restarts from the latest checkpoint and finishes."""
    marker = str(tmp_path / "crashed_once")
    result = train.TorchTrainer(
        cases.crash_loop, train_loop_config={"marker": marker},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(
            storage_path=str(tmp_path), name="restart",
            failure_config=train.FailureConfig(
                max_failures=1, restart_backoff_s=0.0))).fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == 3
    assert os.path.exists(marker)
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]


def test_slice_topology_and_datasets_name_their_items():
    """A slice topology still waits for A3c-2 and says so; datasets
    (A7a) are ported: the trainer keeps them for its workers' shards, and
    a shard is asked for only inside a training worker."""
    with pytest.raises(NotImplementedError, match="A3c-2"):
        train.backend_executor.BackendExecutor(
            train.ScalingConfig(topology="v4-32")).start()
    trainer = train.TorchTrainer(cases.report_loop, datasets={"train": [1]})
    assert trainer.datasets == {"train": [1]}
    with pytest.raises(RuntimeError, match="not inside a training worker"):
        train.get_dataset_shard()


def test_scaling_config_asks_for_gpus_and_torch_distributed():
    cfg = train.ScalingConfig(num_workers=2, use_gpu=True)
    assert cfg.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert cfg.torch_distributed_enabled()
    assert not train.ScalingConfig(num_workers=1,
                                   use_gpu=True).torch_distributed_enabled()
    assert not train.ScalingConfig(num_workers=2).torch_distributed_enabled()
    assert train.ScalingConfig(
        use_torch_distributed=True).torch_distributed_enabled()


B, L, STEPS = 2, 24, 3


def test_llama_loop_matches_jax_and_the_in_process_bits(runtime):
    """3 AdamW(1e-3) steps of llama-debug in fp32 on 3 batches (chunked
    loss, chunk 16): in a train worker, from JAX-initialised weights,
    each step's loss and grad_norm within rtol 1e-4 of JAX
    make_train_fns on a one-device mesh (tests/test_torch_train_step.py's
    bound), and bit for bit equal to the same loop run in this process
    (both on 2 threads). The worker's step profiler counted the step.
    The worker trains while JAX compiles its step."""
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"],
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               remat=False)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    init, step, _ = jax_train.make_train_fns(
        JaxLM(jcfg), optax.adamw(1e-3), mesh, batch_shape=(B, L + 1),
        loss_chunk=16)
    jstate = init(jax.random.PRNGKey(0))
    weights = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, meta.unbox(jstate.params))).items()}
    vocab = MODEL_REGISTRY["llama-debug"].vocab_size
    batches = [np.random.RandomState(s).randint(0, vocab, (B, L + 1))
               for s in range(STEPS)]
    config = {"weights": weights, "batches": batches, "threads": 2}
    fit = {}
    trainer = train.TorchTrainer(
        cases.llama_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1))
    worker = threading.Thread(target=lambda: fit.update(r=trainer.fit()))
    worker.start()
    want = []
    for tokens in batches:
        jstate, jm = step(jstate, jnp.asarray(tokens))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
    worker.join(timeout=120)
    result = fit["r"]
    assert result.error is None, result.error
    got = [(m["loss"], m["grad_norm"]) for m in result.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    threads = torch.get_num_threads()
    try:
        assert cases.llama_steps(config) == got
    finally:
        torch.set_num_threads(threads)
    assert all(m["flops"] > 0 and m["mfu"] > 0
               for m in result.metrics_history)
