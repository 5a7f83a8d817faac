"""TorchTrainer: distributed data/model-parallel training driver, Ray's
name for its PyTorch trainer and the counterpart of the JAX package's
``JaxTrainer`` (``ray_tpu/train/trainer.py``; reference shape:
python/ray/train/data_parallel_trainer.py:25 — worker group, per-worker
sessions, checkpointing, group restart on failure; fit() is
self-contained)."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.backend_executor import BackendExecutor
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (CheckpointConfig, DataConfig,
                                        FailureConfig, RunConfig,
                                        ScalingConfig)


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 dataset_config: Optional[DataConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.dataset_config = dataset_config
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        from ray_tpu_torch._private import events
        rc = self.run_config
        name = rc.name or f"train_{int(time.time())}"
        with events.record_span("train.fit", category="train",
                                run_name=name):
            return self._fit(name, rc)

    def _fit(self, name: str, rc) -> Result:
        from ray_tpu_torch._private import events
        from ray_tpu_torch.util import storage as _storage
        storage = rc.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_results")
        exp_dir = _storage.join(storage, name)
        _storage.makedirs(exp_dir)
        ckpt_cfg = rc.checkpoint_config or CheckpointConfig()
        manager = CheckpointManager(
            _storage.join(exp_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            order=ckpt_cfg.checkpoint_score_order)
        failure_cfg = rc.failure_config or FailureConfig()
        failures_left = failure_cfg.max_failures
        resume = self.resume_from_checkpoint

        history: list = []
        last_metrics: Dict[str, Any] = {}
        while True:
            executor = BackendExecutor(
                self.scaling_config,
                use_torch_distributed=(
                    self.scaling_config.torch_distributed_enabled()))
            error = None
            try:
                executor.start()
                if resume is not None:
                    executor.set_resume_checkpoint(resume)
                if self.datasets:
                    executor.setup_datasets(self.datasets,
                                            self.dataset_config)
                executor.start_training(self.train_loop,
                                        self.train_loop_config)
                while True:
                    for rank, results in enumerate(executor.poll_results()):
                        for item in results:
                            metrics = item["metrics"]
                            ckpt = item["checkpoint"]
                            if rank == 0:
                                metrics = {**metrics,
                                           "_timestamp": time.time()}
                                history.append(metrics)
                                last_metrics = metrics
                                # reported train metrics become timeline
                                # instants so loss/MFU curves line up
                                # with the runtime spans around them
                                events.record_instant(
                                    "train.report", category="train",
                                    run_name=name,
                                    **{k: v for k, v in metrics.items()
                                       if isinstance(v, (int, float))})
                                if ckpt is not None:
                                    manager.register(ckpt, metrics)
                    done, error = executor.finished()
                    if done and error is not None \
                            and failure_cfg.restart_policy == "stage" \
                            and failures_left > 0 \
                            and executor.supports_worker_replace():
                        # per-worker replace: only the dead ranks
                        # restart (fresh actor, same bundle, latest
                        # checkpoint pushed); survivors never stop
                        time.sleep(failure_cfg.restart_backoff_s)
                        latest = manager.latest_checkpoint() or resume
                        replaced = executor.replace_failed_workers(latest)
                        if replaced:
                            failures_left -= 1
                            error = None
                            continue
                        # nothing replaceable (e.g. a driver-side
                        # error): fall through to the job-level ladder
                    if done:
                        break
                    time.sleep(0.25)
                # final drain (workers may already be gone on failure)
                try:
                    for rank, results in enumerate(executor.poll_results()):
                        for item in results:
                            if rank == 0:
                                history.append(item["metrics"])
                                last_metrics = item["metrics"]
                                if item["checkpoint"] is not None:
                                    manager.register(item["checkpoint"],
                                                     item["metrics"])
                except Exception:
                    pass
            except Exception as e:
                error = e
            finally:
                executor.shutdown()

            if error is None:
                return Result(metrics=last_metrics,
                              checkpoint=manager.best_checkpoint(),
                              path=exp_dir, metrics_history=history)
            if failures_left == 0:
                return Result(metrics=last_metrics,
                              checkpoint=manager.latest_checkpoint(),
                              path=exp_dir, error=error,
                              metrics_history=history)
            failures_left -= 1
            resume = manager.latest_checkpoint() or resume
            time.sleep(failure_cfg.restart_backoff_s)
