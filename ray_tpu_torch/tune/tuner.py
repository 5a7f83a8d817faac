"""Tuner + trial-execution controller (reference: python/ray/tune/tuner.py:44
Tuner and tune/execution/tune_controller.py:68 TuneController).

Each trial runs a function trainable inside its own actor; the controller
loop starts trials as resources allow, drains their reported results,
applies scheduler decisions (ASHA early stopping kills the trial actor),
and collects a ResultGrid. Trainables call ray_tpu_torch.tune.report(...)."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch

import logging

logger = logging.getLogger(__name__)
from ray_tpu_torch.tune.schedulers import (CONTINUE, EXPLOIT, STOP,
                                           FIFOScheduler)
from ray_tpu_torch.tune.search import BasicVariantGenerator

_tune_session = None


class _TuneSession:
    def __init__(self, checkpoint=None, start_iteration: int = 0):
        self.results: List[Dict] = []
        self.lock = threading.Lock()
        self.iteration = start_iteration
        self.incoming_checkpoint = checkpoint   # restore source (PBT/resume)
        self.latest_checkpoint = checkpoint

    def report(self, metrics: Dict, checkpoint=None):
        with self.lock:
            self.iteration += 1
            if checkpoint is not None:
                self.latest_checkpoint = checkpoint
            self.results.append({**metrics,
                                 "training_iteration": self.iteration})

    def drain(self):
        with self.lock:
            out = self.results
            self.results = []
            return out


def report(metrics: Optional[Dict] = None, checkpoint=None, **kwargs):
    s = _tune_session
    if s is None:
        raise RuntimeError("tune.report() called outside a trial")
    s.report({**(metrics or {}), **kwargs}, checkpoint=checkpoint)


def get_checkpoint():
    """Inside a trial: the checkpoint this trial was (re)started from —
    set when PBT exploits another trial or on restore (reference:
    ray.tune.get_checkpoint)."""
    s = _tune_session
    return s.incoming_checkpoint if s is not None else None


class TrialActor:
    """Hosts one trial; max_concurrency=2 so poll() answers during run()."""

    def __init__(self, checkpoint=None, start_iteration: int = 0):
        global _tune_session
        _tune_session = _TuneSession(checkpoint, start_iteration)
        self._session = _tune_session

    def run(self, fn, config):
        fn(config)
        return True

    def poll(self):
        return self._session.drain()

    def get_checkpoint(self):
        return self._session.latest_checkpoint


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    history: List[Dict[str, Any]]
    error: Optional[str] = None

    @property
    def last_result(self):
        return self.metrics


class ResultGrid:
    def __init__(self, results: List[TrialResult]):
        self._results = results

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self, metric: str, mode: str = "max") -> TrialResult:
        scored = [r for r in self._results if metric in (r.metrics or {})]
        if not scored:
            raise ValueError(f"no trial reported {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else \
            min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd
        return pd.DataFrame([{**r.config, **(r.metrics or {}),
                              "trial_id": r.trial_id}
                             for r in self._results])


@dataclasses.dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    search_alg: Any = None        # sequential suggest/report (e.g. TPE)
    metric: Optional[str] = None
    mode: str = "max"
    seed: Optional[int] = None


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: Dict[str, Any],
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None,
                 resources_per_trial: Optional[Dict[str, float]] = None):
        self.trainable = trainable
        self.param_space = param_space
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config
        self.resources_per_trial = resources_per_trial or {"CPU": 1.0}

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        if tc.search_alg is not None:
            # sequential suggestion (reference: SearchAlgorithm-driven
            # trials — Optuna/HyperOpt adapters; here the native TPE):
            # configs are proposed lazily as slots free and completed
            # scores feed back into the model
            variants = None
        else:
            variants = BasicVariantGenerator(
                self.param_space, num_samples=tc.num_samples,
                seed=tc.seed).variants()
        scheduler = tc.scheduler or FIFOScheduler()
        max_conc = tc.max_concurrent_trials or max(
            1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)) - 1)

        search_metric = None
        if tc.search_alg is not None:
            search_metric = tc.metric or getattr(tc.search_alg, "metric",
                                                 None)
            if not search_metric:
                raise ValueError(
                    "search_alg requires a metric (TuneConfig.metric or "
                    "the algorithm's metric=...) — without it every "
                    "suggestion would be a blind random draw")

        def report_to_search(res: TrialResult):
            if tc.search_alg is None or res.error:
                return
            score = (res.metrics or {}).get(search_metric)
            if score is None:
                logger.warning(
                    "trial %s reported no %r metric; search model "
                    "unchanged", res.trial_id, search_metric)
                return
            tc.search_alg.report(res.config, score)

        actor_cls = ray_tpu_torch.remote(TrialActor)
        if variants is not None:
            pending = [(f"trial_{i:05d}", cfg)
                       for i, cfg in enumerate(variants)]
            budget = 0
        else:
            pending = []
            budget = tc.num_samples       # suggestions left to draw
        running: Dict[str, Dict] = {}
        done: List[TrialResult] = []

        while pending or running or budget > 0:
            while budget > 0 and len(pending) + len(running) < max_conc:
                pending.append((f"trial_{tc.num_samples - budget:05d}",
                                tc.search_alg.suggest()))
                budget -= 1
            while pending and len(running) < max_conc:
                trial_id, cfg = pending.pop(0)
                actor = actor_cls.options(
                    max_concurrency=2,
                    resources=dict(self.resources_per_trial)).remote()
                run_ref = actor.run.remote(self.trainable, cfg)
                running[trial_id] = {"actor": actor, "config": cfg,
                                     "run_ref": run_ref, "history": [],
                                     "stopped": False}

            def restart_trial(trial_id, t, new_config, checkpoint):
                """PBT exploit: replace the trial's actor, resuming from
                `checkpoint` with the mutated config."""
                try:
                    ray_tpu_torch.kill(t["actor"])
                except Exception:
                    pass
                it = t["history"][-1]["training_iteration"] \
                    if t["history"] else 0
                actor = actor_cls.options(
                    max_concurrency=2,
                    resources=dict(self.resources_per_trial)).remote(
                        checkpoint=checkpoint, start_iteration=it)
                t["actor"] = actor
                t["config"] = new_config
                t["run_ref"] = actor.run.remote(self.trainable, new_config)
            time.sleep(0.15)
            for trial_id, t in list(running.items()):
                try:
                    results = ray_tpu_torch.get(t["actor"].poll.remote(),
                                          timeout=30)
                except Exception:
                    results = []
                decision = CONTINUE
                for r in results:
                    t["history"].append(r)
                    d = scheduler.on_result(trial_id, r)
                    if d == STOP:
                        decision = STOP
                    elif isinstance(d, tuple) and d and d[0] == EXPLOIT:
                        decision = d
                if (isinstance(decision, tuple) and decision[0] == EXPLOIT
                        and decision[1] in running):
                    src = running[decision[1]]
                    try:
                        ckpt = ray_tpu_torch.get(
                            src["actor"].get_checkpoint.remote(), timeout=30)
                    except Exception:
                        ckpt = None
                    new_cfg = scheduler.explore(dict(src["config"])) \
                        if hasattr(scheduler, "explore") \
                        else dict(src["config"])
                    restart_trial(trial_id, t, new_cfg, ckpt)
                    continue
                if decision == STOP and not t["stopped"]:
                    t["stopped"] = True
                    ray_tpu_torch.kill(t["actor"])
                    res = self._finish(trial_id, t, None)
                    report_to_search(res)
                    done.append(res)
                    del running[trial_id]
                    continue
                ready, _ = ray_tpu_torch.wait([t["run_ref"]], timeout=0)
                if ready:
                    err = None
                    try:
                        ray_tpu_torch.get(t["run_ref"], timeout=5)
                    except Exception as e:
                        err = str(e)
                    # final drain
                    try:
                        for r in ray_tpu_torch.get(t["actor"].poll.remote(),
                                             timeout=10):
                            t["history"].append(r)
                    except Exception:
                        pass
                    # release the trial's CPU reservation promptly — GC of
                    # the handle would get there eventually, but later
                    # trials in this fit() need the slot now
                    try:
                        ray_tpu_torch.kill(t["actor"])
                    except Exception:
                        pass
                    res = self._finish(trial_id, t, err)
                    report_to_search(res)
                    done.append(res)
                    del running[trial_id]
        return ResultGrid(done)

    def _finish(self, trial_id, t, err) -> TrialResult:
        hist = t["history"]
        return TrialResult(trial_id=trial_id, config=t["config"],
                           metrics=hist[-1] if hist else {},
                           history=hist, error=err)
