"""Trial schedulers (reference: python/ray/tune/schedulers/ —
FIFOScheduler, ASHA async_hyperband.py). Decisions are made per reported
result: CONTINUE or STOP."""

from __future__ import annotations

import collections
from typing import Dict, List

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"     # returned as ("EXPLOIT", source_trial_id)


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE


class ASHAScheduler:
    """Async successive halving: at each rung (grace_period * rf^k steps),
    a trial continues only if it's in the top 1/reduction_factor of
    completed rung entries (reference: schedulers/async_hyperband.py)."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_records: Dict[int, List[float]] = \
            collections.defaultdict(list)
        self._evaluated: Dict[str, set] = collections.defaultdict(set)

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        # evaluate at the first result AT OR PAST each rung (trials may
        # report on a stride that skips the exact rung value)
        for rung in self.rungs:
            if t >= rung and rung not in self._evaluated[trial_id]:
                self._evaluated[trial_id].add(rung)
                sign = 1.0 if self.mode == "max" else -1.0
                rec = self.rung_records[rung]
                rec.append(sign * score)
                rec.sort(reverse=True)
                k = max(1, len(rec) // self.rf)
                if sign * score < rec[k - 1]:
                    return STOP
        return CONTINUE


class MedianStoppingRule:
    """Stop a trial whose running-average score falls below the median of
    the other trials' running averages at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 3, min_samples_required: int = 3):
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._sums: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        self._sums[trial_id] += self.sign * score
        self._counts[trial_id] += 1
        if t < self.grace:
            return CONTINUE
        others = [self._sums[k] / self._counts[k]
                  for k in self._sums if k != trial_id]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        mine = self._sums[trial_id] / self._counts[trial_id]
        return STOP if mine < median else CONTINUE


class PopulationBasedTraining:
    """PBT (reference: schedulers/pbt.py): every perturbation_interval
    steps a bottom-quantile trial exploits a top-quantile trial — the
    controller restarts it from the source's checkpoint with a mutated
    copy of the source's config (explore)."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Dict = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        import random
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = collections.defaultdict(int)

    def on_result(self, trial_id: str, result: Dict):
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        self._scores[trial_id] = self.sign * score
        if t - self._last_perturb[trial_id] < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        pop = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(pop)
        if n < 4:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = [tid for tid, _ in pop[:k]]
        top = [tid for tid, _ in pop[-k:]]
        if trial_id in bottom:
            src = self._rng.choice(top)
            if src != trial_id:
                return (EXPLOIT, src)
        return CONTINUE

    def explore(self, config: Dict) -> Dict:
        """Mutate a copied config: resample (0.25) or scale by 0.8/1.2."""
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if self._rng.random() < 0.25:
                if callable(spec):
                    out[key] = spec()
                elif isinstance(spec, (list, tuple)):
                    out[key] = self._rng.choice(list(spec))
                elif hasattr(spec, "sample"):
                    out[key] = spec.sample(self._rng)
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(out[key], (int, float)):
                    out[key] = type(out[key])(out[key] * factor)
        return out
