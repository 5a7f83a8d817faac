"""Search spaces + variant generation (reference:
python/ray/tune/search/variant_generator.py, sample.py — grid_search,
uniform/loguniform/choice/randint, BasicVariantGenerator)."""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math
        self.lo, self.hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self.lo, self.hi))


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def uniform(low, high):
    return Uniform(low, high)


def loguniform(low, high):
    return LogUniform(low, high)


def randint(low, high):
    return RandInt(low, high)


def choice(options):
    return Choice(options)


def grid_search(values):
    return GridSearch(values)


class BasicVariantGenerator:
    """Cross product of grid axes × num_samples random draws of the rest
    (reference: BasicVariant semantics)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grids = [self.param_space[k].values for k in grid_keys]
        out = []
        for combo in itertools.product(*grids) if grids else [()]:
            for _ in range(self.num_samples):
                cfg = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                out.append(cfg)
        return out


class TPESearch:
    """Tree-structured Parzen Estimator search (reference: the Optuna /
    HyperOpt integrations in ray.tune.search — here a native, dependency-
    free TPE: observations split into good/bad by quantile; candidates
    are drawn from a Parzen model of the good points and ranked by the
    good/bad density ratio).

    Sequential interface: ``suggest()`` proposes a config, ``report()``
    feeds the observed score back.
    """

    def __init__(self, param_space: Dict[str, Any], *, metric: str = None,
                 mode: str = "min", n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min/max, got {mode!r}")
        grids = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
        if grids:
            raise ValueError(
                f"TPESearch does not support grid_search axes {grids}; "
                f"use tune.choice for categorical dimensions")
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._obs: List[tuple] = []       # (config, score)

    # ------------------------------------------------------------ model
    def _numeric_bounds(self, dom):
        if isinstance(dom, Uniform):
            return dom.low, dom.high, False
        if isinstance(dom, LogUniform):
            return dom.lo, dom.hi, True       # log-space bounds
        if isinstance(dom, RandInt):
            return dom.low, dom.high, False
        return None

    def _to_model_space(self, dom, v):
        return math.log(v) if isinstance(dom, LogUniform) else float(v)

    def _parzen_sample(self, dom, points):
        bounds = self._numeric_bounds(dom)
        if bounds is None:                 # unknown Domain subclass
            return dom.sample(self.rng)
        lo, hi, _ = bounds
        width = (hi - lo) or 1.0
        bw = width / math.sqrt(len(points) + 1)
        center = self.rng.choice(points)
        x = self.rng.gauss(center, bw)
        x = min(max(x, lo), hi)
        if isinstance(dom, LogUniform):
            return math.exp(x)
        if isinstance(dom, RandInt):
            # randrange semantics: high is exclusive
            return min(int(round(x)), int(hi) - 1)
        return x

    def _parzen_logpdf(self, dom, points, v) -> float:
        bounds = self._numeric_bounds(dom)
        if bounds is None:
            return 0.0                     # flat contribution
        lo, hi, _ = bounds
        width = (hi - lo) or 1.0
        bw = width / math.sqrt(len(points) + 1)
        x = self._to_model_space(dom, v)
        acc = 0.0
        for p in points:
            acc += math.exp(-0.5 * ((x - p) / bw) ** 2)
        return math.log(max(acc / (len(points) * bw), 1e-300))

    def _cat_prob(self, options, counts, v) -> float:
        total = sum(counts.values()) + len(options)
        return (counts.get(v, 0) + 1) / total     # Laplace smoothing

    # -------------------------------------------------------------- api
    def suggest(self) -> Dict[str, Any]:
        domains = {k: v for k, v in self.param_space.items()
                   if isinstance(v, Domain)}
        fixed = {k: v for k, v in self.param_space.items()
                 if not isinstance(v, (Domain, GridSearch))}
        if len(self._obs) < self.n_initial or not domains:
            cfg = {k: d.sample(self.rng) for k, d in domains.items()}
            return {**fixed, **cfg}

        ordered = sorted(self._obs, key=lambda o: o[1],
                         reverse=(self.mode == "max"))
        n_good = max(1, int(len(ordered) * self.gamma))
        good = [c for c, _ in ordered[:n_good]]
        bad = [c for c, _ in ordered[n_good:]] or good

        def model_points(dom, configs, key):
            return [self._to_model_space(dom, c[key]) for c in configs]

        # per-key statistics are loop-invariant: build them once
        stats: Dict[str, tuple] = {}
        for key, dom in domains.items():
            if isinstance(dom, Choice):
                g_counts: Dict[Any, int] = {}
                b_counts: Dict[Any, int] = {}
                for c in good:
                    g_counts[c[key]] = g_counts.get(c[key], 0) + 1
                for c in bad:
                    b_counts[c[key]] = b_counts.get(c[key], 0) + 1
                weights = [self._cat_prob(dom.options, g_counts, o)
                           for o in dom.options]
                stats[key] = (g_counts, b_counts, weights)
            else:
                stats[key] = (model_points(dom, good, key),
                              model_points(dom, bad, key))

        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand = dict(fixed)
            score = 0.0
            for key, dom in domains.items():
                if isinstance(dom, Choice):
                    g_counts, b_counts, weights = stats[key]
                    v = self.rng.choices(dom.options, weights=weights)[0]
                    score += math.log(
                        self._cat_prob(dom.options, g_counts, v)) \
                        - math.log(
                            self._cat_prob(dom.options, b_counts, v))
                else:
                    gp, bp = stats[key]
                    v = self._parzen_sample(dom, gp)
                    score += self._parzen_logpdf(dom, gp, v) \
                        - self._parzen_logpdf(dom, bp, v)
                cand[key] = v
            if score > best_score:
                best_cfg, best_score = cand, score
        return best_cfg

    def report(self, config: Dict[str, Any], score: float) -> None:
        if score is None or not isinstance(score, (int, float)) \
                or score != score:
            return
        self._obs.append((dict(config), float(score)))
