"""Tune on the port (ray_tpu_torch/tune): the eight cases of
tests/test_tune.py, run on the port's runtime, and plain-Python parity
with the JAX package's tune, with no runtime: for the same seeds the
grid, random and TPE draws equal the JAX package's, and on the same
result streams ASHA, MedianStoppingRule and PBT (its exploit decisions
and explored configs) decide as the JAX package's do."""

import random
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune import ASHAScheduler, TuneConfig, Tuner, grid_search


@pytest.fixture(scope="module")
def ray_start():
    ctx = rt.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
    yield ctx
    rt.shutdown()


def test_grid_search(ray_start):
    def trainable(config):
        tune.report(score=config["a"] * 10 + config["b"])

    tuner = Tuner(trainable,
                  param_space={"a": grid_search([1, 2, 3]),
                               "b": grid_search([0, 5])})
    results = tuner.fit()
    assert len(results) == 6
    best = results.get_best_result("score", mode="max")
    assert best.config == {"a": 3, "b": 5}
    assert best.metrics["score"] == 35


def test_random_search(ray_start):
    def trainable(config):
        tune.report(val=config["x"])

    tuner = Tuner(trainable,
                  param_space={"x": tune.uniform(0, 1)},
                  tune_config=TuneConfig(num_samples=5, seed=42))
    results = tuner.fit()
    assert len(results) == 5
    vals = [r.metrics["val"] for r in results]
    assert all(0 <= v <= 1 for v in vals)
    assert len(set(vals)) == 5


def test_asha_scheduler_unit():
    """Deterministic halving semantics, incl. reports that stride past
    rung values (first-result-at-or-past-rung evaluation)."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
    sched = ASHAScheduler(metric="acc", mode="max", max_t=100,
                          grace_period=4, reduction_factor=2)
    assert sched.on_result("good1", {"training_iteration": 4,
                                     "acc": 10.0}) == CONTINUE
    assert sched.on_result("good2", {"training_iteration": 4,
                                     "acc": 11.0}) == CONTINUE
    assert sched.on_result("bad", {"training_iteration": 3,
                                   "acc": 0.1}) == CONTINUE
    assert sched.on_result("bad", {"training_iteration": 6,
                                   "acc": 0.2}) == STOP
    assert sched.on_result("good1", {"training_iteration": 100,
                                     "acc": 99.0}) == STOP


def test_asha_integration(ray_start):
    def trainable(config):
        for step in range(20):
            tune.report(acc=config["lr"] * (step + 1))
            time.sleep(0.05)

    tuner = Tuner(
        trainable,
        param_space={"lr": grid_search([0.01, 0.02, 1.0, 2.0])},
        tune_config=TuneConfig(
            scheduler=ASHAScheduler(metric="acc", mode="max", max_t=20,
                                    grace_period=4, reduction_factor=2)))
    results = tuner.fit()
    assert len(results) == 4
    best = results.get_best_result("acc", mode="max")
    assert best.config["lr"] == 2.0


def test_trial_error_captured(ray_start):
    def trainable(config):
        if config["boom"]:
            raise RuntimeError("exploded")
        tune.report(ok=1)

    tuner = Tuner(trainable,
                  param_space={"boom": grid_search([False, True])})
    results = tuner.fit()
    errs = [r for r in results if r.error]
    oks = [r for r in results if not r.error]
    assert len(errs) == 1 and "exploded" in errs[0].error
    assert len(oks) == 1 and oks[0].metrics["ok"] == 1


def test_median_stopping_rule(ray_start):
    """Bad trials stop early under the median rule."""
    from ray_tpu_torch.tune import MedianStoppingRule

    def trainable(config):
        import time as _t
        for i in range(12):
            tune.report({"score": config["quality"] * (i + 1)})
            _t.sleep(0.05)

    tuner = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([0.1, 0.2, 1.0, 2.0])},
        tune_config=tune.TuneConfig(
            scheduler=MedianStoppingRule(metric="score", grace_period=3),
            max_concurrent_trials=4),
    )
    grid = tuner.fit()
    best = grid.get_best_result("score")
    assert best.config["quality"] == 2.0
    shortest = min(len(r.history) for r in grid)
    assert shortest < 12


def test_pbt_exploit_and_checkpoint(ray_start):
    """A weak PBT trial adopts a strong trial's checkpointed weight and a
    mutated config."""
    from ray_tpu_torch.tune import PopulationBasedTraining

    def trainable(config):
        import time as _t
        ckpt = tune.get_checkpoint()
        weight = ckpt["weight"] if ckpt else 0.0
        for _ in range(20):
            weight += config["lr"]
            tune.report({"score": weight}, checkpoint={"weight": weight})
            _t.sleep(0.25)

    pbt = PopulationBasedTraining(
        metric="score", perturbation_interval=4, quantile_fraction=0.5,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0]})
    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.01, 0.02, 1.0, 2.0])},
        tune_config=tune.TuneConfig(scheduler=pbt,
                                    max_concurrent_trials=4),
    )
    grid = tuner.fit()
    best = grid.get_best_result("score")
    assert best.metrics["score"] > 10.0
    final_scores = sorted(r.metrics.get("score", 0.0) for r in grid)
    assert final_scores[0] > 1.0, final_scores


def test_tpe_search(ray_start):
    """Native TPE beats its own random warmup on a smooth objective."""
    from ray_tpu_torch.tune.search import TPESearch

    def objective(config):
        x = config["x"]
        bonus = 0.0 if config["kind"] == "good" else 2.0
        tune.report({"loss": (x - 3.0) ** 2 + bonus})

    space = {"x": tune.uniform(-10.0, 10.0),
             "kind": tune.choice(["good", "bad"])}
    alg = TPESearch(space, metric="loss", mode="min", n_initial=8, seed=7)
    tuner = tune.Tuner(
        objective, param_space=space,
        tune_config=tune.TuneConfig(num_samples=32, metric="loss",
                                    mode="min", search_alg=alg,
                                    max_concurrent_trials=2))
    grid = tuner.fit()
    best = grid.get_best_result(metric="loss", mode="min")
    assert best.metrics["loss"] < 1.0, best.metrics
    assert best.config["kind"] == "good"
    ordered = sorted(grid, key=lambda r: r.trial_id)
    warmup = ordered[:8]
    suggested = ordered[8:]
    best_warm = min(r.metrics["loss"] for r in warmup if r.metrics)
    best_sugg = min(r.metrics["loss"] for r in suggested if r.metrics)
    assert best_sugg <= best_warm + 1e-9


def test_client_mode_refused_beside_a_runtime(ray_start):
    """A process that holds a runtime cannot become a client."""
    with pytest.raises(RuntimeError, match="already called"):
        rt.init("ray://127.0.0.1:1")


# ------------------------------------------------ parity with the JAX package

def _spaces(jt, pt):
    """The same search space in each package's domains."""
    def space(t):
        return {"a": t.grid_search([1, 2, 3]), "x": t.uniform(-1.0, 2.0),
                "lr": t.loguniform(1e-5, 1e-1), "n": t.randint(2, 9),
                "kind": t.choice(["x", "y", "z"]), "fixed": 7}
    return space(jt), space(pt)


@pytest.mark.parametrize("seed", [0, 42])
def test_variant_draws_equal_jax(seed):
    from ray_tpu.tune import search as jsearch

    import ray_tpu.tune as jtune
    from ray_tpu_torch.tune import search as psearch
    js, ps = _spaces(jtune, tune)
    want = jsearch.BasicVariantGenerator(js, num_samples=4,
                                         seed=seed).variants()
    got = psearch.BasicVariantGenerator(ps, num_samples=4,
                                        seed=seed).variants()
    assert len(got) == 12 and got == want


def test_tpe_suggestions_equal_jax():
    """40 suggest/report rounds (8 random, then the Parzen model) on one
    objective: every suggestion equals the JAX package's."""
    from ray_tpu.tune.search import TPESearch as JaxTPE

    import ray_tpu.tune as jtune
    from ray_tpu_torch.tune.search import TPESearch

    def space(t):
        return {"x": t.uniform(-10.0, 10.0), "lr": t.loguniform(1e-4, 1.0),
                "n": t.randint(1, 6), "kind": t.choice(["good", "bad"]),
                "fixed": 3}
    algs = (JaxTPE(space(jtune), metric="loss", mode="min", seed=7),
            TPESearch(space(tune), metric="loss", mode="min", seed=7))
    for _ in range(40):
        cfgs = [a.suggest() for a in algs]
        assert cfgs[0] == cfgs[1]
        c = cfgs[0]
        loss = (c["x"] - 3.0) ** 2 + abs(c["lr"] - 0.01) + c["n"] \
            + (0.0 if c["kind"] == "good" else 2.0)
        for a in algs:
            a.report(c, loss)


def _stream(n_trials, steps, seed, metric):
    """Interleaved reports of n_trials trials (random arrival order,
    some trials stride over steps), with noisy scores."""
    rng = random.Random(seed)
    quality = {f"t{i}": rng.uniform(0.1, 2.0) for i in range(n_trials)}
    t = {k: 0 for k in quality}
    out = []
    while any(v < steps for v in t.values()):
        tid = rng.choice([k for k, v in t.items() if v < steps])
        t[tid] += rng.choice([1, 1, 1, 2])
        out.append((tid, {"training_iteration": t[tid],
                          metric: quality[tid] * t[tid]
                          + rng.gauss(0.0, 0.3)}))
    return out


def _decisions(sched, stream):
    return [sched.on_result(tid, r) for tid, r in stream]


@pytest.mark.parametrize("mode", ["max", "min"])
def test_scheduler_decisions_equal_jax(mode):
    """On the same result streams ASHA and MedianStoppingRule make the
    JAX package's decisions, and PBT its exploits and explored configs
    (its random draws seeded alike)."""
    import ray_tpu.tune as jtune
    from ray_tpu.tune import schedulers as js

    from ray_tpu_torch.tune import schedulers as ps
    for seed in range(3):
        stream = _stream(8, 20, seed, "score")
        for make in (
                lambda m: m.ASHAScheduler(metric="score", mode=mode,
                                          max_t=16, grace_period=2,
                                          reduction_factor=2),
                lambda m: m.MedianStoppingRule(metric="score", mode=mode,
                                               grace_period=3),
                lambda m: m.PopulationBasedTraining(
                    metric="score", mode=mode, perturbation_interval=3,
                    quantile_fraction=0.25, seed=seed,
                    hyperparam_mutations={"lr": [0.1, 0.5, 1.0]})):
            want = _decisions(make(js), stream)
            got = _decisions(make(ps), stream)
            assert got == want
            # each stream makes the scheduler stop or exploit some trials
            assert any(d != ps.CONTINUE for d in got)
        muts = [{"lr": [0.1, 0.5, 1.0], "wd": t.uniform(0.0, 0.1)}
                for t in (jtune, tune)]
        jp, pp = (m.PopulationBasedTraining(metric="score", mode=mode,
                                            seed=seed,
                                            hyperparam_mutations=mu)
                  for m, mu in zip((js, ps), muts))
        cfg = {"lr": 0.5, "wd": 0.01, "other": 3}
        assert [jp.explore(cfg) for _ in range(20)] == \
            [pp.explore(cfg) for _ in range(20)]
