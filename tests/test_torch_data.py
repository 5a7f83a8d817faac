"""The port's Data (``ray_tpu_torch/data``) against the JAX package's
(``ray_tpu/data``) on the CPU: lazy plans, transforms, fusion, limit
pushdown, all-to-all reshapes, groupby and aggregates, column ops,
preprocessors and writes (counterparts of ``tests/test_data.py`` and
``tests/test_data_fusion.py``).

Each case builds the same plan from the same inputs in both packages: the
port runs it on its own runtime (tasks in worker processes, blocks in the
shm store), the JAX package on the eager in-process runtime of
``tests/torch_data_cases.py``. Results are equal exactly (rows, their
order where the plan fixes one, fitted statistics), except the float
aggregates named below."""

import json
import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as rdj
import ray_tpu_torch as rt
import ray_tpu_torch.data as rdt
from ray_tpu.data import execution as exe_j
from ray_tpu_torch.data import execution as exe_t
from tests.torch_data_cases import eager_runtime


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, object_store_memory=256 * 2 ** 20)
    yield
    rt.shutdown()


def _rows(seed=0, n=60):
    rng = np.random.default_rng(seed)
    return [{"k": int(rng.integers(0, 5)), "v": float(rng.normal()),
             "i": i} for i in range(n)]


def _both(case, *args):
    with eager_runtime(ray_tpu):
        want = case(rdj, *args)
    return case(rdt, *args), want


def case_range_count(rd):
    ds = rd.range(1000, parallelism=4)
    return ds.count(), ds.num_blocks()


def case_map_batches(rd):
    return rd.range(100, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 2}).take_all()


def case_map_filter_flat_map(rd):
    return rd.range(20, parallelism=2) \
        .map(lambda r: {"v": r["id"] + 1}) \
        .filter(lambda r: r["v"] % 2 == 0) \
        .flat_map(lambda r: [{"v": r["v"]}, {"v": -r["v"]}]).take_all()


def case_from_items_limit_take(rd):
    ds = rd.from_items(_rows(), parallelism=5)
    return ds.limit(7).take_all(), ds.take(3), ds.count()


def case_repartition(rd):
    ds = rd.range(100, parallelism=2).repartition(10)
    return ds.num_blocks(), [r["id"] for r in ds.take_all()]


def case_random_shuffle(rd):
    return [r["id"] for r in
            rd.range(400, parallelism=8).random_shuffle(seed=3).take_all()]


def case_sort(rd):
    ds = rd.from_items(_rows(1, 80), parallelism=6)
    return [(r["k"], r["i"]) for r in ds.sort("i", descending=True)
            .take_all()], [r["k"] for r in ds.sort("k").take_all()]


def case_iter_batches(rd):
    return [b["id"].tolist() for b in
            rd.range(100, parallelism=7).iter_batches(batch_size=32,
                                                      drop_last=False)]


def case_split(rd):
    return [s.take_all() for s in rd.range(90, parallelism=6).split(3)]


def case_groupby(rd):
    ds = rd.from_items(_rows(2), parallelism=4)
    g = ds.groupby("k")
    out = {}
    for agg in ("count", "sum", "mean", "min", "max", "std"):
        res = g.count() if agg == "count" else getattr(g, agg)("v")
        out[agg] = sorted(tuple(r.values()) for r in res.take_all())
    return out


def case_map_groups(rd):
    ds = rd.from_items(_rows(3), parallelism=3)
    return sorted(r["i"] for r in
                  ds.groupby("k").map_groups(lambda df: df.nlargest(
                      2, "v")).take_all())


def case_column_ops(rd):
    ds = rd.from_items([{"a": i, "b": 2 * i} for i in range(10)])
    ds2 = ds.add_column("c", lambda df: df["a"] + df["b"])
    ds3 = ds2.drop_columns(["b"]).rename_columns({"c": "total"})
    return (ds2.sort("a").take_all(), ds3.take_all(), ds2.max("c"),
            ds2.min("c"), ds2.sum("a"), ds2.mean("b"), ds2.std("b"),
            ds.unique("a"), ds.select_columns(["b"]).take(2))


def case_random_split_zip(rd):
    a, b = rd.range(20).random_split([0.5, 0.5], seed=0)
    z = rd.range(5).zip(rd.from_items([{"id": i * 10} for i in range(5)]))
    return a.take_all(), b.take_all(), z.take_all()


def case_union_materialize(rd):
    ds = rd.range(10, parallelism=2).union(rd.range(5, parallelism=1))
    m = ds.map(lambda r: {"id": r["id"] + 1}).materialize()
    return m.take_all(), m.count(), m.num_blocks()


def case_preprocessors(rd):
    from importlib import import_module
    pp = import_module(rd.__name__ + ".preprocessors")
    ds = rd.from_items([{"x": float(i) ** 1.5, "cat": ["a", "b", "c"][i % 3],
                         "label": ["lo", "hi"][i // 5]} for i in range(10)])
    std = pp.StandardScaler(["x"]).fit(ds)
    mm = pp.MinMaxScaler(["x"]).fit(ds)
    le = pp.LabelEncoder("label").fit(ds)
    oh = pp.OneHotEncoder(["cat"]).fit(ds)
    chain = pp.Chain(pp.StandardScaler(["x"]), pp.LabelEncoder("label"))
    out = {"std": std.stats, "minmax": mm.stats, "labels": le.mapping,
           "cats": oh.categories}
    for name, p in (("std_rows", std), ("minmax_rows", mm),
                    ("label_rows", le), ("onehot_rows", oh),
                    ("chain_rows", chain.fit(ds))):
        out[name] = p.transform(ds).take_all()
    out["concat"] = [list(r["features"]) for r in
                     pp.Concatenator(["x", "label"]).fit_transform(
                         le.transform(ds)).take_all()]
    return out


def case_tensor_columns(rd):
    """map_batches returning arrays of rank 2 and 3: the rows, the numpy
    batches and the sort by a scalar column read back as in the JAX
    package (whose blocks hold such columns as lists of lists)."""
    def expand(b):
        i = b["id"]
        return {"id": i, "m": np.stack([i, i * 2], 1).astype(np.int32),
                "t": np.arange(len(i) * 6, dtype=np.float64).reshape(
                    len(i), 2, 3) + i[:, None, None]}
    def deep(x):
        if isinstance(x, np.ndarray):
            return [deep(e) for e in x] if x.dtype == object \
                else x.tolist()
        return x
    ds = rd.range(12, parallelism=3).map_batches(expand)
    return (ds.take_all(), [{k: deep(v) for k, v in b.items()}
                            for b in ds.iter_batches(batch_size=5)],
            ds.sort("id", descending=True).take(2))


CASES = {f.__name__[5:]: f for f in (
    case_tensor_columns,
    case_range_count, case_map_batches, case_map_filter_flat_map,
    case_from_items_limit_take, case_repartition, case_random_shuffle,
    case_sort, case_iter_batches, case_split, case_groupby,
    case_map_groups, case_column_ops, case_random_split_zip,
    case_union_materialize, case_preprocessors)}


def _close(a, b):
    """Exact, except a float to 1e-12 relative: arrow's threaded hash
    aggregate (groupby's sum, mean and std) sums a group's values in an
    order that varies from run to run, in one package as in the other;
    every other case is exact."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax(runtime, name):
    got, want = _both(CASES[name])
    assert _close(got, want), (got, want)


def test_shuffle_is_a_permutation_that_moves_rows(runtime):
    got, want = _both(case_random_shuffle)
    assert sorted(got) == list(range(400)) and got != sorted(got)
    other = [r["id"] for r in rdt.range(400, parallelism=8)
             .random_shuffle(seed=4).take_all()]
    assert other != got


def test_writes_round_trip_like_jax(runtime, tmp_path):
    """write_parquet/csv/json write one file per block; each package reads
    back what the other wrote, equal to its own."""
    def write(rd, root):
        ds = rd.range(64, parallelism=4).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        for fmt in ("parquet", "csv", "json"):
            getattr(ds, f"write_{fmt}")(str(root / fmt))
    with eager_runtime(ray_tpu):
        write(rdj, tmp_path / "jax")
    write(rdt, tmp_path / "port")
    for fmt in ("parquet", "csv", "json"):
        names = {d: sorted(os.listdir(tmp_path / d / fmt))
                 for d in ("jax", "port")}
        assert names["jax"] == names["port"] and len(names["port"]) == 4
        for d in ("jax", "port"):
            rows = getattr(rdt, f"read_{fmt}")(
                str(tmp_path / d / fmt)).take_all()
            assert sorted((r["id"], r["sq"]) for r in rows) == \
                [(i, i * i) for i in range(64)]
    lines = [json.loads(x) for x in
             open(tmp_path / "port" / "json" / "part-00000.json")]
    assert lines[0] == {"id": 0, "sq": 0}


# ------------------------------------------------------------ fusion rules

def _kinds(plan):
    return [type(s).__name__ for s in plan]


def test_fusion_and_limit_pushdown_plans_match_jax():
    for exe in (exe_j, exe_t):
        a = exe.MapStage("map", lambda r: r)
        b = exe.MapStage("filter", lambda r: True)
        c = exe.AllToAllStage("repartition", num_blocks=2)
        d = exe.MapStage("map_batches", lambda x: x)
        plan = exe.optimize_plan([exe.InputStage([]), a, b, c, d])
        assert _kinds(plan) == ["InputStage", "MapStage", "AllToAllStage",
                                "MapStage"]
        assert plan[1].name == "Map(map->filter)"
        pool = exe.ActorPoolMapStage.__new__(exe.ActorPoolMapStage)
        assert len(exe.optimize_plan([a, pool, b])) == 3
        plan = exe.optimize_plan([exe.InputStage([]),
                                  exe.MapStage("map", lambda r: r),
                                  exe.LimitStage(50)])
        assert _kinds(plan) == ["InputStage", "LimitStage", "MapStage",
                                "LimitStage"]
        plan = exe.optimize_plan([exe.MapStage("filter", lambda r: True),
                                  exe.LimitStage(5)])
        assert _kinds(plan) == ["MapStage", "LimitStage"]


def test_fused_maps_one_task_per_block_and_stats(runtime):
    ds = rdt.range(400, parallelism=4) \
        .map(lambda r: {"id": r["id"], "x": r["id"] * 2}) \
        .filter(lambda r: r["x"] % 4 == 0)
    assert len(ds.take_all()) == 200
    lines = [ln for ln in ds.stats().splitlines() if "Map(" in ln]
    assert len(lines) == 1 and "Map(map->filter)" in lines[0]
    assert "4 tasks" in lines[0], lines
    s = rdt.range(100, parallelism=2).map_batches(lambda b: b)
    s.take_all()
    assert "Read" in s.stats() and "100 rows" in s.stats()


def test_limit_pushdown_maps_only_what_it_keeps(runtime):
    ds = rdt.range(10_000, parallelism=8) \
        .map(lambda r: {"v": r["id"] * 2}).limit(50)
    assert [r["v"] for r in ds.take_all()] == [i * 2 for i in range(50)]
    map_line = next(ln for ln in ds.stats().splitlines() if "Map(" in ln)
    assert " 50 rows" in map_line, ds.stats()


def test_generator_udf_streams_and_fuses_like_jax(runtime):
    def case(rd):
        def expand(batch):
            for k in range(3):
                yield {"id": batch["id"] * 10 + k}
        ds = rd.range(40, parallelism=4).map_batches(expand) \
            .map(lambda r: {"v": r["id"] * 2})
        return ds.take_all(), ds.num_blocks()
    got, want = _both(case)
    assert got == want and got[1] == 12


def test_budget_bounds_in_flight_tasks(runtime, monkeypatch):
    """The backpressure budget: max_tasks plus at most one forced launch
    per stage, as in the JAX package."""
    budget = exe_t.ExecutionBudget(max_tasks=3)
    peak = [0]
    orig = exe_t.ExecutionBudget.try_acquire

    def spy(self, est, force=False):
        ok = orig(self, est, force=force)
        peak[0] = max(peak[0], self.tasks)
        return ok

    monkeypatch.setattr(exe_t.ExecutionBudget, "try_acquire", spy)
    ds = rdt.range(64, parallelism=16).map_batches(
        lambda b: {"id": b["id"] * 2})
    out = list(exe_t.execute_plan(ds._stages, budget=budget))
    assert len(out) == 16 and peak[0] <= 3 + 2
    assert sorted(v for r, _ in out for v in
                  rt.get(r).column("id").to_pylist()) == \
        [2 * i for i in range(64)]
