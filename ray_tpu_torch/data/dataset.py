"""Dataset: lazy, streaming distributed datasets (counterpart of
``ray_tpu/data/dataset.py``; reference: python/ray/data/dataset.py —
logical plan of operations executed by the streaming executor on
materialization/iteration)."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data import block as block_lib
from ray_tpu_torch.data import execution as exe
from ray_tpu_torch.data import shuffle as shuffle_lib


class Dataset:
    def __init__(self, stages: List[exe.Stage]):
        self._stages = stages
        self._materialized: Optional[List[exe.RefBundle]] = None
        self._last_stats: Optional[exe.ExecutionStats] = None

    # ------------------------------------------------------------ transforms
    def _extend(self, stage: exe.Stage) -> "Dataset":
        return Dataset(self._stages + [stage])

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    fn_args=(), fn_kwargs=None,
                    fn_constructor_args=(), fn_constructor_kwargs=None,
                    concurrency: Optional[int] = None,
                    num_cpus: Optional[float] = None,
                    num_gpus: Optional[float] = None,
                    **_ignored) -> "Dataset":
        if isinstance(fn, type):
            # callable class -> stateful transform on an actor pool
            # (reference: ActorPoolMapOperator; map_batches(CallableCls,
            # concurrency=N, num_gpus=1) in ray.data gets GPU actors)
            return self._extend(exe.ActorPoolMapStage(
                fn, batch_format=batch_format,
                fn_constructor_args=fn_constructor_args,
                fn_constructor_kwargs=fn_constructor_kwargs,
                fn_args=fn_args, fn_kwargs=fn_kwargs,
                pool_size=concurrency or 2,
                num_cpus=0.5 if num_cpus is None else num_cpus,
                num_gpus=num_gpus))
        return self._extend(exe.MapStage("map_batches", fn,
                                         batch_format=batch_format,
                                         fn_args=fn_args,
                                         fn_kwargs=fn_kwargs,
                                         concurrency=concurrency,
                                         num_cpus=num_cpus))

    def map(self, fn: Callable, *, concurrency=None, **_) -> "Dataset":
        return self._extend(exe.MapStage("map", fn, concurrency=concurrency))

    def filter(self, fn: Callable, *, concurrency=None, **_) -> "Dataset":
        return self._extend(exe.MapStage("filter", fn,
                                         concurrency=concurrency))

    def flat_map(self, fn: Callable, *, concurrency=None, **_) -> "Dataset":
        return self._extend(exe.MapStage("flat_map", fn,
                                         concurrency=concurrency))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._extend(shuffle_lib.ShuffleStage(
            "repartition", num_blocks=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_partitions: Optional[int] = None) -> "Dataset":
        """Streaming push-based shuffle: inputs are consumed and
        partitioned incrementally, so memory stays bounded by the
        in-flight window + object-store spill, not the dataset size
        (ray_tpu_torch.data.shuffle)."""
        return self._extend(shuffle_lib.ShuffleStage(
            "random_shuffle", seed=seed, num_partitions=num_partitions))

    def sort(self, key: str, descending: bool = False, *,
             num_partitions: Optional[int] = None) -> "Dataset":
        return self._extend(shuffle_lib.ShuffleStage(
            "sort", key=key, descending=descending,
            num_partitions=num_partitions))

    def limit(self, n: int) -> "Dataset":
        return self._extend(exe.LimitStage(n))

    # ------------------------------------------------------------ column ops
    def add_column(self, name: str, fn: Callable) -> "Dataset":
        """fn(pandas.DataFrame) -> column values (reference:
        Dataset.add_column)."""
        def _add(df):
            df = df.copy()
            df[name] = fn(df)
            return df
        return self.map_batches(_add, batch_format="pandas")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(lambda df: df.drop(columns=list(cols)),
                                batch_format="pandas")

    def select_columns(self, cols: List[str]) -> "Dataset":
        # first-class ProjectStage: the optimizer pushes it into
        # column-prunable reads (execution._pushdown_projection)
        return self._extend(exe.ProjectStage(cols))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(lambda df: df.rename(columns=dict(mapping)),
                                batch_format="pandas")

    # ---------------------------------------------------------------- groupby
    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # ------------------------------------------------------ global aggregates
    def _column_chunks(self, col: str):
        import numpy as np
        for ref, _ in self._execute():
            block = ray_tpu_torch.get(ref)
            if block.num_rows:
                yield np.asarray(block.column(col).to_numpy(
                    zero_copy_only=False))

    def sum(self, col: str):
        return float(__import__("numpy").sum(
            [c.sum() for c in self._column_chunks(col)]))

    def min(self, col: str):
        return float(min(c.min() for c in self._column_chunks(col)))

    def max(self, col: str):
        return float(max(c.max() for c in self._column_chunks(col)))

    def mean(self, col: str):
        import numpy as np
        tot, n = 0.0, 0
        for c in self._column_chunks(col):
            tot += float(c.sum())
            n += c.size
        return tot / max(n, 1)

    def std(self, col: str, ddof: int = 1):
        import numpy as np
        chunks = list(self._column_chunks(col))
        if not chunks:
            return 0.0
        all_ = np.concatenate(chunks)
        return float(np.std(all_, ddof=ddof))

    def unique(self, col: str) -> List:
        import numpy as np
        seen = []
        s = set()
        for c in self._column_chunks(col):
            for v in np.unique(c):
                v = v.item() if hasattr(v, "item") else v
                if v not in s:
                    s.add(v)
                    seen.append(v)
        return seen

    # ------------------------------------------------------------ splits/zip
    def random_split(self, fractions: List[float],
                     seed: Optional[int] = None) -> List["Dataset"]:
        import numpy as np
        rows = self.take_all()
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(rows))
        out = []
        start = 0
        from ray_tpu_torch.data.read_api import from_items
        for f in fractions:
            k = int(round(f * len(rows)))
            out.append(from_items([rows[i] for i in idx[start:start + k]]))
            start += k
        return out

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of equal-length datasets (reference:
        Dataset.zip; clashing names get a _1 suffix)."""
        import pandas as pd
        a = self.to_pandas()
        b = other.to_pandas()
        if len(a) != len(b):
            raise ValueError(f"length mismatch: {len(a)} vs {len(b)}")
        b = b.rename(columns={c: f"{c}_1" for c in b.columns
                              if c in a.columns})
        from ray_tpu_torch.data.read_api import from_pandas
        return from_pandas(pd.concat([a.reset_index(drop=True),
                                      b.reset_index(drop=True)], axis=1))

    def union(self, *others: "Dataset") -> "Dataset":
        bundles = list(self._execute())
        for o in others:
            bundles.extend(o._execute())
        return Dataset([exe.InputStage(bundles)])

    # ------------------------------------------------------------- execution
    def _execute(self) -> Iterator[exe.RefBundle]:
        if self._materialized is not None:
            return iter(self._materialized)
        self._last_stats = exe.ExecutionStats()
        return exe.execute_plan(self._stages, stats=self._last_stats)

    def stats(self) -> str:
        """Per-operator execution metrics (tasks/rows/bytes/wall) for the
        most recent execution — runs the plan if it never executed
        (reference: Dataset.stats(), _internal/stats.py)."""
        if self._materialized is not None:
            if self._last_stats is not None:
                return self._last_stats.summary()
            st = exe.StageStats("Input")
            for _, meta in self._materialized:
                st.tasks += 1
                st.rows += getattr(meta, "num_rows", 0) or 0
                st.bytes += getattr(meta, "size_bytes", 0) or 0
            st.done = True
            stats = exe.ExecutionStats()
            stats.stages.append(st)
            self._last_stats = stats
            return stats.summary()
        if self._last_stats is None or not all(
                s.done for s in self._last_stats.stages):
            for _ in self._execute():
                pass
        return self._last_stats.summary()

    def materialize(self) -> "Dataset":
        bundles = list(self._execute())
        ds = Dataset([exe.InputStage(bundles)])
        ds._materialized = bundles
        ds._last_stats = self._last_stats   # stats of the producing run
        return ds

    def get_internal_block_refs(self) -> List:
        return [r for r, _ in self._execute()]

    # ----------------------------------------------------------- consumption
    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     prefetch_batches: int = 1,
                     drop_last: bool = False):
        from ray_tpu_torch.data.iterator import iter_batches as _ib
        return _ib(self._execute(), batch_size=batch_size,
                   batch_format=batch_format, drop_last=drop_last)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref, _ in self._execute():
            yield from block_lib.block_to_rows(ray_tpu_torch.get(ref))

    def iter_torch_batches(self, *, batch_size: int = 256, device="cuda",
                           dtypes=None, drop_last: bool = True,
                           prefetch: int = 2, device_prefetch: int = 2,
                           mesh=None, sharding=None):
        """Dict-of-tensor batches on ``device`` (the card by default;
        ``iterator.iter_torch_batches``)."""
        from ray_tpu_torch.data.iterator import iter_torch_batches as _itb
        return _itb(self._execute(), batch_size=batch_size, device=device,
                    dtypes=dtypes, drop_last=drop_last, prefetch=prefetch,
                    device_prefetch=device_prefetch, mesh=mesh,
                    sharding=sharding)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(meta.num_rows for _, meta in self._execute())

    def schema(self):
        for ref, meta in self._execute():
            if meta.schema is not None:
                return meta.schema
        return None

    def num_blocks(self) -> int:
        return len(list(self._execute()))

    def to_pandas(self):
        blocks = [ray_tpu_torch.get(r) for r, _ in self._execute()]
        return block_lib.concat_blocks(blocks).to_pandas()

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None):
        """One executing stream, n disjoint consumers (reference:
        Dataset.streaming_split -> OutputSplitter)."""
        from ray_tpu_torch.data.split import streaming_split
        return streaming_split(self, n, equal=equal,
                               locality_hints=locality_hints)

    def split(self, n: int) -> List["Dataset"]:
        bundles = list(self._execute())
        shards: List[List[exe.RefBundle]] = [[] for _ in range(n)]
        # greedy row balancing
        order = sorted(bundles, key=lambda b: -b[1].num_rows)
        sizes = [0] * n
        for b in order:
            i = sizes.index(min(sizes))
            shards[i].append(b)
            sizes[i] += b[1].num_rows
        return [Dataset([exe.InputStage(s)]) for s in shards]

    # ---------------------------------------------------------------- writes
    # Distributed: each block is written by a REMOTE task on whatever
    # node holds it (reference: ray.data write_* fan out write tasks;
    # the driver never materializes block bytes), and paths go through
    # the URI storage plane so gs://bucket/out works like a local dir.
    def _write_blocks(self, path: str, fmt: str):
        from ray_tpu_torch.util import storage
        storage.makedirs(path)

        def _write_one(block, dst):
            import io as _io
            import json as _json

            from ray_tpu_torch.data import block as B
            from ray_tpu_torch.util import storage as _storage
            buf = _io.BytesIO()
            if fmt == "parquet":
                import pyarrow.parquet as pq
                pq.write_table(block, buf)
            elif fmt == "csv":
                import pyarrow.csv as pcsv
                pcsv.write_csv(block, buf)
            else:
                for row in B.block_to_rows(block):
                    buf.write((_json.dumps(row, default=str) + "\n")
                              .encode())
            _storage.write_bytes(dst, buf.getvalue())
            return True

        ext = {"parquet": "parquet", "csv": "csv", "json": "json"}[fmt]
        task = ray_tpu_torch.remote(_write_one)
        from ray_tpu_torch.util import storage as _s
        refs = [task.remote(ref, _s.join(path, f"part-{i:05d}.{ext}"))
                for i, (ref, _) in enumerate(self._execute())]
        ray_tpu_torch.get(refs)

    def write_parquet(self, path: str):
        self._write_blocks(path, "parquet")

    def write_csv(self, path: str):
        self._write_blocks(path, "csv")

    def write_json(self, path: str):
        self._write_blocks(path, "json")

    def __repr__(self):
        return f"Dataset(stages={len(self._stages)})"


class GroupedData:
    """Grouped view for aggregations (reference: ray.data
    grouped_data.GroupedData — count/sum/mean/min/max/std + map_groups
    over a distributed key-hash shuffle)."""

    _ARROW_FNS = {"sum": "sum", "mean": "mean", "min": "min",
                  "max": "max", "count": "count", "std": "stddev"}

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, col: str, fn: str, out_name: str) -> Dataset:
        from ray_tpu_torch.data import shuffle as shuffle_lib
        return self._ds._extend(shuffle_lib.ShuffleStage(
            "groupby_agg", key=self._key,
            aggs=[(col, self._ARROW_FNS[fn], out_name)]))

    def count(self) -> Dataset:
        return self._agg(self._key, "count", "count()")

    def sum(self, col: str) -> Dataset:
        return self._agg(col, "sum", f"sum({col})")

    def mean(self, col: str) -> Dataset:
        return self._agg(col, "mean", f"mean({col})")

    def min(self, col: str) -> Dataset:
        return self._agg(col, "min", f"min({col})")

    def max(self, col: str) -> Dataset:
        return self._agg(col, "max", f"max({col})")

    def std(self, col: str) -> Dataset:
        return self._agg(col, "std", f"std({col})")

    def map_groups(self, fn) -> Dataset:
        from ray_tpu_torch.data import shuffle as shuffle_lib
        return self._ds._extend(shuffle_lib.ShuffleStage(
            "map_groups", key=self._key, fn=fn))
