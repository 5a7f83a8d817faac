"""Streaming execution of dataset plans (counterpart of
``ray_tpu/data/execution.py``).

Re-design of the reference's StreamingExecutor (reference:
python/ray/data/_internal/execution/streaming_executor.py:48 — dedicated
thread, operator scheduling loop, backpressure policies). Here each
operator is a generator stage over a stream of block refs: map stages keep
a bounded window of in-flight remote tasks (pipelining + backpressure in
~40 lines instead of a scheduling loop). All-to-all reshapes run as the
push-based streaming shuffle in data/shuffle.py (map tasks
partition each block as it arrives, reduce tasks stream-merge with
locality placement and spill-backed overflow); the materializing
AllToAllStage below survives only as the tiny-input fallback. Only refs
flow through the executor; blocks stay in the object store."""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data import block as block_lib

# (ref, BlockMetadata) pairs flow between stages
RefBundle = Tuple[Any, block_lib.BlockMetadata]

DEFAULT_MAX_IN_FLIGHT = 8


class ExecutionBudget:
    """Cross-operator resource budget (reference: execution/
    resource_manager.py + backpressure_policy/ — the streaming executor
    throttles operators against cluster resources instead of letting one
    stage flood the object store). One budget is shared by every stage of
    a plan: a stage may only widen its in-flight window while under both
    the task cap and the bytes cap; at the cap it drains its own window
    head first (pull-based stages always keep making progress, so this
    throttles without deadlock)."""

    def __init__(self, max_tasks: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        if max_tasks is None or max_bytes is None:
            d_tasks, d_bytes = self._cluster_defaults()
            max_tasks = max_tasks if max_tasks is not None else d_tasks
            max_bytes = max_bytes if max_bytes is not None else d_bytes
        self.max_tasks = max_tasks
        self.max_bytes = max_bytes
        self.tasks = 0
        self.bytes = 0

    @staticmethod
    def _cluster_defaults():
        """Scale the budget to the CLUSTER, not a constant: in-flight
        tasks track total CPUs (x2 for pipelining) and in-flight bytes
        track a quarter of aggregate object-store capacity (reference:
        execution/resource_manager.py derives caps from cluster resources
        the same way). Falls back to single-node-ish constants when no
        cluster is attached."""
        try:
            import ray_tpu_torch
            if ray_tpu_torch.is_initialized():
                total = ray_tpu_torch.cluster_resources()
                cpus = int(total.get("CPU", 8))
                store = float(total.get("object_store_memory",
                                        1024 * 1024 * 1024))
                return (max(8, 2 * cpus),
                        max(64 * 1024 * 1024, int(store // 4)))
        except Exception:
            pass
        return 32, 256 * 1024 * 1024

    def try_acquire(self, est_bytes: int, force: bool = False) -> bool:
        """force=True always succeeds (still counted): a stage with an
        EMPTY window must launch regardless of the budget, otherwise an
        upstream stage whose tokens are all held downstream (or vice
        versa) livelocks the pipeline. Total in-flight stays bounded by
        max_tasks + n_stages."""
        if not force:
            if self.tasks + 1 > self.max_tasks:
                return False
            if self.bytes + est_bytes > self.max_bytes and self.tasks > 0:
                return False
        self.tasks += 1
        self.bytes += est_bytes
        return True

    def release(self, est_bytes: int) -> None:
        self.tasks -= 1
        self.bytes -= est_bytes


def _apply_one(fn_kind: str, fn, block, batch_format: str,
               fn_args, fn_kwargs):
    from ray_tpu_torch.data import block as B
    if fn_kind == "map_batches":
        batch = B.block_to_batch(block, batch_format)
        out = fn(batch, *fn_args, **(fn_kwargs or {}))
        if hasattr(out, "__next__"):
            raise TypeError(
                "map_batches UDF returned a generator from a "
                "non-generator callable; declare it as a generator "
                "FUNCTION (def f(batch): yield ...) so the stage streams "
                "its chunks — wrapping one in a lambda hides it from "
                "streaming detection")
        return B.block_from_batch(out)
    if fn_kind == "map":
        return B.block_from_rows(
            [fn(r, *fn_args, **(fn_kwargs or {}))
             for r in B.block_to_rows(block)])
    if fn_kind == "filter":
        return B.block_from_rows(
            [r for r in B.block_to_rows(block)
             if fn(r, *fn_args, **(fn_kwargs or {}))])
    if fn_kind == "flat_map":
        rows = []
        for r in B.block_to_rows(block):
            rows.extend(fn(r, *fn_args, **(fn_kwargs or {})))
        return B.block_from_rows(rows)
    if fn_kind == "select_columns":
        # arrow-native projection: no row/pandas materialization
        # (fn carries the column list — ProjectStage)
        return block.select(fn_args[0])
    raise ValueError(fn_kind)


def _map_block_remote(ops, block):
    """Runs inside a worker: apply a CHAIN of transforms to one block —
    a fused .map().filter().map_batches() pipeline touches the object
    store once, not once per operator (reference: operator fusion rule,
    _internal/logical/rules/operator_fusion.py). Returns (block,
    metadata); the block stays in the executing node's store and the
    driver only reads the metadata."""
    from ray_tpu_torch.data import block as B
    for (fn_kind, fn, batch_format, fn_args, fn_kwargs) in ops:
        block = _apply_one(fn_kind, fn, block, batch_format,
                           fn_args, fn_kwargs)
    return block, B.block_metadata(block)


def _iter_chain_blocks(ops, block, i=0):
    """Apply ops[i:] to one block, yielding OUTPUT blocks: a map_batches
    UDF that returns a generator fans one input block out into many
    output blocks, each flowing through the remaining fused ops
    independently (reference: generator-UDF map tasks stream blocks via
    streaming generators instead of buffering the whole expansion,
    _internal/execution/operators/map_transformer.py)."""
    from ray_tpu_torch.data import block as B
    if i == len(ops):
        yield block
        return
    fn_kind, fn, batch_format, fn_args, fn_kwargs = ops[i]
    if fn_kind == "map_batches":
        batch = B.block_to_batch(block, batch_format)
        out = fn(batch, *fn_args, **(fn_kwargs or {}))
        if hasattr(out, "__next__"):    # generator UDF: stream chunks
            for chunk in out:
                yield from _iter_chain_blocks(
                    ops, B.block_from_batch(chunk), i + 1)
            return
        yield from _iter_chain_blocks(ops, B.block_from_batch(out), i + 1)
        return
    yield from _iter_chain_blocks(
        ops, _apply_one(fn_kind, fn, block, batch_format,
                        fn_args, fn_kwargs), i + 1)


def _map_block_stream_remote(ops, block):
    """Streaming-generator map task: yields (block, metadata) as
    alternating items so the driver can read the small metadata without
    ever pulling block bytes (block item stays in the executor node's
    store; the consumer holds only its ref)."""
    from ray_tpu_torch.data import block as B
    for out in _iter_chain_blocks(ops, block):
        yield out
        yield B.block_metadata(out)


def _read_blocks_stream(fn):
    """Streaming read task: a datasource fn marked yields_blocks
    produces blocks incrementally (e.g. one parquet row group at a
    time); backpressure keeps at most K unconsumed blocks alive instead
    of buffering the whole file."""
    from ray_tpu_torch.data import block as B
    for blk in fn():
        yield blk
        yield B.block_metadata(blk)


def _drain_pair_stream(gen):
    """Consume a (block, meta, block, meta, ...) item stream into
    (block_ref, meta) bundles, fetching only the metadata items. A
    mid-stream task error arrives as a lone trailing item: resolving it
    re-raises the executor's exception."""
    while True:
        try:
            block_ref = next(gen)
        except StopIteration:
            return
        try:
            meta_ref = next(gen)
        except StopIteration:
            ray_tpu_torch.get(block_ref)   # lone item == the error; raises
            return
        yield (block_ref, ray_tpu_torch.get(meta_ref))


class Stage:
    """Base: transforms a stream of RefBundles."""

    def execute(self, upstream: Iterator[RefBundle],
                budget: Optional[ExecutionBudget] = None
                ) -> Iterator[RefBundle]:
        raise NotImplementedError


class InputStage(Stage):
    def __init__(self, bundles: List[RefBundle]):
        self.bundles = bundles

    def execute(self, upstream, budget=None):
        yield from self.bundles


class ReadStage(Stage):
    """Launches read tasks from serialized read descriptors."""

    name = "Read"

    def __init__(self, read_fns: List[Callable], max_in_flight: int = None,
                 concurrency: Optional[int] = None):
        self.read_fns = read_fns
        self.max_in_flight = (concurrency or max_in_flight
                              or DEFAULT_MAX_IN_FLIGHT)

    EST_READ_BYTES = 8 * 1024 * 1024    # pre-read output size guess

    def execute(self, upstream, budget=None):
        # two returns: the block ref is yielded WITHOUT fetching its bytes
        # to the driver; only the small metadata ref is materialized.
        # Datasource fns marked yields_blocks run as streaming-generator
        # tasks instead: one task emits many blocks with bounded
        # buffering (reference: streaming reads over file fragments)
        remote_read = ray_tpu_torch.remote(num_returns=2)(
            lambda fn: _with_meta(fn()))
        remote_read_stream = ray_tpu_torch.remote(
            num_returns="streaming")(_read_blocks_stream)
        window = collections.deque()
        fns = iter(self.read_fns)
        exhausted = False
        while True:
            while not exhausted and len(window) < self.max_in_flight:
                if budget is not None and not budget.try_acquire(
                        self.EST_READ_BYTES, force=not window):
                    break
                fn = next(fns, None)
                if fn is None:
                    if budget is not None:
                        budget.release(self.EST_READ_BYTES)
                    exhausted = True
                    break
                if getattr(fn, "yields_blocks", False):
                    window.append(("stream",
                                   remote_read_stream.remote(fn)))
                else:
                    window.append(("task", remote_read.remote(fn)))
            if not window:
                return
            kind, handle = window.popleft()
            if budget is not None:
                budget.release(self.EST_READ_BYTES)
            if kind == "stream":
                yield from _drain_pair_stream(handle)
            else:
                block_ref, meta_ref = handle
                yield (block_ref, ray_tpu_torch.get(meta_ref))


def _with_meta(block):
    return block, block_lib.block_metadata(block)


class MapStage(Stage):
    """One (or a fused chain of) map-family transform(s); each input
    block becomes one remote task applying every fused op in sequence."""

    def __init__(self, fn_kind: str, fn, batch_format: str = "numpy",
                 fn_args=(), fn_kwargs=None, max_in_flight: int = None,
                 concurrency: Optional[int] = None,
                 num_cpus: Optional[float] = None):
        import inspect
        self.ops = [(fn_kind, fn, batch_format, fn_args, fn_kwargs)]
        self.concurrency = concurrency
        self.num_cpus = num_cpus
        self.max_in_flight = (concurrency or max_in_flight
                              or DEFAULT_MAX_IN_FLIGHT)
        # generator UDF (yields output batches): run the block task as a
        # streaming generator so chunks flow out with bounded buffering
        self.streaming = (fn_kind == "map_batches"
                          and inspect.isgeneratorfunction(fn))

    @property
    def name(self) -> str:
        return "Map(" + "->".join(k for k, *_ in self.ops) + ")"

    @staticmethod
    def fused(a: "MapStage", b: "MapStage") -> "MapStage":
        """a then b as ONE task per block (task-pool stages only; the
        optimizer never fuses across ActorPoolMapStage/AllToAll)."""
        out = MapStage.__new__(MapStage)
        out.ops = a.ops + b.ops
        out.concurrency = (min(a.concurrency, b.concurrency)
                           if a.concurrency and b.concurrency
                           else a.concurrency or b.concurrency)
        out.num_cpus = (max(a.num_cpus, b.num_cpus)
                        if a.num_cpus and b.num_cpus
                        else a.num_cpus or b.num_cpus)
        out.max_in_flight = min(a.max_in_flight, b.max_in_flight)
        out.streaming = a.streaming or b.streaming
        return out

    def execute(self, upstream, budget=None):
        opts = {"num_returns": 2}
        if self.num_cpus is not None:
            opts["num_cpus"] = self.num_cpus
        if self.streaming:
            s_opts = dict(opts, num_returns="streaming")
            remote_map = ray_tpu_torch.remote(**s_opts)(_map_block_stream_remote)
        else:
            remote_map = ray_tpu_torch.remote(**opts)(_map_block_remote)
        window = collections.deque()
        upstream = iter(upstream)
        exhausted = False
        # rolling output-size estimate for the byte budget: last input
        # block's size (metadata-driven, like op_runtime_metrics);
        # per-execution local so concurrent runs don't share state
        peek_est = 0
        while True:
            while not exhausted and len(window) < self.max_in_flight:
                est = 0
                if budget is not None:
                    est = peek_est
                    if not budget.try_acquire(est, force=not window):
                        break
                nxt = next(upstream, None)
                if nxt is None:
                    if budget is not None:
                        budget.release(est)
                    exhausted = True
                    break
                ref, meta = nxt
                peek_est = getattr(meta, "size_bytes", 0) or 0
                window.append((remote_map.remote(self.ops, ref), est))
            if not window:
                return
            handle, est = window.popleft()
            if budget is not None:
                budget.release(est)
            if self.streaming:
                # one input block -> a stream of output bundles
                yield from _drain_pair_stream(handle)
            else:
                block_ref, meta_ref = handle
                # block until this output's metadata is ready (keeps
                # order; later tasks keep running in the window); bytes
                # stay put
                yield (block_ref, ray_tpu_torch.get(meta_ref))


class ProjectStage(MapStage):
    """Column projection (`select_columns`) as a first-class stage so
    the optimizer can SEE it: _pushdown_projection rebinds
    column-prunable read fns (parquet) to fetch only these columns
    (reference: logical/rules — projection pushdown into the
    datasource). The stage itself still runs as an ordinary fused map:
    it is the exact cut when the source can't prune."""

    def __init__(self, columns):
        self.columns = list(columns)
        super().__init__("select_columns", None, fn_args=(self.columns,))


def _pushdown_projection(stages: List[Stage]) -> List[Stage]:
    """Rebind a ReadStage's column-prunable read fns when a
    ProjectStage follows it with only limits in between — the read then
    never materializes the dropped columns. Sound only for that shape:
    an arbitrary UDF between read and project may consume columns the
    projection drops. Only the FIRST projection of a chain pushes down
    (it names the widest set that chain may reference; narrower chained
    selects still prune their subset downstream — pushing a later,
    narrower one would starve the earlier select of its columns)."""
    out = list(stages)
    for i, s in enumerate(out):
        if not isinstance(s, ReadStage):
            continue
        if not all(hasattr(fn, "with_columns") for fn in s.read_fns):
            continue
        j = i + 1
        while j < len(out) and isinstance(out[j], LimitStage):
            j += 1
        if j < len(out) and isinstance(out[j], ProjectStage):
            out[i] = ReadStage([fn.with_columns(out[j].columns)
                                for fn in s.read_fns],
                               max_in_flight=s.max_in_flight)
    return out


class ActorPoolMapStage(Stage):
    """Stateful transforms on a pool of long-lived actors (reference:
    ActorPoolMapOperator, _internal/execution/operators/ — used when the
    UDF is a callable class whose construction is expensive: model
    weights, tokenizers, device state). Blocks round-robin onto the
    least-loaded actor with a bounded per-actor pipeline."""

    def __init__(self, fn_cls, batch_format: str = "numpy",
                 fn_constructor_args=(), fn_constructor_kwargs=None,
                 fn_args=(), fn_kwargs=None, pool_size: int = 2,
                 max_in_flight_per_actor: int = 2,
                 num_cpus: float = 0.5,
                 num_gpus: Optional[float] = None):
        self.fn_cls = fn_cls
        self.batch_format = batch_format
        self.ctor_args = fn_constructor_args
        self.ctor_kwargs = fn_constructor_kwargs or {}
        self.fn_args = fn_args
        self.fn_kwargs = fn_kwargs or {}
        self.pool_size = pool_size
        self.per_actor = max_in_flight_per_actor
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus

    def execute(self, upstream, budget=None):
        fn_cls = self.fn_cls
        batch_format = self.batch_format
        fn_args, fn_kwargs = self.fn_args, self.fn_kwargs

        opts = {"num_cpus": self.num_cpus, "max_concurrency": 1}
        if self.num_gpus:
            # a UDF class built with num_gpus= runs on GPU actors, each
            # with its CUDA_VISIBLE_DEVICES set by the runtime
            opts["num_gpus"] = self.num_gpus

        @ray_tpu_torch.remote(**opts)
        class _MapWorker:
            def __init__(self, ctor_args, ctor_kwargs):
                self._fn = fn_cls(*ctor_args, **ctor_kwargs)

            def apply(self, block):
                from ray_tpu_torch.data import block as B
                batch = B.block_to_batch(block, batch_format)
                out = self._fn(batch, *fn_args, **fn_kwargs)
                out_block = B.block_from_batch(out)
                return out_block, B.block_metadata(out_block)

        actors = [_MapWorker.remote(self.ctor_args, self.ctor_kwargs)
                  for _ in range(self.pool_size)]
        load = {i: 0 for i in range(self.pool_size)}
        window = collections.deque()   # (result_ref, actor_idx)
        upstream = iter(upstream)
        exhausted = False
        peek_est = 0   # rolling output estimate = last input block size
        try:
            while True:
                while (not exhausted
                       and len(window) < self.pool_size * self.per_actor):
                    est = 0
                    if budget is not None:
                        est = peek_est
                        if not budget.try_acquire(est, force=not window):
                            break
                    nxt = next(upstream, None)
                    if nxt is None:
                        if budget is not None:
                            budget.release(est)
                        exhausted = True
                        break
                    ref, meta = nxt
                    peek_est = getattr(meta, "size_bytes", 0) or 0
                    idx = min(load, key=load.get)
                    load[idx] += 1
                    window.append(
                        (actors[idx].apply.options(num_returns=2)
                         .remote(ref), idx, est))
                if not window:
                    return
                (block_ref, meta_ref), idx, est = window.popleft()
                load[idx] -= 1
                if budget is not None:
                    budget.release(est)
                yield (block_ref, ray_tpu_torch.get(meta_ref))
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass


class AllToAllStage(Stage):
    """LEGACY materializing reshape (repartition / shuffle / sort):
    buffers every input ref at a barrier before reshaping. Kept only as
    the tiny-input fallback of ray_tpu_torch.data.shuffle.ShuffleStage — at
    <= a couple of blocks the barrier is free and the single-block local
    paths below are exact; everything larger streams."""

    def __init__(self, kind: str, **kwargs):
        self.kind = kind
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        return f"AllToAll({self.kind})"

    def execute(self, upstream, budget=None):
        bundles = list(upstream)
        refs = [r for r, _ in bundles]
        if self.kind == "repartition":
            yield from self._repartition(refs, self.kwargs["num_blocks"])
        elif self.kind == "random_shuffle":
            yield from self._random_shuffle(refs, self.kwargs.get("seed"))
        elif self.kind == "sort":
            yield from self._sort(refs, self.kwargs["key"],
                                  self.kwargs.get("descending", False))
        elif self.kind == "groupby_agg":
            yield from self._groupby_agg(refs, self.kwargs["key"],
                                         self.kwargs["aggs"])
        elif self.kind == "map_groups":
            yield from self._map_groups(refs, self.kwargs["key"],
                                        self.kwargs["fn"])
        else:
            raise ValueError(self.kind)

    def _repartition(self, refs, num_blocks: int):
        blocks = ray_tpu_torch.get(list(refs))
        merged = block_lib.concat_blocks(blocks)
        n = max(1, num_blocks)
        rows = merged.num_rows
        per = (rows + n - 1) // n if rows else 0
        for i in range(n):
            part = block_lib.slice_block(merged, min(i * per, rows),
                                         min((i + 1) * per, rows)) \
                if rows else merged
            yield (ray_tpu_torch.put(part), block_lib.block_metadata(part))

    def _random_shuffle(self, refs, seed):
        """Distributed map/reduce shuffle: blocks never materialize in the
        driver (reference: _internal/planner/exchange ShuffleTaskSpec);
        single-block datasets take the local path."""
        import numpy as np
        if len(refs) <= 1:
            blocks = ray_tpu_torch.get(list(refs))
            merged = block_lib.concat_blocks(blocks)
            rng = np.random.default_rng(seed)
            shuffled = merged.take(rng.permutation(merged.num_rows))
            yield (ray_tpu_torch.put(shuffled),
                   block_lib.block_metadata(shuffled))
            return
        from ray_tpu_torch.data import exchange
        n = len(refs)
        seeds = np.random.default_rng(seed).integers(0, 2**31, size=n + 1)
        yield from exchange.exchange(
            list(refs), n, exchange.partition_random, (n, int(seeds[0])),
            exchange.reduce_concat, (int(seeds[1]),))

    def _sort(self, refs, key, descending):
        """Distributed range-partitioned sort (reference: SortTaskSpec —
        sample boundaries, partition by range, merge-sort per partition);
        output partitions are globally ordered."""
        if len(refs) <= 1:
            blocks = ray_tpu_torch.get(list(refs))
            merged = block_lib.concat_blocks(blocks)
            order = "descending" if descending else "ascending"
            out = merged.sort_by([(key, order)])
            yield (ray_tpu_torch.put(out), block_lib.block_metadata(out))
            return
        from ray_tpu_torch.data import exchange
        n = len(refs)
        bounds = exchange.sample_sort_bounds(list(refs), key, n)
        yield from exchange.exchange(
            list(refs), len(bounds) + 1, exchange.partition_range,
            (key, bounds, descending), exchange.reduce_sorted,
            (key, descending))

    def _groupby_agg(self, refs, key, aggs):
        """aggs: list of (column, arrow_agg_fn, out_name); hash-exchange
        to key-disjoint partitions, each aggregated in its reduce task
        (reference: hash-shuffle groupby under
        _internal/planner/exchange)."""
        from ray_tpu_torch.data import exchange
        n = max(1, min(len(refs), 8))
        yield from exchange.exchange(
            list(refs), n, exchange.partition_hash, (key, n),
            exchange.reduce_agg, (key, list(aggs)))

    def _map_groups(self, refs, key, fn):
        """Run fn(pandas.DataFrame) per key group (reference:
        GroupedData.map_groups) via the hash exchange."""
        from ray_tpu_torch.data import exchange
        n = max(1, min(len(refs), 8))
        yield from exchange.exchange(
            list(refs), n, exchange.partition_hash, (key, n),
            exchange.reduce_map_groups, (key, fn))


class LimitStage(Stage):
    def __init__(self, limit: int):
        self.limit = limit

    def execute(self, upstream, budget=None):
        remaining = self.limit
        for ref, meta in upstream:
            if remaining <= 0:
                return
            if meta.num_rows <= remaining:
                remaining -= meta.num_rows
                yield (ref, meta)
            else:
                block = ray_tpu_torch.get(ref)
                part = block_lib.slice_block(block, 0, remaining)
                remaining = 0
                yield (ray_tpu_torch.put(part), block_lib.block_metadata(part))
                return


class StageStats:
    """Per-operator runtime metrics (reference: _internal/stats.py +
    op_runtime_metrics.py — rows/bytes/tasks/wall per operator,
    surfaced as Dataset.stats())."""

    def __init__(self, name: str):
        self.name = name
        self.tasks = 0        # output bundles == tasks for read/map stages
        self.rows = 0
        self.bytes = 0
        self.wall_s = 0.0
        self.done = False

    def line(self, self_wall_s: Optional[float] = None) -> str:
        mb = self.bytes / (1024 * 1024)
        wall = self.wall_s if self_wall_s is None else self_wall_s
        return (f"{self.name}: {self.tasks} tasks, {self.rows} rows, "
                f"{mb:.2f} MiB, {wall * 1e3:.0f} ms")


class ExecutionStats:
    def __init__(self):
        self.stages: List[StageStats] = []
        self.total_wall_s = 0.0

    def summary(self) -> str:
        # a stage's measured wall INCLUDES its whole upstream chain
        # (pull-based generators); report the nested-profiler difference
        # so each operator shows only its own contribution
        lines = []
        prev = 0.0
        for i, st in enumerate(self.stages):
            lines.append(
                f"Operator {i} {st.line(max(0.0, st.wall_s - prev))}")
            prev = max(prev, st.wall_s)
        lines.append(f"Total: {self.total_wall_s * 1e3:.0f} ms")
        return "\n".join(lines)


def _instrument(stream: Iterator[RefBundle], st: StageStats
                ) -> Iterator[RefBundle]:
    import time

    from ray_tpu_torch._private import events
    span = None
    try:
        while True:
            t0 = time.perf_counter()
            if span is None:
                # opened on FIRST pull (plans build lazily; a stage the
                # consumer never reaches must not appear on the timeline)
                span = events.start_span("data.stage", category="data",
                                         stage=st.name)
            try:
                ref, meta = next(stream)
            except StopIteration:
                st.wall_s += time.perf_counter() - t0
                st.done = True
                return
            st.wall_s += time.perf_counter() - t0
            st.tasks += 1
            st.rows += getattr(meta, "num_rows", 0) or 0
            st.bytes += getattr(meta, "size_bytes", 0) or 0
            yield (ref, meta)
    finally:
        # runs on exhaustion AND on early termination (limit pushdown,
        # consumer walked away): a truncated stage still records, marked
        if span is not None:
            span.end(tasks=st.tasks, rows=st.rows, bytes=st.bytes,
                     wall_ms=round(st.wall_s * 1e3, 3),
                     truncated=not st.done)


def _pushdown_limits(stages: List[Stage]) -> List[Stage]:
    """Move a LimitStage ahead of row-count-preserving map stages so
    upstream work stops as soon as `n` rows exist (reference:
    logical/rules/limit_pushdown.py). Only `map` preserves cardinality
    1:1 (filter/flat_map/map_batches may change it), and the original
    limit stays in place as the exact cut."""
    out = list(stages)
    i = 1
    while i < len(out):
        s = out[i]
        if isinstance(s, LimitStage):
            j = i
            while j > 0 and isinstance(out[j - 1], MapStage) \
                    and all(k in ("map", "select_columns")
                            for k, *_ in out[j - 1].ops):
                j -= 1
            if j < i:
                out.insert(j, LimitStage(s.limit))
                i += 1    # the insertion shifted everything right
        i += 1
    return out


def optimize_plan(stages: List[Stage]) -> List[Stage]:
    """Rule passes (reference: _internal/logical/rules/):
    1. limit pushdown past row-preserving maps
    2. fuse adjacent task-pool map-family stages so a .map().filter()
       chain pays ONE object-store round trip per block
       (operator_fusion.py). Actor-pool/all-to-all stages are barriers."""
    stages = _pushdown_projection(stages)
    stages = _pushdown_limits(stages)
    out: List[Stage] = []
    for s in stages:
        if (out and isinstance(s, MapStage) and isinstance(out[-1],
                                                           MapStage)):
            out[-1] = MapStage.fused(out[-1], s)
        else:
            out.append(s)
    return out


def execute_plan(stages: List[Stage],
                 budget: Optional[ExecutionBudget] = None,
                 stats: Optional[ExecutionStats] = None,
                 optimize: bool = True) -> Iterator[RefBundle]:
    budget = budget or ExecutionBudget()
    if optimize:
        stages = optimize_plan(stages)
    stream: Iterator[RefBundle] = iter(())
    for stage in stages:
        stream = stage.execute(stream, budget)
        if stats is not None:
            st = StageStats(getattr(stage, "name", None)
                            or type(stage).__name__)
            stats.stages.append(st)
            stream = _instrument(stream, st)
    if stats is not None:
        stream = _total_wall(stream, stats)
    return stream


def _total_wall(stream: Iterator[RefBundle], stats: ExecutionStats
                ) -> Iterator[RefBundle]:
    import time
    t0 = time.perf_counter()
    try:
        yield from stream
    finally:
        stats.total_wall_s = time.perf_counter() - t0
