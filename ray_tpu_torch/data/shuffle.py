"""Push-based streaming map/reduce shuffle (counterpart of
``ray_tpu/data/shuffle.py``; reference: Exoshuffle /
python/ray/data/_internal/planner/exchange — pipelined shuffle inside the
streaming executor instead of an all-to-all barrier).

Shape: the stage consumes its upstream stream INCREMENTALLY. Each input
block runs a map task that partitions it into P sub-blocks and seals them
into the object store (riding the off-loop parallel put path — task
returns serialize and copy on the executing worker, never the driver).
Sub-blocks are pushed into per-partition runs as their map task finishes;
once a partition accumulates a fixed-size contiguous run it is folded by
an intermediate MERGE task (concat on the node holding the run's bytes),
so the driver's live-ref footprint per partition stays bounded. When the
input is exhausted, one REDUCE task per partition stream-merges its runs
(permute / sort / aggregate) with soft locality placement on the node
holding the plurality of the partition's bytes — the same
object_locations plane streaming_split's locality dealing uses.

Memory bound: the driver holds at most ``max_in_flight`` input-block refs
at any time (peak tracked in ShuffleStats.peak_live_inputs and asserted
in tests); physical sub-block bytes beyond the object-store budget spill
to disk via the node manager's spill loop and restore on reduce, so a
shuffle larger than the store completes instead of OOMing.

Determinism: merge runs are fixed-size contiguous map-index ranges (the
grouping can never depend on task completion timing) and every random
seed is derived from (user seed, phase, index), so ``random_shuffle``
with a seed is a reproducible permutation.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data import block as block_lib
from ray_tpu_torch.data import exchange

DEFAULT_MERGE_FACTOR = 8        # sub-blocks folded per intermediate merge
DEFAULT_MAX_MAPS = 8            # in-flight map tasks == live input refs
DEFAULT_MAX_MERGES = 8          # in-flight merge tasks before the driver waits
DEFAULT_MAX_REDUCES = 8         # in-flight reduce tasks
SMALL_INPUT_BLOCKS = 2          # <= this many inputs -> legacy materializing path


class ShuffleStats:
    """Observability for one shuffle execution (the peak-live gauges are
    the memory-bound evidence the acceptance test asserts)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.num_partitions = 0
        self.map_tasks = 0
        self.merge_tasks = 0
        self.reduce_tasks = 0
        self.input_blocks = 0
        self.input_bytes = 0
        self.output_rows = 0
        self.output_bytes = 0
        self.live_inputs = 0          # current in-flight map tasks
        self.peak_live_inputs = 0     # max input-block refs held at once
        self.live_partials = 0        # current unmerged sub-block refs
        self.peak_live_partials = 0
        self.locality_hits = 0        # reduces placed on a data-holding node
        self.fallback = False         # took the legacy materializing path

    def _touch_inputs(self, delta: int):
        self.live_inputs += delta
        self.peak_live_inputs = max(self.peak_live_inputs, self.live_inputs)

    def _touch_partials(self, delta: int):
        self.live_partials += delta
        self.peak_live_partials = max(self.peak_live_partials,
                                      self.live_partials)

    def summary(self) -> str:
        return (f"Shuffle({self.kind}): {self.input_blocks} blocks -> "
                f"{self.num_partitions} partitions, "
                f"{self.map_tasks}/{self.merge_tasks}/{self.reduce_tasks} "
                f"map/merge/reduce tasks, peak live inputs "
                f"{self.peak_live_inputs}, peak live partials "
                f"{self.peak_live_partials}")


_LAST_STATS: Optional[ShuffleStats] = None


def last_shuffle_stats() -> Optional[ShuffleStats]:
    """Stats of the most recently COMPLETED shuffle in this process."""
    return _LAST_STATS


def object_node_ids(refs) -> List[Optional[str]]:
    """Best-effort node id per ref from the owner's location table (the
    cheap path streaming_split's locality dealing uses; None = unknown)."""
    refs = list(refs)
    try:
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.core.object_locations(refs)
    except Exception:
        return [None] * len(refs)


def plurality_node(refs_and_bytes) -> Optional[str]:
    """Node holding the plurality of the given (ref, nbytes) pairs."""
    pairs = list(refs_and_bytes)
    if not pairs:
        return None
    locs = object_node_ids(r for r, _ in pairs)
    weight: Dict[str, int] = {}
    for loc, (_, nb) in zip(locs, pairs):
        if loc is not None:
            weight[loc] = weight.get(loc, 0) + max(1, int(nb or 0))
    if not weight:
        return None
    return max(weight, key=weight.get)


def default_num_partitions(cap: int = 16) -> int:
    """Cluster-scaled partition count: ~2 tasks per CPU, clamped."""
    try:
        if ray_tpu_torch.is_initialized():
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 4))
            return max(2, min(cap, 2 * cpus))
    except Exception:
        pass
    return max(2, min(cap, 8))


# ----------------------------------------------------------- remote bodies
def _shuffle_map(block, partition_fn, args, n):
    """Partition one input block into n sub-blocks; returns the
    sub-blocks plus one (rows, bytes) list so the driver accounts sizes
    without ever fetching block bytes. num_returns == n + 1."""
    parts = list(partition_fn(block, *args))
    sizes = [(p.num_rows, p.nbytes) for p in parts]
    return (*parts, sizes)


def _shuffle_merge(*parts):
    """Fold a contiguous run of sub-blocks into one block (order
    preserving — determinism of the final concat relies on it)."""
    out = block_lib.concat_blocks(list(parts))
    return out, (out.num_rows, out.nbytes)


def _shuffle_reduce(reduce_fn, reduce_args, *parts):
    out = reduce_fn(*reduce_args, *parts)
    return out, block_lib.block_metadata(out)


def _derived_seed(seed, phase: int, index: int):
    """Deterministic per-task seed material; None stays None (fresh
    entropy per task, matching numpy's default_rng(None) contract)."""
    if seed is None:
        return None
    return [int(seed) & 0x7FFFFFFF, phase, index]


class _Partition:
    """Driver-side state of one reduce partition. Sub-blocks are keyed
    by their map index; merged runs cover FIXED index ranges
    [m*F, (m+1)*F), so both the fold grouping and the final assembly
    order depend only on indices — never on task completion timing."""

    __slots__ = ("arrived", "runs", "bytes", "rows")

    def __init__(self):
        self.arrived: Dict[int, Tuple[Any, int, int]] = {}  # idx -> (ref, rows, nb)
        self.runs: Dict[int, Tuple[Any, int, int]] = {}     # run m -> merged
        self.bytes = 0
        self.rows = 0

    def reduce_refs(self, merge_factor: int) -> List:
        """All refs in deterministic global map-index order (a merged
        run sorts at its range start; leftovers at their own index)."""
        items = [(m * merge_factor, r) for m, (r, _, _) in self.runs.items()]
        items += [(i, v[0]) for i, v in self.arrived.items()]
        return [r for _, r in sorted(items, key=lambda kv: kv[0])]

    def locality_pairs(self):
        return ([(r, nb) for r, _, nb in self.runs.values()]
                + [(v[0], v[2]) for v in self.arrived.values()])


class ShuffleStage:
    """Streaming all-to-all stage. Drop-in replacement for the
    materializing AllToAllStage: same kinds, same kwargs, but the input
    stream is consumed incrementally with bounded live refs. Tiny inputs
    (<= SMALL_INPUT_BLOCKS blocks) fall back to the legacy path, which is
    both exact and cheaper at that scale."""

    def __init__(self, kind: str, *, merge_factor: int = DEFAULT_MERGE_FACTOR,
                 max_in_flight: int = DEFAULT_MAX_MAPS, **kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.merge_factor = max(2, merge_factor)
        self.max_in_flight = max(1, max_in_flight)
        self.stats = ShuffleStats(kind)

    @property
    def name(self) -> str:
        return f"Shuffle({self.kind})"

    # ------------------------------------------------------------- planning
    def _num_partitions(self) -> int:
        if self.kind == "repartition":
            return max(1, self.kwargs["num_blocks"])
        if self.kwargs.get("num_partitions"):
            return max(1, self.kwargs["num_partitions"])
        if self.kind in ("groupby_agg", "map_groups"):
            return default_num_partitions(cap=8)
        return default_num_partitions()

    def _reduce_plan(self, j: int):
        """(reduce_fn, reduce_args) for partition j."""
        k = self.kwargs
        if self.kind == "random_shuffle":
            return exchange.reduce_concat, (
                _derived_seed(self._exec_seed, 1, j),)
        if self.kind == "repartition":
            return exchange.reduce_concat, (None,)
        if self.kind == "sort":
            return exchange.reduce_sorted, (k["key"],
                                            k.get("descending", False))
        if self.kind == "groupby_agg":
            return exchange.reduce_agg, (k["key"], list(k["aggs"]))
        if self.kind == "map_groups":
            return exchange.reduce_map_groups, (k["key"], k["fn"])
        raise ValueError(self.kind)

    def _map_plan(self, n: int, map_idx: int, bounds):
        """(partition_fn, args) for one map task."""
        k = self.kwargs
        if self.kind == "random_shuffle":
            return exchange.partition_random, (
                n, _derived_seed(self._exec_seed, 0, map_idx))
        if self.kind == "repartition":
            return exchange.partition_round_robin, (n,)
        if self.kind == "sort":
            return exchange.partition_range, (
                k["key"], bounds, k.get("descending", False))
        # groupby_agg / map_groups
        return exchange.partition_hash, (k["key"], n)

    # ------------------------------------------------------------ execution
    def execute(self, upstream, budget=None) -> Iterator:
        global _LAST_STATS
        upstream = iter(upstream)
        head = list(itertools.islice(upstream, SMALL_INPUT_BLOCKS + 1))
        if len(head) <= SMALL_INPUT_BLOCKS:
            # tiny input: the barrier is free and the legacy path keeps
            # exact single-block semantics (e.g. one whole-dataset
            # permutation instead of a 2-phase exchange)
            from ray_tpu_torch.data.execution import AllToAllStage
            self.stats.fallback = True
            self.stats.input_blocks = len(head)
            _LAST_STATS = self.stats
            yield from AllToAllStage(self.kind, **self.kwargs).execute(
                iter(head), budget)
            return
        yield from self._stream(itertools.chain(head, upstream), budget)

    def _stream(self, upstream, budget) -> Iterator:
        global _LAST_STATS
        st = self.stats
        _LAST_STATS = st        # visible even if the consumer stops early
        # an unseeded shuffle still permutes within every partition: draw
        # a fresh base seed per execution and derive all task seeds from
        # it (matching the legacy exchange, which always permuted)
        self._exec_seed = self.kwargs.get("seed")
        if self.kind == "random_shuffle" and self._exec_seed is None:
            import numpy as np
            self._exec_seed = int(np.random.default_rng().integers(1 << 31))
        P = self._num_partitions()
        bounds = None
        if self.kind == "sort":
            upstream, bounds = self._sample_bounds(upstream, P)
            P = len(bounds) + 1
        st.num_partitions = P

        map_task = ray_tpu_torch.remote(_shuffle_map).options(num_returns=P + 1)
        merge_task = ray_tpu_torch.remote(_shuffle_merge).options(num_returns=2)

        parts = [_Partition() for _ in range(P)]
        # sizes_ref -> (map_idx, [sub_refs], budget_est)
        inflight: Dict[Any, Tuple[int, List, int]] = {}
        merge_q: collections.deque = collections.deque()  # merge meta refs
        exhausted = False
        map_idx = 0
        peek_est = 0

        # flight-recorder windows: one span for the whole exchange with
        # the ShuffleStats peak-live gauges attached at close, child
        # spans for the map/merge window and the reduce window
        from ray_tpu_torch._private import events
        shuffle_span = events.start_span("data.shuffle", category="data",
                                         kind=self.kind, partitions=P)
        self._rec_span = shuffle_span
        map_span = events.start_span(
            "data.shuffle.map", category="data",
            trace_id=shuffle_span.trace_id,
            parent_span_id=shuffle_span.span_id, kind=self.kind)
        reduce_span = None
        try:
            while True:
                while not exhausted and len(inflight) < self.max_in_flight:
                    est = 0
                    if budget is not None:
                        est = peek_est
                        if not budget.try_acquire(est, force=not inflight):
                            break
                    nxt = next(upstream, None)
                    if nxt is None:
                        if budget is not None:
                            budget.release(est)
                        exhausted = True
                        break
                    ref, meta = nxt
                    peek_est = getattr(meta, "size_bytes", 0) or 0
                    part_fn, args = self._map_plan(P, map_idx, bounds)
                    out = map_task.remote(ref, part_fn, args, P)
                    sub_refs, sizes_ref = list(out[:P]), out[P]
                    inflight[sizes_ref] = (map_idx, sub_refs, est)
                    st.map_tasks += 1
                    st.input_blocks += 1
                    st.input_bytes += peek_est
                    st._touch_inputs(1)
                    map_idx += 1
                    # the input ref is dropped HERE: the map task's arg
                    # holds it until execution; the driver never re-holds it
                    del ref, nxt
                if not inflight:
                    break
                ready, _ = ray_tpu_torch.wait(list(inflight.keys()),
                                        num_returns=1)
                for sizes_ref in ready:
                    idx, sub_refs, est = inflight.pop(sizes_ref)
                    st._touch_inputs(-1)
                    if budget is not None:
                        budget.release(est)
                    sizes = ray_tpu_torch.get(sizes_ref)
                    for j, (sref, (rows, nb)) in enumerate(
                            zip(sub_refs, sizes)):
                        p = parts[j]
                        p.arrived[idx] = (sref, rows, nb)
                        p.rows += rows
                        p.bytes += nb
                        st._touch_partials(1)
                    self._fold_ready_runs(parts, idx, merge_task, merge_q)

            map_span.end(map_tasks=st.map_tasks,
                         merge_tasks=st.merge_tasks,
                         input_blocks=st.input_blocks,
                         input_bytes=st.input_bytes,
                         peak_live_inputs=st.peak_live_inputs)
            reduce_span = events.start_span(
                "data.shuffle.reduce", category="data",
                trace_id=shuffle_span.trace_id,
                parent_span_id=shuffle_span.span_id, kind=self.kind)
            yield from self._reduce_all(parts, P, budget)
            _LAST_STATS = st
        finally:
            map_span.end()      # no-op unless the map window aborted
            if reduce_span is not None:
                reduce_span.end(reduce_tasks=st.reduce_tasks,
                                output_rows=st.output_rows,
                                output_bytes=st.output_bytes,
                                locality_hits=st.locality_hits)
            shuffle_span.end(
                map_tasks=st.map_tasks, merge_tasks=st.merge_tasks,
                reduce_tasks=st.reduce_tasks,
                input_bytes=st.input_bytes, output_bytes=st.output_bytes,
                peak_live_inputs=st.peak_live_inputs,
                peak_live_partials=st.peak_live_partials)
            self._rec_span = None

    def _sample_bounds(self, upstream, P):
        """Buffer a bounded prefix, sample range boundaries from it
        (reference: SortTaskSpec.sample_boundaries). Bounds only steer
        partition BALANCE — any bounds give a correct global order since
        partitions are value-disjoint ranges and each reduce sorts."""
        prefix = []
        for bundle in upstream:
            prefix.append(bundle)
            if len(prefix) >= max(P, 8):
                break
        bounds = exchange.sample_sort_bounds(
            [r for r, _ in prefix], self.kwargs["key"], P)
        return itertools.chain(prefix, upstream), bounds

    def _fold_ready_runs(self, parts, idx, merge_task, merge_q):
        """Launch an intermediate merge in every partition whose run
        [m*F, (m+1)*F) — the FIXED index range containing map ``idx`` —
        has fully arrived. Fixed ranges make the grouping (and therefore
        the final concat order) independent of task completion timing,
        which keeps seeded shuffles reproducible; folding ANY complete
        range (not just the lowest) keeps the driver's live sub-block
        refs bounded even under adversarial completion order."""
        st = self.stats
        F = self.merge_factor
        m = idx // F
        base = m * F
        for p in parts:
            if not all(base + k in p.arrived for k in range(F)):
                continue
            run = [p.arrived.pop(base + k) for k in range(F)]
            nb = sum(r[2] for r in run)
            rows = sum(r[1] for r in run)
            task = merge_task
            node = plurality_node((r[0], r[2]) for r in run)
            if node is not None:
                from ray_tpu_torch.util.scheduling_strategies import \
                    NodeAffinitySchedulingStrategy
                task = merge_task.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node, soft=True))
            block_ref, meta_ref = task.remote(*[r[0] for r in run])
            p.runs[m] = (block_ref, rows, nb)
            st.merge_tasks += 1
            st._touch_partials(-F)
            rec = getattr(self, "_rec_span", None)
            if rec is not None:
                from ray_tpu_torch._private import events
                events.record_instant(
                    "data.shuffle.merge", category="data",
                    trace_id=rec.trace_id, parent_span_id=rec.span_id,
                    run=m, bytes=nb, rows=rows,
                    locality=node is not None)
            merge_q.append(meta_ref)
            # bounded merge pipeline: beyond the cap, wait for the
            # oldest merge before launching more
            while len(merge_q) > DEFAULT_MAX_MERGES:
                ray_tpu_torch.wait([merge_q.popleft()], num_returns=1)

    def _reduce_all(self, parts, P, budget) -> Iterator:
        st = self.stats
        reduce_task = ray_tpu_torch.remote(_shuffle_reduce).options(num_returns=2)
        window = collections.deque()   # (j, block_ref, meta_ref, est)

        def _drain_head():
            j, block_ref, meta_ref, est = window.popleft()
            if budget is not None:
                budget.release(est)
            meta = ray_tpu_torch.get(meta_ref)
            st.output_rows += meta.num_rows
            st.output_bytes += meta.size_bytes
            # empty partitions vanish from the stream — except repartition,
            # whose contract is exactly num_blocks output blocks
            if meta.num_rows or self.kind == "repartition":
                return (block_ref, meta)
            return None

        for j in range(P):
            while len(window) >= DEFAULT_MAX_REDUCES:
                out = _drain_head()
                if out is not None:
                    yield out
            p = parts[j]
            est = p.bytes
            if budget is not None and not budget.try_acquire(
                    est, force=not window):
                # over budget: drain the window head first, then force
                while window:
                    out = _drain_head()
                    if out is not None:
                        yield out
                budget.try_acquire(est, force=True)
            fn, args = self._reduce_plan(j)
            task = reduce_task
            node = plurality_node(p.locality_pairs())
            if node is not None:
                from ray_tpu_torch.util.scheduling_strategies import \
                    NodeAffinitySchedulingStrategy
                task = reduce_task.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node, soft=True))
                st.locality_hits += 1
            refs = p.reduce_refs(self.merge_factor)
            block_ref, meta_ref = task.remote(fn, args, *refs)
            st.reduce_tasks += 1
            st._touch_partials(-len(p.arrived))
            # the partition's run/sub refs are dropped with p: the reduce
            # task's args keep them recoverable through lineage
            parts[j] = None
            window.append((j, block_ref, meta_ref, est))
        while window:
            out = _drain_head()
            if out is not None:
                yield out
