"""Streaming split: one executing dataset feeding N consumers (train
workers) with disjoint block streams (counterpart of
``ray_tpu/data/split.py``; reference: Dataset.streaming_split
via OutputSplitter, python/ray/data/_internal/execution/operators/
output_splitter.py, wired into Train by _internal/data_config.py).

The plan executes ONCE inside a coordinator actor; consumers pull bundles
by split index over actor RPC. Block bytes never route through the
coordinator — only refs + metadata travel; consumers fetch blocks from
the object store directly.

Semantics mirrored from the reference OutputSplitter:
- bundles deal to the consumer with the fewest rows so far (row balance);
- per-consumer queues are bounded — a lagging consumer applies
  backpressure to the whole stream instead of pinning unbounded blocks;
- ``equal=True`` holds back each consumer's tail and, at end of stream,
  slices it so every consumer receives EXACTLY the same row count (the
  remainder is dropped, as in the reference) — required when consumers
  run lockstep collectives (SPMD training gangs).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Iterator, List, Optional

import ray_tpu_torch

_WAIT = "__wait__"          # sentinel: stream blocked on a full peer queue
_QUEUE_CAP = 16             # bundles per consumer before backpressure


class _SplitCoordinator:
    """Actor: executes the plan lazily and deals bundles row-balanced,
    preferring the consumer on the block's node when locality hints are
    given (reference: OutputSplitter.locality_hints — locality wins only
    within a bounded row-imbalance slack, so it can never starve a
    remote consumer)."""

    RETAIN = 4   # handed-out bundles pinned until the consumer's next pull

    def __init__(self, stages, n: int, equal: bool,
                 locality_hints: Optional[List[Optional[str]]] = None):
        from ray_tpu_torch.data import execution as exe
        self._n = n
        self._equal = equal
        self._stream = iter(exe.execute_plan(stages))
        self._queues = [collections.deque() for _ in range(n)]
        self._rows_dealt = [0] * n     # rows enqueued per consumer
        self._rows_handed = [0] * n    # rows actually delivered
        # keep recently handed-out refs alive: the consumer registers its
        # borrow with us (the owner) only after deserializing the reply,
        # so dropping our copy at hand-off would free the block under it
        self._handed = [collections.deque() for _ in range(n)]
        self._hints = list(locality_hints or [])
        self._locality_hits = 0
        self._locality_total = 0
        self._pending = None     # (bundle, dest) parked on a full queue
        self._done = False
        self._trimmed = False

    def _locate(self, ref) -> Optional[str]:
        """Node id of a block this coordinator owns (cheap local read —
        the shared locality plane in ray_tpu_torch.data.shuffle, also used for
        shuffle reduce placement)."""
        from ray_tpu_torch.data.shuffle import object_node_ids
        return object_node_ids([ref])[0]

    def _pick_dest(self, bundle) -> int:
        balanced = min(range(self._n), key=lambda i: self._rows_dealt[i])
        if not self._hints:
            return balanced
        self._locality_total += 1
        loc = self._locate(bundle[0])
        if loc is None:
            return balanced
        local = [i for i in range(self._n) if self._hints[i] == loc]
        if not local:
            return balanced
        # locality wins within a slack of a few bundles' worth of rows;
        # beyond that, row balance takes over (a hot node must not
        # accumulate the whole stream)
        slack = 4 * max(1, bundle[1].num_rows)
        cand = min(local, key=lambda i: self._rows_dealt[i])
        if self._rows_dealt[cand] - self._rows_dealt[balanced] <= slack:
            self._locality_hits += 1
            return cand
        return balanced

    # ------------------------------------------------------------ dealing
    def _advance(self):
        """Pull one bundle from the stream and deal it. Returns True on
        progress, False at end of stream, None when blocked on a full
        queue (backpressure: the chosen consumer's full queue stalls the
        whole stream — bundles are never re-routed around a laggard,
        which would break row balance)."""
        if self._done:
            return False
        if self._pending is None:
            bundle = next(self._stream, None)
            if bundle is None:
                self._done = True
                return False
            self._pending = (bundle, self._pick_dest(bundle))
        bundle, dest = self._pending
        if len(self._queues[dest]) >= _QUEUE_CAP:
            return None
        self._pending = None
        self._queues[dest].append(bundle)
        self._rows_dealt[dest] += bundle[1].num_rows
        return True

    def _hand(self, idx: int):
        bundle = self._queues[idx].popleft()
        self._rows_handed[idx] += bundle[1].num_rows
        handed = self._handed[idx]
        handed.append(bundle)
        while len(handed) > self.RETAIN:
            handed.popleft()
        return bundle

    def _trim_for_equality(self):
        """End of stream, equal mode: pool every undelivered bundle and
        redistribute with block slicing so each consumer's total delivered
        rows is exactly the target (reference OutputSplitter's equal mode
        splits blocks and drops the remainder the same way)."""
        from ray_tpu_torch.data import block as block_lib
        self._trimmed = True
        pool = [b for q in self._queues for b in q]
        pool_rows = sum(b[1].num_rows for b in pool)
        total = sum(self._rows_handed) + pool_rows
        # highest exactly-reachable target: nobody can hand rows back, and
        # the pool must cover everyone's deficit
        target = max(total // self._n, max(self._rows_handed))
        while target > 0 and sum(max(target - h, 0)
                                 for h in self._rows_handed) > pool_rows:
            target -= 1
        if target < max(self._rows_handed):
            # a consumer was already handed more rows than the pool can
            # match for its peers: exact equality is unreachable. Raising
            # here turns a would-be collective deadlock in lockstep SPMD
            # consumers into a loud error (_can_hand prevents this; guard
            # stays in case of a logic hole)
            raise RuntimeError(
                "streaming_split(equal=True): delivered row counts "
                f"diverged beyond repair (handed={self._rows_handed}, "
                f"undelivered pool={pool_rows} rows)")

        cursor = iter(pool)
        current = None          # (ref, meta, offset)

        def take(quota: int, out: collections.deque):
            nonlocal current
            while quota > 0:
                if current is None:
                    nxt = next(cursor, None)
                    if nxt is None:
                        return
                    current = (nxt[0], nxt[1], 0)
                ref, meta, off = current
                avail = meta.num_rows - off
                if avail <= quota and off == 0:
                    out.append((ref, meta))
                    quota -= avail
                    current = None
                else:
                    n_take = min(avail, quota)
                    block = ray_tpu_torch.get(ref)
                    part = block_lib.slice_block(block, off, off + n_take)
                    out.append((ray_tpu_torch.put(part),
                                block_lib.block_metadata(part)))
                    quota -= n_take
                    current = (ref, meta, off + n_take) \
                        if off + n_take < meta.num_rows else None

        for i in range(self._n):
            kept = collections.deque()
            take(max(target - self._rows_handed[i], 0), kept)
            self._queues[i] = kept

    # -------------------------------------------------------------- api
    def _can_hand(self, idx: int) -> bool:
        """Equal mode invariant: after handing the head bundle to idx, the
        undelivered pool must still cover every peer's deficit to the new
        max — bounding run-ahead by ROWS (a fixed bundle-depth reserve
        lets uneven block sizes silently break exact equality)."""
        rows = self._queues[idx][0][1].num_rows
        pool = sum(b[1].num_rows for q in self._queues for b in q) - rows
        handed = list(self._rows_handed)
        handed[idx] += rows
        hmax = max(handed)
        return sum(hmax - h for h in handed) <= pool

    def next(self, idx: int):
        """Next (block_ref, metadata) for consumer idx; (_WAIT,) when the
        stream is backpressured by a lagging peer; None at end."""
        q = self._queues[idx]
        while True:
            if self._equal and not self._done:
                # keep one bundle in reserve until the stream ends so the
                # tail can be sliced to equality
                if len(q) >= 2 and self._can_hand(idx):
                    return self._hand(idx)
            elif q:
                return self._hand(idx)
            progressed = self._advance()
            if progressed is None:
                return (_WAIT,) if not q or self._equal else self._hand(idx)
            if progressed is False:
                if self._equal and not self._trimmed:
                    self._trim_for_equality()
                    q = self._queues[idx]
                return self._hand(idx) if q else None

    def rows_delivered(self) -> List[int]:
        return list(self._rows_handed)

    def locality_stats(self):
        """(locality_hits, bundles_dealt_with_hints) — observability for
        the locality-aware dealing path."""
        return (self._locality_hits, self._locality_total)

    def ping(self):
        return True


class DataIterator:
    """Per-consumer shard handle; usable from any process holding it
    (reference: ray.data.DataIterator returned by streaming_split)."""

    def __init__(self, coordinator, idx: int):
        self._coordinator = coordinator
        self._idx = idx

    def _bundles(self) -> Iterator:
        while True:
            bundle = ray_tpu_torch.get(
                self._coordinator.next.remote(self._idx), timeout=600)
            if bundle is None:
                return
            if bundle[0] == _WAIT:
                time.sleep(0.1)
                continue
            yield tuple(bundle)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False):
        from ray_tpu_torch.data import iterator as it
        return it.iter_batches(self._bundles(), batch_size=batch_size,
                               batch_format=batch_format,
                               drop_last=drop_last)

    def iter_torch_batches(self, **kw):
        from ray_tpu_torch.data import iterator as it
        return it.iter_torch_batches(self._bundles(), **kw)

    def iter_rows(self):
        from ray_tpu_torch.data import block as B
        for ref, _meta in self._bundles():
            yield from B.block_to_rows(ray_tpu_torch.get(ref))


def streaming_split(dataset, n: int, *, equal: bool = False,
                    locality_hints=None) -> List[DataIterator]:
    """Split `dataset`'s output stream across n consumers.
    ``locality_hints``: optional node id per consumer — bundles whose
    block already lives on a hinted node deal to that consumer (within a
    bounded row-imbalance slack), so train workers read their shards
    from local shm instead of pulling cross-node (reference:
    OutputSplitter locality_hints via actor node ids)."""
    if locality_hints is not None and len(locality_hints) != n:
        raise ValueError(
            f"locality_hints must have one entry per consumer: got "
            f"{len(locality_hints)} hints for n={n}")
    coord_cls = ray_tpu_torch.remote(num_cpus=0.1)(_SplitCoordinator)
    coord = coord_cls.remote(dataset._stages, n, equal, locality_hints)
    ray_tpu_torch.get(coord.ping.remote(), timeout=120)
    return [DataIterator(coord, i) for i in range(n)]
