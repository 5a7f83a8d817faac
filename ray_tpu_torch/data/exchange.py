"""Distributed map/reduce exchange for all-to-all Data ops (counterpart
of ``ray_tpu/data/exchange.py``; reference:
python/ray/data/_internal/planner/exchange/ — ShuffleTaskSpec,
SortTaskSpec; push-based map/reduce through the object store).

Shape: every input block runs a PARTITION task (num_returns = n_reduce)
that splits it into reduce partitions; every output partition runs a
REDUCE task over its column of the ref matrix. Only refs flow through the
driver — block bytes move node-to-node via the object store's push-based
transfer, so per-node memory is bounded by the blocks a task touches, not
the dataset."""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data import block as block_lib


# ------------------------------------------------------------- partition fns
def partition_random(block, n: int, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    if block.num_rows == 0:
        return [block] * n
    assign = rng.integers(0, n, size=block.num_rows)
    return [block.take(np.nonzero(assign == j)[0]) for j in range(n)]


def partition_round_robin(block, n: int):
    """Row-cyclic split into n near-equal partitions (the streaming
    repartition map fn: no global row offset is needed, so it works on a
    stream; each output partition ends up within one row of balance per
    input block)."""
    import numpy as np
    if block.num_rows == 0:
        return [block] * n
    idx = np.arange(block.num_rows) % n
    return [block.take(np.nonzero(idx == j)[0]) for j in range(n)]


def _stable_hash(v) -> int:
    """Process-independent hash. Python's builtin hash() of str/bytes is
    salted per interpreter (PYTHONHASHSEED), so two partition tasks on
    different workers would route the same key to different partitions,
    breaking the key-disjointness invariant reduce_agg/reduce_map_groups
    rely on. crc32 over a repr-stable byte encoding is deterministic
    everywhere."""
    import zlib

    import numpy as np
    # canonicalize numerics first: pandas materializes int columns as
    # np.int64 (or float64 when the block has nulls), so 5, np.int64(5)
    # and 5.0 must hash identically or the same key routes to different
    # partitions from different blocks
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and not isinstance(v, bool) and v.is_integer():
        v = int(v)
    if isinstance(v, bytes):
        b = v
    elif isinstance(v, str):
        b = v.encode("utf-8", "surrogatepass")
    elif isinstance(v, bool):
        b = b"\x01" if v else b"\x00"
    elif isinstance(v, int):
        b = v.to_bytes((v.bit_length() + 8) // 8 + 1, "little", signed=True)
    elif isinstance(v, float):
        import struct
        b = struct.pack("<d", v)
    elif v is None:
        b = b"\xff"
    else:
        b = repr(v).encode("utf-8", "surrogatepass")
    return zlib.crc32(b)


def partition_hash(block, key: str, n: int):
    import numpy as np
    if block.num_rows == 0:
        return [block] * n
    col = block.column(key).to_pandas()
    part = np.asarray(col.map(lambda v: _stable_hash(v) % n), np.int64)
    return [block.take(np.nonzero(part == j)[0]) for j in range(n)]


def partition_range(block, key: str, bounds: List, descending: bool):
    """Split by sorted range boundaries (len(bounds) + 1 partitions)."""
    import numpy as np
    n = len(bounds) + 1
    if block.num_rows == 0:
        return [block] * n
    col = np.asarray(block.column(key).to_pandas())
    idx = np.searchsorted(np.asarray(bounds), col, side="right")
    if descending:
        idx = (n - 1) - idx
    return [block.take(np.nonzero(idx == j)[0]) for j in range(n)]


# --------------------------------------------------------------- reduce fns
def reduce_concat(seed, *parts):
    import numpy as np
    merged = block_lib.concat_blocks(list(parts))
    if seed is not None and merged.num_rows:
        rng = np.random.default_rng(seed)
        merged = merged.take(rng.permutation(merged.num_rows))
    return merged


def reduce_sorted(key, descending, *parts):
    merged = block_lib.concat_blocks(list(parts))
    if merged.num_rows == 0:
        return merged    # all-empty concat loses the schema; don't sort
    order = "descending" if descending else "ascending"
    return merged.sort_by([(key, order)])


def reduce_agg(key, aggs, *parts):
    """Per-partition arrow group-by aggregate (keys are hash-disjoint
    across partitions, so no cross-partition combine is needed)."""
    merged = block_lib.concat_blocks(list(parts))
    if merged.num_rows == 0:
        return merged
    spec = [(c, f) for c, f, _ in aggs]
    out = merged.group_by(key).aggregate(spec)
    rename = {f"{c}_{f}": name for c, f, name in aggs}
    return out.rename_columns(
        [rename.get(c, c) for c in out.column_names])


def reduce_map_groups(key, fn, *parts):
    import pandas as pd
    merged = block_lib.concat_blocks(list(parts))
    if merged.num_rows == 0:
        return merged
    df = merged.to_pandas()
    outs = [fn(g) for _, g in df.groupby(key, sort=False)]
    outs = [o if isinstance(o, pd.DataFrame) else pd.DataFrame(o)
            for o in outs]
    return block_lib.block_from_batch(pd.concat(outs)) if outs \
        else merged.slice(0, 0)


# ------------------------------------------------------------------- driver
def exchange(refs: List, n_reduce: int, partition_fn: Callable,
             partition_args: tuple, reduce_fn: Callable,
             reduce_args: tuple) -> Iterator[Tuple]:
    """Run the two-phase exchange; yields (block_ref, metadata) bundles.
    Blocks never materialize in the driver — reduce tasks return their
    block AND metadata, and only the metadata is fetched here."""
    n_reduce = max(1, n_reduce)

    def _part(block, *args):
        return tuple(partition_fn(block, *args))

    def _reduce(*parts):
        out = reduce_fn(*reduce_args, *parts)
        return out, block_lib.block_metadata(out)

    part_task = ray_tpu_torch.remote(_part).options(num_returns=n_reduce)
    reduce_task = ray_tpu_torch.remote(_reduce).options(num_returns=2)

    matrix = []     # matrix[i][j]: map i's piece of reduce partition j
    for ref in refs:
        out = part_task.remote(ref, *partition_args)
        matrix.append(out if isinstance(out, list) else [out])
    for j in range(n_reduce):
        block_ref, meta_ref = reduce_task.remote(
            *[row[j] for row in matrix])
        meta = ray_tpu_torch.get(meta_ref)
        if meta.num_rows:
            yield (block_ref, meta)


def sample_sort_bounds(refs: List, key: str, n: int,
                       sample_size: int = 256) -> List:
    """Approximate range boundaries from per-block samples (reference:
    SortTaskSpec.sample_boundaries)."""
    import numpy as np

    def _sample(block):
        if block.num_rows == 0:
            return []
        col = np.asarray(block.column(key).to_pandas())
        k = min(sample_size, len(col))
        idx = np.random.default_rng(0).choice(len(col), size=k,
                                              replace=False)
        return col[idx].tolist()

    sample_task = ray_tpu_torch.remote(_sample)
    samples = [v for ref in refs
               for v in ray_tpu_torch.get(sample_task.remote(ref))]
    if not samples:
        return []
    samples.sort()
    return [samples[int(len(samples) * (j + 1) / n)]
            for j in range(n - 1)
            if int(len(samples) * (j + 1) / n) < len(samples)]
