"""Block model: a Dataset is a list of object-store-resident blocks
(counterpart of ``ray_tpu/data/block.py``).

Re-design of the reference's block layer (reference:
python/ray/data/block.py, _internal/arrow_block.py): a block is a pyarrow
Table (columnar, zero-copy through the shm store); batches convert to
"numpy" (dict of arrays), "pandas", "pyarrow" or "torch" (dict of CPU
tensors) on demand. The numpy batch format is the device-feed path
(iterator.iter_torch_batches builds its pinned host tensors on it), so
conversions keep arrays contiguous.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import pyarrow as pa


@dataclasses.dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Any] = None


def block_from_rows(rows: List[Dict[str, Any]]) -> pa.Table:
    if not rows:
        return pa.table({})
    cols: Dict[str, list] = {}
    for row in rows:
        if not isinstance(row, dict):
            row = {"item": row}
        for k, v in row.items():
            cols.setdefault(k, []).append(v)
    return pa.table({k: _to_arrow_array(v) for k, v in cols.items()})


def _to_arrow_array(values: list):
    first = next((v for v in values if v is not None), None)
    if isinstance(first, np.ndarray):
        # tensor column: fixed-shape list array
        arr = np.stack(values)
        flat = pa.array(arr.reshape(arr.shape[0], -1).tolist())
        return flat
    return pa.array(values)


def _tensor_column(v: np.ndarray):
    """A numeric array of rank 2 or more as nested fixed-size lists over
    its flat values: no Python object per element (the JAX package goes
    through ``tolist()``, which takes minutes for a GiB of token rows).
    The rows read back the same through ``to_pylist`` and the "numpy"
    format; anything else takes the JAX package's path."""
    if v.dtype.kind not in "biuf":
        return pa.array(v.tolist())
    out = pa.array(np.ascontiguousarray(v).reshape(-1))
    for dim in reversed(v.shape[1:]):
        out = pa.FixedSizeListArray.from_arrays(out, dim)
    return out


def block_from_batch(batch) -> pa.Table:
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        return pa.table({k: (_tensor_column(v)
                             if isinstance(v, np.ndarray) and v.ndim > 1
                             else pa.array(np.asarray(v)))
                         for k, v in batch.items()})
    try:
        import pandas as pd
        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    if isinstance(batch, list):
        return block_from_rows(batch)
    raise TypeError(f"cannot build a block from {type(batch)}")


def block_to_batch(block: pa.Table, batch_format: str = "numpy"):
    if batch_format == "pyarrow":
        return block
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format in ("numpy", "default"):
        return {name: np.asarray(block.column(name).to_numpy(
            zero_copy_only=False)) for name in block.column_names}
    if batch_format == "torch":
        return dense_to_torch(block_to_dense(block))
    raise ValueError(f"unknown batch_format {batch_format!r}")


def column_to_dense(column) -> np.ndarray:
    """One column as one numpy array. A column of equal-length lists (a
    token row, a feature vector) becomes a 2-D array without a Python
    object per row; anything else converts as the "numpy" format does."""
    typ = column.type
    if pa.types.is_list(typ) or pa.types.is_large_list(typ) \
            or pa.types.is_fixed_size_list(typ):
        arr = column.combine_chunks() if isinstance(
            column, pa.ChunkedArray) else column
        n = len(arr)
        if n and arr.null_count == 0:
            import pyarrow.compute as pc
            lengths = pc.list_value_length(arr)
            lo, hi = pc.min(lengths).as_py(), pc.max(lengths).as_py()
            if lo == hi:
                flat = column_to_dense(arr.flatten())
                return flat.reshape((n, lo) + flat.shape[1:])
    return np.asarray(column.to_numpy(zero_copy_only=False))


def block_to_dense(block: pa.Table) -> Dict[str, np.ndarray]:
    return {name: column_to_dense(block.column(name))
            for name in block.column_names}


def dense_to_torch(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A dense numpy batch as a dict of CPU tensors (a read-only array,
    as arrow hands out zero-copy, is copied first: torch tensors are
    writable). A column torch cannot hold (strings, bytes) raises."""
    import torch
    out = {}
    for k, v in batch.items():
        if v.dtype == object and len(v):
            v = np.stack([np.asarray(x) for x in v])
        if not v.flags.writeable:
            v = v.copy()
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def block_to_rows(block: pa.Table) -> Iterable[Dict[str, Any]]:
    cols = {name: block.column(name).to_pylist()
            for name in block.column_names}
    for i in range(block.num_rows):
        yield {k: v[i] for k, v in cols.items()}


def block_metadata(block: pa.Table) -> BlockMetadata:
    return BlockMetadata(num_rows=block.num_rows,
                         size_bytes=block.nbytes,
                         schema=block.schema)


def slice_block(block: pa.Table, start: int, end: int) -> pa.Table:
    return block.slice(start, end - start)


def concat_blocks(blocks: List[pa.Table]) -> pa.Table:
    nonempty = [b for b in blocks if b.num_rows > 0]
    if not nonempty:
        # preserve the schema through an all-empty concat: a shuffle
        # partition that received only empty sub-blocks must still carry
        # its columns (downstream schema() / writes depend on it)
        for b in blocks:
            if len(b.column_names):
                return b.slice(0, 0)
        return pa.table({})
    return pa.concat_tables(nonempty, promote_options="default")
