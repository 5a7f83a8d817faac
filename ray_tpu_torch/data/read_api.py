"""Dataset creation (counterpart of ``ray_tpu/data/read_api.py``;
reference: python/ray/data/read_api.py —
range/from_items/read_parquet/read_csv/read_json/from_numpy/from_pandas).
Reads are lazy: each source becomes a list of zero-arg read callables
launched as tasks by the ReadStage."""

from __future__ import annotations

import glob as glob_mod
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import block as block_lib
from ray_tpu_torch.data import execution as exe
from ray_tpu_torch.data.dataset import Dataset


def range(n: int, *, parallelism: int = 8) -> Dataset:   # noqa: A001
    import builtins
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism

    def make(lo, hi):
        def read():
            import numpy as np
            import pyarrow as pa
            return pa.table({"id": np.arange(lo, hi, dtype=np.int64)})
        return read

    fns = [make(i * per, min((i + 1) * per, n))
           for i in builtins.range(parallelism) if i * per < n]
    return Dataset([exe.ReadStage(fns)])


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    import builtins
    parallelism = max(1, min(parallelism, len(items) or 1))
    per = (len(items) + parallelism - 1) // parallelism
    chunks = [items[i * per:(i + 1) * per]
              for i in builtins.range(parallelism) if i * per < len(items)]

    def make(chunk):
        return lambda: block_lib.block_from_rows(
            [r if isinstance(r, dict) else {"item": r} for r in chunk])

    return Dataset([exe.ReadStage([make(c) for c in chunks])])


def from_numpy(arr: np.ndarray, column: str = "data",
               *, parallelism: int = 8) -> Dataset:
    import builtins
    parallelism = max(1, min(parallelism, len(arr) or 1))
    splits = np.array_split(arr, parallelism)

    def make(part):
        def read():
            import pyarrow as pa
            if part.ndim == 1:
                return pa.table({column: part})
            return pa.table({column: [row.tolist() for row in part]})
        return read

    return Dataset([exe.ReadStage([make(s) for s in splits if len(s)])])


def from_pandas(df) -> Dataset:
    import pyarrow as pa
    table = pa.Table.from_pandas(df, preserve_index=False)
    return Dataset([exe.ReadStage([lambda: table])])


def from_arrow(table) -> Dataset:
    return Dataset([exe.ReadStage([lambda: table])])


def _expand_paths(paths, suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob_mod.glob(os.path.join(p, f"*{suffix}"))))
        elif "*" in p:
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    return out


def read_parquet(paths, columns: Optional[List[str]] = None,
                 **kwargs) -> Dataset:
    files = _expand_paths(paths, ".parquet")

    def make(f, cols):
        def read():
            # one block per row group, streamed: a multi-row-group file
            # never buffers whole in the read worker (the streaming
            # generator's backpressure caps unconsumed blocks; reference:
            # fragment-level parquet reads,
            # _internal/datasource/parquet_datasource.py)
            import pyarrow.parquet as pq
            pf = pq.ParquetFile(f)
            if pf.metadata.num_row_groups <= 1:
                yield pf.read(columns=cols)
            else:
                # NB: builtins.range — this module defines its own
                # Dataset-returning `range`
                import builtins
                for g in builtins.range(pf.metadata.num_row_groups):
                    yield pf.read_row_group(g, columns=cols)
        read.yields_blocks = True
        # projection pushdown hook: the optimizer rebinds the read to
        # fetch only the projected columns (execution.ProjectStage)
        read.with_columns = lambda c: make(f, list(c))
        return read

    return Dataset([exe.ReadStage([make(f, columns) for f in files])])


def read_csv(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def make(f):
        def read():
            import pyarrow.csv as pcsv
            return pcsv.read_csv(f)
        return read

    return Dataset([exe.ReadStage([make(f) for f in files])])


def read_json(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, ".json")

    def make(f):
        def read():
            import pyarrow.json as pjson
            return pjson.read_json(f)
        return read

    return Dataset([exe.ReadStage([make(f) for f in files])])


def read_text(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, ".txt")

    def make(f):
        def read():
            import pyarrow as pa
            with open(f) as fh:
                lines = [line.rstrip("\n") for line in fh]
            return pa.table({"text": lines})
        return read

    return Dataset([exe.ReadStage([make(f) for f in files])])


def read_numpy(paths, *, column: str = "data", **kwargs) -> Dataset:
    """.npy files, one block per file (reference: read_numpy /
    NumpyDatasource)."""
    files = _expand_paths(paths, ".npy")

    def make(path):
        def read():
            import numpy as np
            import pyarrow as pa
            arr = np.load(path)
            if arr.ndim == 1:
                return pa.table({column: arr})
            return pa.table({column: [row.tolist() for row in arr]})
        return read

    return Dataset([exe.ReadStage([make(f) for f in files], **kwargs)])


def read_binary_files(paths, *, include_paths: bool = False,
                      suffix: str = "", **kwargs) -> Dataset:
    """Whole files as bytes rows (reference: read_binary_files /
    BinaryDatasource — the raw substrate for images/audio/etc.)."""
    files = _expand_paths(paths, suffix)

    def make(path):
        def read():
            import pyarrow as pa
            with open(path, "rb") as f:
                data = f.read()
            cols = {"bytes": [data]}
            if include_paths:
                cols["path"] = [path]
            return pa.table(cols)
        return read

    return Dataset([exe.ReadStage([make(f) for f in files], **kwargs)])


def read_images(paths, *, size=None, mode: str = "RGB",
                include_paths: bool = False, **kwargs) -> Dataset:
    """Image files decoded to arrays (reference: read_images /
    ImageDatasource; decoding via PIL when available, else raw bytes
    with a clear error)."""
    files = _expand_paths(paths, "")

    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff",
            ".webp")
    files = [f for f in files
             if os.path.isfile(f) and f.lower().endswith(exts)]

    def make(path):
        def read():
            import numpy as np
            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError(
                    "read_images requires pillow; use read_binary_files "
                    "for raw bytes") from e
            img = Image.open(path).convert(mode)
            if size is not None:
                img = img.resize(tuple(size))
            row = {"image": np.asarray(img)}   # tensor column, unboxed
            if include_paths:
                row["path"] = path
            return block_lib.block_from_rows([row])
        return read

    return Dataset([exe.ReadStage([make(f) for f in files], **kwargs)])


def read_tfrecords(paths, **kwargs) -> Dataset:
    """TFRecord files of tf.train.Example records (reference:
    read_tfrecords / TFRecordDatasource). Parses the record framing and
    Example protos directly — no TensorFlow dependency."""
    files = _expand_paths(paths, ".tfrecord")

    def make(path):
        def read():
            import pyarrow as pa

            from ray_tpu_torch.data import tfrecord as tfr
            rows = [tfr.example_to_row(rec)
                    for rec in tfr.read_records(path)]
            return block_lib.block_from_rows(rows) if rows else \
                pa.table({})
        return read

    return Dataset([exe.ReadStage([make(f) for f in files], **kwargs)])


def from_huggingface(dataset, *, parallelism: int = 8) -> Dataset:
    """A loaded `datasets.Dataset` (reference: from_huggingface). The
    zero-copy arrow path only applies when no lazy _indices mapping is
    pending (select/shuffle/split keep the FULL table in .data and remap
    rows lazily — reading .data directly would return the wrong rows)."""
    if getattr(dataset, "_indices", None) is None \
            and hasattr(dataset, "data"):
        table = getattr(dataset.data, "table", None)
        if table is not None:
            return from_arrow(table.combine_chunks())
    return from_items([dict(r) for r in dataset], parallelism=parallelism)

def read_sql(sql: str, connection_factory, *,
             shard_keys: Optional[List[Any]] = None,
             shard_column: Optional[str] = None) -> Dataset:
    """SQL query -> Dataset (reference: read_sql /
    _internal/datasource/sql_datasource.py). `connection_factory` is a
    zero-arg callable returning a DB-API 2.0 connection (sqlite3,
    psycopg2, ...), created INSIDE each read task so connections never
    pickle. Parallelism strategies, mirroring the reference:

    - default: one task runs the whole query (many databases cannot
      split an arbitrary query soundly);
    - shard_column + shard_keys: one task per key, appending
      ``WHERE <shard_column> = ?`` (the reference's sharded mode).
    """
    def make(where_key):
        def read():
            conn = connection_factory()
            try:
                cur = conn.cursor()
                if where_key is None:
                    cur.execute(sql)
                else:
                    # wrap as a subselect: splicing WHERE onto an
                    # arbitrary query breaks on ORDER BY/GROUP BY/LIMIT
                    # and on queries that already have a WHERE
                    cur.execute(
                        f"SELECT * FROM ({sql}) AS __rt_shard "
                        f"WHERE {shard_column} = ?", (where_key,))
                cols = [d[0] for d in cur.description]
                rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            finally:
                conn.close()
            import pyarrow as pa
            return block_lib.block_from_rows(rows) if rows else pa.table({})
        return read

    if shard_keys and shard_column:
        fns = [make(k) for k in shard_keys]
    else:
        fns = [make(None)]
    return Dataset([exe.ReadStage(fns)])


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[Dict]] = None,
               shard_match: Optional[List[Dict]] = None,
               client_factory=None) -> Dataset:
    """MongoDB collection -> Dataset (reference: read_mongo /
    _internal/datasource/mongo_datasource.py). Connections are created
    INSIDE each read task via `client_factory` (zero-arg callable
    returning a pymongo-compatible client: ``client[db][coll]
    .aggregate(pipeline)`` yielding mapping rows) so clients never
    pickle; default factory imports pymongo, failing with a clear error
    when absent (pymongo is not bundled).

    Parallelism mirrors the reference's partitioned reads: pass
    `shard_match` = one $match filter document per shard (e.g. hash
    ranges over _id) to get one read task per shard; otherwise a single
    task streams the whole aggregation.
    """
    base = list(pipeline or [])

    def make(match):
        def read():
            if client_factory is not None:
                client = client_factory()
            else:
                try:
                    import pymongo
                except ImportError as e:
                    raise ImportError(
                        "read_mongo needs pymongo (not bundled) or an "
                        "explicit client_factory") from e
                client = pymongo.MongoClient(uri)
            try:
                pipe = ([{"$match": match}] if match else []) + base
                cursor = client[database][collection].aggregate(pipe)
                rows = []
                for doc in cursor:
                    d = dict(doc)
                    # ObjectId and friends aren't arrow types
                    if "_id" in d and not isinstance(
                            d["_id"], (str, int, float, bytes)):
                        d["_id"] = str(d["_id"])
                    rows.append(d)
            finally:
                close = getattr(client, "close", None)
                if close:
                    close()
            import pyarrow as pa
            return block_lib.block_from_rows(rows) if rows else pa.table({})
        return read

    fns = ([make(m) for m in shard_match] if shard_match
           else [make(None)])
    return Dataset([exe.ReadStage(fns)])


def read_bigquery(query: Optional[str] = None, *,
                  project_id: Optional[str] = None,
                  dataset: Optional[str] = None,
                  client_factory=None) -> Dataset:
    """BigQuery query/table -> Dataset (reference: read_bigquery /
    _internal/datasource/bigquery_datasource.py). `client_factory` is a
    zero-arg callable returning a google-cloud-bigquery-compatible
    client (``client.query(sql).result()`` yielding mapping rows),
    constructed INSIDE the read task; the default factory imports
    google.cloud.bigquery (not bundled) with a clear error. Passing
    `dataset` ("ds.table") without `query` reads the whole table, like
    the reference."""
    if query is None:
        if dataset is None:
            raise ValueError("read_bigquery needs `query` or `dataset`")
        import re
        # the name is interpolated into backtick-quoted SQL: restrict it
        # to legal BigQuery dataset/table characters so a crafted string
        # can't escape the quoting and smuggle SQL
        if not re.fullmatch(r"[A-Za-z0-9_.$-]+", dataset):
            raise ValueError(
                f"invalid BigQuery dataset name {dataset!r}: expected "
                "only letters, digits, '_', '.', '$' or '-'")
        query = f"SELECT * FROM `{dataset}`"

    def read():
        if client_factory is not None:
            client = client_factory()
        else:
            try:
                from google.cloud import bigquery
            except ImportError as e:
                raise ImportError(
                    "read_bigquery needs google-cloud-bigquery (not "
                    "bundled) or an explicit client_factory") from e
            client = bigquery.Client(project=project_id)
        rows = [dict(r) for r in client.query(query).result()]
        import pyarrow as pa
        return block_lib.block_from_rows(rows) if rows else pa.table({})

    return Dataset([exe.ReadStage([read])])


def read_webdataset(paths, *, decode: bool = True) -> Dataset:
    """WebDataset tar shards -> one row per sample (reference:
    read_webdataset / webdataset_datasource.py). Files sharing a
    basename prefix group into one sample; extensions become columns
    (`{"__key__": "sample001", "jpg": bytes|array, "cls": int, ...}`).
    Pure tarfile — no webdataset dependency; decode=True decodes
    .json/.cls/.txt (and images when PIL is present), matching the
    reference's default decoder."""
    files = _expand_paths(paths, ".tar")

    def _decode(ext: str, data: bytes):
        if not decode:
            return data
        if ext in ("cls", "index", "id"):
            return int(data)
        if ext in ("txt", "text"):
            return data.decode("utf-8")
        if ext == "json":
            import json as _json
            return _json.loads(data)
        if ext in ("jpg", "jpeg", "png"):
            try:
                import io as _io

                from PIL import Image
                return np.asarray(Image.open(_io.BytesIO(data)))
            except Exception:
                return data
        return data

    def make(path):
        def read():
            import tarfile
            samples: Dict[str, Dict[str, Any]] = {}
            order: List[str] = []
            with tarfile.open(path) as tar:
                for m in tar:
                    if not m.isfile():
                        continue
                    base, _, ext = m.name.partition(".")
                    if base not in samples:
                        samples[base] = {"__key__": base}
                        order.append(base)
                    samples[base][ext] = _decode(
                        ext, tar.extractfile(m).read())
            for key in order:
                yield block_lib.block_from_rows([samples[key]])
        read.yields_blocks = True
        return read

    return Dataset([exe.ReadStage([make(f) for f in files])])
