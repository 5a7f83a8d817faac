"""Every reader and ``from_*`` constructor of the port's Data
(``ray_tpu_torch/data/read_api.py``, ``tfrecord.py``) against the JAX
package's, on local files and on fakes of the database clients
(counterparts of ``tests/test_data_sources2.py``, ``tests/
test_data_streaming.py`` and the readers of ``tests/test_data_ingest.py``).

The port reads on its own runtime and the JAX package on the eager
in-process runtime of ``tests/torch_data_cases.py``; the rows, their
order and the block counts are equal exactly. The fakes stand for
pymongo, google-cloud-bigquery and Hugging Face ``datasets``, none of
which is installed, so no test reaches a server."""

import io
import json
import sqlite3
import tarfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_tpu
import ray_tpu.data as rdj
import ray_tpu_torch as rt
import ray_tpu_torch.data as rdt
from ray_tpu.data import execution as exe_j
from ray_tpu.data import tfrecord as tfr_j
from ray_tpu_torch.data import execution as exe_t
from ray_tpu_torch.data import tfrecord as tfr_t
from tests.torch_data_cases import eager_runtime


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, object_store_memory=128 * 2 ** 20)
    yield
    rt.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One directory of every local format, made from a numpy seed."""
    d = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(17)
    a = rng.integers(0, 1000, 100)
    b = rng.normal(size=100)
    t = pa.table({"a": a, "b": b, "payload": [b"x" * 100] * 100,
                  "vec": [list(map(int, rng.integers(0, 9, 4)))
                          for _ in range(100)]})
    pq.write_table(t, str(d / "t.parquet"), row_group_size=25)
    import pyarrow.csv as pcsv
    for i in range(2):
        pcsv.write_csv(t.select(["a", "b"]).slice(i * 50, 50),
                       str(d / f"p{i}.csv"))
    with open(d / "r.json", "w") as f:
        for x, y in zip(a[:20], b[:20]):
            f.write(json.dumps({"a": int(x), "b": float(y)}) + "\n")
    (d / "lines.txt").write_text("".join(f"line {i}\n" for i in range(7)))
    np.save(d / "m.npy", rng.normal(size=(6, 3)).astype(np.float32))
    np.save(d / "v.npy", np.arange(10, dtype=np.int64))
    (d / "b1.bin").write_bytes(b"hello")
    (d / "b2.bin").write_bytes(bytes(range(256)))
    from PIL import Image
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (5, 4, 3), dtype=np.uint8)
                        ).save(d / f"img{i}.png")
    with tarfile.open(d / "shard-000.tar", "w") as tar:
        for i in range(3):
            for ext, payload in (("cls", str(i).encode()),
                                 ("txt", f"sample {i}".encode()),
                                 ("json", json.dumps({"idx": i}).encode()),
                                 ("bin", bytes([i] * 5))):
                info = tarfile.TarInfo(f"sample{i:03d}.{ext}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    db = str(d / "kv.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE kv (k INTEGER, grp TEXT, v REAL)")
    conn.executemany("INSERT INTO kv VALUES (?, ?, ?)",
                     [(i, "ab"[i % 2], float(i) / 3) for i in range(20)])
    conn.commit()
    conn.close()
    return d


def _rows(ds):
    return ds.take_all(), ds.num_blocks()


def _both(make):
    with eager_runtime(ray_tpu):
        want = _rows(make(rdj))
    return _rows(make(rdt)), want


def _norm(rows):
    """numpy arrays (image and tensor columns) compare by value."""
    out = []
    for r in rows:
        out.append({k: (v.tolist(), str(v.dtype)) if isinstance(
            v, np.ndarray) else v for k, v in r.items()})
    return out


READERS = {
    "parquet": lambda rd, d: rd.read_parquet(str(d / "t.parquet")),
    "parquet_columns": lambda rd, d: rd.read_parquet(
        str(d / "t.parquet"), columns=["b"]),
    "parquet_glob": lambda rd, d: rd.read_parquet(str(d / "*.parquet")),
    "csv_dir": lambda rd, d: rd.read_csv(str(d)),
    "json": lambda rd, d: rd.read_json(str(d / "r.json")),
    "text": lambda rd, d: rd.read_text(str(d / "lines.txt")),
    "numpy": lambda rd, d: rd.read_numpy([str(d / "m.npy"),
                                          str(d / "v.npy")], column="x"),
    "binary": lambda rd, d: rd.read_binary_files(
        [str(d / "b1.bin"), str(d / "b2.bin")], include_paths=True),
    "images": lambda rd, d: rd.read_images(str(d), include_paths=True),
    "images_resized": lambda rd, d: rd.read_images(str(d), size=(2, 3),
                                                   mode="L"),
    "webdataset": lambda rd, d: rd.read_webdataset(
        str(d / "shard-000.tar")),
    "webdataset_raw": lambda rd, d: rd.read_webdataset(
        str(d / "shard-000.tar"), decode=False),
    "sql": lambda rd, d: rd.read_sql(
        "SELECT k, v FROM kv ORDER BY k", lambda: sqlite3.connect(
            str(d / "kv.db"))),
    "sql_sharded": lambda rd, d: rd.read_sql(
        "SELECT k, grp FROM kv WHERE k >= 2 ORDER BY k",
        lambda: sqlite3.connect(str(d / "kv.db")),
        shard_column="grp", shard_keys=["a", "b"]),
    "range": lambda rd, d: rd.range(23, parallelism=4),
    "from_items": lambda rd, d: rd.from_items(
        [{"x": i, "s": str(i)} for i in range(11)] + [3, 4]),
    "from_numpy_1d": lambda rd, d: rd.from_numpy(np.arange(9), "c",
                                                 parallelism=3),
    "from_numpy_2d": lambda rd, d: rd.from_numpy(
        np.arange(12).reshape(6, 2), parallelism=4),
    "from_pandas": lambda rd, d: rd.from_pandas(
        pq.read_table(str(d / "t.parquet")).select(["a", "b"]).to_pandas()),
    "from_arrow": lambda rd, d: rd.from_arrow(pa.table({"z": [1, 2, 3]})),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches_jax(runtime, files, name):
    (got, got_n), (want, want_n) = _both(lambda rd: READERS[name](rd, files))
    assert _norm(got) == _norm(want) and got_n == want_n
    assert got, name


def test_parquet_row_groups_stream_as_blocks(runtime, files):
    ds = rdt.read_parquet(str(files / "t.parquet"))
    assert ds.num_blocks() == 4      # four row groups of 25


def test_projection_pushdown_rebinds_the_read_like_jax(files):
    path = str(files / "t.parquet")
    for rd, exe in ((rdj, exe_j), (rdt, exe_t)):
        for ds, cols in (
                (rd.read_parquet(path).select_columns(["a"]), ["a"]),
                (rd.read_parquet(path).select_columns(["a", "b"])
                 .select_columns(["a"]), ["a", "b"]),
                (rd.read_parquet(path).limit(10).select_columns(["b"]),
                 ["b"]),
                (rd.read_parquet(path).map(lambda r: r)
                 .select_columns(["b"]), ["a", "b", "payload", "vec"])):
            read = exe.optimize_plan(list(ds._stages))[0]
            assert isinstance(read, exe.ReadStage)
            assert next(iter(read.read_fns[0]())).column_names == cols


def test_projection_end_to_end(runtime, files):
    path = str(files / "t.parquet")
    rows = rdt.read_parquet(path).select_columns(["a", "b"]) \
        .select_columns(["a"]).take(3)
    want = pq.read_table(path).column("a").to_pylist()[:3]
    assert rows == [{"a": v} for v in want]


def test_tfrecords_cross_read(runtime, tmp_path):
    """A TFRecord file written by each package's codec reads back the
    same through the other's reader; the bytes of both files are equal."""
    rows = [{"label": i, "name": f"row{i}", "score": [float(i), i * 2.5],
             "ids": [i, -i, 2 ** 40]} for i in range(5)]
    paths = {}
    for name, tfr in (("jax", tfr_j), ("port", tfr_t)):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        tfr.write_records(paths[name], [tfr.row_to_example(r) for r in rows])
    assert open(paths["jax"], "rb").read() == \
        open(paths["port"], "rb").read()
    got = rdt.read_tfrecords(paths["jax"]).take_all()
    with eager_runtime(ray_tpu):
        want = rdj.read_tfrecords(paths["port"]).take_all()
    assert got == want and [r["label"] for r in got] == list(range(5))
    assert got[2]["score"] == [2.0, 5.0] and got[1]["ids"] == [1, -1, 2 ** 40]
    back = [tfr_t.example_to_row(r) for r in
            tfr_t.read_records(paths["jax"], validate=True)]
    assert back[2]["name"] == "row2"


def test_tfrecord_validation_like_jax(tmp_path):
    path = str(tmp_path / "v.tfrecord")
    tfr_t.write_records(path, [tfr_t.row_to_example(
        {"a": np.float32(1.5), "b": np.int64(7)})])
    (row,) = [tfr_t.example_to_row(r) for r in
              tfr_t.read_records(path, validate=True)]
    assert row == {"a": 1.5, "b": 7}
    blob = bytearray(open(path, "rb").read())
    blob[14] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(blob))
    for tfr in (tfr_j, tfr_t):
        with pytest.raises(ValueError, match="corrupt"):
            list(tfr.read_records(bad, validate=True))
    assert tfr_t.crc32c(b"123456789") == tfr_j.crc32c(b"123456789") \
        == 0xE3069283


# ------------------------------------------ clients that are faked here

class _FakeObjectId:
    """Not an arrow type: read_mongo stringifies it."""

    def __init__(self, i):
        self.i = i

    def __str__(self):
        return f"oid-{self.i:04d}"


class _FakeMongoCollection:
    def __init__(self, docs):
        self._docs = docs

    def aggregate(self, pipeline):
        docs = self._docs
        for stage in pipeline:
            if "$match" in stage:
                docs = [d for d in docs if all(
                    d.get(k) == v for k, v in stage["$match"].items())]
            elif "$project" in stage:
                keep = [k for k, v in stage["$project"].items() if v]
                docs = [{k: d[k] for k in keep if k in d} for d in docs]
            else:
                raise ValueError(f"fake mongo: unsupported stage {stage}")
        return iter(docs)


class FakeMongoClient:
    """pymongo's surface: client[db][coll].aggregate(...)."""

    def __getitem__(self, db):
        return {"events": _FakeMongoCollection(
            [{"_id": _FakeObjectId(i), "grp": "ab"[i % 2], "v": i}
             for i in range(10)])}

    def close(self):
        pass


class _FakeBqJob:
    def __init__(self, rows):
        self._rows = rows

    def result(self):
        return iter(self._rows)


class FakeBqClient:
    """google-cloud-bigquery's surface: client.query(sql).result()."""

    def query(self, sql):
        if "`ds.t`" in sql:
            return _FakeBqJob([{"x": i, "name": f"n{i}"} for i in range(5)])
        return _FakeBqJob([{"x": 1}])


class FakeHfDataset:
    """A loaded ``datasets.Dataset``: an arrow table under ``.data.table``
    and, after a select/shuffle, a lazy ``_indices`` mapping that the
    table alone does not show."""

    def __init__(self, table, indices=None):
        self.data = type("D", (), {"table": table})()
        self._indices = indices

    def __iter__(self):
        rows = self.data.table.to_pylist()
        order = self._indices if self._indices is not None \
            else range(len(rows))
        return (rows[i] for i in order)


SOURCES = {
    "mongo": lambda rd: rd.read_mongo("mongodb://unused", "db", "events",
                                      client_factory=FakeMongoClient),
    "mongo_sharded": lambda rd: rd.read_mongo(
        "mongodb://unused", "db", "events",
        pipeline=[{"$project": {"grp": 1, "v": 1}}],
        shard_match=[{"grp": "a"}, {"grp": "b"}],
        client_factory=FakeMongoClient),
    "bigquery_query": lambda rd: rd.read_bigquery(
        "SELECT x FROM t", client_factory=FakeBqClient),
    "bigquery_table": lambda rd: rd.read_bigquery(
        dataset="ds.t", client_factory=FakeBqClient),
    "huggingface_table": lambda rd: rd.from_huggingface(FakeHfDataset(
        pa.table({"q": list(range(6)), "t": list("abcdef")}))),
    "huggingface_indices": lambda rd: rd.from_huggingface(FakeHfDataset(
        pa.table({"q": list(range(6)), "t": list("abcdef")}),
        indices=[5, 0, 3]), parallelism=2),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_client_source_matches_jax(runtime, name):
    (got, got_n), (want, want_n) = _both(SOURCES[name])
    assert got == want and got_n == want_n and got


def test_bigquery_rejects_an_identifier_that_could_escape_its_quotes():
    """read_bigquery(dataset=) interpolates the name into backtick-quoted
    SQL, so a name outside [A-Za-z0-9_.$-] is refused before any client
    is made, in both packages; so is a call with neither argument."""
    for rd in (rdj, rdt):
        for bad in ("ds.t` ; DROP TABLE x; --", "a b", "t`", ""):
            with pytest.raises(ValueError, match="invalid BigQuery"):
                rd.read_bigquery(dataset=bad, client_factory=FakeBqClient)
        with pytest.raises(ValueError, match="query.*or.*dataset"):
            rd.read_bigquery()
    assert rdt.read_bigquery(dataset="proj-1.ds_2.t$3",
                             client_factory=FakeBqClient)
