"""GCS store clients: the persistence interface behind the GCS
(reference: src/ray/gcs/store_client/ — StoreClient ABC with
Redis/in-memory/observable implementations; redis_store_client.h:106 is
the synchronous durable write the WAL mirrors here).

Two implementations:
- FileStoreClient — node-local snapshot + write-ahead log + address
  file. Survives GCS process death; head-node disk loss loses the
  cluster.
- ExternalStoreClient — snapshot + address on any fsspec URI
  (gs://bucket/..., memory:// in tests) via ray_tpu_torch.util.storage, so a
  replacement GCS on a DIFFERENT host can restart from the store the
  way the reference's Redis-backed GCS-FT does. Object stores don't
  append, so the WAL degrades to snapshot-interval durability — the
  trade is stated here rather than hidden.

The address file is the discovery channel: the GCS writes its live
address on startup; node managers that lose the GCS re-read it before
reconnecting, so a restart on a new port/host heals without restarting
the raylets (reference: raylets re-resolve the GCS address from Redis).
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional, Tuple

logger = logging.getLogger(__name__)


class StoreClient:
    """Durable state for one GCS instance."""

    #: False when wal_append is a no-op — callers skip serializing the
    #: record at all (per-mutation msgpack on the GCS hot path)
    wal_enabled: bool = True

    def save_snapshot(self, blob: bytes) -> None:
        raise NotImplementedError

    def load_snapshot(self) -> Optional[bytes]:
        raise NotImplementedError

    def wal_append(self, record: bytes) -> None:
        raise NotImplementedError

    def wal_records(self) -> Iterator[bytes]:
        raise NotImplementedError

    def wal_reset(self) -> None:
        """Called after a snapshot covers everything the WAL recorded."""
        raise NotImplementedError

    def write_address(self, address: str) -> None:
        raise NotImplementedError

    def read_address(self) -> Optional[str]:
        raise NotImplementedError


class FileStoreClient(StoreClient):
    """Snapshot at `path`, WAL at `path.wal`, address at `path.addr`."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._wal = None

    # ------------------------------------------------------------ snapshot
    def save_snapshot(self, blob: bytes) -> None:
        tmp = f"{self.path}.tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.path)

    def load_snapshot(self) -> Optional[bytes]:
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            return f.read()

    # ----------------------------------------------------------------- wal
    def wal_append(self, record: bytes) -> None:
        if self._wal is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._wal = open(self.path + ".wal", "ab")
        self._wal.write(len(record).to_bytes(4, "little") + record)
        self._wal.flush()
        if self.fsync:
            os.fsync(self._wal.fileno())

    def wal_records(self) -> Iterator[bytes]:
        path = self.path + ".wal"
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            raw = f.read()
        off = 0
        while off + 4 <= len(raw):
            ln = int.from_bytes(raw[off:off + 4], "little")
            if off + 4 + ln > len(raw):
                break          # torn tail write: ignore
            yield raw[off + 4:off + 4 + ln]
            off += 4 + ln

    def wal_reset(self) -> None:
        if self._wal is not None:
            try:
                self._wal.close()
            except Exception:
                pass
            self._wal = None
        try:
            os.unlink(self.path + ".wal")
        except OSError:
            pass

    # ------------------------------------------------------------- address
    def write_address(self, address: str) -> None:
        tmp = f"{self.path}.addr.tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(address)
        os.replace(tmp, self.path + ".addr")

    def read_address(self) -> Optional[str]:
        try:
            with open(self.path + ".addr") as f:
                return f.read().strip() or None
        except OSError:
            return None


class ExternalStoreClient(StoreClient):
    """Snapshot + address on an fsspec URI. No append on object stores,
    so mutations between snapshots are NOT durable here — durability is
    the snapshot interval (documented trade; the reference's Redis gives
    per-write durability, a future external impl with a log-capable
    backend can too)."""

    wal_enabled = False

    def __init__(self, uri: str):
        from ray_tpu_torch.util import storage
        self._s = storage
        self.uri = uri.rstrip("/")

    def save_snapshot(self, blob: bytes) -> None:
        self._s.write_bytes(f"{self.uri}/snapshot.bin", blob)

    def load_snapshot(self) -> Optional[bytes]:
        if not self._s.exists(f"{self.uri}/snapshot.bin"):
            return None
        return self._s.read_bytes(f"{self.uri}/snapshot.bin")

    def wal_append(self, record: bytes) -> None:
        pass    # see class docstring

    def wal_records(self) -> Iterator[bytes]:
        return iter(())

    def wal_reset(self) -> None:
        pass

    def write_address(self, address: str) -> None:
        self._s.write_bytes(f"{self.uri}/gcs.addr",
                            address.encode("utf-8"))

    def read_address(self) -> Optional[str]:
        if not self._s.exists(f"{self.uri}/gcs.addr"):
            return None
        return self._s.read_bytes(f"{self.uri}/gcs.addr") \
            .decode("utf-8").strip() or None


def store_client_for(target: str, fsync: bool = False) -> StoreClient:
    """path -> FileStoreClient; URI (scheme://) -> ExternalStoreClient."""
    from ray_tpu_torch.util import storage
    scheme, path = storage._split(target)
    if scheme:
        client = ExternalStoreClient(target)
        if not _WARNED_EXTERNAL_WAL.get(scheme):
            _WARNED_EXTERNAL_WAL[scheme] = True
            logger.warning(
                "gcs persistence on %s:// disables the WAL: durability "
                "is the snapshot interval, not per-mutation as with a "
                "local path (gcs_wal_fsync ignored). The reference's "
                "Redis store client persists every write.", scheme)
        return client
    return FileStoreClient(path, fsync=fsync)


_WARNED_EXTERNAL_WAL: dict = {}
