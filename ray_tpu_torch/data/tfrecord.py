"""Minimal TFRecord + tf.train.Example codec, no TensorFlow dependency
(counterpart of ``ray_tpu/data/tfrecord.py``, same wire format)
(reference: python/ray/data/_internal/datasource/tfrecords_datasource.py —
that one parses with TF/protobuf; this is a self-contained wire-format
implementation: TFRecord framing with masked crc32c, and the tiny protobuf
subset Example actually uses).

Wire format per record:
    uint64 length (LE) | uint32 masked_crc32c(length bytes) |
    payload | uint32 masked_crc32c(payload)

Example proto subset:
    Example      := field 1 (Features)
    Features     := repeated field 1 (map entry: key=str, value=Feature)
    Feature      := oneof field 1 BytesList / 2 FloatList / 3 Int64List
    BytesList    := repeated field 1 bytes
    FloatList    := repeated field 1 float (packed)
    Int64List    := repeated field 1 varint (packed)
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# ------------------------------------------------------------------ crc32c
_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (_CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------- framing
def read_records(path: str, *, validate: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                if validate:
                    raise ValueError(f"truncated record header in {path}")
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            pcrc_raw = f.read(4)
            if len(payload) < length or len(pcrc_raw) < 4:
                if validate:
                    raise ValueError(f"truncated record in {path}")
                return
            if validate:
                (hcrc,) = struct.unpack("<I", header[8:])
                if _masked_crc(header[:8]) != hcrc:
                    raise ValueError(f"corrupt record header in {path}")
                (pcrc,) = struct.unpack("<I", pcrc_raw)
                if _masked_crc(payload) != pcrc:
                    raise ValueError(f"corrupt record payload in {path}")
            yield payload


def write_records(path: str, payloads: List[bytes]) -> None:
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------------- proto codec
def _read_varint(data: bytes, i: int):
    out = shift = 0
    while True:
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(data: bytes) -> Iterator[tuple]:
    """(field_number, wire_type, value) over a serialized message."""
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(data, i)
        elif wt == 2:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            i += ln
        elif wt == 5:
            v = data[i:i + 4]
            i += 4
        elif wt == 1:
            v = data[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _decode_feature(data: bytes):
    for field, wt, v in _fields(data):
        if field == 1:      # BytesList
            return [bv for f2, _, bv in _fields(v) if f2 == 1]
        if field == 2:      # FloatList (packed or repeated)
            floats: List[float] = []
            for f2, wt2, fv in _fields(v):
                if f2 != 1:
                    continue
                if wt2 == 2:
                    floats.extend(struct.unpack(f"<{len(fv) // 4}f", fv))
                else:
                    floats.append(struct.unpack("<f", fv)[0])
            return floats
        if field == 3:      # Int64List
            ints: List[int] = []
            for f2, wt2, iv in _fields(v):
                if f2 != 1:
                    continue
                if wt2 == 2:
                    j = 0
                    while j < len(iv):
                        n, j = _read_varint(iv, j)
                        ints.append(n - (1 << 64) if n >= 1 << 63 else n)
                else:
                    ints.append(iv - (1 << 64) if iv >= 1 << 63 else iv)
            return ints
    return []


def example_to_row(payload: bytes) -> Dict[str, Any]:
    """Serialized tf.train.Example -> {column: scalar-or-list}."""
    row: Dict[str, Any] = {}
    for field, _, features in _fields(payload):
        if field != 1:
            continue
        for f2, _, entry in _fields(features):
            if f2 != 1:
                continue
            key = None
            value = None
            for f3, _, v in _fields(entry):
                if f3 == 1:
                    key = v.decode()
                elif f3 == 2:
                    value = _decode_feature(v)
            if key is not None:
                if isinstance(value, list) and len(value) == 1:
                    value = value[0]
                if isinstance(value, bytes):
                    try:
                        value = value.decode()
                    except UnicodeDecodeError:
                        pass
                row[key] = value
    return row


def _encode_feature(values) -> bytes:
    import numpy as np
    # normalize numpy scalars so dtype quirks can't flip the branch
    values = [v.item() if isinstance(v, np.generic) else v for v in values]
    inner = bytearray()
    if values and isinstance(values[0], (bytes, str)):
        for v in values:
            b = v.encode() if isinstance(v, str) else v
            inner.append((1 << 3) | 2)
            _write_varint(inner, len(b))
            inner += b
        kind = 1
    elif values and isinstance(values[0], float):
        packed = struct.pack(f"<{len(values)}f", *values)
        inner.append((1 << 3) | 2)
        _write_varint(inner, len(packed))
        inner += packed
        kind = 2
    else:
        packed = bytearray()
        for v in values:
            _write_varint(packed, v & ((1 << 64) - 1))
        inner.append((1 << 3) | 2)
        _write_varint(inner, len(packed))
        inner += packed
        kind = 3
    out = bytearray()
    out.append((kind << 3) | 2)
    _write_varint(out, len(inner))
    out += inner
    return bytes(out)


def row_to_example(row: Dict[str, Any]) -> bytes:
    """{column: scalar-or-list} -> serialized tf.train.Example."""
    entries = bytearray()
    for key, value in row.items():
        values = value if isinstance(value, (list, tuple)) else [value]
        kb = key.encode()
        feat = _encode_feature(list(values))
        entry = bytearray()
        entry.append((1 << 3) | 2)
        _write_varint(entry, len(kb))
        entry += kb
        entry.append((2 << 3) | 2)
        _write_varint(entry, len(feat))
        entry += feat
        entries.append((1 << 3) | 2)
        _write_varint(entries, len(entry))
        entries += entry
    out = bytearray()
    out.append((1 << 3) | 2)
    _write_varint(out, len(entries))
    out += entries
    return bytes(out)
