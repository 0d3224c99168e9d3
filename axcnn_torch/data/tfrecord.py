"""First-party TFRecord + tf.train.Example codec (no TensorFlow dependency).

The reference consumes Inception-style sharded TFRecords of ``tf.train.Example``
protos with ``image/encoded`` (JPEG bytes) and ``image/class/label`` features
(SURVEY.md §2 items 4/11). TFRecord framing is trivial:

    uint64 length | uint32 masked_crc32c(length) | payload | uint32 masked_crc32c(payload)

and the Example proto needs only three wire types to decode, so we implement
both directly — the C++ loader (``cpp/``) mirrors this format; this Python
codec is the bootstrap reader and the golden-test writer.

CRC verification is optional (off by default for speed on the hot path; the
C++ loader does it in hardware-accelerated code).

The port's own copy of ``axcnn/data/tfrecord.py``, so that the port runs
without the JAX package installed. It writes and reads the same bytes; its
CRC32C runs in numpy lanes (``crc32c``) beside the byte loop
(``crc32c_bytewise``), which gives the same values.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli)
#
# ``crc32c_bytewise`` is the table-driven byte loop, the plain version.
# ``crc32c`` splits an input of at least _LANES_MIN_BYTES into K equal lanes
# of L bytes and runs the K registers in lockstep in numpy, 4 bytes a step
# (slicing-by-4, its four 256-entry tables merged into two 65,536-entry
# ones). The register is linear over GF(2): the CRC register after lanes
# 0..k is "advance the register after lanes 0..k-1 by L zero bytes" XOR
# lane k's own register from 0. That advance is a fixed 32x32 bit matrix,
# applied through four 256-entry tables of its columns, so the lanes fold
# in K table steps. The tail past K*L bytes takes the byte loop.
# ---------------------------------------------------------------------------

_CRC_POLY = 0x82F63B78
_LANES_MIN_BYTES = 1024
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ _CRC_POLY if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc_update(crc: int, data) -> int:
    tbl = _crc_table()
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def crc32c_bytewise(data: bytes) -> int:
    """CRC32C one byte at a time: the plain version of :func:`crc32c`."""
    return _crc_update(0xFFFFFFFF, data) ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def _word_tables():
    """Slicing-by-4's tables T0..T3, merged in pairs: the register after one
    4-byte step from ``r`` is ``lo[r & 0xFFFF] ^ hi[r >> 16]``."""
    t = [np.array(_crc_table(), np.uint32)]
    for _ in range(3):
        t.append((t[-1] >> 8) ^ t[0][t[-1] & 0xFF])
    lo = (t[2][:, None] ^ t[3][None, :]).ravel()
    hi = (t[0][:, None] ^ t[1][None, :]).ravel()
    return lo, hi


def _apply_bits(cols, x: int) -> int:
    y, i = 0, 0
    while x:
        if x & 1:
            y ^= cols[i]
        x >>= 1
        i += 1
    return y


@functools.lru_cache(maxsize=None)
def _advance_tables(nbytes: int):
    """Four 256-entry tables of the linear map "advance the register by
    ``nbytes`` zero bytes": the image of ``x`` is the XOR of table ``k``
    at byte ``k`` of ``x``. The map's 32 columns come from squaring the
    one-byte map."""
    tbl = _crc_table()
    step = [tbl[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
    cols = [1 << i for i in range(32)]
    while nbytes:
        if nbytes & 1:
            cols = [_apply_bits(step, c) for c in cols]
        step = [_apply_bits(step, c) for c in step]
        nbytes >>= 1
    return [[_apply_bits(cols[8 * k:8 * k + 8], b) for b in range(256)] for k in range(4)]


def _lane_bytes(n: int) -> int:
    """A power of two near sqrt(n / 8), in [64, 4096]: it balances the
    lockstep's steps (L / 4) against the fold's (n / L)."""
    return 1 << min(12, max(6, round(np.log2(max(n / 8, 1)) / 2)))


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of ``data`` (bytes-like): the byte loop's value,
    computed in numpy lanes for inputs of at least ``_LANES_MIN_BYTES``."""
    n = len(data)
    if n < _LANES_MIN_BYTES:
        return crc32c_bytewise(data)
    lane = _lane_bytes(n)
    k = n // lane
    words = np.frombuffer(data, "<u4", count=k * lane // 4).reshape(k, lane // 4).T.copy()
    lo_t, hi_t = _word_tables()
    reg = np.zeros(k, np.uint32)
    lo, hi = np.empty(k, np.intp), np.empty(k, np.intp)
    for w in words:
        reg ^= w
        np.bitwise_and(reg, 0xFFFF, out=lo, casting="unsafe")
        np.right_shift(reg, 16, out=hi, casting="unsafe")
        np.take(lo_t, lo, out=reg)
        reg ^= hi_t[hi]
    z0, z1, z2, z3 = _advance_tables(lane)
    crc = 0xFFFFFFFF
    for r in reg.tolist():
        crc = z0[crc & 0xFF] ^ z1[(crc >> 8) & 0xFF] ^ z2[(crc >> 16) & 0xFF] ^ z3[crc >> 24] ^ r
    return _crc_update(crc, memoryview(data)[k * lane:]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    """Iterates raw record payloads of one TFRecord file.

    Supports resumable iteration: ``tell()`` returns the byte offset of the
    next record, ``seek(offset)`` resumes there — the hook the reference's
    tf.data pipeline lacks for exact data-position checkpointing
    (SURVEY.md §5.3).
    """

    def __init__(self, path: str, *, verify_crc: bool = False):
        self._path = path
        self._verify = verify_crc
        self._f = open(path, "rb")

    def tell(self) -> int:
        return self._f.tell()

    def seek(self, offset: int):
        self._f.seek(offset)

    def __iter__(self) -> Iterator[bytes]:
        return self

    def __next__(self) -> bytes:
        header = self._f.read(8)
        if len(header) < 8:
            raise StopIteration
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", self._f.read(4))
        payload = self._f.read(length)
        (pcrc,) = struct.unpack("<I", self._f.read(4))
        if self._verify:
            if masked_crc32c(header) != hcrc:
                raise IOError(f"{self._path}: header CRC mismatch")
            if masked_crc32c(payload) != pcrc:
                raise IOError(f"{self._path}: payload CRC mismatch")
        return payload

    def close(self):
        self._f.close()

    def __del__(self):  # abandoned mid-iteration by resuming loaders
        try:
            self._f.close()
        except Exception:
            pass


class MmapShardReader:
    """Zero-copy record iteration: yields payloads as read-only ``np.uint8``
    VIEWS over an mmap of the whole shard.

    The hot-path companion of TFRecordReader for the native (C++) decode
    pipeline: per record the Python side does one ``struct.unpack_from`` and
    one array slice — no payload bytes are copied (the C++ loader reads the
    JPEG straight out of the page cache via the view's pointer). Views keep
    the mmap alive through numpy's base-object chain, so they can sit in the
    shuffle buffer after the reader is gone.
    """

    def __init__(self, path: str):
        import mmap as _mmap

        self._path = path
        # write_shards legitimately produces zero-byte shards (more shards
        # than items); mmap(fd, 0) raises on an empty file, so treat them as
        # zero records like TFRecordReader does
        if os.path.getsize(path) == 0:
            self._mm = b""
        else:
            with open(path, "rb") as f:
                self._mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        self._arr = np.frombuffer(self._mm, np.uint8)

    def __iter__(self):
        arr = self._arr
        mm = self._mm
        n = len(mm)
        pos = 0
        while pos + 8 <= n:
            (length,) = struct.unpack_from("<Q", mm, pos)
            start = pos + 12  # 8B length + 4B length-crc
            yield arr[start:start + length]
            pos = start + length + 4  # + payload crc


def count_records(path: str) -> int:
    """Number of records in a shard, by framing scan (seek past payloads —
    no payload reads, no parsing). Used for multi-host eval batch-count
    agreement."""
    n = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return n
            (length,) = struct.unpack("<Q", header)
            f.seek(4 + length + 4, 1)  # header crc + payload + payload crc
            n += 1


# ---------------------------------------------------------------------------
# minimal tf.train.Example proto codec
#
# Example        = { 1: Features }
# Features       = { 1: map<string, Feature> }  (map entry: {1: key, 2: value})
# Feature        = { 1: BytesList | 2: FloatList | 3: Int64List }
# BytesList      = { 1: repeated bytes }
# FloatList      = { 1: repeated float  (packed) }
# Int64List      = { 1: repeated int64  (packed) }
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:  # varint
            v, pos = _read_varint(buf, pos)
            yield field, v
        elif wire == 5:  # 32-bit
            yield field, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf: bytes):
    for field, val in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList
            floats = []
            for f, v in _iter_fields(val):
                if f == 1:
                    if isinstance(v, bytes):  # packed or single fixed32
                        floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                    else:
                        raise ValueError("bad float encoding")
            return floats
        if field == 3:  # Int64List
            ints = []
            for f, v in _iter_fields(val):
                if f == 1:
                    if isinstance(v, int):
                        # reinterpret as signed
                        ints.append(v - (1 << 64) if v >= (1 << 63) else v)
                    else:  # packed
                        pos = 0
                        while pos < len(v):
                            x, pos = _read_varint(v, pos)
                            ints.append(x - (1 << 64) if x >= (1 << 63) else x)
            return ints
    return []


def parse_example(payload: bytes) -> dict:
    """Decode a serialized tf.train.Example into {name: list-of-values}."""
    out = {}
    for field, val in _iter_fields(payload):
        if field != 1:
            continue
        for f2, entry in _iter_fields(val):  # Features.feature map entries
            if f2 != 1:
                continue
            key, feature = None, None
            for f3, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feature = v3
            if key is not None and feature is not None:
                out[key] = _decode_feature(feature)
    return out


def _encode_feature(values) -> bytes:
    inner = bytearray()
    if not values:
        raise ValueError("empty feature")
    if isinstance(values[0], (bytes, str)):
        for v in values:
            if isinstance(v, str):
                v = v.encode()
            inner.append((1 << 3) | 2)
            _write_varint(inner, len(v))
            inner.extend(v)
        kind = 1
    elif isinstance(values[0], float):
        packed = struct.pack(f"<{len(values)}f", *values)
        inner.append((1 << 3) | 2)
        _write_varint(inner, len(packed))
        inner.extend(packed)
        kind = 2
    elif isinstance(values[0], int):
        for v in values:
            inner.append((1 << 3) | 0)
            _write_varint(inner, v & ((1 << 64) - 1) if v < 0 else v)
        kind = 3
    else:
        raise TypeError(f"unsupported feature type {type(values[0])}")
    out = bytearray()
    out.append((kind << 3) | 2)
    _write_varint(out, len(inner))
    out.extend(inner)
    return bytes(out)


def make_example(features: dict) -> bytes:
    """Encode {name: list} into a serialized tf.train.Example."""
    fmap = bytearray()
    for key, values in features.items():
        kb = key.encode()
        feat = _encode_feature(values)
        entry = bytearray()
        entry.append((1 << 3) | 2)
        _write_varint(entry, len(kb))
        entry.extend(kb)
        entry.append((2 << 3) | 2)
        _write_varint(entry, len(feat))
        entry.extend(feat)
        fmap.append((1 << 3) | 2)
        _write_varint(fmap, len(entry))
        fmap.extend(entry)
    example = bytearray()
    example.append((1 << 3) | 2)
    _write_varint(example, len(fmap))
    example.extend(fmap)
    return bytes(example)


def list_shards(data_dir: str, pattern_prefix: str) -> list[str]:
    """Inception-style shard listing: ``<prefix>-00000-of-01024`` files."""
    files = sorted(
        os.path.join(data_dir, f)
        for f in os.listdir(data_dir)
        if f.startswith(pattern_prefix)
    )
    if not files:
        raise FileNotFoundError(f"no shards matching {pattern_prefix}* in {data_dir}")
    return files
