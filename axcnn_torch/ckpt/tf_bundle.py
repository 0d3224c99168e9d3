"""TensorFlow's V2 checkpoint bundle, read without TensorFlow.

A TF 1.x ``Saver`` (and ``tf.raw_ops.SaveV2``) writes ``<prefix>.index``
and ``<prefix>.data-NNNNN-of-MMMMM``. The index is a LevelDB-style table:

- a 48-byte footer: the metaindex and index blocks' handles (two varint64s
  each: offset, size), zero padding to 40 bytes, the fixed64 magic
  ``0xdb4775248b80fb57``;
- blocks of entries, each followed by a 5-byte trailer: a compression byte
  (0 = none; TF's bundles are not compressed) and the masked CRC32C of the
  block and that byte. An entry is varint32 ``shared``, ``non_shared`` and
  ``value_length``, the key's last ``non_shared`` bytes (the first
  ``shared`` are the previous key's), then the value; a fixed32 restart
  array and its length close the block;
- the index block maps a separator key to each data block's handle.

Key ``""`` holds a ``BundleHeaderProto`` (``num_shards`` 1, ``endianness``
2, ``version`` 3). Every other key holds a ``BundleEntryProto``: ``dtype``
1, ``shape`` 2 (a ``TensorShapeProto``: ``dim`` 2, each with ``size`` 1),
``shard_id`` 3, ``offset`` 4, ``size`` 5, ``crc32c`` 6 (fixed32, masked as
in TFRecords) and ``slices`` 7. A partitioned variable's entry lists its
slices; each slice has an entry of its own under a key that starts with a
NUL byte, which is not a variable and is left out of the maps.

``BundleReader`` gives what ``tf.train.load_checkpoint`` gives the
reference's importer: the shape and dtype maps and ``get_tensor``, which
checks the tensor's CRC on every read. It refuses, naming the cause: a V1
checkpoint (one file, no ``.index``), a big-endian bundle, a compressed
block, and, when asked for, a partitioned variable, a string tensor or a
dtype it does not map. A corrupt byte in the index or the data raises.
"""

from __future__ import annotations

import codecs
import os
import re
import struct

import numpy as np

from axcnn_torch.data.tfrecord import _iter_fields, _read_varint, masked_crc32c

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
# DataType enum values -> (name, little-endian numpy dtype of the stored bytes)
DTYPES = {1: ("float32", "<f4"), 2: ("float64", "<f8"), 3: ("int32", "<i4"),
          9: ("int64", "<i8"), 10: ("bool", "?"), 14: ("bfloat16", "<u2"),
          19: ("float16", "<f2")}
DT_STRING = 7
_STATE_FILE = "checkpoint"


class CorruptBundleError(IOError):
    """A checksum, a magic number or a length in the bundle is wrong."""


def _u32(buf, pos):
    return struct.unpack_from("<I", buf, pos)[0]


def _handle(buf, pos):
    """A BlockHandle (varint64 offset, varint64 size) at ``pos``."""
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def _block(index: bytes, handle, path: str) -> bytes:
    offset, size = handle
    end = offset + size + BLOCK_TRAILER_BYTES
    if end > len(index) - FOOTER_BYTES:
        raise CorruptBundleError(f"{path}: block at {offset} (+{size}) runs past the table")
    data, kind = index[offset:offset + size], index[offset + size]
    if _u32(index, offset + size + 1) != masked_crc32c(index[offset:offset + size + 1]):
        raise CorruptBundleError(f"{path}: CRC mismatch in the block at {offset}")
    if kind != 0:
        raise ValueError(f"{path}: block at {offset} is compressed (type {kind}); "
                         "the reader takes uncompressed tables only, as TF writes them")
    return data


def _block_entries(block: bytes, path: str):
    """(key, value) of each entry of a block, keys as bytes."""
    if len(block) < 4:
        raise CorruptBundleError(f"{path}: block of {len(block)} bytes")
    n_restarts = _u32(block, len(block) - 4)
    limit = len(block) - 4 - 4 * n_restarts
    if limit < 0:
        raise CorruptBundleError(f"{path}: {n_restarts} restarts in a block of {len(block)} bytes")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        n_value, pos = _read_varint(block, pos)
        if shared > len(key) or pos + non_shared + n_value > limit:
            raise CorruptBundleError(f"{path}: bad entry at byte {pos} of a block")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _table_entries(index: bytes, path: str):
    if len(index) < FOOTER_BYTES:
        raise CorruptBundleError(f"{path}: {len(index)} bytes, shorter than a table footer")
    footer = index[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0] != TABLE_MAGIC:
        raise CorruptBundleError(f"{path}: not a table (bad magic number)")
    _, pos = _handle(footer, 0)  # the metaindex block: TF writes it empty
    index_handle, _ = _handle(footer, pos)
    for _, value in _block_entries(_block(index, index_handle, path), path):
        yield from _block_entries(_block(index, _handle(value, 0)[0], path), path)


class _Entry:
    __slots__ = ("dtype", "shape", "shard", "offset", "size", "crc", "slices")

    def __init__(self, value: bytes):
        self.dtype, self.shape, self.shard, self.offset, self.size = 0, (), 0, 0, 0
        self.crc, self.slices = None, 0
        for field, v in _iter_fields(value):
            if field == 1:
                self.dtype = v
            elif field == 2:
                self.shape = _shape(v)
            elif field == 3:
                self.shard = v
            elif field == 4:
                self.offset = v
            elif field == 5:
                self.size = v
            elif field == 6:
                self.crc = struct.unpack("<I", v)[0]
            elif field == 7:
                self.slices += 1


def _shape(buf: bytes) -> tuple:
    """A ``TensorShapeProto``'s dims (``dim`` 2, each with ``size`` 1)."""
    return tuple(next((size for f, size in _iter_fields(dim) if f == 1), 0)
                 for field, dim in _iter_fields(buf) if field == 2)


def _dtype_name(dtype: int) -> str:
    if dtype in DTYPES:
        return DTYPES[dtype][0]
    return "string" if dtype == DT_STRING else f"DataType {dtype}"


def _state_file_prefix(directory: str) -> str:
    """The newest checkpoint named in ``directory``'s ``checkpoint`` state
    file (``model_checkpoint_path: "..."``, relative to the directory or
    absolute), as ``tf.train.latest_checkpoint`` resolves it."""
    state = os.path.join(directory, _STATE_FILE)
    if not os.path.isfile(state):
        raise FileNotFoundError(f"no '{_STATE_FILE}' state file in {directory}")
    with open(state) as f:
        m = re.search(r'^\s*model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', f.read(), re.M)
    if m is None:
        raise ValueError(f"{state} names no model_checkpoint_path")
    name = codecs.escape_decode(m.group(1).encode())[0].decode()
    return name if os.path.isabs(name) else os.path.join(directory, name)


class BundleReader:
    """A TF V2 checkpoint: ``path`` is its prefix (``.../model.ckpt-100``) or
    a directory whose ``checkpoint`` state file names one."""

    def __init__(self, path: str):
        prefix = _state_file_prefix(path) if os.path.isdir(path) else path
        if not os.path.isfile(prefix + ".index"):
            if os.path.isfile(prefix):
                raise ValueError(
                    f"{prefix} is a V1 checkpoint (one file, no .index); the reader takes "
                    "TF's V2 bundle (<prefix>.index and <prefix>.data-*), which TF 1.x's "
                    "Saver writes by default")
            raise FileNotFoundError(f"no checkpoint at {prefix} ({prefix}.index is missing)")
        self.prefix = prefix
        with open(prefix + ".index", "rb") as f:
            index = f.read()
        entries = dict(_table_entries(index, prefix + ".index"))
        if b"" not in entries:
            raise ValueError(f"{prefix}.index has no bundle header")
        header = dict(_iter_fields(entries.pop(b"")))
        if header.get(2, 0) != 0:
            raise ValueError(f"{prefix} is a big-endian bundle; the reader takes "
                             "little-endian ones only")
        self.num_shards = header.get(1, 1)
        self._entries = {k.decode(): _Entry(v) for k, v in entries.items()
                         if not k.startswith(b"\x00")}  # NUL: a partition's slice

    def get_variable_to_shape_map(self) -> dict:
        return {name: list(e.shape) for name, e in self._entries.items()}

    def get_variable_to_dtype_map(self) -> dict:
        """``{name: dtype name}``, TF's names (``"float32"``, ``"bfloat16"``)."""
        return {name: _dtype_name(e.dtype) for name, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor ``name`` as a numpy array, its CRC checked; bfloat16 is
        widened to float32, exactly."""
        e = self._entries.get(name)
        if e is None:
            raise KeyError(f"{name} is not in the checkpoint {self.prefix}")
        if e.slices:
            raise ValueError(f"{name} is a partitioned variable ({e.slices} slices); the "
                             "reader takes whole tensors only")
        if e.dtype == DT_STRING:
            raise ValueError(f"{name} is a string tensor; the reader takes numeric ones only")
        if e.dtype not in DTYPES:
            raise ValueError(f"{name} has dtype {_dtype_name(e.dtype)}, which the reader "
                             f"does not map (it maps {sorted(n for n, _ in DTYPES.values())})")
        path = f"{self.prefix}.data-{e.shard:05d}-of-{self.num_shards:05d}"
        with open(path, "rb") as f:
            f.seek(e.offset)
            data = f.read(e.size)
        if len(data) != e.size:
            raise CorruptBundleError(f"{path}: {name} runs past the end of the file")
        if e.crc is not None and masked_crc32c(data) != e.crc:
            raise CorruptBundleError(f"{path}: CRC mismatch in {name}")
        stored = np.dtype(DTYPES[e.dtype][1])
        if stored.itemsize * int(np.prod(e.shape)) != e.size:
            raise CorruptBundleError(f"{path}: {name} holds {e.size} bytes, not "
                                     f"{e.shape} of {_dtype_name(e.dtype)}")
        a = np.frombuffer(data, stored).reshape(e.shape)
        if e.dtype == 14:  # bfloat16: the high half of a float32
            return (a.astype(np.uint32) << 16).view(np.float32)
        return a.astype(stored.newbyteorder("="))
