"""Read a TensorFlow checkpoint (a V2 tensor bundle) with stdlib and numpy.

A checkpoint prefix ``P`` is ``P.index`` and the data shards
``P.data-NNNNN-of-NNNNN``. The index is a LevelDB-format sorted table:
blocks of prefix-compressed key/value entries, each block followed by a
one-byte compression type and a CRC, an index block of handles to the
data blocks, and a 48-byte footer that ends in the table's magic number.
Its empty key holds the ``BundleHeaderProto`` (shard count, endianness);
every other key is a tensor's name and holds its ``BundleEntryProto``
(dtype, shape, shard id, offset and size in that shard). A tensor's bytes
are its elements in row-major order, little-endian; a string tensor holds
its lengths as varints, a 4-byte checksum of them, then the bytes.

The bundle writer stores its index blocks without compression; a block of
any other compression type is refused by name, and so is a partitioned
(sliced) variable. No part of TensorFlow is imported.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
COMPRESSION_NAMES = {0: "none", 1: "snappy", 2: "zlib", 3: "lz4",
                     4: "lz4hc", 5: "xpress", 6: "zstd"}
# TensorFlow's DataType enum -> numpy dtype (the numeric types a model
# checkpoint holds); DT_STRING (7) is read as bytes objects.
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16,
          19: np.float16, 22: np.uint32, 23: np.uint64}
DT_STRING, DT_BFLOAT16 = 7, 14


class BundleFormatError(ValueError):
    """The files are not a tensor bundle this reader can read."""


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of the unsigned LEB128 varint at ``pos``."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise BundleFormatError("truncated varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _proto_fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """(field number, wire type, value) of every field of one serialized
    protocol buffer message: varints as ints, length-delimited fields as
    bytes, fixed fields as ints."""
    fields, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        else:
            raise BundleFormatError(f"protobuf wire type {wire} not read")
        fields.append((number, wire, value))
    return fields


def _block(data: bytes, offset: int, size: int, path: str) -> bytes:
    """The contents of the table block at (offset, size), refused unless
    stored without compression."""
    if offset + size + BLOCK_TRAILER_BYTES > len(data):
        raise BundleFormatError(f"{path}: block past the end of the file")
    kind = data[offset + size]
    if kind != 0:
        raise BundleFormatError(
            f"{path}: index block compressed with "
            f"{COMPRESSION_NAMES.get(kind, f'type {kind}')}; the reader "
            "takes uncompressed blocks only (what the bundle writer stores)")
    return data[offset:offset + size]


def _block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """(key, value) of every entry of one table block, in order."""
    if len(block) < 4:
        raise BundleFormatError("table block shorter than its restart count")
    restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * restarts
    entries, pos, key = [], 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        size, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        entries.append((key, block[pos:pos + size]))
        pos += size
    return entries


def _handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    """(offset, size, next position) of the BlockHandle at ``pos``."""
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def read_index(prefix: str) -> Dict[bytes, bytes]:
    """Every (key, serialized proto) of ``prefix.index``."""
    path = prefix + ".index"
    if not os.path.isfile(path):
        raise FileNotFoundError(f"TF checkpoint index {path} does not exist")
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES or struct.unpack_from(
            "<Q", data, len(data) - 8)[0] != TABLE_MAGIC:
        raise BundleFormatError(f"{path} is not a TF checkpoint index (no "
                                "table magic number)")
    footer = data[len(data) - FOOTER_BYTES:]
    _, _, pos = _handle(footer)  # the metaindex block, unused
    index_offset, index_size, _ = _handle(footer, pos)
    entries: Dict[bytes, bytes] = {}
    for _, value in _block_entries(_block(data, index_offset, index_size,
                                          path)):
        offset, size, _ = _handle(value)
        entries.update(_block_entries(_block(data, offset, size, path)))
    return entries


def _entry(name: str, proto: bytes) -> dict:
    """The fields of one BundleEntryProto that locate its tensor."""
    entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    for number, _, value in _proto_fields(proto):
        if number == 1:
            entry["dtype"] = value
        elif number == 2:
            for dim_number, _, dim in _proto_fields(value):
                if dim_number == 2:
                    size = next((v for n, _, v in _proto_fields(dim)
                                 if n == 1), 0)
                    entry["shape"].append(size)
        elif number == 3:
            entry["shard_id"] = value
        elif number == 4:
            entry["offset"] = value
        elif number == 5:
            entry["size"] = value
        elif number == 7:
            raise BundleFormatError(
                f"{name}: a partitioned (sliced) variable; the reader takes "
                "whole tensors only")
    # int64 fields arrive as unsigned varints; a dim of -1 is unknown.
    entry["shape"] = [d - (1 << 64) if d >= 1 << 63 else d
                      for d in entry["shape"]]
    return entry


class TFCheckpointReader:
    """The tensors of the checkpoint ``prefix``: :meth:`shapes` (name ->
    shape, as ``tf.train.load_checkpoint(...).get_variable_to_shape_map``)
    and :meth:`get_tensor` (name -> numpy array)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = read_index(prefix)
        header = index.pop(b"", None)
        if header is None:
            raise BundleFormatError(f"{prefix}.index holds no bundle header")
        fields = {n: v for n, _, v in _proto_fields(header)}
        self.num_shards = fields.get(1, 1)
        if fields.get(2, 0) != 0:
            raise BundleFormatError(f"{prefix}: a big-endian bundle")
        self.entries = {key.decode("utf-8"): _entry(key.decode("utf-8"), v)
                        for key, v in index.items()}

    def shard_path(self, shard_id: int) -> str:
        return (f"{self.prefix}.data-{shard_id:05d}-of-"
                f"{self.num_shards:05d}")

    def shapes(self) -> Dict[str, List[int]]:
        return {name: list(e["shape"]) for name, e in self.entries.items()}

    def _bytes(self, entry: dict) -> bytes:
        path = self.shard_path(entry["shard_id"])
        if not os.path.isfile(path):
            raise FileNotFoundError(f"TF checkpoint shard {path} does not "
                                    "exist")
        with open(path, "rb") as f:
            f.seek(entry["offset"])
            data = f.read(entry["size"])
        if len(data) != entry["size"]:
            raise BundleFormatError(f"{path}: {len(data)} bytes at offset "
                                    f"{entry['offset']}, {entry['size']} "
                                    "expected")
        return data

    def get_tensor(self, name: str) -> np.ndarray:
        entry = self.entries[name]
        shape = tuple(entry["shape"])
        data = self._bytes(entry)
        dtype = entry["dtype"]
        if dtype == DT_STRING:
            count = int(np.prod(shape, dtype=np.int64))
            lengths, pos = [], 0
            for _ in range(count):
                length, pos = _varint(data, pos)
                lengths.append(length)
            pos += 4  # the checksum of the lengths
            out = []
            for length in lengths:
                out.append(data[pos:pos + length])
                pos += length
            return np.array(out, dtype=object).reshape(shape)
        if dtype == DT_BFLOAT16:
            bits = np.frombuffer(data, "<u2").astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        if dtype not in DTYPES:
            raise BundleFormatError(f"{name}: TF dtype {dtype} not read")
        return np.frombuffer(data, np.dtype(DTYPES[dtype]).newbyteorder(
            "<")).astype(DTYPES[dtype]).reshape(shape)
