"""The part of msgpack that ``flax.serialization.msgpack_serialize`` writes,
in pure Python, with torch tensors for the array leaves.

The JAX package stores its checkpoints as flax msgpack: nested maps of
string keys whose leaves are nil, bools, ints, float64s, strings, bytes,
lists, and arrays as msgpack extensions. This module reads and writes
exactly that subset without the ``msgpack``, ``flax`` or ``ml_dtypes``
packages, which a CUDA serving host need not have:

* ext code 1 holds an ndarray: the msgpack triple (shape, dtype name,
  C-order bytes); ext code 3 a numpy scalar, the same triple of a 0-dim
  array;
* a leaf above ``MAX_CHUNK_SIZE`` bytes is written as a chunked map,
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat slice, ...}}``, and read back whole.

The entry points: :func:`skip` returns the end offset of one value
without decoding it (``msgpack.Unpacker.skip``), :func:`decode` decodes one
value (arrays as torch tensors; bfloat16 through ``torch.frombuffer``,
since numpy alone cannot spell it), and :func:`encode` gives the bytes
``msgpack_serialize`` gives for the same tree: minimal int, str, bin, map,
array and ext headers, strings as str (``use_bin_type``), and every dict's
keys sorted, as flax's copy of the tree through ``jax.tree_util`` sorts
them. :func:`encode_to` streams the same bytes to a ``write`` callable,
each array's bytes straight from its (host) tensor, so writing a
multi-GB training state never holds its encoding in memory.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: leaves of more bytes than this are
# written chunked (read at each encode, as flax reads its own).
MAX_CHUNK_SIZE = 2 ** 30

# Array dtype names (numpy's, as flax writes them) and their torch dtypes.
TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}

# Single-byte values, fixed-width numbers and sized headers (kind, width
# of the length field) by their first byte.
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# First bytes that open a map: fixmap, map16, map32.
_MAP_TAGS = frozenset(range(0x80, 0x90)) | {0xDE, 0xDF}


class MsgpackError(ValueError):
    """The bytes are not the msgpack subset this module reads."""


def _header(buf, pos: int) -> Tuple[str, Any, int]:
    """(kind, argument, offset after the header) of the value at ``pos``.
    Scalars carry their value (kind ``"value"``); str, bin, array and map
    their length or item count; ext (type code, payload length)."""
    try:
        b = buf[pos]
        if b <= 0x7F:
            return "value", b, pos + 1
        if b >= 0xE0:
            return "value", b - 0x100, pos + 1
        if b <= 0x8F:
            return "map", b & 0x0F, pos + 1
        if b <= 0x9F:
            return "array", b & 0x0F, pos + 1
        if b <= 0xBF:
            return "str", b & 0x1F, pos + 1
        if b in _CONSTANTS:
            return "value", _CONSTANTS[b], pos + 1
        if b in _NUMBERS:
            fmt = _NUMBERS[b]
            return ("value", struct.unpack_from(fmt, buf, pos + 1)[0],
                    pos + 1 + struct.calcsize(fmt))
        if b in _FIXEXT:
            return ("ext", (struct.unpack_from(">b", buf, pos + 1)[0],
                            _FIXEXT[b]), pos + 2)
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = struct.unpack_from(fmt, buf, pos + 1)[0]
            end = pos + 1 + struct.calcsize(fmt)
            if kind == "ext":
                return "ext", (struct.unpack_from(">b", buf, end)[0], n), end + 1
            return kind, n, end
    except (IndexError, struct.error) as exc:
        raise MsgpackError(f"truncated msgpack at offset {pos}") from exc
    raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at "
                       f"offset {pos}")


def skip(buf, pos: int = 0) -> int:
    """The offset just past the value at ``pos``, decoding nothing."""
    pending = 1
    while pending:
        pending -= 1
        kind, arg, pos = _header(buf, pos)
        if kind in ("str", "bin"):
            pos += arg
        elif kind == "ext":
            pos += arg[1]
        elif kind == "array":
            pending += arg
        elif kind == "map":
            pending += 2 * arg
    if pos > len(buf):
        raise MsgpackError(f"truncated msgpack: value ends at {pos}, "
                           f"buffer holds {len(buf)} bytes")
    return pos


def is_map(buf, pos: int) -> bool:
    """Whether the value at ``pos`` is a map (read from its first byte)."""
    return pos < len(buf) and buf[pos] in _MAP_TAGS


def map_header(buf, pos: int) -> Tuple[int, int]:
    """(item count, offset of the first key) of the map at ``pos``."""
    kind, n, pos = _header(buf, pos)
    if kind != "map":
        raise MsgpackError(f"expected a map at offset {pos}, found {kind}")
    return n, pos


def is_chunked_leaf(buf, pos: int) -> bool:
    """Whether the map at ``pos`` is a chunked array leaf (its first key
    is the chunk marker, as flax writes it)."""
    n, pos = map_header(buf, pos)
    return n > 0 and _decode(buf, pos)[0] == CHUNKED_KEY


def _writable(buf):
    """``buf`` as a writable buffer, which ``torch.frombuffer`` needs."""
    return bytearray(buf) if isinstance(buf, bytes) else buf


def decode(buf, pos: int = 0) -> Tuple[Any, int]:
    """(value, end offset) of the value at ``pos``: maps as dicts, arrays
    as lists, ext-1 arrays as CPU torch tensors of their own memory, ext-3
    scalars as numpy scalars (a bfloat16 one as a 0-dim tensor), chunked
    leaves joined back into one tensor. ``bytes`` input is copied once into
    a writable buffer; pass a ``bytearray`` to avoid that."""
    return _decode(_writable(buf), pos)


def _decode(buf, pos: int) -> Tuple[Any, int]:
    kind, arg, pos = _header(buf, pos)
    if kind == "value":
        return arg, pos
    if kind in ("str", "bin"):
        raw = bytes(buf[pos:pos + arg])
        if len(raw) != arg:
            raise MsgpackError(f"truncated msgpack at offset {pos}")
        return (raw.decode("utf-8") if kind == "str" else raw), pos + arg
    if kind == "array":
        items = []
        for _ in range(arg):
            item, pos = _decode(buf, pos)
            items.append(item)
        return items, pos
    if kind == "map":
        out = {}
        for _ in range(arg):
            key, pos = _decode(buf, pos)
            out[key], pos = _decode(buf, pos)
        if CHUNKED_KEY in out:
            return _unchunk(out), pos
        return out, pos
    code, n = arg
    end = pos + n
    if code == EXT_NDARRAY:
        return _array(buf, pos, end), end
    if code == EXT_NPSCALAR:
        value = _array(buf, pos, end)
        if value.dtype == torch.bfloat16:
            return value, end
        return value.numpy()[()], end
    raise MsgpackError(f"unsupported msgpack ext type {code} at offset {pos}")


def _array(buf, pos: int, end: int) -> torch.Tensor:
    """The tensor of one ext-1 payload (shape, dtype name, C-order bytes)
    spanning ``buf[pos:end]``."""
    kind, count, pos = _header(buf, pos)
    if kind != "array" or count != 3:
        raise MsgpackError("ndarray extension is not a (shape, dtype, "
                           "bytes) triple")
    shape, pos = _decode(buf, pos)
    name, pos = _decode(buf, pos)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    kind, nbytes, pos = _header(buf, pos)
    dtype = TORCH_DTYPES.get(name)
    if kind != "bin" or dtype is None:
        raise MsgpackError(f"ndarray extension of unsupported dtype {name!r}")
    numel = math.prod(shape)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if numel * itemsize != nbytes or pos + nbytes != end or end > len(buf):
        raise MsgpackError(f"ndarray extension of shape {shape} {name} "
                           f"holds {nbytes} bytes")
    if numel == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype, count=numel,
                            offset=pos).reshape(shape).clone()


def _unchunk(data: dict) -> torch.Tensor:
    shape = [data["shape"][str(i)] for i in range(len(data["shape"]))]
    chunks = [data["chunks"][str(i)].reshape(-1)
              for i in range(len(data["chunks"]))]
    return torch.cat(chunks).reshape(shape)


# -- encoding ------------------------------------------------------------

# Header bytes are gathered up to this size before a write; a payload of at
# least _DIRECT_BYTES (an array's bytes) is written as it is, uncopied.
_FLUSH_BYTES = 1 << 16
_DIRECT_BYTES = 1 << 12


class _Sink:
    """The encoder's output: small pieces gather in a buffer, large ones go
    to ``write`` directly (``out += piece`` and ``out.append(byte)``, as
    on a bytearray)."""

    def __init__(self, write):
        self._write = write
        self._buf = bytearray()

    def append(self, byte: int) -> None:
        self._buf.append(byte)

    def __iadd__(self, data) -> "_Sink":
        if len(data) >= _DIRECT_BYTES:
            self.flush()
            self._write(data)
        else:
            self._buf += data
            if len(self._buf) >= _FLUSH_BYTES:
                self.flush()
        return self

    def flush(self) -> None:
        if self._buf:
            self._write(self._buf)
            self._buf = bytearray()


def encode(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives, for
    a tree of dicts, lists, None, bools, ints, floats, strings, bytes,
    numpy scalars, and numpy arrays or torch tensors (written from the
    CPU). Leaves of a dict (or the root) above ``MAX_CHUNK_SIZE`` bytes are
    chunked; tuples are refused, as flax's strict packer refuses them."""
    out = bytearray()
    encode_to(tree, out.extend)
    return bytes(out)


def encode_to(tree, write) -> None:
    """:func:`encode`'s bytes handed to ``write`` piece by piece, in
    order; an array's bytes are passed as a view of the host tensor (a
    device tensor is copied to the host, on the current stream, one leaf
    at a time)."""
    sink = _Sink(write)
    _pack(tree, sink, chunk=True)
    sink.flush()


def _pack_header(out, n: int, fix: int, fix_limit: int,
                 wide: Tuple[Tuple[int, str, int], ...]) -> None:
    if n < fix_limit:
        out.append(fix | n)
        return
    for tag, fmt, limit in wide:
        if n < limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} too large for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))
_FIXEXT_TAGS = {v: k for k, v in _FIXEXT.items()}


def _pack_int(x: int, out) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif x >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < limit:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise MsgpackError(f"integer {x} too large for msgpack")
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise MsgpackError(f"integer {x} too small for msgpack")


def _pack_bytes(data, out) -> None:
    _pack_header(out, len(data), 0, 0, _BIN)
    out += data


def _pack_array(x, code: int, out) -> None:
    """One array leaf as an ext value: the ext header, then its payload,
    the msgpack triple (shape, dtype name, bytes), the bytes uncopied."""
    shape, name, data = _host(x)
    head = bytearray([0x93])
    _pack_header(head, len(shape), 0x90, 16, _ARRAY)
    for dim in shape:
        _pack_int(int(dim), head)
    _pack(name, head, chunk=False)
    _pack_header(head, len(data), 0, 0, _BIN)
    n = len(head) + len(data)
    if n in _FIXEXT_TAGS:
        out.append(_FIXEXT_TAGS[n])
    else:
        _pack_header(out, n, 0, 0, _EXT)
    out += struct.pack(">b", code)
    out += head
    out += data


def _host(x) -> Tuple[tuple, str, memoryview]:
    """(shape, dtype name, C-order bytes as a flat byte view) of an array
    leaf; a tensor not on the CPU is copied there first."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype not in DTYPE_NAMES:
            raise MsgpackError(f"cannot write a {t.dtype} tensor")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), DTYPE_NAMES[t.dtype], memoryview(raw)
    flat = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    return x.shape, x.dtype.name, memoryview(flat)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _pack_map(items: dict, out, chunk: bool) -> None:
    """A map in ``items``' own order; ``chunk`` whether its array values
    may be chunked."""
    _pack_header(out, len(items), 0x80, 16, _MAP)
    for key, value in items.items():
        _pack(key, out, chunk=False)
        _pack(value, out, chunk=chunk)


def _pack_chunked(x, out) -> None:
    """flax's ``_chunk``: the flat array in slices of at most
    ``MAX_CHUNK_SIZE`` bytes, under maps in flax's insertion order (marker,
    shape, chunks; dimensions and slices by index), never sorted."""
    flat = x.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / (_nbytes(x) // max(1, flat.shape[0]))))
    _pack_header(out, 3, 0x80, 16, _MAP)
    _pack(CHUNKED_KEY, out, chunk=False)
    _pack(True, out, chunk=False)
    _pack("shape", out, chunk=False)
    _pack_map({str(i): int(d) for i, d in enumerate(x.shape)}, out,
              chunk=False)
    _pack("chunks", out, chunk=False)
    _pack_map({str(i): flat[start:start + size] for i, start in
               enumerate(range(0, flat.shape[0], size))}, out, chunk=False)


def _pack(x, out, chunk: bool) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        if chunk and _nbytes(x) > MAX_CHUNK_SIZE:
            _pack_chunked(x, out)
            return
        _pack_array(x, EXT_NDARRAY, out)
    elif isinstance(x, np.generic):
        _pack_array(np.asarray(x), EXT_NPSCALAR, out)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_header(out, len(data), 0xA0, 32, _STR)
        out += data
    elif type(x) in (bytes, bytearray):
        _pack_bytes(bytes(x), out)
    elif type(x) is dict:
        _pack_map({key: x[key] for key in sorted(x)}, out, chunk=True)
    elif type(x) is list:
        _pack_header(out, len(x), 0x90, 16, _ARRAY)
        for item in x:
            _pack(item, out, chunk=False)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")
