"""Read-only TensorFlow checkpoints in plain Python and numpy (the port's
stand-in for TensorFlow's ``NewCheckpointReader``, as ``hdf5.py`` stands in
for h5py): the V2 "tensor bundle" that ``tf.compat.v1.train.Saver`` writes
(``<prefix>.index`` and ``<prefix>.data-NNNNN-of-NNNNN``) and that a
SavedModel keeps under ``variables/variables``.

``<prefix>.index`` is a LevelDB table (footer, index block, data blocks of
prefix-compressed keys with a restart array, each block followed by a
compression byte and a masked crc32c, which is verified).  Its first key,
``""``, holds a ``BundleHeaderProto`` (shard count, endianness, version);
every other key names a tensor and holds a ``BundleEntryProto`` (dtype,
shape, shard, offset, size, masked crc32c of the data, slices), decoded by
the minimal protobuf reader below.  A tensor's bytes are read from its shard
with one ``np.fromfile`` and checked against the entry's crc32c before they
are returned, as TensorFlow checks them.

Read: float16/32/64, bfloat16 (returned as float32, exactly), int8/16/32/64,
uint8/16, bool and strings (an object array of ``bytes``, their length
checksum verified too).  Anything else raises ``NotImplementedError`` naming
what it met and never returns data: a V1 checkpoint (one table file and no
``.index``), a big-endian bundle, a partitioned variable (``slices``), a
snappy-compressed block, a newer bundle version, or another dtype
(complex, uint32/64, quantized, resource, variant).  A file that is
cut short or whose checksum does not match raises ``OSError``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57  # LevelDB's table magic, the footer's last 8 bytes
FOOTER_SIZE = 48  # two block handles padded to 40 bytes, then the magic
BLOCK_TRAILER_SIZE = 5  # compression byte + masked crc32c
BUNDLE_VERSION = 1  # the newest bundle format version this reader knows

# tensorflow/core/framework/types.proto: DataType -> (name, numpy dtype)
DTYPES = {
    1: ("float32", "<f4"), 2: ("float64", "<f8"), 3: ("int32", "<i4"), 4: ("uint8", "u1"),
    5: ("int16", "<i2"), 6: ("int8", "i1"), 7: ("string", None), 8: ("complex64", None),
    9: ("int64", "<i8"), 10: ("bool", "?"), 11: ("qint8", None), 12: ("quint8", None),
    13: ("qint32", None), 14: ("bfloat16", "<u2"), 15: ("qint16", None), 16: ("quint16", None),
    17: ("uint16", "<u2"), 18: ("complex128", None), 19: ("float16", "<f2"), 20: ("resource", None),
    21: ("variant", None), 22: ("uint32", None), 23: ("uint64", None),
}
DT_STRING, DT_BFLOAT16 = 7, 14


# --- crc32c (Castagnoli), numpy only ------------------------------------

_POLY = 0x82F63B78  # reflected


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_TABLE = _byte_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _pair_table() -> np.ndarray:
    """The register's map over two zero bytes from a 16-bit state: the
    register after two bytes ``w`` (little-endian) from ``s`` is
    ``_PAIRS[(s ^ w) & 0xFFFF] ^ (s >> 16)``."""
    v = np.arange(1 << 16, dtype=np.uint32)
    once = _TABLE[v & np.uint32(0xFF)] ^ (v >> np.uint32(8))
    return _TABLE[once & np.uint32(0xFF)] ^ (once >> np.uint32(8))


_PAIRS = _pair_table()


def _raw_update(state: int, data) -> int:
    """The reflected register after ``data``, byte at a time."""
    t = _TABLE_LIST
    for b in bytes(data):
        state = t[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


def _apply(cols: np.ndarray, x):
    """The GF(2) operator with columns ``cols`` (its images of bits 0..31)
    applied to each uint32 of ``x``."""
    x = np.asarray(x, dtype=np.uint32)
    out = np.zeros_like(x)
    for i in range(32):
        out ^= cols[i] * ((x >> np.uint32(i)) & np.uint32(1))
    return out


def _zeros_operator(n: int) -> np.ndarray:
    """The register's map over ``n`` zero bytes, as 32 columns."""
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)
    square = _TABLE[bits & np.uint32(0xFF)] ^ (bits >> np.uint32(8))  # one zero byte
    result = bits  # the identity
    while n:
        if n & 1:
            result = _apply(square, result)
        n >>= 1
        if n:
            square = _apply(square, square)
    return result


def _update(state: int, data: np.ndarray) -> int:
    """The register after ``data`` from ``state``.  The register is linear
    in the bytes: the data is cut into equal chunks, each run from 0 two
    bytes at a time in parallel across the chunks, and their registers are folded
    pairwise, the left one carried over the right one's length by the
    zero-byte operator; a prefix of under a chunk starts from ``state``."""
    n = data.size
    if n < 4096:
        return _raw_update(state, data.tobytes())
    width = 2 * min(512, max(32, math.isqrt(n) // 2))  # bytes a chunk, even
    head = n % width
    state = _raw_update(state, data[:head].tobytes())
    cols = data[head:].reshape(-1, width).view("<u2").T.copy()  # byte pair j of every chunk, contiguous
    regs = np.zeros(cols.shape[1], np.uint32)
    for row in cols:
        regs = _PAIRS[(regs ^ row) & np.uint32(0xFFFF)] ^ (regs >> np.uint32(16))
    pad = (1 << (len(regs) - 1).bit_length()) - len(regs)
    regs = np.concatenate([np.zeros(pad, np.uint32), regs])  # leading zero chunks add nothing
    op = _zeros_operator(width)
    while len(regs) > 1:
        regs = _apply(op, regs[0::2]) ^ regs[1::2]
        op = _apply(op, op)
    return int(_apply(_zeros_operator(n - head), [state])[0]) ^ int(regs[0])


def crc32c(data, crc: int = 0) -> int:
    """crc32c of ``data`` (bytes-like or a numpy array's bytes), extending
    ``crc``, the crc32c of the bytes before it (TensorFlow's
    ``crc32c::Extend``)."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    return _update(crc ^ 0xFFFFFFFF, buf) ^ 0xFFFFFFFF


def mask(crc: int) -> int:
    """The masked form TensorFlow and LevelDB store."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# --- protobuf wire format -------------------------------------------------


def varint(buf, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at ``pos``."""
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise OSError("tensor bundle: a varint runs past its end")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def fields(buf) -> Dict[int, List]:
    """A message's fields: number -> values in order (ints for varint and
    fixed fields, ``bytes`` for length-delimited ones)."""
    out: Dict[int, List] = {}
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = varint(buf, pos)
        elif wire == 1:
            value, pos = int.from_bytes(buf[pos : pos + 8], "little"), pos + 8
        elif wire == 2:
            size, pos = varint(buf, pos)
            value, pos = bytes(buf[pos : pos + size]), pos + size
        elif wire == 5:
            value, pos = int.from_bytes(buf[pos : pos + 4], "little"), pos + 4
        else:
            raise OSError(f"tensor bundle: protobuf wire type {wire} (field {number})")
        if pos > n:
            raise OSError("tensor bundle: a protobuf field runs past its end")
        out.setdefault(number, []).append(value)
    return out


def ints(values) -> List[int]:
    """A repeated integer field's values, packed or not."""
    out = []
    for v in values:
        if isinstance(v, bytes):  # packed
            pos = 0
            while pos < len(v):
                x, pos = varint(v, pos)
                out.append(x)
        else:
            out.append(v)
    return out


def first(msg: Dict[int, List], number: int, default=0):
    values = msg.get(number)
    return values[-1] if values else default  # a later value of a scalar field wins


# --- LevelDB table ---------------------------------------------------------


def _handle(buf, pos: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = varint(buf, pos)
    size, pos = varint(buf, pos)
    return (offset, size), pos


def _read_at(f, offset: int, n: int, what: str) -> bytes:
    f.seek(offset)
    data = f.read(n)
    if len(data) != n:
        raise OSError(f"{what}: {n} bytes at {offset} run past the end of the file")
    return data


def _block(f, handle: Tuple[int, int], path: str) -> bytes:
    """A block's contents, its trailer's checksum verified."""
    offset, size = handle
    raw = _read_at(f, offset, size + BLOCK_TRAILER_SIZE, path)
    contents, kind = raw[:size], raw[size]
    if unmask(int.from_bytes(raw[size + 1 :], "little")) != crc32c(raw[: size + 1]):
        raise OSError(f"{path}: the block at {offset} fails its crc32c (corrupt table)")
    if kind == 1:
        raise NotImplementedError(f"{path}: the block at {offset} is snappy-compressed; this reader reads uncompressed tables only")
    if kind != 0:
        raise OSError(f"{path}: the block at {offset} has compression type {kind}")
    return contents


def _block_entries(block: bytes, path: str) -> List[Tuple[bytes, bytes]]:
    """The (key, value) pairs of a block: keys share a prefix with the key
    before them, except at the restart points, which must reset it."""
    if len(block) < 4:
        raise OSError(f"{path}: a block of {len(block)} bytes")
    restarts = int.from_bytes(block[-4:], "little")
    end = len(block) - 4 - 4 * restarts
    if end < 0:
        raise OSError(f"{path}: a block's restart array runs past its start")
    points = {int.from_bytes(block[end + 4 * i : end + 4 * i + 4], "little") for i in range(restarts)}
    entries, key, pos = [], b"", 0
    while pos < end:
        at = pos
        shared, pos = varint(block, pos)
        unshared, pos = varint(block, pos)
        size, pos = varint(block, pos)
        if shared > len(key) or pos + unshared + size > end or (at in points and shared):
            raise OSError(f"{path}: a corrupt block entry at {at}")
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        entries.append((key, block[pos : pos + size]))
        pos += size
    return entries


def read_table(path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of the LevelDB table at ``path``, in key order."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        n = f.tell()
        if n < FOOTER_SIZE:
            raise OSError(f"{path}: {n} bytes, shorter than a table's footer")
        footer = _read_at(f, n - FOOTER_SIZE, FOOTER_SIZE, path)
        if int.from_bytes(footer[40:], "little") != TABLE_MAGIC:
            raise OSError(f"{path}: not a TensorFlow checkpoint index (no table magic)")
        meta, pos = _handle(footer, 0)
        index, _ = _handle(footer, pos)
        _block(f, meta, path)  # the metaindex: bundles hold no filters, only its checksum is read
        out = []
        for _, value in _block_entries(_block(f, index, path), path):
            handle, _ = _handle(value, 0)
            out += _block_entries(_block(f, handle, path), path)
    keys = [k for k, _ in out]
    if keys != sorted(keys):
        raise OSError(f"{path}: the table's keys are out of order")
    return out


def _is_table(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() < FOOTER_SIZE:
                return False
            f.seek(-8, os.SEEK_END)
            return int.from_bytes(f.read(8), "little") == TABLE_MAGIC
    except OSError:
        return False


# --- the bundle --------------------------------------------------------------


class _Entry:
    """A decoded ``BundleEntryProto``."""

    def __init__(self, name: str, value: bytes):
        msg = fields(value)
        self.name = name
        self.dtype = first(msg, 1)
        shape = fields(first(msg, 2, b""))
        self.shape = [first(fields(d), 1) for d in shape.get(2, [])]
        self.shape = [s - (1 << 64) if s >= 1 << 63 else s for s in self.shape]
        self.shard, self.offset, self.size = first(msg, 3), first(msg, 4), first(msg, 5)
        self.crc = first(msg, 6)
        self.sliced = bool(msg.get(7))


class CheckpointReader:
    """A V2 checkpoint opened by its prefix (``.../model.ckpt``), with the
    methods of TensorFlow's ``NewCheckpointReader``."""

    def __init__(self, prefix: str):
        prefix = os.fspath(prefix)
        index = prefix + ".index"
        if not os.path.exists(index):
            if _is_table(prefix):
                raise NotImplementedError(
                    f"{prefix} is a V1 checkpoint (one table file, no .index); this reader reads V2 checkpoints: "
                    "re-save it with tf.compat.v1.train.Saver(write_version=tf.compat.v1.train.SaverDef.V2)"
                )
            raise FileNotFoundError(f"no checkpoint at {prefix} ({index} does not exist)")
        self.prefix = prefix
        table = read_table(index)
        if not table or table[0][0] != b"":
            raise OSError(f"{index}: no bundle header (the empty key)")
        header = fields(table[0][1])
        self.num_shards = first(header, 1, 1)
        if first(header, 2) != 0:
            raise NotImplementedError(f"{prefix}: a big-endian bundle; this reader reads little-endian ones")
        version = fields(first(header, 3, b""))  # a VersionDef, checked as TensorFlow checks it
        if first(version, 2) > BUNDLE_VERSION or BUNDLE_VERSION in ints(version.get(3, [])):
            raise NotImplementedError(f"{prefix}: bundle version {first(version, 1)} (min consumer {first(version, 2)}, "
                                      f"bad consumers {ints(version.get(3, []))}) is not read by a reader of version {BUNDLE_VERSION}")
        # keys from "\0" on are the slices of partitioned variables, read by no one here
        self._entries = {k.decode("utf-8"): _Entry(k.decode("utf-8"), v) for k, v in table[1:] if not k.startswith(b"\0")}

    def _entry(self, name: str) -> _Entry:
        if name not in self._entries:
            raise KeyError(f"{name!r} not found in checkpoint {self.prefix}")
        return self._entries[name]

    def has_tensor(self, name: str) -> bool:
        return name in self._entries

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {name: list(e.shape) for name, e in self._entries.items()}

    def get_variable_to_dtype_map(self) -> Dict[str, str]:
        """name -> TensorFlow's dtype name (``"float32"``, ``"bfloat16"``,
        ``"string"``...)."""
        return {name: DTYPES.get(e.dtype, (f"dtype {e.dtype}",))[0] for name, e in self._entries.items()}

    def _data(self, e: _Entry) -> np.ndarray:
        if not 0 <= e.shard < self.num_shards:
            raise OSError(f"{e.name}: shard {e.shard} of a bundle of {self.num_shards}")
        path = f"{self.prefix}.data-{e.shard:05d}-of-{self.num_shards:05d}"
        data = np.fromfile(path, np.uint8, count=e.size, offset=e.offset)
        if data.size != e.size:
            raise OSError(f"{e.name}: {e.size} bytes at {e.offset} run past the end of {path}")
        return data

    def get_tensor(self, name: str) -> np.ndarray:
        e = self._entry(name)
        if e.sliced:
            raise NotImplementedError(f"{name} is a partitioned variable (saved in slices); this reader reads whole tensors only")
        kind = DTYPES.get(e.dtype, (f"dtype {e.dtype}", None))
        if e.dtype != DT_STRING and kind[1] is None:
            raise NotImplementedError(f"{name}: {kind[0]} tensors are not read")
        count = int(np.prod(e.shape, dtype=np.int64))
        data = self._data(e)
        if e.dtype == DT_STRING:
            return self._strings(e, data, count)
        if crc32c(data) != unmask(e.crc):
            raise OSError(f"{name}: the data fails its crc32c (corrupt checkpoint)")
        dtype = np.dtype(kind[1])
        if e.size != count * dtype.itemsize:
            raise OSError(f"{name}: {e.size} bytes for {count} {kind[0]} values")
        out = data.view(dtype).reshape(e.shape)
        if e.dtype == DT_BFLOAT16:
            out = (out.astype(np.uint32) << np.uint32(16)).view(np.float32)
        return out

    def _strings(self, e: _Entry, data: np.ndarray, count: int) -> np.ndarray:
        """A string tensor: ``count`` varint64 lengths, the masked crc32c of
        the lengths (each as 4 little-endian bytes, 8 past 2^32 - 1), the
        bytes.  The entry's crc32c covers the lengths as checksummed, the
        length checksum and the bytes."""
        buf = data.tobytes()
        pos, lengths, crc = 0, [], 0
        for _ in range(count):
            n, pos = varint(buf, pos)
            lengths.append(n)
            crc = crc32c(n.to_bytes(4 if n <= 0xFFFFFFFF else 8, "little"), crc)
        if pos + 4 > len(buf) or unmask(int.from_bytes(buf[pos : pos + 4], "little")) != crc:
            raise OSError(f"{e.name}: the string lengths fail their crc32c (corrupt checkpoint)")
        crc = crc32c(buf[pos : pos + 4], crc)
        pos = start = pos + 4
        out = np.empty(count, dtype=object)
        for i, n in enumerate(lengths):
            out[i] = buf[pos : pos + n]
            pos += n
        if pos != len(buf):
            raise OSError(f"{e.name}: {len(buf)} bytes for strings of {pos}")
        if crc32c(buf[start:], crc) != unmask(e.crc):
            raise OSError(f"{e.name}: the data fails its crc32c (corrupt checkpoint)")
        return out.reshape(e.shape)


def object_graph(reader: CheckpointReader) -> List[Dict]:
    """The checkpoint's ``_CHECKPOINTABLE_OBJECT_GRAPH`` (a
    ``TrackableObjectGraph``): one dict a node, ``children``
    [(local name, node id)] and ``attributes`` [(name, full name,
    checkpoint key)]."""
    graph = fields(reader.get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH").reshape(-1)[0])
    nodes = []
    for raw in graph.get(1, []):
        node = fields(raw)
        children = [fields(c) for c in node.get(1, [])]
        attrs = [fields(a) for a in node.get(2, [])]
        nodes.append({
            "children": [(first(c, 2, b"").decode(), first(c, 1)) for c in children],
            "attributes": [tuple(first(a, k, b"").decode() for k in (1, 2, 3)) for a in attrs],
        })
    return nodes
