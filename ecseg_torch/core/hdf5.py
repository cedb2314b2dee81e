"""Read-only HDF5 in plain Python and numpy (the port's stand-in for h5py,
as ``config.py`` stands in for PyYAML): what the imported-Keras executor
reads of a Keras ``.h5`` save or of a ``.keras`` archive's
``model.weights.h5``, returned as h5py returns it.

Reads the files that h5py writes under its default ``libver`` (and that
Keras 2 and 3 write): superblock v0/v1 (any sizes of offsets and lengths, a
user block), version 1 object headers with continuation blocks, groups as
symbol tables (a v1 B-tree of any depth over SNOD nodes, names in a local
heap) or as compact link messages, and attributes (message versions 1-3)
and datasets of

- fixed-point numbers of 1, 2, 4 or 8 bytes, IEEE floats of 2, 4 or 8
  bytes, either byte order (kept as stored, as h5py keeps it);
- fixed-length strings (``S`` arrays; a scalar is ``np.bytes_``), stripped
  under their padding rule as h5py's conversion strips them;
- variable-length strings in a global heap: ``str`` in attributes,
  ``bytes`` in datasets (object arrays when not scalar);

over scalar, simple (zero-sized too) and null dataspaces (a null one reads
as :class:`Empty`), stored compact, contiguous (an unallocated one reads as
its fill value) or chunked (a v1 B-tree of chunks, edge chunks cut; the
filters deflate, shuffle and fletcher32, the checksum verified).

Anything else raises ``NotImplementedError`` naming what it met and never
returns data: a v2/v3 superblock or a v2 object header (h5py's
``libver="latest"``), dense link or attribute storage, soft and external
links, compound, enum, reference, array and other datatypes, variable-length
sequences, shared messages, other filters, external and virtual storage.
A file that is not HDF5, or is cut short or corrupt where it is read, raises
``OSError``, as h5py's does.
"""

from __future__ import annotations

import io
import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_LATEST_HINT = "re-save it with h5py's default libver (h5py.File(path, 'w') without libver='latest')"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL, _LINK, _EXTERNAL = 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07
_LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0x08, 0x0B, 0x0C, 0x10, 0x11, 0x15

_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enum", 10: "array"}
# IEEE layouts: size -> (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32 = 1, 2, 3


class Empty:
    """A null dataspace's value (h5py's ``h5py.Empty``): no shape, a dtype."""

    shape = None

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)


class _Cursor:
    """Little-endian fields of a message, read in order."""

    def __init__(self, data, pos: int, offsets: int, lengths: int):
        self.data, self.pos, self.offsets, self.lengths = data, pos, offsets, lengths

    def u(self, n: int) -> int:
        if self.pos + n > len(self.data):
            raise OSError("HDF5: a message runs past its end")
        v = int.from_bytes(self.data[self.pos : self.pos + n], "little")
        self.pos += n
        return v

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OSError("HDF5: a message runs past its end")
        v = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return v

    def addr(self) -> Optional[int]:
        """An address; None for the undefined address (all bits set)."""
        v = self.u(self.offsets)
        return None if v == (1 << (8 * self.offsets)) - 1 else v

    def length(self) -> int:
        return self.u(self.lengths)


class _Type:
    """A parsed datatype: ``kind`` is "num", "fstr" or "vstr"; ``dtype`` the
    numpy dtype h5py reads it as; ``size`` the stored element size."""

    def __init__(self, kind: str, dtype: np.dtype, size: int, pad: int = 0):
        self.kind, self.dtype, self.size, self.pad = kind, dtype, size, pad


class _Space:
    """A parsed dataspace: ``shape`` (None for a null dataspace)."""

    def __init__(self, shape: Optional[Tuple[int, ...]]):
        self.shape = shape

    @property
    def count(self) -> int:
        return 0 if self.shape is None else int(np.prod(self.shape, dtype=np.int64))


class _Header:
    """One object header's messages: [(type, flags, bytes)]."""

    def __init__(self, messages: List[Tuple[int, int, bytes]]):
        self.messages = messages

    def first(self, mtype: int) -> Optional[bytes]:
        for t, _, body in self.messages:
            if t == mtype:
                return body
        return None

    def all(self, mtype: int) -> List[Tuple[int, bytes]]:
        return [(flags, body) for t, flags, body in self.messages if t == mtype]


class _Reader:
    """The open file: superblock fields, raw reads relative to the base
    address, and the caches of parsed headers, group members and global
    heap collections."""

    def __init__(self, f, close: bool):
        self.f, self._close = f, close
        self.base, self.offsets, self.lengths, root = self._superblock()
        self.root = root
        self.headers: Dict[int, _Header] = {}
        self.groups: Dict[int, Dict[str, Tuple[str, Optional[int]]]] = {}
        self.heaps: Dict[int, Dict[int, bytes]] = {}

    def close(self) -> None:
        if self._close and self.f is not None:
            self.f.close()
        self.f = None

    def read(self, addr: int, n: int) -> bytearray:
        if self.f is None:
            raise ValueError("HDF5: the file is closed")
        self.f.seek(self.base + addr)
        buf = bytearray(n)
        got = self.f.readinto(buf)
        if got != n:
            raise OSError(f"HDF5: {n} bytes at {addr} run past the end of the file")
        return buf

    def cursor(self, data, pos: int = 0) -> _Cursor:
        return _Cursor(data, pos, self.offsets, self.lengths)

    def _superblock(self):
        """Finds the signature at 0, 512, 1024, ... (a user block before
        it) and reads a v0/v1 superblock.  Returns (base, offsets, lengths,
        root object header address)."""
        f = self.f
        f.seek(0, os.SEEK_END)
        size = f.tell()
        at = 0
        while True:
            if at + 8 > size:
                raise OSError("not an HDF5 file (no superblock signature)")
            f.seek(at)
            if f.read(8) == _SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        head = f.read(16)
        if len(head) < 16:
            raise OSError("HDF5: the superblock runs past the end of the file")
        version = head[0]
        if version in (2, 3):
            raise NotImplementedError(f"HDF5 superblock v2/v3 (this file's is v{version}) is not read: {_LATEST_HINT}")
        if version not in (0, 1):
            raise NotImplementedError(f"HDF5 superblock v{version} is not read")
        offsets, lengths = head[5], head[6]
        if offsets not in (2, 4, 8) or lengths not in (2, 4, 8):
            raise OSError(f"HDF5: sizes of offsets {offsets} and lengths {lengths}")
        if version == 1:
            f.read(4)  # indexed storage internal node K, reserved
        # base, free-space, end-of-file and driver addresses, then the root
        # group's symbol table entry; addresses count from where the
        # superblock was found, as the HDF5 library counts them
        rest = f.read(4 * offsets + 2 * offsets + 8 + 16)
        c = _Cursor(rest, 4 * offsets, offsets, lengths)
        c.u(offsets)  # the link name offset
        root = c.addr()
        if root is None:
            raise OSError("HDF5: the root group has no object header")
        return at, offsets, lengths, root

    def header(self, addr: int) -> _Header:
        """The messages of the object header at ``addr`` (v1; its
        continuation blocks followed)."""
        hit = self.headers.get(addr)
        if hit is not None:
            return hit
        prefix = self.read(addr, 16)
        if bytes(prefix[:4]) == b"OHDR":
            raise NotImplementedError(f"HDF5 object header v2 (at {addr}) is not read: {_LATEST_HINT}")
        if prefix[0] != 1:
            raise NotImplementedError(f"HDF5 object header version {prefix[0]} (at {addr}) is not read")
        c = self.cursor(prefix, 2)
        count, _, size = c.u(2), c.u(4), c.u(4)
        messages: List[Tuple[int, int, bytes]] = []
        blocks = [(addr + 16, size)]
        while blocks and len(messages) < count:
            start, n = blocks.pop(0)
            block = self.read(start, n)
            c = self.cursor(block)
            while c.pos + 8 <= n and len(messages) < count:
                mtype, msize, flags = c.u(2), c.u(2), c.u(1)
                c.u(3)
                body = c.take(msize)
                messages.append((mtype, flags, body))
                if mtype == _CONTINUATION:
                    cc = self.cursor(body)
                    blocks.append((cc.addr(), cc.length()))
        header = _Header(messages)
        self.headers[addr] = header
        return header

    def heap_object(self, collection: int, index: int) -> bytes:
        """Object ``index`` of the global heap collection at
        ``collection`` (the collection parsed once)."""
        objects = self.heaps.get(collection)
        if objects is None:
            head = self.read(collection, 8 + self.lengths)
            if bytes(head[:4]) != b"GCOL":
                raise OSError(f"HDF5: no global heap collection at {collection}")
            total = self.cursor(head, 8).length()
            data = self.read(collection, total)
            c = self.cursor(data, 8 + self.lengths)
            objects = {}
            while c.pos + 8 + self.lengths <= total:
                idx = c.u(2)
                c.u(6)  # reference count, reserved
                n = c.length()
                if idx == 0:  # the free space closes the collection
                    break
                objects[idx] = c.take(n)
                c.pos += -n % 8
            self.heaps[collection] = objects
        if index not in objects:
            raise OSError(f"HDF5: global heap collection {collection} has no object {index}")
        return objects[index]

    # -- groups -----------------------------------------------------------

    def links(self, addr: int) -> Dict[str, Tuple[str, Optional[int]]]:
        """A group's members (parsed once): name -> ("hard", object header
        address) or (the link's kind, None)."""
        if addr not in self.groups:
            self.groups[addr] = self._links(addr)
        return self.groups[addr]

    def _links(self, addr: int) -> Dict[str, Tuple[str, Optional[int]]]:
        header = self.header(addr)
        table = header.first(_SYMBOL_TABLE)
        if table is not None:
            c = self.cursor(table)
            return self._symbol_table(c.addr(), c.addr())
        info = header.first(_LINK_INFO)
        if info is not None:
            c = self.cursor(info)
            c.u(1)
            flags = c.u(1)
            if flags & 1:
                c.u(8)  # the maximum creation index
            if c.addr() is not None:
                raise NotImplementedError(f"HDF5 dense link storage (a fractal heap, group at {addr}) is not read: {_LATEST_HINT}")
        out = {}
        for _, body in header.all(_LINK):
            name, kind, target = self._link_message(body)
            out[name] = (kind, target)
        return out

    def _link_message(self, body: bytes) -> Tuple[str, str, Optional[int]]:
        c = self.cursor(body)
        c.u(1)
        flags = c.u(1)
        kind = c.u(1) if flags & 0x8 else 0
        if flags & 0x4:
            c.u(8)  # creation order
        if flags & 0x10:
            c.u(1)  # the name's character set
        name = c.take(c.u(1 << (flags & 3))).decode("utf-8", "surrogateescape")
        if kind == 0:
            return name, "hard", c.addr()
        return name, {1: "soft", 64: "external"}.get(kind, f"user-defined ({kind})"), None

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, Tuple[str, Optional[int]]]:
        head = self.read(heap, 8 + 2 * self.lengths + self.offsets)
        if bytes(head[:4]) != b"HEAP":
            raise OSError(f"HDF5: no local heap at {heap}")
        c = self.cursor(head, 8)
        size = c.length()
        c.length()  # the free list
        names = self.read(c.addr(), size)

        def name_at(offset: int) -> str:
            end = names.index(0, offset)
            return bytes(names[offset:end]).decode("utf-8", "surrogateescape")

        entry = 2 * self.offsets + 24
        out: Dict[str, Tuple[str, Optional[int]]] = {}
        for _, snod in self._btree_leaves(btree, 0, self.lengths):
            head = self.read(snod, 8)
            if bytes(head[:4]) != b"SNOD":
                raise OSError(f"HDF5: no symbol table node at {snod}")
            n = int.from_bytes(head[6:8], "little")
            body = self.read(snod + 8, n * entry)
            for k in range(n):
                c = self.cursor(body, k * entry)
                name = name_at(c.u(self.offsets))
                target, cache = c.addr(), c.u(4)
                out[name] = ("soft", None) if cache == 2 else ("hard", target)
        return out

    def _btree_leaves(self, addr: int, node_type: int, key_size: int) -> List[Tuple[bytes, int]]:
        """(left key, child address) of every leaf entry of the v1 B-tree at
        ``addr``, in key order."""
        head = self.read(addr, 8 + 2 * self.offsets)
        if bytes(head[:4]) != b"TREE" or head[4] != node_type:
            raise OSError(f"HDF5: no B-tree node of type {node_type} at {addr}")
        level, used = head[5], int.from_bytes(head[6:8], "little")
        step = key_size + self.offsets
        body = self.read(addr + len(head), used * step + key_size)
        out = []
        for k in range(used):
            key = bytes(body[k * step : k * step + key_size])
            child = int.from_bytes(body[k * step + key_size : (k + 1) * step], "little")
            if level:
                out += self._btree_leaves(child, node_type, key_size)
            else:
                out.append((key, child))
        return out

    # -- datatypes, dataspaces, values ---------------------------------------

    def datatype(self, body: bytes, flags: int = 0) -> _Type:
        if flags & 0x2:
            raise NotImplementedError("HDF5 shared (committed) datatypes are not read")
        return self._datatype(self.cursor(body))

    def _datatype(self, c: _Cursor) -> _Type:
        b0 = c.u(1)
        cls, bits = b0 & 0x0F, c.u(3)
        size = c.u(4)
        if cls == 0:  # fixed-point
            order = ">" if bits & 1 else "<"
            offset, precision = c.u(2), c.u(2)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise NotImplementedError(f"HDF5 fixed-point datatype of {size} bytes, bits {offset}+{precision}")
            return _Type("num", np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}"), size)
        if cls == 1:  # floating point
            if bits & 0x40:
                raise NotImplementedError("HDF5 VAX-order floating point")
            order = ">" if bits & 1 else "<"
            offset, precision = c.u(2), c.u(2)
            exp_loc, exp_size, mant_loc, mant_size, bias = c.u(1), c.u(1), c.u(1), c.u(1), c.u(4)
            if _IEEE.get(size) != (exp_loc, exp_size, mant_size, bias) or offset or mant_loc or precision != 8 * size:
                raise NotImplementedError(f"HDF5 floating-point datatype of {size} bytes that is not IEEE")
            return _Type("num", np.dtype(f"{order}f{size}"), size)
        if cls == 3:  # fixed-length string
            return _Type("fstr", np.dtype(f"S{size}"), size, pad=bits & 0x0F)
        if cls == 9:  # variable length
            if bits & 0x0F != 1:
                raise NotImplementedError("HDF5 variable-length sequences are not read (only variable-length strings)")
            self._datatype(c)  # the base type (a character)
            return _Type("vstr", np.dtype(object), size)
        raise NotImplementedError(f"HDF5 datatype class {cls} ({_TYPE_CLASSES.get(cls, 'unknown')}) is not read")

    def dataspace(self, body: bytes, flags: int = 0) -> _Space:
        if flags & 0x2:
            raise NotImplementedError("HDF5 shared dataspaces are not read")
        c = self.cursor(body)
        version, rank, dflags = c.u(1), c.u(1), c.u(1)
        if version == 1:
            c.u(5)
            null = False
        elif version == 2:
            null = c.u(1) == 2
        else:
            raise NotImplementedError(f"HDF5 dataspace message version {version}")
        return _Space(None if null else tuple(c.u(self.lengths) for _ in range(rank)))

    def storage_dtype(self, t: _Type) -> np.dtype:
        """How an element lies in the file: a vlen string's (length,
        collection, index) record, else the value's dtype."""
        if t.kind != "vstr":
            return t.dtype
        return np.dtype([("n", "<u4"), ("addr", f"<u{self.offsets}"), ("idx", "<u4")])

    def values(self, raw: np.ndarray, t: _Type, as_str: bool) -> np.ndarray:
        """Stored elements -> the array h5py returns: fixed strings
        stripped, vlen strings fetched from the global heap (``str`` when
        ``as_str``, else ``bytes``)."""
        if t.kind == "fstr":
            rows = [r.tobytes() for r in np.ascontiguousarray(raw).view(np.uint8).reshape(-1, t.size)]
            if t.pad == 2:  # space-padded: the trailing spaces of all the bytes
                items = [r.rstrip(b" ") for r in rows]
            else:  # null-terminated or null-padded: up to the first null
                items = [r.split(b"\0", 1)[0] for r in rows]
            return np.array(items, dtype=t.dtype).reshape(raw.shape)
        if t.kind == "vstr":
            out = np.empty(raw.shape, dtype=object)
            flat = out.reshape(-1)
            for k, rec in enumerate(raw.reshape(-1)):
                n = int(rec["n"])
                data = self.heap_object(int(rec["addr"]), int(rec["idx"]))[:n] if n else b""
                flat[k] = data.decode("utf-8", "surrogateescape") if as_str else data
            return out
        return raw


def _fletcher32(data: bytes) -> int:
    """The HDF5 library's Fletcher-32 of ``data`` (16-bit big-endian words,
    sums folded every 360 words)."""
    words = np.frombuffer(data[: len(data) - len(data) % 2], ">u2").astype(np.int64)
    sum1 = sum2 = 0
    for start in range(0, len(words), 360):
        block = np.cumsum(words[start : start + 360])
        sum2 += len(block) * sum1 + int(block.sum())
        sum1 += int(block[-1])
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _unfilter(data: bytes, filters: List[Tuple[int, List[int]]], mask: int) -> bytes:
    """A chunk's stored bytes through its pipeline in reverse, skipping the
    filters its mask marks."""
    for k in range(len(filters) - 1, -1, -1):
        if mask & (1 << k):
            continue
        fid, values = filters[k]
        if fid == _FILTER_FLETCHER32:
            body, stored = data[:-4], int.from_bytes(data[-4:], "little")
            sum_ = _fletcher32(body)
            swapped = ((sum_ & 0xFF) << 24) | ((sum_ & 0xFF00) << 8) | ((sum_ >> 8) & 0xFF00) | (sum_ >> 24)
            if stored not in (sum_, swapped):  # the library also accepts the byte-swapped sum of old files
                raise OSError("HDF5: a chunk fails its Fletcher-32 checksum")
            data = body
        elif fid == _FILTER_DEFLATE:
            data = zlib.decompress(data)
        elif fid == _FILTER_SHUFFLE:
            size = values[0] if values else 1
            n = len(data) // size
            head = np.frombuffer(data[: n * size], np.uint8).reshape(size, n).T.tobytes()
            data = head + data[n * size :]
    return data


class AttributeManager:
    """An object's attributes (h5py's ``obj.attrs``), in name order."""

    def __init__(self, reader: _Reader, header: _Header):
        self._reader = reader
        info = header.first(_ATTR_INFO)
        if info is not None:
            c = reader.cursor(info)
            c.u(1)
            if c.u(1) & 1:
                c.u(2)  # the maximum creation index
            if c.addr() is not None:
                raise NotImplementedError(f"HDF5 dense attribute storage (a fractal heap) is not read: {_LATEST_HINT}")
        self._bodies: Dict[str, bytes] = {}
        for _, body in header.all(_ATTRIBUTE):
            self._bodies[self._name(body)] = body

    def _name(self, body: bytes) -> str:
        c = self._reader.cursor(body)
        version = c.u(1)
        c.u(1)
        n = c.u(2)
        c.u(4)
        if version == 3:
            c.u(1)
        return c.take(n).split(b"\0", 1)[0].decode("utf-8", "surrogateescape")

    def _value(self, body: bytes):
        r = self._reader
        c = r.cursor(body)
        version, flags = c.u(1), c.u(1)
        if version not in (1, 2, 3):
            raise NotImplementedError(f"HDF5 attribute message version {version}")
        n_name, n_type, n_space = c.u(2), c.u(2), c.u(2)
        if version == 3:
            c.u(1)  # the name's character set
        pad = (lambda n: n + -n % 8) if version == 1 else (lambda n: n)
        c.pos += pad(n_name)
        t = r.datatype(body[c.pos : c.pos + n_type], 0x2 if flags & 1 else 0)
        c.pos += pad(n_type)
        space = r.dataspace(body[c.pos : c.pos + n_space], 0x2 if flags & 2 else 0)
        c.pos += pad(n_space)
        if space.shape is None:
            return Empty(t.dtype)
        stored = r.storage_dtype(t)
        raw = np.frombuffer(c.take(space.count * t.size), stored).reshape(space.shape).copy()
        value = r.values(raw, t, as_str=True)
        return value[()] if space.shape == () else value

    def keys(self) -> List[str]:
        return sorted(self._bodies, key=lambda s: s.encode("utf-8", "surrogateescape"))

    def __contains__(self, name) -> bool:
        return name in self._bodies

    def __getitem__(self, name: str):
        if name not in self._bodies:
            raise KeyError(f"Can't open attribute (no attribute {name!r})")
        return self._value(self._bodies[name])

    def get(self, name: str, default=None):
        return self[name] if name in self._bodies else default

    def items(self):
        return [(k, self[k]) for k in self.keys()]


class _Object:
    def __init__(self, reader: _Reader, addr: int, name: str):
        self._reader, self._addr, self.name = reader, addr, name

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self._reader, self._reader.header(self._addr))


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``ds[()]`` and ``np.array(ds)``
    read it whole (one read for contiguous storage)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        super().__init__(reader, addr, name)
        header = reader.header(addr)
        flags, body = next(iter(header.all(_DATATYPE)), (0, None))
        self._type = reader.datatype(body, flags)
        sflags, sbody = next(iter(header.all(_DATASPACE)), (0, None))
        self._space = reader.dataspace(sbody, sflags)
        if header.first(_EXTERNAL) is not None:
            raise NotImplementedError(f"HDF5 external storage ({name}) is not read")

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return self._space.shape

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype

    def _fill(self) -> bytes:
        """One element of the fill value (zeros when none is defined)."""
        r, header = self._reader, self._reader.header(self._addr)
        body = header.first(_FILL)
        if body is not None:
            c = r.cursor(body)
            version = c.u(1)
            if version in (1, 2):
                c.u(2)
                defined = c.u(1)
                if version == 1 or defined:
                    n = c.u(4)
                    if n:
                        return c.take(n)
            else:
                if c.u(1) & 0x20:
                    n = c.u(4)
                    if n:
                        return c.take(n)
            return bytes(self._type.size)
        body = header.first(_FILL_OLD)
        if body is not None:
            c = r.cursor(body)
            n = c.u(4)
            if n:
                return c.take(n)
        return bytes(self._type.size)

    def _filled(self, shape, stored: np.dtype) -> np.ndarray:
        return np.frombuffer(self._fill() * int(np.prod(shape, dtype=np.int64)), stored).reshape(shape).copy()

    def _read(self):
        r, t, shape = self._reader, self._type, self.shape
        if shape is None:
            return Empty(t.dtype)
        stored = r.storage_dtype(t)
        header = r.header(self._addr)
        body = header.first(_LAYOUT)
        if body is None:
            raise OSError(f"HDF5: dataset {self.name} has no layout message")
        c = r.cursor(body)
        version = c.u(1)
        nbytes = self._space.count * t.size
        if version in (1, 2):
            ndims, cls = c.u(1), c.u(1)
            c.u(5)
            addr = c.addr() if cls in (1, 2) else None
            dims = [c.u(4) for _ in range(ndims)]
            if cls == 0:
                raw = bytearray(c.take(c.u(4)))
            elif cls == 1:
                raw = None if addr is None else r.read(addr, nbytes)
            elif cls == 2:
                return r.values(self._chunked(addr, dims[:-1], stored), t, as_str=False)
            else:
                raise NotImplementedError(f"HDF5 layout class {cls}")
        elif version == 3:
            cls = c.u(1)
            if cls == 0:
                raw = bytearray(c.take(c.u(2)))
            elif cls == 1:
                addr, _ = c.addr(), c.length()
                raw = None if addr is None else r.read(addr, nbytes)
            elif cls == 2:
                ndims = c.u(1)
                addr = c.addr()
                dims = [c.u(4) for _ in range(ndims)]
                return r.values(self._chunked(addr, dims[:-1], stored), t, as_str=False)
            else:
                raise NotImplementedError(f"HDF5 layout class {cls} ({self.name})")
        else:
            raise NotImplementedError(f"HDF5 layout message version {version} ({self.name}): {_LATEST_HINT}")
        if raw is None:  # never written: the fill value, as h5py reads it
            return r.values(self._filled(shape, stored), t, as_str=False)
        return r.values(np.frombuffer(raw, stored, count=self._space.count).reshape(shape), t, as_str=False)

    def _chunked(self, btree: Optional[int], chunk: List[int], stored: np.dtype) -> np.ndarray:
        r, shape = self._reader, self.shape
        out = self._filled(shape, stored)
        if btree is None:
            return out
        filters = self._filters()
        rank = len(shape)
        key_size = 8 + 8 * (rank + 1)
        nchunk = int(np.prod(chunk, dtype=np.int64)) * stored.itemsize
        for key, addr in r._btree_leaves(btree, 1, key_size):
            size = int.from_bytes(key[:4], "little")
            mask = int.from_bytes(key[4:8], "little")
            origin = [int.from_bytes(key[8 + 8 * d : 16 + 8 * d], "little") for d in range(rank)]
            data = _unfilter(bytes(r.read(addr, size)), filters, mask)
            if len(data) != nchunk:
                raise OSError(f"HDF5: a chunk of {self.name} holds {len(data)} bytes, not {nchunk}")
            block = np.frombuffer(data, stored).reshape(chunk)
            dst = tuple(slice(o, min(o + n, s)) for o, n, s in zip(origin, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _filters(self) -> List[Tuple[int, List[int]]]:
        body = self._reader.header(self._addr).first(_FILTERS)
        if body is None:
            return []
        c = self._reader.cursor(body)
        version, count = c.u(1), c.u(1)
        if version == 1:
            c.u(6)
        out = []
        for _ in range(count):
            fid = c.u(2)
            n_name = c.u(2) if version == 1 or fid >= 256 else 0
            c.u(2)  # flags
            n_values = c.u(2)
            c.pos += (n_name + -n_name % 8) if version == 1 else n_name
            values = [c.u(4) for _ in range(n_values)]
            if version == 1 and n_values % 2:
                c.u(4)
            if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32):
                raise NotImplementedError(f"HDF5 filter {fid} ({self.name}) is not read: deflate, shuffle and fletcher32 are")
            out.append((fid, values))
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        if isinstance(arr, Empty):
            raise TypeError("HDF5: an empty (null dataspace) dataset has no array")
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, key):
        arr = self._read()
        if isinstance(arr, Empty):
            if key == () or key is Ellipsis:
                return arr
            raise ValueError("Empty datasets cannot be sliced")
        return arr[key]


class Group(_Object):
    """A group: members by ``/``-separated path, in name order."""

    def _members(self) -> Dict[str, Tuple[str, Optional[int]]]:
        return self._reader.links(self._addr)

    def keys(self) -> List[str]:
        return sorted(self._members(), key=lambda s: s.encode("utf-8", "surrogateescape"))

    def __len__(self) -> int:
        return len(self._members())

    def _child(self, name: str):
        members = self._members()
        if name not in members:
            raise KeyError(f"Unable to open object (object {name!r} doesn't exist)")
        kind, addr = members[name]
        path = f"{self.name.rstrip('/')}/{name}"
        if kind != "hard":
            raise NotImplementedError(f"HDF5 {kind} link {path} is not followed (only hard links are)")
        header = self._reader.header(addr)
        if header.first(_SYMBOL_TABLE) is not None or header.first(_LINK_INFO) is not None or header.first(_LINK) is not None:
            return Group(self._reader, addr, path)
        if header.first(_LAYOUT) is not None:
            return Dataset(self._reader, addr, path)
        raise NotImplementedError(f"HDF5 object {path} is neither a group nor a dataset (a committed datatype?)")

    def __getitem__(self, path: str):
        node = self
        if path.startswith("/"):
            node = Group(self._reader, self._reader.root, "/")
        for part in (p for p in path.split("/") if p and p != "."):
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is not a group")
            node = node._child(part)
        return node

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def visititems(self, fn: Callable):
        """``fn(relative name, object)`` for every object below this group,
        depth first in name order, each object once (h5py's order and
        names); stops at and returns the first result that is not None."""
        seen = {self._addr}

        def walk(group: Group, prefix: str):
            for name in group.keys():
                obj = group[name]
                if obj._addr in seen:
                    continue
                seen.add(obj._addr)
                result = fn(prefix + name, obj)
                if result is None and isinstance(obj, Group):
                    result = walk(obj, prefix + name + "/")
                if result is not None:
                    return result
            return None

        return walk(self, "")


class File(Group):
    """An HDF5 file opened read-only: a path, or the bytes of one (``bytes``,
    ``bytearray``, ``memoryview`` or a binary file object, which stays
    open)."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray, memoryview)):
            f, close = io.BytesIO(bytes(source)), True
        elif isinstance(source, (str, os.PathLike)):
            f, close = open(source, "rb"), True
        else:
            f, close = source, False
        try:
            reader = _Reader(f, close)
        except BaseException:
            if close:
                f.close()
            raise
        super().__init__(reader, reader.root, "/")

    def close(self) -> None:
        self._reader.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
