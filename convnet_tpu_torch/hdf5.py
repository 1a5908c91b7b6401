"""The subset of HDF5 that the port's files use, read and written with numpy
and the standard library, so that the port needs no h5py; a checkpoint
written by either package still loads in the other
(docs/checkpoint_format.md).

The API is the part of h5py's that the port calls: `File(path, "r" | "w")`
as a context manager, `Group` (`[]`, `in`, `keys`, `items`,
`create_group`, `create_dataset`, `create_appendable`), `Dataset`
(`shape`, `dtype`, `[...]`, a slice or an integer array on the first axis,
sorted or not, repeats allowed) and `.attrs` on both.

Read: superblock version 0 or 1; version 1 object headers with their
continuation blocks; symbol-table groups (a v1 B-tree of type 0, any
depth, over SNOD nodes and a local heap); dataspaces (version 1 and 2,
scalar and null included); fixed-point and IEEE float types of either byte
order, fixed-length strings and variable-length strings (global heap);
attribute messages version 1 to 3; layout message version 3: compact,
contiguous (read through a memory map of the file, so a row read touches
only its rows) and chunked (a v1 B-tree of type 1; only the chunks that
hold the asked rows are read), with the deflate and shuffle filters.
Anything else raises NotImplementedError naming it: superblock 2 or 3 and
version 2 object headers (libver "latest"), link messages, dense
attribute storage, shared messages, other filters (fletcher32, szip,
lzf, ...), other datatype classes.

Write: superblock version 0 with 8-byte offsets and lengths, version 1
object headers, symbol-table groups (as many SNOD leaves and B-tree levels
as a group needs), contiguous datasets written as they are created,
attributes (int and float scalars, numeric arrays, fixed-length bytes and
variable-length UTF-8 str, as h5py stores a Python str), and appendable
chunked datasets (`create_appendable`) whose chunks go to the file as
their rows arrive. The metadata, the chunk indexes and the superblock's
end-of-file address are written at close.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x6, 0x8, 0xA, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                5: "opaque", 6: "compound", 7: "reference", 8: "enumerated",
                9: "variable-length", 10: "array"}
# IEEE layouts by size: (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}

# what the writer uses: the library's defaults for a version 0 superblock
_LEAF_K = 4  # a symbol-table node holds up to 2K links
_GROUP_K = 16  # a group B-tree node holds up to 2K children
_CHUNK_K = 32  # a chunk B-tree node holds up to 2K children


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Type:
    """A parsed datatype: `dtype` is numpy's, object for a variable-length
    string, whose `utf8` says its character set."""

    def __init__(self, dtype: np.dtype, vlen: bool = False, utf8: bool = False):
        self.dtype, self.vlen, self.utf8 = dtype, vlen, utf8


# -- reading ---------------------------------------------------------------------


class _Reader:
    """A file's bytes through a read-only memory map, and the parsers of
    its metadata."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        size = os.fstat(self._fh.fileno()).st_size
        if size < len(SIGNATURE):
            self._fh.close()
            raise OSError(f"{path}: not an HDF5 file ({size} bytes)")
        self.mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        at = 0  # the superblock sits at 0 or past a user block of 512 * 2^n bytes
        while self.mm[at : at + 8] != SIGNATURE:
            at = 512 if at == 0 else at * 2
            if at + 8 > size:
                self.close()
                raise OSError(f"{path}: not an HDF5 file (no signature)")
        self._superblock(at)

    def close(self):
        if self.mm is not None:
            self.mm.close()
            self.mm = None
            self._fh.close()

    def _superblock(self, at: int):
        mm = self.mm
        version = mm[at + 8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{self.path}: HDF5 superblock version {version} (written with libver "
                f"'latest' or 'v108' and up); only versions 0 and 1 are read")
        self.O, self.L = mm[at + 13], mm[at + 14]
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise NotImplementedError(f"{self.path}: {self.O}-byte offsets, {self.L}-byte lengths")
        pos = at + (28 if version == 1 else 24)
        self.base = self.u(pos, self.O)
        root = pos + 4 * self.O  # past the base address and the three that follow it
        self.root = self.u(root + self.O, self.O)

    # -- primitives

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.mm[pos : pos + n], "little")

    def addr(self, a: int) -> int:
        """A file address -> a position in the map."""
        return self.base + a

    def undefined(self, a: int) -> bool:
        return a == (1 << (8 * self.O)) - 1

    # -- object headers

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of each message of the object header at `addr`,
        continuation blocks followed."""
        mm, pos = self.mm, self.addr(addr)
        if mm[pos : pos + 4] == b"OHDR":
            raise NotImplementedError(
                f"{self.path}: version 2 object header at {addr} (written with libver "
                "'latest' or 'v108' and up); only version 1 headers are read")
        if mm[pos] != 1:
            raise NotImplementedError(f"{self.path}: object header version {mm[pos]} at {addr}")
        blocks = [(pos + 16, self.u(pos + 8, 4))]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            p, end = start, start + length
            while p + 8 <= end:
                mtype, size, flags = self.u(p, 2), self.u(p + 2, 2), mm[p + 4]
                data = mm[p + 8 : p + 8 + size]
                p += 8 + size
                if mtype == _CONTINUATION:
                    blocks.append((self.addr(int.from_bytes(data[: self.O], "little")),
                                   int.from_bytes(data[self.O : self.O + self.L], "little")))
                    continue
                if mtype == _NIL:
                    continue
                if flags & 0x02:
                    raise NotImplementedError(
                        f"{self.path}: shared message (type {mtype:#x}) at {addr}")
                out.append((mtype, data))
        return out

    # -- datatypes, dataspaces, attributes

    def datatype(self, b: bytes, at: int = 0) -> Tuple[_Type, int]:
        """The datatype encoded at b[at:] and the bytes it takes."""
        cls, bits, size = b[at] & 0x0F, b[at + 1 : at + 4], int.from_bytes(b[at + 4 : at + 8], "little")
        if cls == 0:  # fixed-point
            order = ">" if bits[0] & 1 else "<"
            offset, precision = struct.unpack_from("<HH", b, at + 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise NotImplementedError(
                    f"{self.path}: {size}-byte integer of {precision} bits at offset {offset}")
            kind = "i" if bits[0] & 0x08 else "u"
            return _Type(np.dtype(f"{order}{kind}{size}")), 12
        if cls == 1:  # floating-point
            if bits[0] & 0x40:
                raise NotImplementedError(f"{self.path}: VAX-order float")
            order = ">" if bits[0] & 1 else "<"
            offset, precision, eloc, esize, mloc, msize, bias = struct.unpack_from(
                "<HHBBBBI", b, at + 8)
            if _IEEE.get(size) != (eloc, esize, msize, bias) or offset or mloc or precision != 8 * size:
                raise NotImplementedError(f"{self.path}: {size}-byte non-IEEE float")
            return _Type(np.dtype(f"{order}f{size}")), 20
        if cls == 3:  # fixed-length string
            return _Type(np.dtype(f"S{size}")), 8
        if cls == 9 and bits[0] & 0x0F == 1:  # variable-length string
            _, used = self.datatype(b, at + 8)
            return _Type(np.dtype(object), vlen=True, utf8=bool(bits[1] & 0x0F)), 8 + used
        what = "variable-length sequence" if cls == 9 else _CLASS_NAMES.get(cls, f"class {cls}")
        raise NotImplementedError(f"{self.path}: HDF5 datatype {what}")

    def dataspace(self, b: bytes) -> Optional[Tuple[int, ...]]:
        """The shape (maximum dims are not needed to read); None for a null
        dataspace."""
        version, rank = b[0], b[1]
        if version == 1:
            at = 8
        elif version == 2:
            if b[3] == 2:
                return None
            at = 4
        else:
            raise NotImplementedError(f"{self.path}: dataspace message version {version}")
        L = self.L
        return tuple(int.from_bytes(b[at + i * L : at + (i + 1) * L], "little") for i in range(rank))

    def attribute(self, b: bytes):
        """(name, value) of an attribute message, values as h5py gives
        them: a numpy scalar or array, str for a variable-length string."""
        version = b[0]
        if version not in (1, 2, 3):
            raise NotImplementedError(f"{self.path}: attribute message version {version}")
        if version > 1 and b[1] & 0x03:
            raise NotImplementedError(f"{self.path}: attribute with a shared datatype or dataspace")
        nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
        pad = _pad8 if version == 1 else (lambda n: n)
        at = 9 if version == 3 else 8
        name = bytes(b[at : at + nsize]).rstrip(b"\0").decode("utf-8")
        at += pad(nsize)
        dtype, _ = self.datatype(b, at)
        at += pad(tsize)
        shape = self.dataspace(b[at : at + ssize])
        at += pad(ssize)
        if shape is None:
            return name, None
        return name, self.values(bytes(b[at:]), dtype, shape)

    def values(self, raw: bytes, t: _Type, shape: Tuple[int, ...], decode: bool = True):
        """Elements of type t from their stored bytes; variable-length
        strings as str where `decode` (attributes), else as bytes (datasets,
        as h5py gives them)."""
        n = int(np.prod(shape, dtype=np.int64))
        if t.vlen:
            arr = np.empty(n, object)
            width = 8 + self.O  # length, collection address, index
            for i in range(n):
                at = width * i
                length = int.from_bytes(raw[at : at + 4], "little")
                coll = int.from_bytes(raw[at + 4 : at + 4 + self.O], "little")
                index = int.from_bytes(raw[at + 4 + self.O : at + width], "little")
                data = self.gheap_object(coll, index)[:length]
                arr[i] = data.decode("utf-8" if t.utf8 else "ascii") if decode else data
            arr = arr.reshape(shape)
        else:
            arr = np.frombuffer(raw, t.dtype, count=n).reshape(shape).copy()
        return arr[()] if shape == () else arr

    def gheap_object(self, coll: int, index: int) -> bytes:
        if coll not in self._gheaps:
            pos = self.addr(coll)
            if self.mm[pos : pos + 4] != b"GCOL":
                raise OSError(f"{self.path}: no global heap collection at {coll}")
            end = pos + self.u(pos + 8, self.L)
            objs, p = {}, pos + 8 + self.L
            while p + 8 + self.L <= end:
                idx, size = self.u(p, 2), self.u(p + 8, self.L)
                if idx == 0:  # free space: the rest of the collection
                    break
                objs[idx] = bytes(self.mm[p + 8 + self.L : p + 8 + self.L + size])
                p += 8 + self.L + _pad8(size)
            self._gheaps[coll] = objs
        return self._gheaps[coll][index]

    # -- B-trees, symbol tables

    def btree(self, addr: int, node_type: int, key_size: int) -> Iterator[Tuple[bytes, int]]:
        """(left key, child address) of each leaf entry of the v1 B-tree at
        `addr`, in key order, at any depth."""
        pos = self.addr(addr)
        if self.mm[pos : pos + 4] != b"TREE" or self.mm[pos + 4] != node_type:
            raise OSError(f"{self.path}: no type {node_type} B-tree node at {addr}")
        level, entries = self.mm[pos + 5], self.u(pos + 6, 2)
        p = pos + 8 + 2 * self.O
        for _ in range(entries):
            key = bytes(self.mm[p : p + key_size])
            child = self.u(p + key_size, self.O)
            p += key_size + self.O
            if level:
                yield from self.btree(child, node_type, key_size)
            else:
                yield key, child

    def links(self, btree: int, heap: int) -> Dict[str, int]:
        """{name: object header address} of a symbol-table group."""
        pos = self.addr(heap)
        if self.mm[pos : pos + 4] != b"HEAP":
            raise OSError(f"{self.path}: no local heap at {heap}")
        names = self.addr(self.u(pos + 8 + 2 * self.L, self.O))
        out = {}
        entry = 2 * self.O + 24
        for _, snod in self.btree(btree, 0, self.L):
            p = self.addr(snod)
            if self.mm[p : p + 4] != b"SNOD":
                raise OSError(f"{self.path}: no symbol-table node at {snod}")
            for i in range(self.u(p + 6, 2)):
                e = p + 8 + i * entry
                start = names + self.u(e, self.O)
                name = bytes(self.mm[start : self.mm.find(b"\0", start)]).decode("utf-8")
                out[name] = self.u(e + self.O, self.O)
        return out

    def open(self, addr: int, name: str):
        """The Group or Dataset whose object header is at `addr`."""
        msgs = self.messages(addr)
        types = {t for t, _ in msgs}
        attrs: Dict = {}
        for t, data in msgs:
            if t == _ATTRIBUTE:
                key, value = self.attribute(data)
                attrs[key] = value
            elif t == _ATTRIBUTE_INFO:
                flags = data[1]
                at = 2 + (2 if flags & 1 else 0)
                if not self.undefined(int.from_bytes(data[at : at + self.O], "little")):
                    raise NotImplementedError(
                        f"{self.path}: dense attribute storage (fractal heap) on {name!r}")
        attrs = dict(sorted(attrs.items(), key=lambda kv: kv[0].encode("utf-8")))  # h5py's order
        if _SYMBOL_TABLE in types:
            data = next(d for t, d in msgs if t == _SYMBOL_TABLE)
            btree = int.from_bytes(data[: self.O], "little")
            heap = int.from_bytes(data[self.O : 2 * self.O], "little")
            return Group(name, attrs, reader=self, links=(btree, heap))
        if _LAYOUT in types:
            return Dataset(name, attrs, layout=_StoredLayout(self, msgs, name))
        if types & {_LINK, _LINK_INFO, _GROUP_INFO}:
            raise NotImplementedError(
                f"{self.path}: {name!r} is a group with link messages (compact or dense link "
                "storage); only symbol-table groups are read")
        raise NotImplementedError(f"{self.path}: {name!r} is neither a group nor a dataset")


class _StoredLayout:
    """How a dataset's elements lie in the file, and their reads."""

    def __init__(self, r: _Reader, msgs, name: str):
        self.r, self.name = r, name
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        self.fill = None
        shape = dtype = None
        layout = None
        for t, b in msgs:
            if t == _DATASPACE:
                shape = r.dataspace(b)
            elif t == _DATATYPE:
                dtype, _ = r.datatype(b)
            elif t == _LAYOUT:
                layout = b
            elif t == _FILTERS:
                self.filters = self._pipeline(b)
            elif t in (_FILL, _FILL_OLD):
                self.fill = self._fill(t, b)
        self.type = dtype
        # variable-length strings are stored as heap IDs: length, collection, index
        self.stored = np.dtype((np.void, 8 + r.O)) if dtype.vlen else dtype.dtype
        self.shape = shape if shape is not None else (0,)
        if layout[0] != 3:
            raise NotImplementedError(f"{r.path}: {name!r}: data layout message version {layout[0]}")
        self.kind = layout[1]
        O = r.O
        if self.kind == 0:  # compact
            size = struct.unpack_from("<H", layout, 2)[0]
            self.compact = bytes(layout[4 : 4 + size])
        elif self.kind == 1:  # contiguous
            self.address = int.from_bytes(layout[2 : 2 + O], "little")
        elif self.kind == 2:  # chunked
            rank = layout[2]
            self.address = int.from_bytes(layout[3 : 3 + O], "little")
            self.chunk = struct.unpack_from(f"<{rank - 1}I", layout, 3 + O)
            self._index: Optional[Dict[Tuple[int, ...], Tuple[int, int, int]]] = None
            self._last: Tuple = (None, None)
        else:
            raise NotImplementedError(f"{r.path}: {name!r}: layout class {self.kind}")
        if self.filters and self.kind != 2:
            raise NotImplementedError(f"{r.path}: {name!r}: filters on an unchunked dataset")

    def _pipeline(self, b: bytes):
        version, n = b[0], b[1]
        at = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = struct.unpack_from("<H", b, at)[0]
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", b, at + 2)[0]
                at += 4
            else:
                name_len = 0
                at += 2
            flags, nvals = struct.unpack_from("<HH", b, at)
            at += 4 + (_pad8(name_len) if version == 1 else name_len)
            vals = struct.unpack_from(f"<{nvals}I", b, at)
            at += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2):
                raise NotImplementedError(
                    f"{self.r.path}: {self.name!r}: the {_FILTER_NAMES.get(fid, f'id {fid}')} "
                    "filter; only deflate and shuffle are read")
            out.append((fid, vals))
        return out

    def _fill(self, t: int, b: bytes):
        """The fill value's bytes, or None for zeros."""
        if t == _FILL_OLD:
            size = struct.unpack_from("<I", b, 0)[0]
            return bytes(b[4 : 4 + size]) or None
        version = b[0]
        if version in (1, 2):
            if version == 2 and not b[3]:
                return None
            size = struct.unpack_from("<I", b, 4)[0]
            return bytes(b[8 : 8 + size]) or None
        if b[1] & 0x20:  # version 3, fill value defined
            size = struct.unpack_from("<I", b, 2)[0]
            return bytes(b[6 : 6 + size]) or None
        return None

    def filled(self, shape) -> np.ndarray:
        out = np.zeros(shape, self.type.dtype)
        if self.fill is not None and not self.type.vlen:
            out[...] = np.frombuffer(self.fill, self.type.dtype, count=1)[0]
        return out

    # -- element reads

    def _stored(self, shape) -> np.ndarray:
        """A view of the stored elements (a variable-length string's as its
        heap ID)."""
        dt = self.stored
        if self.kind == 0:
            return np.frombuffer(self.compact, dt, count=int(np.prod(shape))).reshape(shape)
        return np.ndarray(shape, dt, buffer=self.r.mm, offset=self.r.addr(self.address))

    def read(self, rows: np.ndarray) -> np.ndarray:
        """The elements at the first-axis indices `rows`, an integer array
        of any shape and order, repeats allowed."""
        shape = rows.shape + tuple(self.shape[1:])
        if self.kind == 2:
            out = self._chunked(rows.reshape(-1)).reshape(shape)
        elif (self.kind == 1 and self.r.undefined(self.address)) or 0 in self.shape:
            return self.filled(shape)
        else:
            out = self._stored(self.shape)[rows]
        if self.type.vlen:
            return self.r.values(out.tobytes(), self.type, shape, decode=False)
        return out

    def read_all(self) -> np.ndarray:
        if self.shape == ():
            if self.kind == 1 and self.r.undefined(self.address):
                return self.filled(())
            out = np.array(self._stored(()))
            return self.r.values(out.tobytes(), self.type, (), decode=False) if self.type.vlen else out
        return self.read(np.arange(self.shape[0]))

    # -- chunked

    def _chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """{chunk's first element: (address, stored bytes, filter mask)}."""
        if self._index is None:
            self._index = {}
            if not self.r.undefined(self.address):
                rank = len(self.chunk)
                key_size = 8 + 8 * (rank + 1)
                for key, child in self.r.btree(self.address, 1, key_size):
                    size, mask = struct.unpack_from("<II", key, 0)
                    offset = struct.unpack_from(f"<{rank}Q", key, 8)
                    self._index[offset] = (child, size, mask)
        return self._index

    def _chunk(self, offset: Tuple[int, ...]) -> Optional[np.ndarray]:
        """One chunk's elements, or None where none was written."""
        if self._last[0] == offset:
            return self._last[1]
        entry = self._chunk_index().get(offset)
        if entry is None:
            return None
        addr, size, mask = entry
        dt = self.stored
        active = [(fid, vals) for i, (fid, vals) in enumerate(self.filters) if not mask >> i & 1]
        if not active:
            return np.ndarray(self.chunk, dt, buffer=self.r.mm, offset=self.r.addr(addr))
        pos = self.r.addr(addr)
        raw = bytes(self.r.mm[pos : pos + size])
        for fid, vals in reversed(active):
            if fid == 1:
                raw = zlib.decompress(raw)
            else:  # shuffle: byte planes back to elements
                width = vals[0] if vals else dt.itemsize
                n = len(raw) // width
                planes = np.frombuffer(raw, np.uint8, count=n * width).reshape(width, n)
                raw = planes.T.tobytes() + raw[n * width :]
        arr = np.frombuffer(raw, dt, count=int(np.prod(self.chunk))).reshape(self.chunk)
        self._last = (offset, arr)
        return arr

    def _chunked(self, rows: np.ndarray) -> np.ndarray:
        """The rows at the 1-D indices `rows`, a band of chunks along the
        first axis at a time: each chunk of the band is read (and decoded)
        once, its rows gathered by a fancy index into a temporary, and the
        temporary scattered to their places in the result, two copies."""
        shape = (len(rows),) + tuple(self.shape[1:])
        out = np.zeros(shape, self.stored) if self.type.vlen else self.filled(shape)
        c0 = self.chunk[0]
        band = rows // c0
        order = np.argsort(band, kind="stable")
        cuts = np.flatnonzero(np.diff(band[order])) + 1
        grids = [range(0, n, c) for n, c in zip(self.shape[1:], self.chunk[1:])]
        for where in np.split(order, cuts) if len(rows) else []:
            first = int(band[where[0]]) * c0
            inner = rows[where] - first
            for rest in np.ndindex(*[len(g) for g in grids]):
                lo = tuple(g[i] for g, i in zip(grids, rest))
                chunk = self._chunk((first,) + lo)
                if chunk is None:
                    continue
                region = tuple(slice(a, min(a + c, n)) for a, c, n in
                               zip(lo, self.chunk[1:], self.shape[1:]))
                inside = tuple(slice(0, r.stop - r.start) for r in region)
                out[(where,) + region] = chunk[(inner,) + inside]
        return out


# -- the h5py-like objects ----------------------------------------------------------


class AttributeManager(dict):
    """An object's attributes, as a dict. On a file opened "w" a value set
    is converted to what is stored; on a file opened "r" setting raises."""

    def __init__(self, values: Dict, writable: bool):
        super().__init__(values)
        self._writable = writable

    def __setitem__(self, key, value):
        if not self._writable:
            raise OSError("attributes of a file opened for reading are read-only")
        super().__setitem__(key, _attribute_value(key, value))


class Group:
    """A group of named members, each a Group or a Dataset."""

    def __init__(self, name: str, attrs: Dict, reader: Optional[_Reader] = None,
                 links=None, writer: Optional["_Writer"] = None):
        self.name = name
        self.attrs = AttributeManager(attrs, writable=writer is not None)
        self._reader, self._links, self._writer = reader, links, writer
        self._members: Optional[Dict] = None if reader is not None else {}

    def _table(self) -> Dict:
        if self._members is None:
            self._members = dict(self._reader.links(*self._links))
        return self._members

    def _child(self, name: str):
        item = self._table()[name]
        if isinstance(item, int):  # an object header not yet opened
            path = f"{self.name.rstrip('/')}/{name}"
            item = self._table()[name] = self._reader.open(item, path)
        return item

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._table():
                raise KeyError(f"{path!r} not in {self.name!r}")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._table())

    def keys(self) -> List[str]:
        return sorted(self._table(), key=lambda n: n.encode("utf-8"))

    def items(self):
        return [(n, self._child(n)) for n in self.keys()]

    # -- writing

    def _add(self, name: str, item):
        if self._writer is None:
            raise OSError(f"{self.name!r} is read-only: open the file with mode 'w'")
        parent = self
        parts = [p for p in name.split("/") if p]
        for part in parts[:-1]:
            parent = parent[part] if part in parent._table() else parent.create_group(part)
        if not parts or parts[-1] in parent._table():
            raise ValueError(f"cannot create {name!r} in {self.name!r}: the name is taken")
        item.name = f"{parent.name.rstrip('/')}/{parts[-1]}"
        parent._table()[parts[-1]] = item
        return item

    def create_group(self, name: str) -> "Group":
        return self._add(name, Group(name, {}, writer=self._writer))

    def create_dataset(self, name: str, data=None) -> "Dataset":
        """A contiguous dataset holding `data`, written to the file now."""
        if self._writer is None:
            raise OSError(f"{self.name!r} is read-only: open the file with mode 'w'")
        arr = np.asarray(data)
        _type_message(arr.dtype)  # refuse what cannot be stored before writing
        address = self._writer.write_array(arr) if arr.size else UNDEF
        return self._add(name, Dataset(name, {}, writer=self._writer, array=(arr.shape, arr.dtype, address)))

    def create_appendable(self, name: str, row_shape, dtype, chunk_rows: int) -> "Dataset":
        """An empty dataset of rows of `row_shape` that grows by `append`,
        chunked by `chunk_rows` rows; each chunk goes to the file when it
        fills (the last at close), so at most one chunk is held."""
        if self._writer is None:
            raise OSError(f"{self.name!r} is read-only: open the file with mode 'w'")
        _type_message(np.dtype(dtype))
        ds = Dataset(name, {}, writer=self._writer,
                     appendable=(tuple(row_shape), np.dtype(dtype), int(chunk_rows)))
        self._writer.appendables.append(ds)
        return self._add(name, ds)


class Dataset:
    """A dataset: `shape`, `dtype`, and its elements through `[...]`,
    `[()]`, or a slice, an integer or an integer array on the first axis."""

    def __init__(self, name: str, attrs: Dict, layout: Optional[_StoredLayout] = None,
                 writer=None, array=None, appendable=None):
        self.name = name
        self.attrs = AttributeManager(attrs, writable=writer is not None)
        self._layout = layout
        if layout is not None:
            self.shape, self.dtype = tuple(layout.shape), layout.type.dtype
        elif array is not None:
            self.shape, self.dtype, self._address = array
        else:
            row_shape, self.dtype, self._chunk_rows = appendable
            self._row_shape = row_shape
            self.shape = (0,) + row_shape
            self._buffer = np.zeros((self._chunk_rows,) + row_shape, self.dtype)
            self._filled = 0
            self._chunks: List[int] = []  # file address of each chunk, in row order
        self._writer = writer

    def __getitem__(self, key):
        if self._layout is None:
            raise OSError(f"{self.name!r} was opened for writing and is not read back")
        layout = self._layout
        if isinstance(key, tuple) and not key:  # [()]: a scalar's element as a numpy scalar
            out = layout.read_all()
            return out[()] if not self.shape else out
        if key is Ellipsis:
            return layout.read_all()
        if isinstance(key, tuple):
            raise TypeError(f"{self.name!r}: index the first axis only (..., a slice, an int "
                            "or an integer array), then index the rows read")
        if not self.shape:
            raise ValueError(f"{self.name!r} is scalar: index it with [()] or [...]")
        n = self.shape[0]
        if isinstance(key, slice):
            return layout.read(np.arange(*key.indices(n)))
        if isinstance(key, (int, np.integer)):
            if not -n <= key < n:
                raise IndexError(f"index {key} out of range for {n} rows")
            return layout.read(np.array([key % n]))[0]
        rows = np.asarray(key).astype(np.int64)
        if rows.size and (rows.min() < -n or rows.max() >= n):
            raise IndexError(f"indices out of range for {n} rows")
        return layout.read(rows % n if rows.size else rows)

    # -- writing

    def append(self, rows: np.ndarray):
        """Add rows (of this dataset's row shape) at the end."""
        if not hasattr(self, "_chunks"):
            raise OSError(f"{self.name!r} is not appendable")
        rows = np.asarray(rows, self.dtype).reshape((-1,) + self._row_shape)
        done = 0
        while done < len(rows):
            take = min(len(rows) - done, self._chunk_rows - self._filled)
            self._buffer[self._filled : self._filled + take] = rows[done : done + take]
            self._filled += take
            done += take
            if self._filled == self._chunk_rows:
                self._flush()
        self.shape = (self.shape[0] + len(rows),) + self._row_shape

    def _flush(self):
        if self._filled:
            self._buffer[self._filled :] = 0
            self._chunks.append(self._writer.write_array(self._buffer))
            self._filled = 0


class File(Group):
    """An HDF5 file: its root group. mode "r" reads an existing file, "w"
    creates one (truncating); the file is written in full at close."""

    def __init__(self, path, mode: str = "r"):
        path = os.fspath(path)
        self.filename, self.mode = path, mode
        if mode == "r":
            r = _Reader(path)
            try:
                root = r.open(r.root, "/")
                if not isinstance(root, Group):
                    raise OSError(f"{path}: the root object is not a group")
            except BaseException:
                r.close()
                raise
            super().__init__("/", root.attrs, reader=r, links=root._links)
        elif mode == "w":
            super().__init__("/", {}, writer=_Writer(path))
        else:
            raise ValueError(f"mode {mode!r}: only 'r' and 'w' are supported")

    def close(self):
        if self._reader is not None:
            self._reader.close()
        elif self._writer is not None and not self._writer.closed:
            self._writer.finish(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- writing ---------------------------------------------------------------------


def _attribute_value(name: str, value):
    """A value as it is stored: a numpy array (0-d for a scalar) or str."""
    if isinstance(value, str):
        return value
    if isinstance(value, bool) or isinstance(value, np.bool_):
        raise TypeError(f"attribute {name!r}: booleans are not stored")
    if isinstance(value, bytes):
        return np.bytes_(value)
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        if arr.ndim:
            raise TypeError(f"attribute {name!r}: arrays of str are not stored")
        return str(arr)
    _type_message(arr.dtype)
    return arr[()] if arr.ndim == 0 else arr


def _type_message(dtype: np.dtype) -> bytes:
    """The datatype message of a numeric or fixed-length string dtype."""
    dtype = np.dtype(dtype)
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and np.little_endian is False) else 0
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in _IEEE:
        eloc, esize, msize, bias = _IEEE[size]
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20 | order, 8 * size - 1, 0, size,
                           0, 8 * size, eloc, esize, 0, msize, bias)
    if dtype.kind == "S" and size:
        return struct.pack("<B3BI", 0x13, 0x00, 0, 0, size)  # null-terminated ASCII
    raise TypeError(f"dtype {dtype} is not stored: integers, IEEE floats and bytes only")


# a variable-length UTF-8 string over bytes, as h5py stores a Python str
_VLEN_UTF8 = struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16) + struct.pack("<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8)


def _dataspace(shape, maxshape=None) -> bytes:
    flags = 1 if maxshape is not None else 0
    out = struct.pack("<BBBBI", 1, len(shape), flags, 0, 0) + struct.pack(f"<{len(shape)}Q", *shape)
    if maxshape is not None:
        out += struct.pack(f"<{len(shape)}Q", *(UNDEF if m is None else m for m in maxshape))
    return out


def _header(messages: List[Tuple[int, bytes, int]]) -> bytes:
    """A version 1 object header of (type, data, flags) messages."""
    body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), f) + d + b"\0" * (_pad8(len(d)) - len(d))
                    for t, d, f in messages)
    return struct.pack("<BBHIIxxxx", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    """Appends to the file as it goes; `finish` writes the metadata and
    then the superblock at offset 0."""

    SUPERBLOCK = 96

    def __init__(self, path: str):
        self.path = path
        self.fh = open(path, "wb")
        self.fh.write(b"\0" * self.SUPERBLOCK)
        self.pos = self.SUPERBLOCK
        self.appendables: List[Dataset] = []
        self.closed = False

    def write(self, data) -> int:
        """Write bytes at the end, 8-byte aligned; their address."""
        if self.pos % 8:
            self.fh.write(b"\0" * (8 - self.pos % 8))
            self.pos = _pad8(self.pos)
        at = self.pos
        view = memoryview(data).cast("B")
        self.fh.write(view)
        self.pos += view.nbytes
        return at

    def write_array(self, arr: np.ndarray) -> int:
        return self.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))

    def finish(self, root: Group):
        try:
            for ds in self.appendables:
                ds._flush()
            strings = self._global_heap(root)
            stab = self._group(root, strings)
            btree, heap, header = stab
            superblock = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                          + struct.pack("<HHI", _LEAF_K, _GROUP_K, 0)
                          + struct.pack("<QQQQ", 0, UNDEF, self.pos, UNDEF)
                          + struct.pack("<QQII", 0, header, 1, 0) + struct.pack("<QQ", btree, heap))
            assert len(superblock) == self.SUPERBLOCK
            self.fh.seek(0)
            self.fh.write(superblock)
        finally:
            self.fh.close()
            self.closed = True

    # -- attributes and their strings

    def _global_heap(self, root: Group) -> Dict[str, Tuple[int, int]]:
        """One global heap collection holding every str attribute value;
        {value: (collection address, index)}."""
        index: Dict[str, int] = {}  # each distinct value once, numbered from 1

        def walk(item):
            for v in item.attrs.values():
                if isinstance(v, str):
                    index.setdefault(v, len(index) + 1)
            if isinstance(item, Group):
                for child in item._table().values():
                    walk(child)

        walk(root)
        if not index:
            return {}
        body = b""
        for v, i in index.items():
            data = v.encode("utf-8")
            body += struct.pack("<HH4xQ", i, 0, len(data)) + data + b"\0" * (_pad8(len(data)) - len(data))
        used = 16 + len(body)
        size = 4096 if used <= 4096 - 16 else used
        free = struct.pack("<HH4xQ", 0, 0, size - used) + b"\0" * (size - used - 16) if size > used else b""
        at = self.write(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body + free)
        return {v: (at, i) for v, i in index.items()}

    def _attributes(self, attrs: AttributeManager, strings) -> List[Tuple[int, bytes, int]]:
        out = []
        for name, value in attrs.items():
            if isinstance(value, str):
                dtype, space = _VLEN_UTF8, _dataspace(())
                at, index = strings[value]
                data = struct.pack("<IQI", len(value.encode("utf-8")), at, index)
            else:
                arr = np.asarray(value)
                dtype, space = _type_message(arr.dtype), _dataspace(arr.shape)
                data = np.ascontiguousarray(arr).tobytes()
            key = name.encode("utf-8") + b"\0"
            msg = (struct.pack("<BBHHH", 1, 0, len(key), len(dtype), len(space))
                   + key.ljust(_pad8(len(key)), b"\0") + dtype.ljust(_pad8(len(dtype)), b"\0")
                   + space.ljust(_pad8(len(space)), b"\0") + data)
            out.append((_ATTRIBUTE, msg, 0))
        return out

    # -- B-trees

    def _btree(self, node_type: int, k: int, key_size: int, entries, last_key: bytes) -> int:
        """A v1 B-tree over (left key, child address) leaf entries, as many
        levels as 2K children a node need; the root's address."""
        node_size = 8 + 16 + (2 * k + 1) * key_size + 2 * k * 8
        level = 0
        while True:
            groups = [entries[i : i + 2 * k] for i in range(0, len(entries), 2 * k)] or [[]]
            start = _pad8(self.pos)
            parents = []
            for j, group in enumerate(groups):
                left = start + (j - 1) * node_size if j else UNDEF
                right = start + (j + 1) * node_size if j + 1 < len(groups) else UNDEF
                body = b"".join(key + struct.pack("<Q", child) for key, child in group)
                right_key = groups[j + 1][0][0] if j + 1 < len(groups) else last_key
                node = (b"TREE" + struct.pack("<BBHQQ", node_type, level, len(group), left, right)
                        + body + right_key)
                at = self.write(node.ljust(node_size, b"\0"))
                assert at == start + j * node_size
                parents.append((group[0][0] if group else last_key, at))
            if len(parents) == 1:
                return parents[0][1]
            entries, level = parents, level + 1

    # -- objects

    def _group(self, group: Group, strings) -> Tuple[int, int, int]:
        """Write a group's members, then its local heap, symbol-table
        nodes, B-tree and object header; (B-tree, heap, header) addresses."""
        members = group._table()
        names = sorted(members, key=lambda n: n.encode("utf-8"))
        entries = []
        for name in names:
            item = members[name]
            if isinstance(item, Group):
                btree, heap, header = self._group(item, strings)
                entries.append((header, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((self._dataset(item, strings), 0, b"\0" * 16))
        # the local heap: "" at offset 0, then each name, 8-byte padded
        data, offsets = b"\0" * 8, []
        for name in names:
            key = name.encode("utf-8") + b"\0"
            offsets.append(len(data))
            data += key.ljust(_pad8(len(key)), b"\0")
        heap_at = _pad8(self.pos)
        heap = self.write(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(data), 1, heap_at + 32) + data)
        assert heap == heap_at
        leaves = []
        for i in range(0, len(names), 2 * _LEAF_K):
            part = list(range(i, min(i + 2 * _LEAF_K, len(names))))
            body = b"".join(struct.pack("<QQII", offsets[j], entries[j][0], entries[j][1], 0)
                            + entries[j][2] for j in part)
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + body
            at = self.write(snod.ljust(8 + 2 * _LEAF_K * 40, b"\0"))
            leaves.append((part[-1], at))
        keys = [struct.pack("<Q", 0)] + [struct.pack("<Q", offsets[j]) for j, _ in leaves]
        btree = self._btree(0, _GROUP_K, 8, [(keys[i], at) for i, (_, at) in enumerate(leaves)],
                            keys[-1])
        msgs = [(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap), 0)]
        return btree, heap, self.write(_header(msgs + self._attributes(group.attrs, strings)))

    def _dataset(self, ds: Dataset, strings) -> int:
        dtype = _type_message(ds.dtype)
        if hasattr(ds, "_chunks"):
            rows = ds._chunk_rows
            rank = len(ds.shape)
            elem = ds.dtype.itemsize
            size = rows * int(np.prod(ds._row_shape, dtype=np.int64)) * elem

            def key(row):  # chunk bytes, filter mask, the chunk's first element
                return struct.pack(f"<II{rank + 1}Q", size, 0, row, *[0] * rank)

            btree = (self._btree(1, _CHUNK_K, 8 + 8 * (rank + 1),
                                 [(key(i * rows), at) for i, at in enumerate(ds._chunks)],
                                 key(len(ds._chunks) * rows))
                     if ds._chunks else UNDEF)
            space = _dataspace(ds.shape, (None,) + ds._row_shape)
            layout = struct.pack("<BBBQ", 3, 2, rank + 1, btree) + struct.pack(
                f"<{rank + 1}I", rows, *ds._row_shape, elem)
            fill = struct.pack("<BBBBI", 2, 3, 2, 1, 0)  # incremental allocation, default fill
        else:
            space = _dataspace(ds.shape)
            nbytes = int(np.prod(ds.shape, dtype=np.int64)) * ds.dtype.itemsize
            layout = struct.pack("<BBQQ", 3, 1, ds._address, nbytes)
            fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # late allocation, default fill
        msgs = [(_DATASPACE, space, 0), (_DATATYPE, dtype, 1), (_FILL, fill, 1), (_LAYOUT, layout, 0)]
        return self.write(_header(msgs + self._attributes(ds.attrs, strings)))
