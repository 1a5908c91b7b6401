"""The HDF5 that the port reads and writes, with numpy and the standard
library, so that the port needs no h5py: every file that the JAX package
reads through h5py reads here as h5py reads it (the same keys in the same
order, attributes, shapes, dtypes and values), and a checkpoint written by
either package loads in the other (docs/checkpoint_format.md).

The API is the part of h5py's that the port calls: `File(path, "r" | "w")`
as a context manager, `Group` (`[]`, `in`, `get`, `keys`, `items`,
`create_group`, `create_dataset`, `create_appendable`), `Dataset`
(`shape`, `dtype`, `[...]`, a slice or an integer array on the first axis,
sorted or not, repeats allowed), `Datatype` (a committed type's `dtype`)
and `.attrs` on each.

Read:
- superblock versions 0 to 3 (libver "earliest" to "latest"); version 1
  and version 2 object headers with their continuation blocks; every
  metadata checksum (Jenkins' lookup3, as HDF5 computes it) is verified,
  and a mismatch raises OSError;
- shared object header messages (a superblock extension's shared-message
  table, as `h5repack --ssize` sets one): each index's fractal heap holds
  the dataspaces, datatypes, fill values, filter pipelines and attributes
  of its types, read where a header (or dense attribute storage) names
  them by heap ID; each ID must be in its index's records (a list or a
  v2 B-tree), else OSError;
- groups: symbol tables (a v1 B-tree over SNOD nodes and a local heap),
  and link messages, held in the group's header or, past 8 links, in a
  fractal heap (its blocks and huge objects through the heap's I/O
  filters where it has them) indexed by a version 2 B-tree; hard, soft
  and external links (an external file is looked for at its own path,
  then in the directory of the file that links to it, then in the
  working directory). Keys come in h5py's order: by name, or by creation
  order in a group made with track_order;
- attributes in the object header or in dense storage (a fractal heap
  and a v2 B-tree), by name or, where the object tracks it, by creation
  order;
- layouts: compact, contiguous (read through a memory map of the file, so
  a row read touches only its rows) and chunked, from data layout
  messages 1 to 4, with every chunk index: the v1 B-tree, and version 4's
  single chunk, implicit, fixed array, extensible array (both paged) and
  v2 B-tree. Only the chunks that hold the asked rows are read;
  unwritten chunks read as the fill value;
- raw data in external files (the external file list message): each
  slot's file read through a memory map, its name resolved as HDF5 does
  (against HDF5_EXTFILE_PREFIX, "${ORIGIN}" the file's directory, else
  the working directory); a missing file raises OSError, bytes past a
  file's end read as zeros;
- virtual datasets (layout class 3): each mapping's source read through
  its own layout (chunk reads or a memory map), its file found as an
  external link's ("." the same file), whole rows mapped onto whole rows
  where both selections take whole rows; unlimited mappings and printf
  ("%b") source names, sized as HDF5 sizes them at open (the last
  available source); a missing source file or dataset, and an element no
  mapping reaches, read as the fill value. Source files stay open until
  the virtual dataset's file closes;
- filters: deflate, shuffle, fletcher32 (verified: a mismatch raises
  OSError), lzf (decoded by `native/lzf.cc`, built with g++ at first
  use), szip (CCSDS 121.0 Rice coding as libaec decodes it, by
  `native/szip.cc`, built the same way), scaleoffset (integer, and float
  D-scale, to the bit as HDF5 decodes it) and nbit;
- datatypes: integers (with h5py's mapping of a reduced precision or a
  bit offset), floats of any layout (bfloat16, a 7-bit exponent, another
  bias, a stored leading bit, x87 long double) in the numpy float h5py
  picks, converted to the bit as HDF5 converts them for h5py (vectorised:
  `_convert_float`), fixed and variable-length strings, bitfields,
  opaque, enums (a FALSE/TRUE enum is np.bool_), compounds (nested, with
  h5py's names, offsets and itemsize), arrays, variable-length sequences
  (an object array of arrays), committed datatypes shared by a dataset or
  an attribute, and object and region references (`Reference` and
  `RegionReference`; `group[ref]` opens the object under the name HDF5
  gives it, `dataset[regref]` reads the selection in h5py's shape), so
  that datasets with dimension scales open.
Still refused with NotImplementedError naming them, each a kind of file
that h5py does not read or that HDF5 does not implement: plugin filters
(ids from 256, lzf's 32000 apart: h5py's stock build reads none), HDF5
1.12's revised references (h5py neither writes nor reads them), the
scaleoffset filter's float E-scale (HDF5 does not implement it), VAX-order
floats (h5py gives them no dtype), floats whose mantissa's leading bit is
always set (HDF5 does not convert them) and floats no numpy float holds,
integers of a size numpy has not, and structures of versions HDF5 never
wrote.

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

import bisect
import mmap
import os
import re
import struct
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL_FILES, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xA, 0xB, 0xC
_SHARED_TABLE, _CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0xF, 0x10, 0x11, 0x15
# a shared-message index's bit for each message type it can hold (the old
# fill value message's is the new one's)
_SHAREABLE = {t: 1 << t for t in (_DATASPACE, _DATATYPE, _FILL, _FILTERS, _ATTRIBUTE)}
_SHAREABLE[_FILL_OLD] = _SHAREABLE[_FILL]

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                5: "opaque", 6: "compound", 7: "reference", 8: "enumerated",
                9: "variable-length", 10: "array"}
_REFERENCE_NAMES = {0: "object reference", 1: "region reference", 2: "object reference",
                    3: "region reference", 4: "attribute reference"}
# HDF5's default limit on the soft and external links one lookup follows
_MAX_LINK_HOPS = 16

# what the writer uses: the library's defaults for a version 0 superblock
_LEAF_K = 4  # a symbol-table node holds up to 2K links
_GROUP_K = 16  # a group B-tree node holds up to 2K children
_CHUNK_K = 32  # a chunk B-tree node holds up to 2K children


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _enc_size(n: int) -> int:
    """The bytes HDF5 gives a field that holds numbers up to n
    (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _le(b, at: int, n: int) -> int:
    return int.from_bytes(b[at : at + n], "little")


# -- checksums and bit streams ----------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data) -> int:
    """Bob Jenkins' lookup3 `hashlittle` with an initial value of 0, as HDF5
    checksums its metadata (H5_checksum_lookup3)."""
    data = bytes(data)
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if n == 0:
        return c
    full = (n - 1) // 12  # the last 1 to 12 bytes take the final mix
    words = struct.unpack_from(f"<{3 * full}I", data)
    for i in range(0, 3 * full, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    x, y, z = struct.unpack("<3I", data[12 * full :].ljust(12, b"\0"))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c = ((c ^ b) - _rot(b, 14)) & _M32
    a = ((a ^ c) - _rot(c, 11)) & _M32
    b = ((b ^ a) - _rot(a, 25)) & _M32
    c = ((c ^ b) - _rot(b, 16)) & _M32
    a = ((a ^ c) - _rot(c, 4)) & _M32
    b = ((b ^ a) - _rot(a, 14)) & _M32
    c = ((c ^ b) - _rot(b, 24)) & _M32
    return c


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): the sums of big-endian
    16-bit words, folded to 16 bits after every 360 words as the library
    folds them, so that the result is the library's to the bit."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", count=n).astype(np.int64)
    full = n // 360
    blocks = words[: full * 360].reshape(full, 360)
    lens = [360] * full
    sums = blocks.sum(1).tolist()
    weighted = (blocks @ np.arange(360, 0, -1, dtype=np.int64)).tolist()
    tail = words[full * 360 :]
    if len(tail):
        lens.append(len(tail))
        sums.append(int(tail.sum()))
        weighted.append(int(tail @ np.arange(len(tail), 0, -1, dtype=np.int64)))
    s1 = s2 = 0
    for t, total, ramp in zip(lens, sums, weighted):
        s2 += t * s1 + ramp  # sum2 adds sum1 after each word
        s1 += total
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _uint(cols: np.ndarray) -> np.ndarray:
    """Little-endian unsigned integers from an (n, k) uint8 array, k <= 8."""
    pad = np.zeros((cols.shape[0], 8), np.uint8)
    pad[:, : cols.shape[1]] = cols
    return pad.view("<u8").reshape(-1)


def _msb_values(bits: np.ndarray) -> np.ndarray:
    """Unsigned integers from an (n, w) array of bits, most significant
    first, w <= 64."""
    pad = np.zeros((bits.shape[0], 64), np.uint8)
    pad[:, 64 - bits.shape[1] :] = bits
    return np.packbits(pad, axis=1).view(">u8").reshape(-1).astype(np.uint64)


def _bit_rows(buf: bytes, n: int, width: int) -> np.ndarray:
    """The first n * width bits of buf, most significant bit of each byte
    first, as n rows of `width` bits."""
    if len(buf) * 8 < n * width:
        raise OSError("a filtered chunk holds fewer bits than its elements need")
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), count=n * width)
    return bits.reshape(n, width)


# -- filters ---------------------------------------------------------------------


def _unshuffle(raw: bytes, width: int) -> bytes:
    """Byte planes back to elements."""
    n = len(raw) // width
    planes = np.frombuffer(raw, np.uint8, count=n * width).reshape(width, n)
    return planes.T.tobytes() + raw[n * width :]


def _unfletcher32(raw: bytes, where: str) -> bytes:
    """The chunk without its checksum, which must match HDF5's or HDF5's
    byte-swapped one (what HDF5 before 1.6.3 wrote; the library takes
    both)."""
    body, stored = raw[:-4], _le(raw, len(raw) - 4, 4)
    got = fletcher32(body)
    swapped = ((got & 0x00FF00FF) << 8) | ((got >> 8) & 0x00FF00FF)
    if stored not in (got, swapped):
        raise OSError(f"{where}: data error detected by the fletcher32 checksum")
    return body


def _unlzf(raw: bytes, size: int) -> bytes:
    from convnet_tpu_torch.data import native  # its g++ build of native/lzf.cc

    return native.lzf_decompress(raw, size)


def _unszip(raw: bytes, cd, where: str) -> bytes:
    """H5Z_FILTER_SZIP's decode: the element bytes' count (4 bytes,
    little-endian), then libaec's SZ_BufftoBuffDecompress of the rest with
    the filter's options mask, pixels per block, bits per pixel and pixels
    per scanline."""
    from convnet_tpu_torch.data import native  # its g++ build of native/szip.cc

    if len(raw) < 4 or len(cd) < 4:
        raise OSError(f"{where}: an szip chunk without its size or parameters")
    return native.szip_decompress(raw[4:], _le(raw, 0, 4), *cd[:4])


def _scaleoffset(raw: bytes, cd, where: str) -> bytes:
    """H5Z_FILTER_SCALEOFFSET's decode: each element's `minbits` bits (a
    most-significant-first stream after a 21-byte header holding minbits
    and the minimum), plus the minimum; float D-scale divides by 10^scale
    first; the all-ones value is the fill value where one is defined."""
    scale_type, scale, n, cls, size, signed, order, fill_defined = cd[:8]
    minbits = _le(raw, 0, 4)
    minval = _le(raw, 5, min(8, raw[4]))
    udt = np.dtype(f"<u{size}")
    if minbits == size * 8:  # full precision: stored as is
        out = np.frombuffer(raw, udt, count=n, offset=21)
    else:
        v = _msb_values(_bit_rows(raw[21:], n, minbits)) if minbits else np.zeros(n, np.uint64)
        full = np.uint64((1 << minbits) - 1)
        fill = np.frombuffer(struct.pack(f"<{len(cd) - 8}I", *cd[8:]), udt, count=1)[0] \
            if fill_defined else None
        if cls == 0:  # integer
            out = ((v + np.uint64(minval & ((1 << 8 * size) - 1))) & np.uint64((1 << 8 * size) - 1))
            out = out.astype(udt)
        elif scale_type != 0:
            raise NotImplementedError(f"{where}: the scaleoffset filter's float E-scale")
        else:  # float D-scale, in the element's own precision, as the C code computes it
            ft, it = (np.float32, np.int32) if size == 4 else (np.float64, np.int64)
            low = np.frombuffer(struct.pack("<Q", minval)[:size], ft)[0]
            scaled = v.astype(np.uint64).view(np.int64).astype(it).astype(ft)
            out = (scaled / ft(10.0 ** scale) + low).astype(ft).view(udt)
        if fill is not None:
            out = np.where(v == full, fill, out).astype(udt)
    if order:  # the dataset's type is big-endian: back to its byte order
        out = out.astype(udt.newbyteorder(">"))
    return np.ascontiguousarray(out).tobytes()


def _nbit_fields(cd, at: int, base: int, out: list) -> int:
    """The fields of one nbit element from its parameters at cd[at:]: an
    atomic (element offset, size, order, precision, bit offset) or a no-op
    (element offset, size); returns the index past them."""
    cls = cd[at]
    if cls == 1:  # atomic
        size, order, precision, offset = cd[at + 1 : at + 5]
        out.append((base, size, order, precision, offset))
        return at + 5
    if cls == 2:  # array: the base type's fields, once an element
        total, step = cd[at + 1], cd[at + 3]  # the array's size, then its base type's
        inner: list = []
        end = _nbit_fields(cd, at + 2, 0, inner)
        for i in range(total // step):
            out.extend((f[0] + base + i * step,) + f[1:] for f in inner)
        return end
    if cls == 3:  # compound: each member at its offset
        nmembers = cd[at + 2]
        at += 3
        for _ in range(nmembers):
            offset = cd[at]
            at = _nbit_fields(cd, at + 1, base + offset, out)
        return at
    if cls == 4:  # no-op: the bytes as they are
        out.append((base, cd[at + 1]))
        return at + 2
    raise OSError(f"nbit parameters of class {cls}")


def _nbit(raw: bytes, cd) -> bytes:
    """H5Z_FILTER_NBIT's decode: each atomic field's `precision` bits (most
    significant first, one stream over all elements) put back at its bit
    offset, no-op fields' bytes copied, every other bit zero."""
    if cd[1] or len(cd) < 5:  # nothing to compress: the chunk is stored as it is
        return raw
    n, size = cd[2], cd[4]
    fields: list = []
    _nbit_fields(cd, 3, 0, fields)  # each type: its class, its size, then what the class needs
    width = sum(f[3] if len(f) == 5 else 8 * f[1] for f in fields)
    bits = _bit_rows(raw, n, width)
    out = np.zeros((n, size), np.uint8)
    col = 0
    for f in fields:
        if len(f) == 2:  # no-op
            at, nbytes = f
            out[:, at : at + nbytes] = np.packbits(bits[:, col : col + 8 * nbytes], axis=1)
            col += 8 * nbytes
            continue
        at, nbytes, order, precision, offset = f
        value = _msb_values(bits[:, col : col + precision]) << np.uint64(offset)
        col += precision
        as_bytes = value.astype(np.dtype(f"{'>' if order else '<'}u8")).view(np.uint8).reshape(n, 8)
        out[:, at : at + nbytes] = as_bytes[:, 8 - nbytes :] if order else as_bytes[:, :nbytes]
    return out.tobytes()


def _pipeline(b: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
    """(filter id, parameters) of each filter of a filter pipeline message,
    in the order they were applied."""
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
        out.append((fid, vals))
    return out


def _active(filters, mask: int):
    """The filters of a pipeline that a block went through: those whose bit
    in its filter mask is clear."""
    return [(fid, vals) for i, (fid, vals) in enumerate(filters) if not mask >> i & 1]


def _defilter(raw: bytes, active, itemsize: int, size: int, where: str) -> bytes:
    """A chunk's or a heap block's bytes through the filters it went
    through, last first: `itemsize` the element size shuffle undoes where
    its parameters do not say, `size` the bytes lzf gives where its
    parameters do not say."""
    for fid, vals in reversed(active):
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            width = vals[0] if vals else itemsize
            if width > 1:  # one-byte elements shuffle to themselves
                raw = _unshuffle(raw, width)
        elif fid == 3:
            raw = _unfletcher32(raw, where)
        elif fid == 4:
            raw = _unszip(raw, vals, where)
        elif fid == 5:
            raw = _nbit(raw, vals)
        elif fid == 6:
            raw = _scaleoffset(raw, vals, where)
        elif fid == 32000:
            raw = _unlzf(raw, vals[2] if len(vals) > 2 and vals[2] else size)
        elif fid >= 256:
            raise NotImplementedError(
                f"{where}: plugin filter id {fid} ({_FILTER_NAMES.get(fid, 'unregistered')})")
        else:
            raise NotImplementedError(f"{where}: the {_FILTER_NAMES.get(fid, f'id {fid}')} filter")
    return raw


# -- datatypes -------------------------------------------------------------------


class _Type:
    """A parsed datatype. `dtype` is the numpy dtype h5py gives, `stored`
    the numpy dtype of the bytes as the file holds them (the same where
    h5py's elements are those bytes), and `convert(stored array, reader,
    decode)` gives the elements as h5py gives them where the two differ
    (None where they do not): `decode` gives variable-length strings as
    str (attributes) rather than bytes (datasets), as h5py does."""

    def __init__(self, dtype, stored=None, convert: Optional[Callable] = None):
        self.dtype = np.dtype(dtype)
        self.stored = self.dtype if stored is None else np.dtype(stored)
        self.convert = convert

    def to_h5py(self, arr: np.ndarray, r: "_Reader", decode: bool) -> np.ndarray:
        return arr if self.convert is None else self.convert(arr, r, decode)


def _fixed_point(signed: bool, offset: int, precision: int, dtype: np.dtype) -> Callable:
    """An integer of `precision` bits at bit `offset`, sign-extended, as
    HDF5 converts it to h5py's full-width integer of the same size."""

    def convert(arr, r, decode):
        v = (arr.astype(np.uint64) >> np.uint64(offset)) & np.uint64((1 << precision) - 1)
        if signed and precision:
            sign = np.uint64(1 << (precision - 1))
            v = ((v ^ sign) - sign).view(np.int64)
        return v.astype(dtype)

    return convert


class _FloatLayout(NamedTuple):
    """Where a float's fields lie: the sign's bit, the exponent's first bit
    and size, the mantissa's first bit and size (all from the element's
    least significant bit), the exponent bias, and whether the mantissa's
    leading 1 is implied (else stored: HDF5's normalization "none")."""

    sign: int
    epos: int
    esize: int
    mpos: int
    msize: int
    bias: int
    implied: bool


# h5py's float dtypes, smallest first: (itemsize, precision, numpy type,
# HDF5's layout of it, mantissa bits, numpy's maxexp and minexp); long
# double where it is the x87 80-bit float, whose mantissa's leading 1 is
# stored (h5py counting it among the mantissa's bits)
_FLOAT_TARGETS = [(2, 16, np.float16, _FloatLayout(15, 10, 5, 0, 10, 15, True), 10, 16, -14),
                  (4, 32, np.float32, _FloatLayout(31, 23, 8, 0, 23, 127, True), 23, 128, -126),
                  (8, 64, np.float64, _FloatLayout(63, 52, 11, 0, 52, 1023, True), 52, 1024, -1022)]
if np.finfo(np.longdouble).nmant == 63 and np.finfo(np.longdouble).nexp == 15:
    _FLOAT_TARGETS.append((np.dtype(np.longdouble).itemsize, 80, np.longdouble,
                           _FloatLayout(79, 64, 15, 0, 64, 16383, False), 64, 16384, -16382))

_U64 = np.uint64
_ONES = _U64(0xFFFFFFFFFFFFFFFF)


def _mask(n) -> np.ndarray:
    """(1 << n) - 1 for each n in 0..64, as uint64."""
    n = np.asarray(n, np.int64)
    return np.where(n >= 64, _ONES, (_U64(1) << np.minimum(n, 63).astype(_U64)) - _U64(1))


def _shift(x: np.ndarray, n) -> np.ndarray:
    """x << n for n >= 0, x >> -n for n < 0, per element; bits shifted past
    64 are gone."""
    n = np.asarray(n, np.int64)
    left = np.where(n >= 64, _U64(0), x << np.clip(n, 0, 63).astype(_U64))
    right = np.where(n <= -64, _U64(0), x >> np.clip(-n, 0, 63).astype(_U64))
    return np.where(n >= 0, left, right)


def _bit_length(x: np.ndarray) -> np.ndarray:
    n = np.zeros(x.shape, np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> _U64(s)) != 0
        x = np.where(big, x >> _U64(s), x)
        n += big * s
    return n + (x != 0)


def _get_bits(words: np.ndarray, pos: int, n: int) -> np.ndarray:
    """Bits pos .. pos + n - 1 (n <= 64) of elements held as (count, 2)
    little-endian uint64 words."""
    lo, hi = words[:, 0], words[:, 1]
    if pos >= 64:
        v = hi >> _U64(pos - 64)
    elif pos == 0:
        v = lo
    else:
        v = (lo >> _U64(pos)) | (hi << _U64(64 - pos))
    return v & _mask(n)


def _put_bits(words: np.ndarray, value: np.ndarray, pos: int, n: int):
    value = value & _mask(n)
    if pos < 64:
        words[:, 0] |= value << _U64(pos)
        if pos + n > 64:
            words[:, 1] |= value >> _U64(64 - pos)
    else:
        words[:, 1] |= value << _U64(pos - 64)


def _convert_float(raw: np.ndarray, src: _FloatLayout, dst: _FloatLayout, dst_size: int) -> np.ndarray:
    """Elements of layout `src` ((count, size) uint8, least significant
    byte first) in layout `dst`, as HDF5's soft float conversion
    (H5T__conv_f_f) gives them in one call, to the bit: zeros and
    infinities keep their sign, a NaN becomes the NaN of all mantissa
    bits set, a denormal source is normalized, a value below the target's
    least denormal is zero and one above its largest is infinity; a
    mantissa cut short rounds half up, except where that would carry the
    largest finite exponent to infinity. HDF5's flag that a value is
    denormal (in the source or in the target) is never cleared within a
    call: from the first such value on, in the order the call takes them
    (the last first where the target is wider), a rounding that carries
    out of the mantissa loses the carry. h5py's pick of the target
    (_float_type) cuts no mantissa short but the 64-bit one of a wide
    float with its leading 1 implied. Returns (count, dst_size) uint8,
    least significant byte first."""
    count = len(raw)
    padded = np.zeros((count, 16), np.uint8)
    padded[:, : raw.shape[1]] = raw
    words = padded.view("<u8")
    sign = _get_bits(words, src.sign, 1)
    e = _get_bits(words, src.epos, src.esize).astype(np.int64)
    m = _get_bits(words, src.mpos, src.msize)
    e_top = (1 << src.esize) - 1
    zero = (m == 0) & (e == 0)
    inf = (m == 0) & (e == e_top)
    if not src.implied:  # only the leading bit set, the exponent all ones
        inf |= ((m & _mask(src.msize - 1)) == 0) & (e == e_top)
    nan = ~zero & ~inf & (e == e_top)

    # the leading 1 found in the mantissa (a denormal, or a stored leading
    # bit) or implied; `frac` the `ms` mantissa bits below it
    explicit = (e == 0) | (not src.implied)
    lead = _bit_length(m) - 1
    ms = np.where(explicit, np.maximum(lead, 1), src.msize)
    frac = np.where(explicit, m & _mask(np.maximum(lead, 0)), m)
    expo = np.where(explicit, e - (src.bias - 1) - (src.msize - lead), e - src.bias) + dst.bias
    d, e_max = dst.msize, (1 << dst.esize) - 1
    mrsh = np.full(count, 0 if dst.implied else 1, np.int64)  # a stored leading bit takes a place
    tiny = expo < -d
    den = ~tiny & (expo <= 0)
    over = ~tiny & ~den & (expo >= e_max)
    mrsh = np.where(den, mrsh + 1 - expo, mrsh)
    expo = np.where(tiny | den, 0, np.where(over, e_max, expo))
    ms = np.where(tiny | over, 0, ms)
    frac = np.where(tiny | over, _U64(0), frac)
    denormal = ~zero & ~inf & ~nan & ((e == 0) | den)
    if dst_size > raw.shape[1]:  # HDF5 widens in place from the last element back
        denormal = np.logical_or.accumulate(denormal[::-1])[::-1]
    else:
        denormal = np.logical_or.accumulate(denormal)

    # rounding: `cut` low bits go; the first of them set rounds up
    cut_short = (ms > 0) & (mrsh <= d) & (mrsh + ms > d)
    cut = np.where(cut_short, mrsh + ms - d, 1)
    kept_bits = np.where(cut_short, ms - cut, 0)
    field = _shift(frac, -(cut - 1))  # the first bit cut, then the bits kept
    kept = field >> _U64(1)
    up = cut_short & ((field & _U64(1)) == 1) & (
        denormal | (kept != _mask(kept_bits)) | (expo < e_max - 1))
    wraps = up & (field == _mask(kept_bits + 1))
    carry = wraps & ~denormal
    kept = np.where(wraps, _U64(0), np.where(up, (field + _U64(1)) >> _U64(1), kept)) & _mask(kept_bits)
    frac = np.where(cut_short, kept, frac)
    ms = np.where(cut_short, kept_bits, ms)
    implied = np.where(carry, _U64(2), _U64(1))

    # the mantissa: the leading 1 (or, after a carry, 10) shifted in where
    # the value is denormal in the target, then the fraction's bits
    top = np.where(mrsh > 0, _shift(implied, d - mrsh), _U64(0))
    low = _shift(frac, np.where(mrsh + ms >= d, -(mrsh + ms - d), d - mrsh - ms))
    mant = (top | low) & _mask(d)
    mant = np.where(mrsh == d, implied & _mask(min(2, d)), mant)
    mant = np.where(mrsh == d + 1, _U64(1), mant)
    mant = np.where(mrsh > d + 1, _U64(0), mant)
    expo = np.where(carry, expo + 1, expo)
    over = carry & (expo >= e_max)
    expo = np.where(over, e_max, expo)
    mant = np.where(over, _U64(0), mant)

    mant = np.where(zero, _U64(0), mant)
    expo = np.where(zero, 0, expo)
    mant = np.where(inf, _U64(0 if dst.implied else 1 << (d - 1)), mant)
    mant = np.where(nan, _mask(d), mant)
    expo = np.where(inf | nan, e_max, expo)
    out = np.zeros((count, 2), "<u8")
    _put_bits(out, mant, dst.mpos, d)
    _put_bits(out, expo.astype(_U64), dst.epos, dst.esize)
    _put_bits(out, sign, dst.sign, 1)
    return out.view(np.uint8)[:, :dst_size]


def _float_type(where: str, version: int, size: int, bits: int, offset: int, precision: int,
                epos: int, esize: int, mpos: int, msize: int, bias: int) -> _Type:
    """A floating-point datatype, in the numpy float h5py picks for it (the
    smallest no smaller than the element that holds its mantissa and its
    exponent's range): as it is where the layouts are the same, else
    converted as HDF5 converts it for h5py (_convert_float). The VAX
    order bit counts from datatype message version 3, as HDF5 reads it:
    before, the order is the first bit's alone."""
    order = ">" if bits & 0x01 else "<"
    norm, sign, pads = (bits >> 4) & 0x03, (bits >> 8) & 0xFF, (bits >> 1) & 0x07
    if version >= 3 and bits & 0x40:
        if not bits & 0x01:
            raise OSError(f"{where}: a float datatype of a bad byte order")
        raise NotImplementedError(f"{where}: VAX-order float (h5py gives VAX order no dtype, so it "
                                  "reads none)")
    if norm == 3:
        raise OSError(f"{where}: a float datatype of the reserved normalization 3")
    if norm == 1:
        raise NotImplementedError(f"{where}: a float whose mantissa's leading bit is always set "
                                  "(HDF5 converts no such float)")
    for tsize, tprec, ftype, layout, nmant, maxexp, minexp in _FLOAT_TARGETS:  # h5py's pick
        if (tsize >= size and msize <= nmant and 2**esize - bias - 1 <= maxexp
                and 1 - bias >= minexp):
            break
    else:
        raise NotImplementedError(f"{where}: a {size}-byte float of a {esize}-bit exponent and a "
                                  f"{msize}-bit mantissa, which no numpy float holds (h5py reads "
                                  "none)")
    src = _FloatLayout(sign, epos, esize, mpos, msize, bias, norm == 2)
    dtype = np.dtype(ftype).newbyteorder(order)
    if (src, size, precision, offset, pads) == (layout, tsize, tprec, 0, 0):
        return _Type(dtype)  # HDF5 converts nothing: the bytes as stored

    def convert(arr, r, decode):
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8).reshape(-1, size)
        out = _convert_float(raw[:, ::-1] if order == ">" else raw, src, layout, tsize)
        out = np.ascontiguousarray(out[:, ::-1] if order == ">" else out)
        return out.view(dtype).reshape(arr.shape)

    return _Type(dtype, np.dtype(f"V{size}"), convert)


def _array_type(base: _Type, dims) -> _Type:
    # numpy expands a subarray dtype into trailing axes, so the base
    # type's conversion applies to the expanded array as it is
    return _Type(np.dtype((base.dtype, tuple(dims))), np.dtype((base.stored, tuple(dims))),
                 base.convert)


def _compound_type(names, offsets, types, size) -> _Type:
    layout = {"names": names, "offsets": offsets, "itemsize": size}
    dtype = np.dtype(dict(layout, formats=[t.dtype for t in types]))
    stored = np.dtype(dict(layout, formats=[t.stored for t in types]))
    if names == ["r", "i"] and types[0].dtype == types[1].dtype and types[0].dtype.kind == "f":
        part = types[0].dtype  # h5py's complex number, of twice the part's size
        cdtype = np.dtype(f"{part.str[0]}c{2 * part.itemsize}")

        def complex_convert(arr, r, decode):
            out = np.empty(arr.shape, cdtype)
            out.real, out.imag = arr["r"], arr["i"]
            return out

        return _Type(cdtype, stored, complex_convert)

    def convert(arr, r, decode):  # member by member: padding bytes read as zeros, as in h5py
        out = np.zeros(arr.shape, dtype)
        for name, t in zip(names, types):
            out[name] = t.to_h5py(arr[name], r, decode)
        return out

    return _Type(dtype, stored, convert)


def _vlen_type(base: Optional[_Type], utf8: bool, width: int) -> _Type:
    """A variable-length string (base None) or sequence: each element a
    heap ID (length, global heap collection, index) of `width` bytes."""
    if base is None:
        dtype = np.dtype("O", metadata={"vlen": str if utf8 else bytes})
    else:
        dtype = np.dtype("O", metadata={"vlen": base.dtype})

    def convert(arr, r, decode):
        flat = np.ascontiguousarray(arr).reshape(-1)
        raw = flat.tobytes()
        out = np.empty(len(flat), dtype)
        for i in range(len(flat)):
            at = i * width
            length = _le(raw, at, 4)
            data = r.gheap_object(_le(raw, at + 4, r.O), _le(raw, at + 4 + r.O, 4)) if length else b""
            if base is None:
                data = data[:length]
                out[i] = data.decode("utf-8" if utf8 else "ascii") if decode else data
            else:
                items = base.to_h5py(np.frombuffer(data, base.stored, count=length).copy(), r, decode)
                if items.dtype == object and items.dtype.metadata:
                    items = items.view(np.dtype("O"))  # h5py's sequences of references carry none
                out[i] = items
        return out.reshape(arr.shape)

    return _Type(dtype, np.dtype((np.void, width)), convert)


def _names(b: bytes, at: int, count: int, version: int) -> Tuple[List[bytes], int]:
    """`count` null-terminated names from b[at:], each padded to 8 bytes
    before datatype message version 3."""
    out = []
    for _ in range(count):
        end = b.index(b"\0", at)
        out.append(b[at:end])
        at = end + 1 if version >= 3 else at + (end - at + 8) // 8 * 8
    return out, at


# -- references and selections -----------------------------------------------------


class Reference:
    """An object reference, as h5py's: the address of the object header it
    points to, 0 for a null reference, which is falsy. A group of the file
    it was read from opens the object: `f[ref]`."""

    __slots__ = ("address",)

    def __init__(self, address: int = 0):
        self.address = address

    def __bool__(self) -> bool:
        return self.address != 0

    def __repr__(self) -> str:
        return f"<HDF5 object reference{'' if self else ' (null)'}>"


class RegionReference(Reference):
    """A dataset region reference, as h5py's: the dataset's address and a
    selection of its elements. `f[ref]` is the dataset, `f[ref][ref]` the
    elements selected, as h5py gives them."""

    __slots__ = ("selection",)

    def __init__(self, address: int = 0, selection: Optional["_Selection"] = None):
        super().__init__(address)
        self.selection = selection

    def __repr__(self) -> str:
        return f"<HDF5 region reference{'' if self else ' (null)'}>"


class _Selection(NamedTuple):
    """A dataspace selection as HDF5 serializes it: "all", "none",
    "points" (`array` (n, rank), in their order), "blocks" (an irregular
    hyperslab: `array` (n, 2, rank), each block's first and last
    coordinates) or "regular" (a regular hyperslab: `dims` per axis
    (start, stride, count, block), None for an unlimited count or
    block)."""

    kind: str
    array: Optional[np.ndarray] = None
    dims: Optional[Tuple[Tuple[int, int, Optional[int], Optional[int]], ...]] = None

    def unlimited_axis(self) -> Optional[int]:
        if self.kind == "regular":
            for d, (_, _, count, block) in enumerate(self.dims):
                if count is None or block is None:
                    return d
        return None

    def axis(self, d: int, limit: int) -> np.ndarray:
        """A regular hyperslab's coordinates along axis d, below `limit`."""
        start, stride, count, block = self.dims[d]
        if count is None:
            count = max(0, -(-(limit - start) // stride))
        if block is None:
            block = max(0, limit - start)
        c = (start + stride * np.arange(count, dtype=np.int64)[:, None]
             + np.arange(block, dtype=np.int64)).reshape(-1)
        return c[c < limit]

    def coords(self, limits) -> np.ndarray:
        """The coordinates selected below `limits` (n, rank), in HDF5's
        order: row-major, points as listed."""
        rank = len(limits)
        if self.kind == "none":
            return np.zeros((0, rank), np.int64)
        if self.kind == "points":
            return self.array
        if self.kind == "blocks":
            flat = np.unique(np.concatenate(
                [np.ravel_multi_index(tuple(np.indices(e - s + 1).reshape(rank, -1) + s[:, None]), limits)
                 for s, e in self.array]))
            return np.stack(np.unravel_index(flat, limits), 1)
        axes = ([np.arange(n) for n in limits] if self.kind == "all"
                else [self.axis(d, n) for d, n in enumerate(limits)])
        grids = np.meshgrid(*axes, indexing="ij")
        return np.stack([g.reshape(-1) for g in grids], 1).reshape(-1, rank)

    def rows(self, limits) -> Optional[np.ndarray]:
        """The rows, in order, of a selection that takes whole rows of a
        dataset of shape `limits`; None for one that does not."""
        if not limits:
            return None
        if self.kind == "all":
            return np.arange(limits[0])
        if self.kind == "regular" and all(np.array_equal(self.axis(d, n), np.arange(n))
                                          for d, n in enumerate(limits[1:], 1)):
            return self.axis(0, limits[0])
        if self.kind == "blocks":
            first, last = self.array[:, 0], self.array[:, 1]
            if (first[:, 1:] == 0).all() and (last[:, 1:] == np.array(limits[1:]) - 1).all():
                return np.unique(np.concatenate([np.arange(a, b + 1) for a, b in
                                                 zip(first[:, 0].tolist(), last[:, 0].tolist())]))
        return None

    def bounds(self, shape) -> Tuple[int, ...]:
        """One past the largest coordinate selected along each axis."""
        if self.kind == "all":
            return tuple(shape)
        if self.kind == "regular":
            return tuple(0 if not count or not block else start + (count - 1) * stride + block
                         for start, stride, count, block in self.dims)
        c = self.array.reshape(-1, len(shape))
        return tuple(c.max(0) + 1) if len(c) else (0,) * len(shape)


def _selection(b: bytes, at: int) -> Tuple[_Selection, int]:
    """The selection serialized at b[at:] (H5S_SELECT_SERIALIZE, versions
    1 to 3) and the index past it."""
    kind, version = _le(b, at, 4), _le(b, at + 4, 4)
    p = at + 8
    if kind in (0, 3) and version == 1:  # none, all: a reserved word and a length of 0
        return _Selection("none" if kind == 0 else "all"), p + 8
    if (kind, version) not in ((1, 1), (1, 2), (2, 1), (2, 2), (2, 3)):
        raise NotImplementedError(f"a serialized selection of type {kind}, version {version}")
    regular = False
    if version == 1:  # reserved, length, rank, count, then 4-byte coordinates
        rank, n, enc, p = _le(b, p + 8, 4), _le(b, p + 12, 4), 4, p + 16
    elif kind == 1:  # points: the numbers' width, rank, count
        enc, rank = b[p], _le(b, p + 1, 4)
        n, p = _le(b, p + 5, enc), p + 5 + enc
    elif version == 2:  # a regular hyperslab: flags, length, rank, 8-byte numbers
        regular, enc, rank, p = bool(b[p] & 0x01), 8, _le(b, p + 5, 4), p + 9
    else:  # flags, the numbers' width, rank, and for an irregular one its count
        regular, enc, rank, p = bool(b[p] & 0x01), b[p + 1], _le(b, p + 2, 4), p + 6
        if not regular:
            n, p = _le(b, p, enc), p + enc
    if enc not in (2, 4, 8) or (kind, version, regular) == (2, 2, False):
        raise NotImplementedError(f"a serialized selection of version {version}, {enc}-byte numbers")
    if regular:  # per axis start, stride, count, block; the largest number is unlimited
        top = (1 << (8 * enc)) - 1
        v = np.frombuffer(b, f"<u{enc}", count=4 * rank, offset=p).reshape(rank, 4).tolist()
        dims = tuple(tuple(None if x == top else x for x in row) for row in v)
        return _Selection("regular", dims=dims), p + 4 * rank * enc
    per = rank if kind == 1 else 2 * rank
    v = np.frombuffer(b, f"<u{enc}", count=n * per, offset=p).astype(np.int64)
    if kind == 1:
        return _Selection("points", v.reshape(n, rank)), p + n * per * enc
    return _Selection("blocks", v.reshape(n, 2, rank)), p + n * per * enc


def _region_shape(sel: _Selection, coords: np.ndarray, shape) -> Tuple[int, ...]:
    """The shape h5py gives `ds[regref]` (h5py's selections.guess_shape):
    a point selection flat; a hyperslab in the shape of its extent along
    each axis where those multiply to its count, else flat."""
    n, rank = len(coords), len(shape)
    if sel.kind == "all":
        return tuple(shape)
    if sel.kind == "points":
        return (n,)
    if sel.kind == "none" or n == 0:
        return (0,) * rank
    low, high = coords.min(0), coords.max(0)
    out = tuple(1 if high[d] == low[d] else n // int((coords[:, d] == low[d]).sum())
                for d in range(rank))
    return out if int(np.prod(out)) == n else (n,)


def _reference_type(region: bool, size: int) -> _Type:
    """h5py's object or region reference dtype. An object reference is
    stored as an object header's address; a region reference as a global
    heap ID whose object is the dataset's address and its serialized
    selection."""
    dtype = np.dtype("O", metadata={"ref": RegionReference if region else Reference})

    def convert(arr, r, decode):
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8).reshape(-1, size)
        addrs = _uint(raw[:, : r.O]).tolist()
        out = np.empty(len(addrs), dtype)
        if not region:
            for i, a in enumerate(addrs):
                out[i] = Reference(a)
            return out.reshape(arr.shape)
        for i, (coll, index) in enumerate(zip(addrs, _uint(raw[:, r.O : r.O + 4]).tolist())):
            if not coll:
                out[i] = RegionReference()
                continue
            blob = r.gheap_object(coll, index)
            out[i] = RegionReference(_le(blob, 0, r.O), _selection(blob, r.O)[0])
        return out.reshape(arr.shape)

    return _Type(dtype, np.dtype((np.void, size)), convert)


# -- reading ---------------------------------------------------------------------


class _SoftLink(NamedTuple):
    path: str


class _ExternalLink(NamedTuple):
    filename: str
    path: str


class _SharedIndex(NamedTuple):
    """An index of the shared-message table: `kind` 0 a list, 1 a v2
    B-tree; `mask` the message types it holds (_SHAREABLE's bits); the
    addresses of the index and of its messages' fractal heap; the number
    of messages it holds."""

    kind: int
    mask: int
    index: int
    heap: int
    count: int


class _LinkTable(NamedTuple):
    """A group stored with link messages: the messages in its header, and
    its link info message (None in a group without one)."""

    messages: List[bytes]
    info: Optional[bytes]


class _FractalHeap:
    """A fractal heap (FRHP): its objects by heap ID. Managed objects lie in
    direct blocks (FHDB) under a tree of indirect blocks (FHIB), tiny ones
    inside their ID, huge ones in blocks of their own. A heap with I/O
    filters keeps each direct block and each huge object filtered: the
    header holds the root direct block's filtered size and filter mask,
    an indirect block each direct block's, and a huge object's ID (or its
    B-tree record) its own."""

    def __init__(self, r: "_Reader", addr: int):
        self.r = r
        O, L, mm = r.O, r.L, r.mm
        pos = r.block(addr, b"FRHP", "fractal heap header")
        self.where = f"{r.path}: the fractal heap at {addr}"
        self.id_len, filter_len = struct.unpack_from("<HH", mm, pos + 5)
        flags = mm[pos + 9]
        max_managed = r.u(pos + 10, 4)
        self.huge_btree = r.u(pos + 14 + L, O)
        p = pos + 14 + 10 * L + 2 * O  # past the space and object counts
        self.width = r.u(p, 2)
        self.start, self.max_direct = r.u(p + 2, L), r.u(p + 2 + L, L)
        self.max_bits = r.u(p + 2 + 2 * L, 2)
        self.root = r.u(p + 6 + 2 * L, O)
        self.root_rows = r.u(p + 6 + 2 * L + O, 2)
        end = p + 8 + 2 * L + O
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        self.root_filtered = (0, 0)  # a filtered root direct block's size and filter mask
        if filter_len:
            self.root_filtered = (r.u(end, L), r.u(end + L, 4))
            self.filters = _pipeline(bytes(mm[end + L + 4 : end + L + 4 + filter_len]))
            end += L + 4 + filter_len
        r.verify(pos, end, "fractal heap header")
        self.checksummed = bool(flags & 0x02)
        self.off_size = (self.max_bits + 7) // 8
        # H5HF_hdr_finish_init_phase1: offsets within the largest direct
        # block, or within the largest managed object, whichever is shorter
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8, _enc_size(max_managed))
        self.direct_rows = (self.max_direct.bit_length() - self.start.bit_length()) + 2
        # (heap offset, address, size, filtered size, filter mask) of each direct block
        self._blocks: Optional[List[Tuple[int, int, int, int, int]]] = None
        self._images: Dict[int, bytes] = {}  # filtered direct blocks, decoded and verified
        self._verified: set = set()

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _walk(self, addr: int, rows: int, offset: int, out: list):
        r = self.r
        pos = r.block(addr, b"FHIB", "fractal heap indirect block")
        p = pos + 5 + r.O + self.off_size
        for row in range(rows):
            size = self._row_size(row)
            for _ in range(self.width):
                child = r.u(p, r.O)
                p += r.O
                direct = row < self.direct_rows
                filtered = (0, 0)
                if direct and self.filters:
                    filtered = (r.u(p, r.L), r.u(p + r.L, 4))
                    p += r.L + 4
                if not r.undefined(child):
                    if direct:
                        out.append((offset, child, size) + filtered)
                    else:  # an indirect block as wide as this row's block
                        child_rows = size.bit_length() - (self.start * self.width).bit_length() + 1
                        self._walk(child, child_rows, offset, out)
                offset += size
        r.verify(pos, p, "fractal heap indirect block")

    def _direct_blocks(self) -> List[Tuple[int, int, int, int, int]]:
        if self._blocks is None:
            blocks: list = []
            if not self.r.undefined(self.root):
                if self.root_rows == 0:
                    blocks.append((0, self.root, self.start) + self.root_filtered)
                else:
                    self._walk(self.root, self.root_rows, 0, blocks)
            self._blocks = sorted(blocks)
        return self._blocks

    def _unfilter(self, addr: int, stored: int, mask: int, size: int) -> bytes:
        """The `stored` bytes at `addr` through the heap's filters that the
        mask leaves on: `size` bytes."""
        pos = self.r.addr(addr)
        raw = _defilter(bytes(self.r.mm[pos : pos + stored]), _active(self.filters, mask), 1, size,
                        self.where)
        if len(raw) != size:
            raise OSError(f"{self.where}: a filtered block of {len(raw)} bytes where {size} were due")
        return raw

    def _image(self, addr: int, size: int, stored: int, mask: int) -> Tuple[object, int]:
        """A direct block's bytes and where they start in them: the file's
        map where the block is stored as it is, its decoded bytes where it
        went through the heap's filters; its checksum verified once."""
        r = self.r
        if self.filters:
            if addr not in self._images:
                self._images[addr] = self._unfilter(addr, stored, mask, size)
            buf, pos = self._images[addr], 0
        else:
            buf, pos = r.mm, r.addr(addr)
        if buf[pos : pos + 4] != b"FHDB":
            raise OSError(f"{r.path}: no fractal heap direct block at {addr}")
        if self.checksummed and addr not in self._verified:
            at = pos + 5 + r.O + self.off_size  # the checksum, zeroed for its own sum
            image = bytes(buf[pos:at]) + b"\0\0\0\0" + bytes(buf[at + 4 : pos + size])
            if lookup3(image) != _le(buf, at, 4):
                raise OSError(f"{r.path}: fractal heap direct block at {addr}: checksum mismatch")
            self._verified.add(addr)
        return buf, pos

    def _huge(self, hid: bytes) -> bytes:
        """A huge object: its address and stored length (for a filtered
        heap also its filter mask and its size unfiltered) in its ID where
        the ID is long enough, else in the v2 B-tree record under the ID's
        key."""
        r, O, L = self.r, self.r.O, self.r.L
        fields = O + L + (4 + L if self.filters else 0)
        if fields <= self.id_len - 1:
            rec, at = hid, 1
        else:
            key = _le(hid, 1, min(self.id_len - 1, 8))
            for rec in r.btree2(self.huge_btree):
                if _le(rec, fields, L) == key:
                    at = 0
                    break
            else:
                raise OSError(f"{r.path}: huge heap object {key} not found")
        addr, length = _le(rec, at, O), _le(rec, at + O, L)
        if self.filters:
            return self._unfilter(addr, length, _le(rec, at + O + L, 4), _le(rec, at + O + L + 4, L))
        pos = r.addr(addr)
        return bytes(r.mm[pos : pos + length])

    def get(self, hid: bytes) -> bytes:
        r = self.r
        kind = (hid[0] >> 4) & 0x03
        if kind == 2:  # tiny: the object is inside the ID
            if self.id_len <= 18:
                return bytes(hid[1 : 2 + (hid[0] & 0x0F)])
            return bytes(hid[2 : 3 + (((hid[0] & 0x0F) << 8) | hid[1])])
        if kind == 1:  # huge: a block of its own
            return self._huge(hid)
        if kind != 0:
            raise OSError(f"{r.path}: heap ID of type {kind}")
        offset = _le(hid, 1, self.off_size)
        length = _le(hid, 1 + self.off_size, self.len_size)
        blocks = self._direct_blocks()
        i = bisect.bisect_right(blocks, (offset, UNDEF, UNDEF, UNDEF, UNDEF)) - 1
        if i < 0 or offset + length > blocks[i][0] + blocks[i][2]:
            raise OSError(f"{r.path}: heap offset {offset} is in no direct block")
        start, addr, size, stored, mask = blocks[i]
        buf, pos = self._image(addr, size, stored, mask)
        at = pos + offset - start
        return bytes(buf[at : at + length])


class _Reader:
    """A file's bytes through a read-only memory map, and the parsers of
    its metadata."""

    def __init__(self, path: str):
        self.path = path
        self.file: Optional["File"] = None  # the File this reader serves
        self._fh = open(path, "rb")
        size = os.fstat(self._fh.fileno()).st_size
        if size < len(SIGNATURE):
            self._fh.close()
            raise OSError(f"{path}: not an HDF5 file ({size} bytes)")
        self.mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        self._heaps: Dict[int, _FractalHeap] = {}
        self._sohm: List[_SharedIndex] = []  # the shared-message table's indexes
        self._sohm_ids: Dict[int, set] = {}
        self.closers: List[Callable[[], None]] = []  # external raw data files' maps
        at = 0  # the superblock sits at 0 or past a user block of 512 * 2^n bytes
        while self.mm[at : at + 8] != SIGNATURE:
            at = 512 if at == 0 else at * 2
            if at + 8 > size:
                self.close()
                raise OSError(f"{path}: not an HDF5 file (no signature)")
        try:
            self._superblock(at)
        except BaseException:
            self.close()
            raise

    def close(self):
        for close in self.closers:
            close()
        self.closers.clear()
        if self.mm is not None:
            self.mm.close()
            self.mm = None
            self._fh.close()

    def _superblock(self, at: int):
        mm = self.mm
        version = mm[at + 8]
        if version > 3:
            raise NotImplementedError(f"{self.path}: HDF5 superblock version {version}")
        if version >= 2:
            self.O, self.L = mm[at + 9], mm[at + 10]
        else:
            self.O, self.L = mm[at + 13], mm[at + 14]
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise NotImplementedError(f"{self.path}: {self.O}-byte offsets, {self.L}-byte lengths")
        if version >= 2:
            self.base = self.u(at + 12, self.O)
            extension = self.u(at + 12 + self.O, self.O)
            self.root = self.u(at + 12 + 3 * self.O, self.O)
            self.verify(at, at + 12 + 4 * self.O, "superblock")
            if not self.undefined(extension):
                for t, data, _ in self.messages(extension):
                    if t == _SHARED_TABLE:
                        self._shared_table(data)
            return
        pos = at + (28 if version == 1 else 24)
        self.base = self.u(pos, self.O)
        root = pos + 4 * self.O  # past the base address and the three that follow it
        self.root = self.u(root + self.O, self.O)

    def _shared_table(self, b: bytes):
        """The shared-message table (SMTB) that the superblock extension's
        message names: each index's kind (a list, SMLI, or a v2 B-tree), the
        message types it holds, where it lies, the fractal heap of its
        messages, and its message count."""
        if b[0] != 0:
            raise NotImplementedError(f"{self.path}: shared object header messages (a shared-message "
                                      f"table message of version {b[0]})")
        O, addr = self.O, _le(b, 1, self.O)
        pos = self.block(addr, b"SMTB", "shared-message table")
        p = pos + 4
        for _ in range(b[1 + O]):
            version, kind, mask = self.mm[p], self.mm[p + 1], self.u(p + 2, 2)
            if version != 0 or kind > 1:
                raise NotImplementedError(f"{self.path}: shared object header messages (an index "
                                          f"of version {version}, type {kind})")
            self._sohm.append(_SharedIndex(kind, mask, self.u(p + 14, O), self.u(p + 14 + O, O),
                                           self.u(p + 12, 2)))
            p += 14 + 2 * O
        self.verify(pos, p, "shared-message table")

    def _shared_ids(self, i: int) -> set:
        """The heap IDs of the messages that shared-message index i holds in
        its heap: its list's records (checksummed) or its B-tree's; each
        record a location (0: the heap), a hash, a reference count and the
        heap ID, or, for a message kept in an object header, where."""
        if i not in self._sohm_ids:
            ix = self._sohm[i]
            size = 5 + max(12, 4 + self.O)
            if ix.kind == 0:
                pos = self.block(ix.index, b"SMLI", "shared-message list")
                end = pos + 4 + ix.count * size
                self.verify(pos, end, "shared-message list")
                records = [self.mm[p : p + size] for p in range(pos + 4, end, size)]
            else:
                records = list(self.btree2(ix.index))
            self._sohm_ids[i] = {bytes(rec[9:17]) for rec in records if rec[0] == 0}
        return self._sohm_ids[i]

    def shared_heap_message(self, mtype: int, hid: bytes) -> bytes:
        """The message of type `mtype` stored under heap ID `hid` in the
        heap of the shared-message index that holds that type."""
        for i, ix in enumerate(self._sohm):
            if ix.mask & _SHAREABLE.get(mtype, 0):
                if bytes(hid) not in self._shared_ids(i):
                    raise OSError(f"{self.path}: a shared message of type {mtype:#x} under a heap "
                                  f"ID ({bytes(hid).hex()}) that its index does not hold")
                return self.heap(ix.heap).get(hid)
        raise OSError(f"{self.path}: a message of type {mtype:#x} in the shared-message heap, "
                      "which no shared-message index holds")

    # -- primitives

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.mm[pos : pos + n], "little")

    def addr(self, a: int) -> int:
        """A file address -> a position in the map."""
        return self.base + a

    def undefined(self, a: int) -> bool:
        return a == (1 << (8 * self.O)) - 1

    def block(self, addr: int, signature: bytes, what: str) -> int:
        """The map position of the block at `addr`, whose signature must be
        `signature`."""
        pos = self.addr(addr)
        if self.mm[pos : pos + 4] != signature:
            raise OSError(f"{self.path}: no {what} at {addr}")
        return pos

    def verify(self, start: int, end: int, what: str):
        """The lookup3 checksum of mm[start:end] must be the one stored at
        `end`."""
        if lookup3(self.mm[start:end]) != self.u(end, 4):
            raise OSError(f"{self.path}: {what} at {start - self.base}: checksum mismatch")

    # -- object headers

    def header(self, addr: int) -> Tuple[int, List[Tuple[int, bytes, Optional[int]]]]:
        """The flags of the object header at `addr` (0 for version 1) and
        (type, data, creation order or None) of each message, continuation
        blocks followed and shared messages resolved."""
        mm, pos = self.mm, self.addr(addr)
        if mm[pos : pos + 4] == b"OHDR":
            flags = mm[pos + 5]
            p = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            size_len = 1 << (flags & 0x03)
            start = p + size_len
            end = start + self.u(p, size_len)
            self.verify(pos, end, "object header")
            blocks, head = [(start, end)], 6 if flags & 0x04 else 4
        elif mm[pos] == 1:
            flags, blocks, head = 0, [(pos + 16, pos + 16 + self.u(pos + 8, 4))], 8
        else:
            raise NotImplementedError(f"{self.path}: object header version {mm[pos]} at {addr}")
        out = []
        while blocks:
            p, end = blocks.pop(0)
            while p + head <= end:
                if head == 8:
                    mtype, size, mflags, order = self.u(p, 2), self.u(p + 2, 2), mm[p + 4], None
                else:
                    mtype, size, mflags = mm[p], self.u(p + 1, 2), mm[p + 3]
                    order = self.u(p + 4, 2) if head == 6 else None
                data = bytes(mm[p + head : p + head + size])
                p += head + size
                if mtype == _CONTINUATION:
                    at, length = _le(data, 0, self.O), _le(data, self.O, self.L)
                    if head == 8:
                        blocks.append((self.addr(at), self.addr(at) + length))
                    else:
                        cpos = self.block(at, b"OCHK", "object header continuation block")
                        self.verify(cpos, cpos + length - 4, "object header continuation block")
                        blocks.append((cpos + 4, cpos + length - 4))
                    continue
                if mtype == _NIL:
                    continue
                if mflags & 0x02:
                    data = self.shared(mtype, data)
                out.append((mtype, data, order))
        return flags, out

    def messages(self, addr: int) -> List[Tuple[int, bytes, Optional[int]]]:
        """(type, data, creation order) of each message of the object header
        at `addr`."""
        return self.header(addr)[1]

    def shared(self, mtype: int, b: bytes) -> bytes:
        """The message of type `mtype` that a shared message points to: the
        one in a committed object's header, or in the shared-message heap
        (a dataspace, datatype, fill value, filter pipeline or attribute
        that the file's shared-message table shares)."""
        version, kind = b[0], b[1]
        if version == 1:  # a symbol-table entry: the name's offset, then the address
            at = 8 + self.L
        elif version == 2 or (version == 3 and kind == 2):
            at = 2
        elif version == 3 and kind == 1:  # in the shared-message heap
            return self.shared_heap_message(mtype, b[2:10])
        else:
            raise NotImplementedError(f"{self.path}: shared message version {version}, type {kind}")
        target = _le(b, at, self.O)
        for t, data, _ in self.messages(target):
            if t == mtype:
                return data
        raise OSError(f"{self.path}: no message of type {mtype:#x} in the object at {target}")

    # -- datatypes, dataspaces, attributes

    def datatype(self, b: bytes, at: int = 0) -> Tuple[_Type, int]:
        """The datatype encoded at b[at:] and the bytes it takes."""
        cls, version = b[at] & 0x0F, b[at] >> 4
        bits = b[at + 1] | b[at + 2] << 8 | b[at + 3] << 16
        size = _le(b, at + 4, 4)
        p = at + 8
        order = ">" if bits & 0x01 else "<"
        if cls in (0, 4):  # fixed-point; a bitfield is h5py's unsigned integer
            offset, precision = struct.unpack_from("<HH", b, p)
            if size not in (1, 2, 4, 8):
                raise NotImplementedError(f"{self.path}: {size}-byte integer")
            kind = "i" if cls == 0 and bits & 0x08 else "u"
            dtype = np.dtype(f"{order}{kind}{size}")
            if cls == 4 or (offset == 0 and precision == 8 * size):
                return _Type(dtype), 12
            return _Type(dtype, f"{order}u{size}",
                         _fixed_point(kind == "i", offset, precision, dtype)), 12
        if cls == 1:  # floating-point
            return _float_type(self.path, version, size, bits, *struct.unpack_from("<HHBBBBI", b, p)), 20
        if cls == 3:  # fixed-length string
            utf8 = (bits >> 4) & 0x0F == 1
            return _Type(np.dtype(f"S{size}", metadata={"h5py_encoding": "utf-8" if utf8 else "ascii"})), 8
        if cls == 5:  # opaque: h5py's void of its size (past its tag)
            return _Type(np.dtype(f"V{size}")), 8 + (bits & 0xFF)
        if cls == 6:  # compound
            names, offsets, types = [], [], []
            for _ in range(bits & 0xFFFF):
                (name,), p = _names(b, p, 1, version)
                if version >= 3:
                    offset, p = _le(b, p, _enc_size(size)), p + _enc_size(size)
                else:
                    offset, p = _le(b, p, 4), p + 4
                dims = ()
                if version == 1:  # a member's own dimensions, before array types
                    dims = struct.unpack_from("<4I", b, p + 12)[: b[p]]
                    p += 28
                t, used = self.datatype(b, p)
                p += used
                names.append(name.decode("utf-8"))
                offsets.append(offset)
                types.append(_array_type(t, dims) if dims else t)
            return _compound_type(names, offsets, types, size), p - at
        if cls == 7:  # reference
            kind = bits & 0x0F
            if version >= 4 or kind > 1:  # HDF5 1.12's H5R_ref_t
                what = _REFERENCE_NAMES.get(kind, f"reference of type {kind}")
                raise NotImplementedError(f"{self.path}: HDF5 datatype revised reference ({what})")
            return _reference_type(kind == 1, size), 8
        if cls == 8:  # enumerated: h5py's dtype of the base, with the members
            base, used = self.datatype(b, p)
            names, p = _names(b, p + used, bits & 0xFFFF, version)
            values = np.frombuffer(b, base.stored, count=len(names), offset=p)
            p += len(names) * base.stored.itemsize
            members = dict(zip(names, base.to_h5py(values, self, False).tolist()))
            if members == {b"FALSE": 0, b"TRUE": 1}:  # h5py's bool
                return _Type(np.bool_, base.stored,
                             lambda a, r, d: base.to_h5py(a, r, d).astype(np.bool_)), p - at
            dtype = np.dtype(base.dtype, metadata={"enum": {k.decode("utf-8"): v
                                                            for k, v in members.items()}})
            return _Type(dtype, base.stored, lambda a, r, d: base.to_h5py(a, r, d).view(dtype)), p - at
        if cls == 9:  # variable-length string or sequence
            base, used = self.datatype(b, p)
            width = 8 + self.O
            if bits & 0x0F == 1:
                return _vlen_type(None, (bits >> 8) & 0x0F == 1, width), 8 + used
            return _vlen_type(base, False, width), 8 + used
        if cls == 10:  # array
            ndims = b[p]
            p += 1 if version >= 3 else 4
            dims = struct.unpack_from(f"<{ndims}I", b, p)
            p += 4 * ndims * (1 if version >= 3 else 2)  # version 2 adds permutations
            base, used = self.datatype(b, p)
            return _array_type(base, dims), p + used - at
        raise NotImplementedError(f"{self.path}: HDF5 datatype {_CLASS_NAMES.get(cls, f'class {cls}')}")

    def dataspace(self, b: bytes):
        """(shape, maximum shape with None for unlimited); (None, None) for a
        null dataspace."""
        version, rank, flags = b[0], b[1], b[2]
        if version == 1:
            at = 8
        elif version == 2:
            if b[3] == 2:
                return None, None
            at = 4
        else:
            raise NotImplementedError(f"{self.path}: dataspace message version {version}")
        L = self.L
        dims = tuple(_le(b, at + i * L, L) for i in range(rank))
        if not flags & 0x01:
            return dims, dims
        top = (1 << (8 * L)) - 1
        maxdims = tuple(_le(b, at + (rank + i) * L, L) for i in range(rank))
        return dims, tuple(None if m == top else m for m in maxdims)

    def attribute(self, b: bytes):
        """(name, value) of an attribute message, values as h5py gives
        them: a numpy scalar or array, str for a variable-length string."""
        version = b[0]
        if version not in (1, 2, 3):
            raise NotImplementedError(f"{self.path}: attribute message version {version}")
        flags = b[1] if version > 1 else 0
        nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
        pad = _pad8 if version == 1 else (lambda n: n)
        at = 9 if version == 3 else 8
        name = bytes(b[at : at + nsize]).rstrip(b"\0").decode("utf-8")
        at += pad(nsize)
        tb = self.shared(_DATATYPE, b[at : at + tsize]) if flags & 0x01 else b[at : at + tsize]
        dtype, _ = self.datatype(tb)
        at += pad(tsize)
        sb = self.shared(_DATASPACE, b[at : at + ssize]) if flags & 0x02 else b[at : at + ssize]
        shape, _ = self.dataspace(sb)
        at += pad(ssize)
        if shape is None:
            return name, None
        return name, self.values(bytes(b[at:]), dtype, shape)

    def attributes(self, msgs, tracked: bool) -> Dict:
        """An object's attributes, from its attribute messages and its dense
        storage, in h5py's order: by creation order where the object tracks
        it, else by name."""
        found = []  # (creation order, name, value)
        for t, data, order in msgs:
            if t == _ATTRIBUTE:
                found.append((order or 0,) + self.attribute(data))
            elif t == _ATTRIBUTE_INFO:
                at = 2 + (2 if data[1] & 0x01 else 0)
                heap, btree = _le(data, at, self.O), _le(data, at + self.O, self.O)
                if self.undefined(heap):
                    continue
                h = self.heap(heap)
                for rec in self.btree2(btree):  # heap ID, flags, creation order, name hash
                    # a shared attribute's heap ID is in the shared-message heap
                    msg = self.shared_heap_message(_ATTRIBUTE, rec[:8]) if rec[8] & 0x02 else h.get(rec[:8])
                    found.append((_le(rec, 9, 4),) + self.attribute(msg))
        found.sort(key=(lambda x: x[0]) if tracked else (lambda x: x[1].encode("utf-8")))
        return {name: value for _, name, value in found}

    def values(self, raw: bytes, t: _Type, shape: Tuple[int, ...], decode: bool = True):
        """Elements of type t from their stored bytes, as h5py gives them;
        variable-length strings as str where `decode` (attributes), else as
        bytes (datasets)."""
        n = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(raw, t.stored, count=n)
        arr = arr.reshape(tuple(shape) + arr.shape[1:])
        arr = arr.copy() if t.convert is None else t.to_h5py(arr, self, decode)
        return arr[()] if arr.ndim == 0 else arr

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

    def heap(self, addr: int) -> _FractalHeap:
        if addr not in self._heaps:
            self._heaps[addr] = _FractalHeap(self, addr)
        return self._heaps[addr]

    # -- B-trees, symbol tables, links

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

    def btree2(self, addr: int) -> Iterator[bytes]:
        """Each record of the version 2 B-tree at `addr` (BTHD), in key
        order, at any depth."""
        pos = self.block(addr, b"BTHD", "v2 B-tree header")
        node_size, rec_size, depth = self.u(pos + 6, 4), self.u(pos + 10, 2), self.u(pos + 12, 2)
        root, root_records = self.u(pos + 16, self.O), self.u(pos + 16 + self.O, 2)
        self.verify(pos, pos + 18 + self.O + self.L, "v2 B-tree header")
        # H5B2__hdr_init: the widths of an internal node's child counts
        leaf_max = (node_size - 10) // rec_size
        count_size = _enc_size(leaf_max)
        cum_max, cum_size = [leaf_max], [0]
        for d in range(1, depth + 1):
            ptr = self.O + count_size + (cum_size[d - 1] if d > 1 else 0)
            node_max = (node_size - (10 + ptr)) // (rec_size + ptr)
            cum_max.append((node_max + 1) * cum_max[d - 1] + node_max)
            cum_size.append(_enc_size(cum_max[d]))
        if not self.undefined(root):
            yield from self._btree2_node(root, root_records, depth, rec_size, count_size, cum_size)

    def _btree2_node(self, addr, nrec, depth, rec_size, count_size, cum_size) -> Iterator[bytes]:
        if depth == 0:
            pos = self.block(addr, b"BTLF", "v2 B-tree leaf")
            end = pos + 6 + nrec * rec_size
            self.verify(pos, end, "v2 B-tree leaf")
            for i in range(nrec):
                yield bytes(self.mm[pos + 6 + i * rec_size : pos + 6 + (i + 1) * rec_size])
            return
        pos = self.block(addr, b"BTIN", "v2 B-tree internal node")
        p = pos + 6 + nrec * rec_size
        children = []
        for _ in range(nrec + 1):
            children.append((self.u(p, self.O), self.u(p + self.O, count_size)))
            p += self.O + count_size + (cum_size[depth - 1] if depth > 1 else 0)
        self.verify(pos, p, "v2 B-tree internal node")
        for i, (child, count) in enumerate(children):
            yield from self._btree2_node(child, count, depth - 1, rec_size, count_size, cum_size)
            if i < nrec:
                yield bytes(self.mm[pos + 6 + i * rec_size : pos + 6 + (i + 1) * rec_size])

    def local_heap(self, heap: int) -> int:
        """The map position of the data segment of the local heap at `heap`."""
        pos = self.addr(heap)
        if self.mm[pos : pos + 4] != b"HEAP":
            raise OSError(f"{self.path}: no local heap at {heap}")
        return self.addr(self.u(pos + 8 + 2 * self.L, self.O))

    def string(self, pos: int) -> str:
        """The null-terminated UTF-8 string at map position `pos`."""
        return bytes(self.mm[pos : self.mm.find(b"\0", pos)]).decode("utf-8")

    def links(self, btree: int, heap: int) -> Dict[str, int]:
        """{name: object header address} of a symbol-table group."""
        names = self.local_heap(heap)
        out = {}
        entry = 2 * self.O + 24
        for _, snod in self.btree(btree, 0, self.L):
            p = self.addr(snod)
            if self.mm[p : p + 4] != b"SNOD":
                raise OSError(f"{self.path}: no symbol-table node at {snod}")
            for i in range(self.u(p + 6, 2)):
                e = p + 8 + i * entry
                out[self.string(names + self.u(e, self.O))] = self.u(e + self.O, self.O)
        return out

    def link(self, b: bytes):
        """(name, target, creation order) of a link message: the target an
        object header address, a _SoftLink or an _ExternalLink."""
        if b[0] != 1:
            raise NotImplementedError(f"{self.path}: link message version {b[0]}")
        flags, at = b[1], 2
        kind = 0
        if flags & 0x08:
            kind, at = b[at], at + 1
        order = None
        if flags & 0x04:
            order, at = _le(b, at, 8), at + 8
        if flags & 0x10:
            at += 1  # the name's character set
        size = 1 << (flags & 0x03)
        length, at = _le(b, at, size), at + size
        name, at = b[at : at + length].decode("utf-8"), at + length
        if kind == 0:
            return name, _le(b, at, self.O), order
        value = b[at + 2 : at + 2 + _le(b, at, 2)]
        if kind == 1:
            return name, _SoftLink(value.decode("utf-8")), order
        if kind == 64:  # flags byte, then the file's name and the object's path
            filename, path = value[1:].split(b"\0")[:2]
            return name, _ExternalLink(filename.decode("utf-8"), path.decode("utf-8")), order
        raise NotImplementedError(f"{self.path}: user-defined link {name!r} of type {kind}")

    def members(self, links, native: bool = False) -> Dict[str, object]:
        """{name: target} of a group's links, in h5py's order: by name, or by
        creation order where the group tracks it; or, `native`, in the
        order HDF5 visits them (symbol tables and the dense name index in
        their B-tree's order, compact links in their header's)."""
        if not isinstance(links, _LinkTable):
            found = self.links(*links)
            return found if native else dict(sorted(found.items(), key=lambda kv: kv[0].encode("utf-8")))
        found = [self.link(m) for m in links.messages]
        tracked = False
        if links.info is not None:
            info = links.info
            tracked = bool(info[1] & 0x01)
            at = 2 + (8 if tracked else 0)
            heap, btree = _le(info, at, self.O), _le(info, at + self.O, self.O)
            if not self.undefined(heap):  # dense storage: the name index's records
                h = self.heap(heap)
                found += [self.link(h.get(rec[4:])) for rec in self.btree2(btree)]
        if not native:
            found.sort(key=(lambda x: x[2]) if tracked else (lambda x: x[0].encode("utf-8")))
        return {name: target for name, target, _ in found}

    def group_links(self, msgs):
        """A group's links from its header's messages: a symbol table's
        (B-tree, heap) or a _LinkTable; None for an object not a group."""
        types = {t for t, _, _ in msgs}
        if _SYMBOL_TABLE in types:
            data = next(d for t, d, _ in msgs if t == _SYMBOL_TABLE)
            return _le(data, 0, self.O), _le(data, self.O, self.O)
        if types & {_LINK, _LINK_INFO, _GROUP_INFO}:
            return _LinkTable([d for t, d, _ in msgs if t == _LINK],
                              next((d for t, d, _ in msgs if t == _LINK_INFO), None))
        return None

    def open(self, addr: int, name: Optional[str]):
        """The Group, Dataset or Datatype whose object header is at `addr`."""
        flags, msgs = self.header(addr)
        types = {t for t, _, _ in msgs}
        attrs = self.attributes(msgs, tracked=bool(flags & 0x04))
        links = self.group_links(msgs)
        if links is not None:
            obj = Group(name, attrs, reader=self, links=links)
        elif _LAYOUT in types:
            obj = Dataset(name, attrs, layout=_StoredLayout(self, msgs, name))
        elif _DATATYPE in types:
            t, _ = self.datatype(next(d for mt, d, _ in msgs if mt == _DATATYPE))
            obj = Datatype(name, attrs, t.dtype)
        else:
            raise NotImplementedError(f"{self.path}: {name!r} is neither a group, a dataset nor a datatype")
        obj._addr = addr
        return obj


class _StoredLayout:
    """How a dataset's elements lie in the file, and their reads."""

    def __init__(self, r: _Reader, msgs, name: str):
        self.r, self.name = r, name
        self.where = f"{r.path}: {name!r}"
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        self.fill = None
        self.external: Optional[_External] = None
        self.virtual: Optional[_Virtual] = None
        shape = maxshape = t = layout = external = None
        for mt, b, _ in msgs:
            if mt == _DATASPACE:
                shape, maxshape = r.dataspace(b)
            elif mt == _DATATYPE:
                t, _ = r.datatype(b)
            elif mt == _LAYOUT:
                layout = b
            elif mt == _FILTERS:
                self.filters = _pipeline(b)
            elif mt in (_FILL, _FILL_OLD):
                self.fill = self._fill(mt, b)
            elif mt == _EXTERNAL_FILES:
                external = b
        self.type = t
        self.stored = t.stored
        self._sub = self.stored.shape  # an array type's own axes, after the dataset's
        self.shape = shape if shape is not None else (0,)
        self.maxshape = maxshape if maxshape is not None else self.shape
        self._decode_s = 0.0  # time spent in the filters of the chunks read
        self.skip_edge_filters = False
        self._layout(layout)
        if self.filters and self.kind != 2:
            raise NotImplementedError(f"{self.where}: filters on an unchunked dataset")
        if external is not None:
            self.external = _External(self, external)
        if self.kind == 3:
            self.virtual = _Virtual(self, r.gheap_object(*self.address))

    @property
    def decode_seconds(self) -> float:
        """Time spent in the filters of the chunks read (a virtual
        dataset's: in its sources')."""
        return self._decode_s + (self.virtual.decode_seconds() if self.virtual else 0.0)

    def _layout(self, b: bytes):
        O, version = self.r.O, b[0]
        if version in (1, 2):  # rank + 1 dimensions, the last a chunk's element size
            rank, self.kind = b[1], b[2]
            at = 8
            if self.kind in (1, 2):
                self.address, at = _le(b, at, O), at + O
            dims = struct.unpack_from(f"<{rank}I", b, at)
            at += 4 * rank
            if self.kind == 0:
                self.compact = bytes(b[at + 4 : at + 4 + _le(b, at, 4)])
            elif self.kind == 2:
                self.chunk, self.index = tuple(dims[:-1]), "btree1"
        elif version in (3, 4):
            self.kind = b[1]
            if self.kind == 0:
                self.compact = bytes(b[4 : 4 + _le(b, 2, 2)])
            elif self.kind == 1:
                self.address = _le(b, 2, O)
            elif self.kind == 3:  # virtual: a global heap ID of the mappings
                self.address = (_le(b, 2, O), _le(b, 2 + O, 4))
            elif self.kind == 2 and version == 3:
                rank = b[2]
                self.address = _le(b, 3, O)
                self.chunk, self.index = struct.unpack_from(f"<{rank - 1}I", b, 3 + O), "btree1"
            elif self.kind == 2:
                self._chunk_layout(b)
        else:
            raise NotImplementedError(f"{self.where}: data layout message version {version}")
        if self.kind > 3:
            raise NotImplementedError(f"{self.where}: layout class {self.kind}")
        if self.kind == 2:
            self.chunk = tuple(self.chunk)
            self.chunk_bytes = int(np.prod(self.chunk, dtype=np.int64)) * self.stored.itemsize
            self._index: Optional[Dict[Tuple[int, ...], Tuple[int, int, int]]] = None
            self._last: Tuple = (None, None)

    def _chunk_layout(self, b: bytes):
        """A version 4 chunked layout: its chunk dimensions and its chunk
        index's type and address."""
        r = self.r
        flags, ndims, enc = b[2], b[3], b[4]
        self.chunk = tuple(_le(b, 5 + i * enc, enc) for i in range(ndims - 1))
        self.skip_edge_filters = bool(flags & 0x01)  # partial edge chunks unfiltered
        at = 5 + ndims * enc
        kind = b[at]
        at += 1
        if kind == 1:  # single chunk
            self.single = None
            if flags & 0x02:
                self.single = (_le(b, at, r.L), _le(b, at + r.L, 4))
                at += r.L + 4
        elif kind in (3, 4, 5):  # fixed array, extensible array, v2 B-tree: their parameters
            at += {3: 1, 4: 5, 5: 6}[kind]
        elif kind != 2:
            raise NotImplementedError(f"{self.where}: chunk index type {kind}")
        self.index = {1: "single", 2: "implicit", 3: "farray", 4: "earray", 5: "btree2"}[kind]
        self.address = _le(b, at, r.O)

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
        """Stored elements of `shape` holding the fill value."""
        out = np.zeros(shape, self.stored)
        if (self.fill is not None and len(self.fill) == self.stored.itemsize
                and not self.type.dtype.hasobject):
            out[...] = np.frombuffer(self.fill, self.stored, count=1)[0]
        return out

    # -- element reads

    def _stored(self, shape) -> np.ndarray:
        """A view of the stored elements."""
        dt = self.stored
        if self.kind == 0:
            count = int(np.prod(shape, dtype=np.int64))
            return np.frombuffer(self.compact, dt, count=count).reshape(tuple(shape) + self._sub)
        return np.ndarray(shape, dt, buffer=self.r.mm, offset=self.r.addr(self.address))

    def read(self, rows: np.ndarray) -> np.ndarray:
        """The elements at the first-axis indices `rows`, an integer array
        of any shape and order, repeats allowed."""
        if self.virtual is not None:
            return self.virtual.read(rows)
        shape = rows.shape + tuple(self.shape[1:])
        if self.kind == 2:
            out = self._chunked(rows.reshape(-1)).reshape(shape + self._sub)
        elif 0 in self.shape or (self.external is None and self.kind == 1
                                 and self.r.undefined(self.address)):
            out = self.filled(shape)
        elif self.external is not None:
            out = self._external_rows(rows.reshape(-1), self.shape[1:]).reshape(shape + self._sub)
        else:
            out = self._stored(self.shape)[rows]
        return self.type.to_h5py(out, self.r, False)

    def read_all(self) -> np.ndarray:
        if self.shape == ():
            if self.external is not None:
                out = self._external_rows(np.zeros(1, np.int64), ())[0]
            elif self.kind == 1 and self.r.undefined(self.address):
                out = self.filled(())
            else:
                out = np.array(self._stored(()))
            return self.type.to_h5py(out, self.r, False)
        return self.read(np.arange(self.shape[0]))

    def _external_rows(self, rows: np.ndarray, row_shape) -> np.ndarray:
        """Stored elements of the rows at the 1-D `rows` of raw data in
        external files."""
        count = int(np.prod(row_shape, dtype=np.int64))
        raw = self.external.read(rows, count * self.stored.itemsize)
        return raw.view(self.stored.base).reshape((len(rows),) + tuple(row_shape) + self._sub)

    def region(self, sel: "_Selection") -> np.ndarray:
        """The elements a region reference selects, as h5py's ds[regref]
        gives them: in HDF5's order, in h5py's shape (_region_shape)."""
        if sel.kind == "all":
            return self.read_all()
        coords = sel.coords(self.shape)
        shape = _region_shape(sel, coords, self.shape)
        if not len(coords):
            return np.zeros(shape, self.type.dtype)
        rows, inverse = np.unique(coords[:, 0], return_inverse=True)
        return self.read(rows)[(inverse,) + tuple(coords[:, 1:].T)].reshape(shape)

    # -- chunked: the chunk indexes

    def _chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """{chunk's first element: (address, stored bytes, filter mask)}."""
        if self._index is None:
            self._index = {}
            if not self.r.undefined(self.address):
                {"btree1": self._btree1, "single": self._single, "implicit": self._implicit,
                 "farray": self._farray, "earray": self._earray,
                 "btree2": self._btree2}[self.index]()
        return self._index

    def _btree1(self):
        rank = len(self.chunk)
        for key, child in self.r.btree(self.address, 1, 8 + 8 * (rank + 1)):
            size, mask = struct.unpack_from("<II", key, 0)
            self._index[struct.unpack_from(f"<{rank}Q", key, 8)] = (child, size, mask)

    def _single(self):
        size, mask = self.single or (self.chunk_bytes, 0)
        self._index[(0,) * len(self.chunk)] = (self.address, size, mask)

    def _max_grid(self) -> List[Optional[int]]:
        """Chunks along each axis at the maximum shape (None: unlimited)."""
        return [None if m is None else -(-m // c) for m, c in zip(self.maxshape, self.chunk)]

    def _put(self, first: int, addr: np.ndarray, size: np.ndarray, mask: np.ndarray):
        """Index entries from the elements numbered first, first + 1, ... of
        a fixed or extensible array: element i is the chunk whose
        coordinates, in chunks, are i in row-major order over the maximum
        shape, the unlimited axis moved first (HDF5's swizzle)."""
        keep = np.flatnonzero(addr != np.uint64((1 << (8 * self.r.O)) - 1))
        if not len(keep):
            return
        idx = first + keep.astype(np.int64)
        grid = self._max_grid()
        order = [d for d, g in enumerate(grid) if g is None] + [d for d, g in enumerate(grid) if g is not None]
        rest = [grid[d] for d in order if grid[d] is not None]
        if len(order) > len(rest):  # the unlimited axis counts the rest's whole grids
            lead, rem = np.divmod(idx, int(np.prod(rest, dtype=np.int64)))
            parts = [lead] + (list(np.unravel_index(rem, rest)) if rest else [])
        else:
            parts = list(np.unravel_index(idx, rest))
        coords = [None] * len(grid)
        for d, part in zip(order, parts):
            coords[d] = (part * self.chunk[d]).tolist()
        for offset, a, s, m in zip(zip(*coords), addr[keep].tolist(), size[keep].tolist(),
                                   mask[keep].tolist()):
            self._index[offset] = (a, s, m)

    def _elements(self, raw: bytes, count: int, width: int, filtered: bool):
        """(addresses, sizes, filter masks) of `count` index elements of
        `width` bytes: an address, then for a filtered chunk its size (as
        wide as the element leaves) and its filter mask."""
        O = self.r.O
        cols = np.frombuffer(raw, np.uint8, count=count * width).reshape(count, width)
        addr = _uint(cols[:, :O])
        if not filtered:
            return addr, np.full(count, self.chunk_bytes, np.uint64), np.zeros(count, np.uint64)
        return addr, _uint(cols[:, O : width - 4]), _uint(cols[:, width - 4 :])

    def _implicit(self):
        """Every chunk at its place in one allocation, in row-major order
        over the maximum shape."""
        count = int(np.prod(self._max_grid(), dtype=np.int64))
        addr = self.address + np.arange(count, dtype=np.uint64) * np.uint64(self.chunk_bytes)
        self._put(0, addr, np.full(count, self.chunk_bytes, np.uint64), np.zeros(count, np.uint64))

    def _farray(self):
        """A fixed array (FAHD, FADB), its elements in pages of 2^bits where
        there are more, each page present where its bit says so."""
        r, O, L = self.r, self.r.O, self.r.L
        pos = r.block(self.address, b"FAHD", "fixed array header")
        filtered, width, page_bits = r.mm[pos + 5], r.mm[pos + 6], r.mm[pos + 7]
        count, dblock = r.u(pos + 8, L), r.u(pos + 8 + L, O)
        r.verify(pos, pos + 8 + L + O, "fixed array header")
        if r.undefined(dblock):
            return
        dp = r.block(dblock, b"FADB", "fixed array data block")
        page = 1 << page_bits
        at = dp + 6 + O
        if count <= page:
            r.verify(dp, at + count * width, "fixed array data block")
            self._put(0, *self._elements(r.mm[at : at + count * width], count, width, filtered))
            return
        pages = -(-count // page)
        bitmap = r.mm[at : at + (pages + 7) // 8]
        r.verify(dp, at + len(bitmap), "fixed array data block")
        start = at + len(bitmap) + 4
        for i in range(pages):
            if not bitmap[i // 8] & (0x80 >> (i % 8)):
                continue
            n = min(page, count - i * page)
            p = start + i * (page * width + 4)
            r.verify(p, p + n * width, "fixed array data block page")
            self._put(i * page, *self._elements(r.mm[p : p + n * width], n, width, filtered))

    def _earray(self):
        """An extensible array (EAHD): its first elements in the index block
        (EAIB), the rest in data blocks (EADB) that the index block or its
        super blocks (EASB) point to, a super block's data blocks in pages
        where they hold more than 2^bits elements."""
        r, O, L = self.r, self.r.O, self.r.L
        pos = r.block(self.address, b"EAHD", "extensible array header")
        filtered, width, max_bits, in_index, dblock_min, sblock_min, page_bits = r.mm[pos + 5 : pos + 12]
        iblock = r.u(pos + 12 + 6 * L, O)
        r.verify(pos, pos + 12 + 6 * L + O, "extensible array header")
        if r.undefined(iblock):
            return
        offset_size = (max_bits + 7) // 8
        page = 1 << page_bits
        # H5EA__hdr_init: super block s holds 2^(s/2) data blocks of 2^((s+1)/2) * min elements
        sblocks, first = [], in_index
        for s in range(1 + max_bits - (dblock_min.bit_length() - 1)):
            ndata, nelem = 1 << (s // 2), (1 << ((s + 1) // 2)) * dblock_min
            sblocks.append((ndata, nelem, first))
            first += ndata * nelem
        ip = r.block(iblock, b"EAIB", "extensible array index block")
        at = ip + 6 + O
        self._put(0, *self._elements(r.mm[at : at + in_index * width], in_index, width, filtered))
        at += in_index * width
        direct = 2 * (sblock_min.bit_length() - 1)  # super blocks whose data blocks the index block holds
        daddrs = [r.u(at + i * O, O) for i in range(2 * (sblock_min - 1))]
        at += len(daddrs) * O
        saddrs = [r.u(at + i * O, O) for i in range(len(sblocks) - direct)]
        r.verify(ip, at + len(saddrs) * O, "extensible array index block")
        d = 0
        for ndata, nelem, start in sblocks[:direct]:
            for j in range(ndata):
                if not r.undefined(daddrs[d]):
                    self._ea_data(daddrs[d], nelem, start + j * nelem, width, filtered, offset_size,
                                  page, None)
                d += 1
        for s, saddr in enumerate(saddrs, direct):
            if r.undefined(saddr):
                continue
            ndata, nelem, start = sblocks[s]
            sp = r.block(saddr, b"EASB", "extensible array super block")
            at = sp + 6 + O + offset_size
            bitmap = None
            if nelem > page:  # each data block's page bits, bit j * pages + i
                bitmap = r.mm[at : at + ndata * ((nelem // page + 7) // 8)]
                at += len(bitmap)
            addrs = [r.u(at + j * O, O) for j in range(ndata)]
            r.verify(sp, at + ndata * O, "extensible array super block")
            for j, a in enumerate(addrs):
                if not r.undefined(a):
                    self._ea_data(a, nelem, start + j * nelem, width, filtered, offset_size, page,
                                  None if bitmap is None else (bitmap, j * (nelem // page)))

    def _ea_data(self, addr, nelem, first, width, filtered, offset_size, page, pages):
        r = self.r
        dp = r.block(addr, b"EADB", "extensible array data block")
        at = dp + 6 + r.O + offset_size
        if nelem <= page:
            r.verify(dp, at + nelem * width, "extensible array data block")
            self._put(first, *self._elements(r.mm[at : at + nelem * width], nelem, width, filtered))
            return
        r.verify(dp, at, "extensible array data block")
        at += 4
        for i in range(nelem // page):
            if pages is not None:
                bitmap, bit = pages
                if not bitmap[(bit + i) // 8] & (0x80 >> ((bit + i) % 8)):
                    continue
            p = at + i * (page * width + 4)
            r.verify(p, p + page * width, "extensible array data block page")
            self._put(first + i * page, *self._elements(r.mm[p : p + page * width], page, width,
                                                        filtered))

    def _btree2(self):
        """A v2 B-tree of chunk records: address, (for filtered chunks) size
        and filter mask, then the chunk's coordinates in chunks."""
        O, rank = self.r.O, len(self.chunk)
        for rec in self.r.btree2(self.address):
            scaled = struct.unpack_from(f"<{rank}Q", rec, len(rec) - 8 * rank)
            offset = tuple(s * c for s, c in zip(scaled, self.chunk))
            if len(rec) == O + 8 * rank:
                self._index[offset] = (_le(rec, 0, O), self.chunk_bytes, 0)
            else:
                end = len(rec) - 8 * rank
                self._index[offset] = (_le(rec, 0, O), _le(rec, O, end - 4 - O), _le(rec, end - 4, 4))

    # -- chunked: the reads

    def _chunk(self, offset: Tuple[int, ...]) -> Optional[np.ndarray]:
        """One chunk's elements, or None where none was written."""
        if self._last[0] == offset:
            return self._last[1]
        entry = self._chunk_index().get(offset)
        if entry is None:
            return None
        addr, size, mask = entry
        dt = self.stored
        active = _active(self.filters, mask)
        if self.skip_edge_filters and any(o + c > n for o, c, n in zip(offset, self.chunk, self.shape)):
            active = []
        pos = self.r.addr(addr)
        if not active:
            return np.ndarray(self.chunk, dt, buffer=self.r.mm, offset=pos)
        t0 = time.perf_counter()
        raw = _defilter(bytes(self.r.mm[pos : pos + size]), active, dt.itemsize, self.chunk_bytes,
                        self.where)
        count = int(np.prod(self.chunk, dtype=np.int64))
        arr = np.frombuffer(raw, dt, count=count).reshape(self.chunk + self._sub)
        self._decode_s += time.perf_counter() - t0
        self._last = (offset, arr)
        return arr

    def _chunked(self, rows: np.ndarray) -> np.ndarray:
        """The rows at the 1-D indices `rows`, a band of chunks along the
        first axis at a time: each chunk of the band is read (and decoded)
        once, its rows gathered by a fancy index into a temporary, and the
        temporary scattered to their places in the result, two copies."""
        shape = (len(rows),) + tuple(self.shape[1:])
        out = self.filled(shape)
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


def _extfile_prefix(path: str) -> Optional[str]:
    """The directory that external raw data files' relative names are read
    against (H5D__build_file_prefix): HDF5_EXTFILE_PREFIX, "${ORIGIN}" at
    its start standing for the directory of the file at `path`; None (the
    working directory) where it is unset, "" or ".". HDF5 reads the
    variable when the library starts; this reader, when a dataset opens."""
    prefix = os.environ.get("HDF5_EXTFILE_PREFIX", "")
    if prefix in ("", "."):
        return None
    if prefix.startswith("${ORIGIN}"):
        prefix = os.path.dirname(os.path.abspath(path)) + "/" + prefix[len("${ORIGIN}") :]
    return prefix


class _External:
    """Raw data in external files: the dataset's bytes are its slots'
    bytes concatenated, each slot a range of a file that is read through
    a memory map. A file that cannot be opened raises OSError when it is
    first read, as in HDF5; bytes past a file's end read as zeros."""

    def __init__(self, layout: "_StoredLayout", b: bytes):
        r = layout.r
        self.where = layout.where
        if b[0] != 1:
            raise NotImplementedError(f"{layout.where}: external file list message version {b[0]}")
        used, names = _le(b, 6, 2), r.local_heap(_le(b, 8, r.O))
        prefix = _extfile_prefix(r.path)
        top = (1 << (8 * r.L)) - 1  # H5F_UNLIMITED: the rest of the file
        # (first dataset byte, past its last, file, offset in the file) per slot
        self.slots: List[Tuple[int, int, str, int]] = []
        start, at = 0, 8 + r.O
        for _ in range(used):
            name_at, offset, size = (_le(b, at + i * r.L, r.L) for i in range(3))
            at += 3 * r.L
            name = r.string(names + name_at)
            path = name if prefix is None or os.path.isabs(name) else os.path.join(prefix, name)
            end = 1 << 62 if size == top else start + size
            self.slots.append((start, end, path, offset))
            start = end
        self._maps: Dict[str, Tuple[Optional[mmap.mmap], int]] = {}
        r.closers.append(self.close)

    def _map(self, path: str) -> Tuple[Optional[mmap.mmap], int]:
        if path not in self._maps:
            try:
                fh = open(path, "rb")
            except OSError as e:
                raise OSError(f"{self.where}: unable to open external raw data file {path!r}") from e
            with fh:
                size = os.fstat(fh.fileno()).st_size
                self._maps[path] = (mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) if size else None,
                                    size)
        return self._maps[path]

    def read(self, rows: np.ndarray, row_bytes: int) -> np.ndarray:
        """The bytes of the rows at the 1-D `rows`, (len(rows), row_bytes)
        uint8: the rows that lie whole in a slot through one view of its
        file's map, those across a slot's or its file's end byte by byte."""
        out = np.zeros((len(rows), row_bytes), np.uint8)
        low, high = rows * row_bytes, (rows + 1) * row_bytes
        for start, end, path, offset in self.slots:
            hit = (low < end) & (high > start)
            if not row_bytes or not hit.any():
                continue
            mm, size = self._map(path)
            held = min(end, start + max(0, size - offset))  # past the bytes the file holds
            whole = hit & (low >= start) & (high <= held)
            if whole.any():
                first = -(-start // row_bytes)  # the first row wholly in the slot
                view = np.ndarray((held // row_bytes - first, row_bytes), np.uint8, buffer=mm,
                                  offset=offset + first * row_bytes - start)
                out[whole] = view[rows[whole] - first]
            for i in np.flatnonzero(hit & ~whole & (low < held)).tolist():
                a, z = max(int(low[i]), start), min(int(high[i]), held)
                out[i, a - low[i] : z - low[i]] = np.frombuffer(mm, np.uint8, count=z - a,
                                                                offset=offset + a - start)
        return out

    def close(self):
        for mm, _ in self._maps.values():
            if mm is not None:
                mm.close()
        self._maps.clear()


def _has_printf(name: str) -> bool:
    return "%b" in name.replace("%%", "")


def _printf(name: str, block: int) -> str:
    """A printf-named source's name for `block`: "%b" its number, "%%" a %."""
    return re.sub("%([%b])", lambda m: "%" if m.group(1) == "%" else str(block), name)


def _clip_extent(dim, slices: int) -> int:
    """The extent along an unlimited axis at which a regular hyperslab's
    (start, stride, count, block) there takes `slices` coordinates
    (H5S__hyper_get_clip_extent_real, the last available source's view)."""
    start, stride, _, block = dim
    if not slices:
        return 0
    if block is None or block == stride:
        return start + slices
    full, rest = divmod(slices, block)
    return start + full * stride + rest if rest else start + (full - 1) * stride + block


class _Part(NamedTuple):
    """A mapping of a virtual dataset with its source opened: rows onto
    rows (`vrows`, `srows`) where both selections take whole rows of the
    same size, else flat element indices (`vflat`, `sflat`)."""

    source: "_StoredLayout"
    vrows: Optional[np.ndarray]
    srows: Optional[np.ndarray]
    vflat: Optional[np.ndarray]
    sflat: Optional[np.ndarray]


class _Virtual:
    """A virtual dataset (layout class 3): its mappings, each a source
    dataset's selection mapped element for element, in HDF5's order, onto
    a selection of this dataset, from the global heap object that the
    layout names (version 0: the count, then per mapping the source file
    and dataset names and the source and virtual selections, then a
    lookup3 checksum). Each source is read through its own layout. An
    unlimited mapping is clipped to its source's extent and a printf one
    takes blocks 0, 1, ... while their sources exist; the dataset's
    extent along that axis is then the largest the mappings reach (HDF5's
    view of the last available source)."""

    def __init__(self, layout: "_StoredLayout", blob: bytes):
        self.layout = layout
        r, where = layout.r, layout.where
        if blob[0] != 0:
            raise NotImplementedError(f"{where}: virtual dataset mappings of encoding version {blob[0]}")
        if len(blob) < 5 or lookup3(blob[:-4]) != _le(blob, len(blob) - 4, 4):
            raise OSError(f"{where}: virtual dataset mappings: checksum mismatch")
        count, at = _le(blob, 1, r.L), 1 + r.L
        self.mappings: List[Tuple[str, str, _Selection, _Selection]] = []
        for _ in range(count):
            names = []
            for _ in range(2):
                end = blob.index(b"\0", at)
                names.append(blob[at:end].decode("utf-8"))
                at = end + 1
            source, at = _selection(blob, at)
            virtual, at = _selection(blob, at)
            self.mappings.append((names[0], names[1], source, virtual))
        self._sources: Dict[Tuple[str, str], Optional[_StoredLayout]] = {}
        self._plan: Optional[List[tuple]] = None
        self._parts: Optional[List[_Part]] = None
        if any(v.unlimited_axis() is not None for *_, v in self.mappings):
            self._plan_mappings()  # the extent depends on the sources'

    def _source(self, filename: str, name: str) -> Optional["_StoredLayout"]:
        """A source dataset's layout; None where its file or dataset is
        missing."""
        key = (filename, name)
        if key not in self._sources:
            f = self.layout.r.file._vds_source(filename)
            ds = f.get(name) if f is not None else None
            self._sources[key] = ds._layout if isinstance(ds, Dataset) else None
        return self._sources[key]

    def _plan_mappings(self):
        """Each mapping's (virtual selection, the limits of its coordinates,
        source layout, source selection, its limits), printf mappings a
        block each, and the extent they give the dataset."""
        layout = self.layout
        shape = list(layout.shape)
        plan, clips = [], {}
        for filename, name, ssel, vsel in self.mappings:
            d = vsel.unlimited_axis()
            if d is None:
                plan.append((vsel, None, self._source(filename, name), ssel, None))
                continue
            start, stride, _, block = vsel.dims[d]
            if _has_printf(filename) or _has_printf(name):
                j = 0
                while (src := self._source(_printf(filename, j), _printf(name, j))) is not None:
                    dims = list(vsel.dims)
                    dims[d] = (start + j * stride, 1, 1, block)
                    plan.append((vsel._replace(dims=tuple(dims)), None, src, ssel, None))
                    j += 1
                clip = start + (j - 1) * stride + block if j else 0
            else:
                sd = ssel.unlimited_axis()
                if sd is None:
                    raise NotImplementedError(
                        f"{layout.where}: an unlimited virtual selection over a limited source selection")
                src = self._source(filename, name)
                n = len(ssel.axis(sd, src.shape[sd])) if src is not None else 0
                clip = _clip_extent(vsel.dims[d], n)
                plan.append((vsel, (d, n), src, ssel, (sd, n)))
            clips[d] = max(clips.get(d, 0), clip)
        for d, clip in clips.items():  # the fixed mappings' reach is the least extent
            shape[d] = max([clip] + [v.bounds(shape)[d] for v, lim, *_ in plan if lim is None
                                     and v.unlimited_axis() is None])
        self._plan = []
        for vsel, vlim, src, ssel, slim in plan:
            if src is None:
                continue
            vlimits, slimits = list(shape), list(src.shape)
            if vlim is not None:  # the first n slices of each, n those the source holds
                (d, n), (sd, _) = vlim, slim
                vlimits[d] = int(vsel.axis(d, shape[d])[n - 1]) + 1 if n else 0
                slimits[sd] = int(ssel.axis(sd, src.shape[sd])[n - 1]) + 1 if n else 0
            self._plan.append((vsel, tuple(vlimits), src, ssel, tuple(slimits)))
        layout.shape = tuple(shape)

    def parts(self) -> List[_Part]:
        if self._parts is None:
            if self._plan is None:
                self._plan_mappings()
            shape = tuple(self.layout.shape)
            self._parts = []
            for vsel, vlimits, src, ssel, slimits in self._plan:
                vrows, srows = vsel.rows(vlimits), ssel.rows(slimits)
                if (vrows is not None and srows is not None
                        and np.prod(shape[1:], dtype=np.int64) == np.prod(src.shape[1:], dtype=np.int64)):
                    got, want = len(srows), len(vrows)
                    part = _Part(src, vrows, srows, None, None)
                else:
                    v = np.ravel_multi_index(tuple(vsel.coords(vlimits).T), shape)
                    s = np.ravel_multi_index(tuple(ssel.coords(slimits).T), src.shape)
                    got, want = len(s), len(v)
                    part = _Part(src, None, None, v, s)
                if got != want:
                    raise OSError(f"{self.layout.where}: a mapping's source selection holds {got} "
                                  f"{'rows' if part.vrows is not None else 'elements'}, its virtual "
                                  f"selection {want}")
                self._parts.append(part)
        return self._parts

    def decode_seconds(self) -> float:
        return sum(src.decode_seconds for src in {id(p.source): p.source for p in self.parts()}.values())

    def read(self, rows: np.ndarray) -> np.ndarray:
        """The rows at `rows`: each distinct row once, filled, then each
        mapping's elements over it in the mappings' order."""
        layout = self.layout
        shape = tuple(layout.shape)
        uniq, inverse = np.unique(rows.reshape(-1), return_inverse=True)
        out = layout.type.to_h5py(layout.filled((len(uniq),) + shape[1:]), layout.r, False)
        flat = out.reshape(len(uniq), int(np.prod(out.shape[1:], dtype=np.int64)))
        for p in self.parts() if len(uniq) else []:
            if p.vrows is not None:
                if not len(p.vrows):
                    continue
                i = np.minimum(np.searchsorted(p.vrows, uniq), len(p.vrows) - 1)
                hit = p.vrows[i] == uniq
                if hit.any():
                    flat[hit] = p.source.read(p.srows[i[hit]]).reshape(int(hit.sum()), -1)
                continue
            vr, vc = np.divmod(p.vflat, flat.shape[1])
            i = np.minimum(np.searchsorted(uniq, vr), len(uniq) - 1)
            hit = uniq[i] == vr
            if not hit.any():
                continue
            sr, sc = np.divmod(p.sflat[hit], np.prod(p.source.shape[1:], dtype=np.int64))
            su, sinv = np.unique(sr, return_inverse=True)
            flat[i[hit], vc[hit]] = p.source.read(su).reshape(len(su), -1)[sinv, sc]
        return out[inverse].reshape(rows.shape + out.shape[1:])


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
    """A group of named members, each a Group, a Dataset or a Datatype."""

    _addr: Optional[int] = None  # the object header's address, in a file read

    def __init__(self, name: str, attrs: Dict, reader: Optional[_Reader] = None,
                 links=None, writer: Optional["_Writer"] = None):
        self.name = name
        self.attrs = AttributeManager(attrs, writable=writer is not None)
        self._reader, self._links, self._writer = reader, links, writer
        self._members: Optional[Dict] = None if reader is not None else {}

    def _table(self) -> Dict:
        if self._members is None:
            self._members = self._reader.members(self._links)
        return self._members

    def _child(self, name: str, hops: int = 0):
        item = self._table()[name]
        if isinstance(item, int):  # an object header not yet opened
            path = f"{self.name.rstrip('/')}/{name}"
            item = self._table()[name] = self._reader.open(item, path)
        elif isinstance(item, (_SoftLink, _ExternalLink)):
            if hops >= _MAX_LINK_HOPS:
                raise KeyError(f"{name!r} in {self.name!r}: too many links")
            if isinstance(item, _SoftLink):  # a path from this group, or from the root
                return self._lookup(item.path, hops + 1)
            return self._reader.file._external(item.filename)._lookup(item.path, hops + 1)
        return item

    def _lookup(self, path: str, hops: int = 0):
        node = self._reader.file if path.startswith("/") and self._reader is not None else self
        for part in [p for p in path.split("/") if p and p != "."]:
            if not isinstance(node, Group) or part not in node._table():
                raise KeyError(f"{path!r} not in {self.name!r}")
            node = node._child(part, hops)
        return node

    def __getitem__(self, path):
        """The member at a path, or the object a Reference points to."""
        if isinstance(path, Reference):
            return self._reader.file._deref(path)
        return self._lookup(path)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._table())

    def keys(self) -> List[str]:
        if self._reader is not None:  # in h5py's order already
            return list(self._table())
        return sorted(self._table(), key=lambda n: n.encode("utf-8"))

    def items(self):
        """(name, member) pairs; a member a link does not reach is None,
        as in h5py."""
        return [(n, self.get(n)) for n in self.keys()]
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
    `[()]`, a slice, an integer or an integer array on the first axis, or
    a RegionReference to it."""

    _addr: Optional[int] = None

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
        if isinstance(key, RegionReference):
            if not key or key.address != self._addr:
                raise ValueError("Region reference must point to this dataset")
            return layout.region(key.selection)
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




class Datatype:
    """A committed (named) datatype: its `dtype` as h5py gives it, and its
    attributes."""

    _addr: Optional[int] = None

    def __init__(self, name: str, attrs: Dict, dtype: np.dtype):
        self.name, self.dtype = name, dtype
        self.attrs = AttributeManager(attrs, writable=False)


def _external_paths(filename: str, parent: str) -> List[str]:
    """Where HDF5 looks for an external link's file (H5F_prefix_open_file,
    without the HDF5_EXT_PREFIX search path): an absolute name as it is,
    then the name, or an absolute name's last part, in the directory of
    the file that holds the link, then in the working directory."""
    out = [filename] if os.path.isabs(filename) else []
    base = os.path.basename(filename) if out else filename
    return out + [os.path.join(os.path.dirname(os.path.abspath(parent)), base), base]


class File(Group):
    """An HDF5 file: its root group. mode "r" reads an existing file, "w"
    creates one (truncating); the file is written in full at close."""

    def __init__(self, path, mode: str = "r"):
        path = os.fspath(path)
        self.filename, self.mode = path, mode
        self._externals: Dict[str, "File"] = {}  # the files external links opened
        self._sources: Dict[str, Optional["File"]] = {}  # virtual datasets' source files
        self._paths: Optional[Dict[int, str]] = None  # object address: the path references name
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
            r.file = self
        elif mode == "w":
            super().__init__("/", {}, writer=_Writer(path))
        else:
            raise ValueError(f"mode {mode!r}: only 'r' and 'w' are supported")

    def _external(self, filename: str) -> "File":
        if filename not in self._externals:
            found = next((p for p in _external_paths(filename, self.filename) if os.path.isfile(p)),
                         None)
            if found is None:
                raise KeyError(f"{self.filename}: external link to {filename!r}: no such file")
            self._externals[filename] = File(found)
        return self._externals[filename]

    def _vds_source(self, filename: str) -> Optional["File"]:
        """A virtual dataset's source file: "." this one; else found where
        HDF5 looks for it, as for an external link's file; None where
        there is none."""
        if filename == ".":
            return self
        if filename not in self._sources:
            found = next((p for p in _external_paths(filename, self.filename) if os.path.isfile(p)),
                         None)
            self._sources[filename] = File(found) if found else None
        return self._sources[filename]

    def _path_of(self, addr: int) -> Optional[str]:
        """The path HDF5 names an object reached through a reference by
        (H5G_get_name_by_addr): its first hard link in a depth-first visit
        of the groups from the root, each group's links in native order."""
        if self._paths is None:
            r = self._reader
            self._paths = {r.root: "/"}

            def visit(links, prefix):
                for name, target in r.members(links, native=True).items():
                    if isinstance(target, int) and target not in self._paths:
                        self._paths[target] = f"{prefix}/{name}"
                        sub = r.group_links(r.messages(target))
                        if sub is not None:
                            visit(sub, f"{prefix}/{name}")

            visit(self._links, "")
        return self._paths.get(addr)

    def _deref(self, ref: Reference):
        if not ref:
            raise ValueError("Invalid HDF5 object reference")
        path = self._path_of(ref.address)
        if path is not None:
            return self[path]
        return self._reader.open(ref.address, None)  # linked from nowhere: no name, as in h5py

    def close(self):
        for f in list(self._externals.values()) + [f for f in self._sources.values() if f is not None]:
            f.close()
        self._externals.clear()
        self._sources.clear()
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
    ieee = {t[0]: t[3] for t in _FLOAT_TARGETS if t[3].implied}  # half, single, double
    if dtype.kind == "f" and size in ieee:
        f = ieee[size]
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20 | order, f.sign, 0, size,
                           0, 8 * size, f.epos, f.esize, f.mpos, f.msize, f.bias)
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
