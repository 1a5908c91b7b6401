"""Committed test data of the port, and the means to check it.

`hdf5/` holds small HDF5 files that h5py wrote in the formats the JAX
package reads through h5py and the port reads through its own
`convnet_tpu_torch/hdf5.py`:
- `formats_latest.h5`: libver "latest" files, dense links and attributes,
  every chunk index, the lzf, fletcher32, scaleoffset and nbit filters,
  enum, compound and variable-length types;
- `cifar10_train_latest.h5` and `cifar10_mean_latest.h5`: a CIFAR-10
  shard and its mean file for the CIFAR-10 data template;
  `checkpoint_latest.h5`: a checkpoint with dense links;
- `references_latest.h5` and `references_earliest.h5`: a dataset with a
  dimension scale attached and its axes labelled, object and region
  references (hyperslabs regular and not, points, all, none, null) in
  attributes and datasets;
- `vds.h5` over the uint8 shards `vds_shard{0,1,2}.h5` beside it: an
  unmapped band, a strided mapping, a source file that is missing,
  blocks of part rows, and a source in its own file ("."); `vds_printf.h5`:
  an unlimited printf mapping over `vds_shard%b.h5` and an unlimited
  strided one; `cifar10_vds.h5`: "data" and "labels" over
  `cifar10_half{0,1}.h5`, which are not here (they read as fill values;
  chip_smoke.py and the tests write them from the CIFAR-10 shard);
- `external.h5` over `external_0.bin` and `external_1.bin` (raw data in
  external files, named relative to it);
- `szip.h5`: szip chunks, NN and EC, int8 to int32 and float32 in both
  byte orders, 24- and 12-bit integers, edge chunks; `cifar10_szip.h5`:
  a CIFAR-10 shard through szip;
- shared object header messages: `sohm_list.h5` (superblock 2, two list
  indexes: dataspaces and datatypes, then fill values, pipelines and
  attributes), `sohm_btree.h5` (superblock 3, one index of every type
  past its phase change to a v2 B-tree, dense attributes shared), both
  with chunked datasets of one dataspace, datatype, fill value and
  pipeline, a committed datatype and the same attributes on every
  object; `cifar10_sohm.h5`: the CIFAR-10 shard's first 128 rows with
  every message type shared, filters kept, as `h5repack --ssize` leaves
  a file;
- `filtered_heap.h5`: groups whose dense links lie in a fractal heap
  through deflate (and fletcher32), under indirect blocks, with a
  60,000-character soft link (a filtered huge object);
- `floats.h5`: non-IEEE floats in both byte orders: every bfloat16 and
  fp8 (e4m3) pattern, a 4-byte float of a 7-bit exponent and a 24-bit
  mantissa, an 8-byte one of bias 1000 (long double in h5py), a stored
  leading bit, a precision from bit 2, a float marked VAX-order in a
  version 1 message (read big-endian), bfloat16 in a compound and an
  attribute, and long double as numpy holds it.
`hdf5/digests.json` holds, for each dataset of each file, the sha256 of
its elements, its dtype and its shape as h5py read them (a reference by
its object's name: `dereferencer`). `tests/torch_port_hdf5_fixtures.py`
writes both (it needs h5py); `check_hdf5_fixtures` reads every file with
the port's reader (no h5py) and holds each dataset to its digest.

`jpeg/` holds small JPEGs of every kind the JPEG loader's decoder
(`convnet_tpu_torch/native/jpeg_decode.h`) covers: 4:4:4, 4:2:2 and 4:2:0,
progressive, optimized tables, restart markers, gray, Adobe RGB, quality
100 and all-ones tables (PIL wrote them), odd sampling factors such as
4:1:1 and h1v2 and arithmetic coding (libjpeg's encoder), files cut in
half, and three that libjpeg refuses (a CMYK JPEG, a PNG and random
bytes). `jpeg/digests.json` holds, for each file, colour count and
min_side (the loader's DCT-scale rule: 0, 4, 8 and 16 reach the scales 1/1
to 1/8 on these sizes), the sha256, dtype and shape of libjpeg-turbo's
decode, or null where libjpeg refuses the file.
`tests/torch_port_jpeg_fixtures.py` writes both (it needs g++ -ljpeg);
`check_jpeg_fixtures` decodes every file with the port's decoder (no
libjpeg, no PIL) and holds each decode to its digest.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

HDF5_DIR = Path(__file__).resolve().parent / "hdf5"
HDF5_DIGESTS = HDF5_DIR / "digests.json"
# the CIFAR-10 shard: 256 rows of 32x32x3 uint8 images and int32 labels,
# chunked a row a chunk (an extensible-array index), lzf + shuffle +
# fletcher32; and its full-pixel mean and std
CIFAR_SHARD = HDF5_DIR / "cifar10_train_latest.h5"
CIFAR_MEAN = HDF5_DIR / "cifar10_mean_latest.h5"
JPEG_DIR = Path(__file__).resolve().parent / "jpeg"
JPEG_DIGESTS = JPEG_DIR / "digests.json"


def _update(h, arr: np.ndarray, deref: Optional[Callable] = None):
    if arr.dtype.names:  # field by field, so that padding bytes do not count
        for name in arr.dtype.names:
            _update(h, arr[name], deref)
    elif arr.dtype.hasobject:
        for x in arr.reshape(-1):
            b = None if deref is None else deref(x)
            if b is None and isinstance(x, np.ndarray) and x.dtype.hasobject:
                b = bytes.fromhex(digest(x, deref))  # a sequence of references
            elif b is None:
                b = x if isinstance(x, bytes) else np.ascontiguousarray(x).tobytes()
            h.update(struct.pack("<Q", len(b)))
            h.update(b)
    else:
        h.update(np.ascontiguousarray(arr).tobytes())


def digest(arr, deref: Optional[Callable] = None) -> str:
    """The sha256 of an array's elements: their bytes in C order, a
    structured array's field by field; an object array's elements each as
    its bytes (a bytes object, an array's C-order bytes, a reference's
    `deref` bytes, an object array's digest) after its length as 8
    little-endian bytes."""
    h = hashlib.sha256()
    _update(h, np.asarray(arr), deref)
    return h.hexdigest()


def describe(arr, deref: Optional[Callable] = None) -> Dict:
    arr = np.asarray(arr)
    return {"sha256": digest(arr, deref), "dtype": str(arr.dtype), "shape": list(arr.shape)}


def dereferencer(f, reference: type, region: type) -> Callable:
    """`deref` for a file `f` whose references are of class `reference`
    (region references `region`), h5py's or the port's alike: a
    reference's bytes are its object's name, a region reference's that
    and the digest of what it selects, a null one's none; None for a
    value that is not a reference."""

    def deref(x) -> Optional[bytes]:
        if not isinstance(x, reference):
            return None
        if not x:
            return b""
        obj = f[x]
        return (obj.name or "").encode() + (digest(obj[x]).encode() if isinstance(x, region) else b"")

    return deref


def datasets(group, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, dataset) of every dataset that the group's links reach, in
    the group's key order, groups entered depth first: an h5py group or
    the port's, alike (a link that reaches nothing is skipped)."""
    for name in group.keys():
        item = group.get(name)
        path = f"{prefix}/{name}"
        if hasattr(item, "keys"):
            yield from datasets(item, path)
        elif hasattr(item, "shape"):
            yield path, item


def check_hdf5_fixtures() -> Tuple[int, int, List[str]]:
    """Every committed fixture read with the port's reader: (datasets
    checked, bytes of their elements, what differs from the digests).
    External raw data files are named relative to the file that names
    them, so they are read with HDF5_EXTFILE_PREFIX="${ORIGIN}" (the
    variable is restored after)."""
    from convnet_tpu_torch import hdf5

    want = json.loads(HDF5_DIGESTS.read_text())
    count, nbytes, problems = 0, 0, []
    before = os.environ.get("HDF5_EXTFILE_PREFIX")
    os.environ["HDF5_EXTFILE_PREFIX"] = "${ORIGIN}"
    try:
        for name, entries in want.items():
            count, nbytes = _check_hdf5_file(hdf5, name, entries, count, nbytes, problems)
    finally:
        if before is None:
            del os.environ["HDF5_EXTFILE_PREFIX"]
        else:
            os.environ["HDF5_EXTFILE_PREFIX"] = before
    return count, nbytes, problems


def _check_hdf5_file(hdf5, name: str, entries: Dict, count: int, nbytes: int, problems: List[str]):
    with hdf5.File(HDF5_DIR / name) as f:
        deref = dereferencer(f, hdf5.Reference, hdf5.RegionReference)
        got = {}
        for path, ds in datasets(f):
            arr = np.asarray(ds[()])
            got[path] = describe(arr, deref)
            nbytes += arr.nbytes
        if list(got) != list(entries):
            problems.append(f"{name}: datasets {list(got)}, digests of {list(entries)}")
        for path, entry in entries.items():
            count += 1
            if got.get(path) != entry:
                problems.append(f"{name}{path}: read {got.get(path)}, digest {entry}")
    return count, nbytes


def check_jpeg_fixtures() -> Tuple[int, int, List[str]]:
    """Every committed JPEG decoded by the port's loader at each colour
    count and min_side of the digests: (decodes checked, bytes decoded,
    what differs from the digests). A refusal matches a null digest."""
    from convnet_tpu_torch.data import native

    want = json.loads(JPEG_DIGESTS.read_text())
    count, nbytes, problems = 0, 0, []
    for name, entries in want.items():
        for key, entry in entries.items():
            colors, min_side = (int(part.split("=")[1]) for part in key.split())
            arr = native.jpeg_decode_file(str(JPEG_DIR / name), colors, min_side)
            got = None if arr is None else describe(arr)
            count += 1
            nbytes += 0 if arr is None else arr.nbytes
            if got != entry:
                problems.append(f"{name} {key}: decoded {got}, digest {entry}")
    return count, nbytes, problems
