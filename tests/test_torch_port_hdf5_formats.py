"""The port's HDF5 reader (convnet_tpu_torch/hdf5.py) against h5py on every
format that h5py writes, and so that the JAX package reads: libver
"latest" files (superblock 2 and 3, version 2 object headers, checksums),
groups of link messages (compact and dense; hard, soft and external links;
creation order), dense attributes, data layout messages 1 to 4 with every
chunk index, virtual datasets, raw data in external files, the lzf,
szip, fletcher32, scaleoffset and nbit filters, and the enum, compound,
array, opaque, bitfield, variable-length, reference and committed
datatypes.

Each case has h5py write a file, then holds the port's read to h5py's,
from the file's directory and from another working directory: keys and
their order, attributes, shapes, dtypes (their h5py metadata too) and
values array-equal, whole and by rows (sorted, unsorted and repeated
indices, also through np.unique as the JAX HDF5Stream takes them); a
reference by the name of the object it opens (and a region reference by
what it selects); a read that h5py fails with OSError (external raw data
named relative to a directory that is not the working one) fails so in
the port too. Then the JAX package's checkpoint.load and HDF5Stream
against the port's on the same libver "latest" files, corrupted
checksums, and the committed fixtures read with h5py blocked.
"""

import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import torch_port_hdf5_fixtures as fx  # noqa: E402

from convnet_tpu import checkpoint as jax_ckpt  # noqa: E402
from convnet_tpu import config as jax_config  # noqa: E402
from convnet_tpu.data import datahandler as jax_datahandler  # noqa: E402
from convnet_tpu_torch import checkpoint as ckpt  # noqa: E402
from convnet_tpu_torch import config as pt_config  # noqa: E402
from convnet_tpu_torch import hdf5  # noqa: E402
from convnet_tpu_torch import testdata  # noqa: E402
from convnet_tpu_torch.data import datahandler  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _x(dtype="u1", shape=(37, 6, 10), seed=0):
    """37 rows: chunks of 5 or 8 rows leave a partial edge chunk."""
    return np.random.default_rng(seed).integers(0, 255, shape).astype(dtype)


# -- the comparison ----------------------------------------------------------------

# the files being compared (the port's, h5py's): references open in them
_OPEN = []
# (path, error type) of each dataset read that failed alike in both
_FAILED_READS = []
_REFERENCE_TYPES = {hdf5.Reference: h5py.Reference, hdf5.RegionReference: h5py.RegionReference}


def _metadata(dtype):
    """A dtype's metadata with the port's reference classes as h5py's."""
    meta = dtype.metadata
    if meta and "ref" in meta:
        return dict(meta, ref=_REFERENCE_TYPES.get(meta["ref"], meta["ref"]))
    return meta


def _same_reference(got, want, what):
    """A reference of the same kind, null where h5py's is, opening an
    object of the same name; a region reference selecting the same."""
    region = isinstance(want, h5py.RegionReference)
    assert isinstance(got, hdf5.RegionReference if region else hdf5.Reference), (what, type(got))
    assert isinstance(got, hdf5.RegionReference) == region, what
    assert bool(got) == bool(want), what
    if want:
        mine, theirs = _OPEN[-1]
        a, b = mine[got], theirs[want]
        assert a.name == b.name, (what, a.name, b.name)
        if region:
            _same(a[got], b[want], f"{what} region")


def _same(got, want, what):
    """Values as h5py gives them: the same type, and for arrays the same
    shape, dtype (with h5py's metadata) and elements."""
    if isinstance(want, h5py.Empty):
        assert got is None, what
        return
    if isinstance(want, h5py.Reference):
        _same_reference(got, want, what)
        return
    assert type(got) is type(want), (what, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
        assert _metadata(got.dtype) == want.dtype.metadata, (what, got.dtype.metadata)
    if isinstance(want, np.ndarray) and want.dtype.names and want.dtype.hasobject:
        for name in want.dtype.names:  # a compound holding references
            _same(got[name], want[name], f"{what}.{name}")
    elif isinstance(want, np.ndarray) and want.dtype.hasobject:
        for g, w in zip(got.reshape(-1), want.reshape(-1)):
            _same(g, w, what)
    elif isinstance(want, (np.ndarray, np.generic)):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _same_attrs(mine, theirs, what):
    assert list(mine.attrs) == list(theirs.attrs), what
    for key in theirs.attrs:
        _same(mine.attrs[key], theirs.attrs[key], f"{what} attribute {key}")


def _same_rows(a, b, what):
    """Row reads: unsorted with repeats, the same through np.unique (as
    the JAX HDF5Stream.read_rows takes them), sorted, and a slice."""
    n = b.shape[0]
    idx = np.concatenate([np.random.default_rng(n).integers(0, n, min(3 * n, 60)), [n - 1, 0, n - 1]])
    uniq, inverse = np.unique(idx, return_inverse=True)
    want = b[uniq][inverse]
    _same(a[idx], want, f"{what} rows")
    _same(a[uniq][inverse], want, f"{what} rows through np.unique")
    _same(a[np.sort(idx)], want[np.argsort(idx, kind="stable")], f"{what} sorted rows")
    _same(a[1 : n - 1], b[1 : n - 1], f"{what} slice")


def _same_tree(mine, theirs, what=""):
    """Keys in order, attributes, and every member the links reach."""
    assert list(mine.keys()) == list(theirs.keys()), what
    _same_attrs(mine, theirs, what or "/")
    for name in theirs.keys():
        path = f"{what}/{name}"
        want, got = theirs.get(name), mine.get(name)
        if want is None:
            assert got is None and name not in mine, path
        elif isinstance(want, h5py.Group):
            assert isinstance(got, hdf5.Group), path
            _same_tree(got, want, path)
        elif isinstance(want, h5py.Datatype):
            assert isinstance(got, hdf5.Datatype) and got.dtype == want.dtype, path
            _same_attrs(got, want, path)
        else:
            assert isinstance(got, hdf5.Dataset), path
            assert got.shape == want.shape and got.dtype == want.dtype, (path, got.dtype, want.dtype)
            assert _metadata(got.dtype) == want.dtype.metadata, path
            _same_attrs(got, want, path)
            values, error = _read(got), _read(want)
            assert values[1] is error[1], (path, values[1], error[1])
            if error[1] is not None:
                _FAILED_READS.append((path, error[1]))
                continue
            _same(values[0], error[0], path)
            if want.ndim and want.shape[0]:
                _same_rows(got, want, path)


def _read(ds):
    """(the dataset's elements, None), or (None, OSError) where reading
    fails so, as h5py's does for external raw data it cannot open."""
    try:
        return ds[()], None
    except OSError:
        return None, OSError


def _same_file(path):
    with hdf5.File(path) as mine, h5py.File(path, "r") as theirs:
        _OPEN.append((mine, theirs))
        try:
            _same_tree(mine, theirs)
        finally:
            _OPEN.pop()
        return mine._reader.mm[mine._reader.addr(0) + 8]  # the superblock's version


# -- the cases: each has h5py write a file --------------------------------------


def _latest(path, libver="latest"):
    with h5py.File(path, "w", libver=libver) as f:
        f.attrs["step"] = 3
        f.attrs["name"] = "latest é"
        f.attrs["vector"] = np.arange(4, dtype=">i2")
        f.attrs["empty"] = h5py.Empty("f4")
        f.create_dataset("contiguous", data=_x("<f4") / 7)
        f.create_dataset("big_endian", data=_x(">i4") - 99)
        f.create_dataset("scalar", data=1.5)
        f.create_dataset("empty", data=np.zeros((0, 3), "i2"))
        f.create_dataset("unwritten", shape=(5, 2), dtype="i4", fillvalue=-3)
        f.create_dataset("vlen_str", data=["a", "bcd", ""], dtype=h5py.string_dtype())
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        f.create_dataset("compact", data=np.arange(12, dtype="i2").reshape(6, 2), dcpl=dcpl)
        f.create_group("sub").create_dataset("x", data=np.arange(7))


def case_superblock_3(d):
    _latest(d / "f.h5")


def case_superblock_2(d):
    _latest(d / "f.h5", libver=("v108", "v108"))


def case_v2_header_in_superblock_0(d):
    """Default libver, a group with track_order: a version 2 object header
    (6-byte message headers) in a version 0 file."""
    with h5py.File(d / "f.h5", "w") as f:
        g = f.create_group("g", track_order=True)
        for name in ("zeta", "alpha", "mid"):
            g.create_dataset(name, data=np.arange(3) * len(name))
        g.attrs["b"] = 1
        g.attrs["a"] = 2.5


def case_header_times_phases_continuations(d):
    """Times in the header, non-default attribute phase changes, and
    attributes added after creation that go to OCHK continuation blocks."""
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_attr_phase_change(20, 10)
        ds = f.create_dataset("timed", data=np.arange(5.0), track_times=True, dcpl=dcpl)
        for i in range(12):
            ds.attrs[f"big{i:02d}"] = np.arange(300 + i, dtype="i4")
            f.attrs[f"r{i:02d}"] = np.full(500, i, "f8")


def case_compact_links(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        for name in ("delta", "alpha", "charlie", "bravo"):
            f.create_group(name).create_dataset("v", data=np.array([len(name)]))
        f["alpha"]["echo"] = f["delta/v"]  # a second hard link to one dataset


def case_soft_links(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        g = f.create_group("g")
        g.create_dataset("target", data=np.arange(4.0))
        g["relative"] = h5py.SoftLink("target")
        f["absolute"] = h5py.SoftLink("/g/target")
        f["to_group"] = h5py.SoftLink("/g")
        f["chain"] = h5py.SoftLink("/absolute")
        f["dangling"] = h5py.SoftLink("/nowhere")
        f["dot"] = h5py.SoftLink("./g/./target")


def case_external_links(d):
    with h5py.File(d / "other.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=_x("i2"))
        f.create_group("grp").create_dataset("y", data=np.arange(3))
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        f["ext"] = h5py.ExternalLink("other.h5", "/data")
        f["ext_group"] = h5py.ExternalLink("other.h5", "/grp")
        f["ext_absolute"] = h5py.ExternalLink(str(d / "other.h5"), "/grp/y")
        f["ext_missing"] = h5py.ExternalLink("missing.h5", "/x")


def case_dense_links(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        for i in range(40):
            f.create_dataset(f"n{(i * 17) % 40:03d}", data=np.array([i], "i4"))


def case_dense_links_creation_order(d):
    with h5py.File(d / "f.h5", "w", libver="latest", track_order=True) as f:
        for i in range(40):
            f.create_dataset(f"n{(i * 17) % 40:03d}", data=np.array([i], "i4"))
            f.attrs[f"a{(i * 7) % 40:02d}"] = i


def case_dense_links_deep(d):
    """2000 links to one dataset: a v2 B-tree with internal nodes, a
    fractal heap with indirect blocks."""
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        ds = f.create_dataset("one", data=np.arange(3))
        g = f.create_group("g")
        for i in range(2000):
            g[f"link{(i * 7919) % 2000:05d}"] = ds


def case_dense_attributes(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        ds = f.create_dataset("x", data=np.arange(3))
        for i in range(30):
            ds.attrs[f"k{(i * 11) % 30:02d}"] = [np.int64(i), f"s{i}", np.arange(i, dtype="f4")][i % 3]


def case_huge_attribute(d):
    """An attribute past the largest managed heap object: a huge object
    found through its own v2 B-tree."""
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        f.attrs["huge"] = np.arange(30000, dtype="f8")
        f.attrs["small"] = 1


def case_chunk_index_single(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        f.create_dataset("single", data=_x(), chunks=(37, 6, 10))
        f.create_dataset("single_filtered", data=_x("i4"), chunks=(37, 6, 10), compression="gzip")
        f.create_dataset("single_unwritten", shape=(4, 3), chunks=(4, 3), dtype="f4", fillvalue=2)


def case_chunk_index_implicit(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        f.create_dataset("implicit", data=_x(), chunks=(5, 4, 3), dcpl=dcpl)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        f.create_dataset("implicit_max", data=_x("i2"), chunks=(8, 4, 4), maxshape=(50, 9, 10),
                         dcpl=dcpl)


def case_chunk_index_fixed_array(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        f.create_dataset("fixed", data=_x(), chunks=(5, 4, 3))
        f.create_dataset("fixed_max", data=_x("f4"), chunks=(5, 4, 3), maxshape=(60, 6, 13))
        part = f.create_dataset("fixed_unwritten", shape=(37, 6, 10), chunks=(5, 4, 3), dtype="i2",
                                fillvalue=-5)
        part[10:20] = 7
        f.create_dataset("fixed_filtered", data=_x("i4"), chunks=(5, 4, 3), compression="gzip",
                         fletcher32=True)


def case_chunk_index_fixed_array_paged(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        ds = f.create_dataset("paged", shape=(2200,), chunks=(1,), dtype="i2", fillvalue=3)
        ds[:1500] = np.arange(1500) % 300  # the third page is never written
        f.create_dataset("paged_filtered", data=np.arange(1300, dtype="i4"), chunks=(1,),
                         compression="gzip")


def case_chunk_index_extensible_array(d):
    """300 chunks reach the super blocks; rows never written are fill."""
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        ds = f.create_dataset("grows", shape=(300, 6), maxshape=(None, 6), chunks=(1, 6), dtype="i4",
                              fillvalue=-1)
        ds[:120] = _x("i4", (120, 6))
        ds[200:290] = _x("i4", (90, 6), seed=1)
        f.create_dataset("edges", data=_x(), maxshape=(None, 6, 10), chunks=(5, 4, 3))
        f.create_dataset("axis1", data=_x("i2", (6, 37)), maxshape=(6, None), chunks=(4, 3))
        f.create_dataset("axis2", data=_x("i2", (4, 5, 37)), maxshape=(4, 5, None), chunks=(3, 2, 4))


def case_chunk_index_extensible_array_filtered(d):
    """Filtered entries: the chunk's size in a field whose width follows
    the chunk's byte size (2 bytes for 240, 3 for 96000)."""
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        f.create_dataset("small_chunks", data=_x("u1", (1100, 6, 10)), maxshape=(None, 6, 10),
                         chunks=(4, 6, 10), compression="lzf", shuffle=True, fletcher32=True)
        f.create_dataset("large_chunks", data=_x("f4", (20, 100, 240)) / 3, maxshape=(None, 100, 240),
                         chunks=(1, 100, 240), compression="gzip", shuffle=True)


def case_chunk_index_extensible_array_paged(d):
    """Past 131060 chunks a super block's data blocks are paged."""
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        ds = f.create_dataset("paged", shape=(131400,), maxshape=(None,), chunks=(1,), dtype="u1")
        ds[:131100] = np.arange(131100) % 251
        ds[131300:] = 9  # one page is left unwritten


def case_chunk_index_btree2(d):
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        f.create_dataset("deep", data=_x("i2", (200, 30)), maxshape=(None, None), chunks=(2, 3))
        f.create_dataset("filtered", data=_x("f8", (37, 20)) / 3, maxshape=(None, None), chunks=(4, 3),
                         compression="gzip", shuffle=True)
        part = f.create_dataset("unwritten", shape=(20, 20), maxshape=(None, None), chunks=(3, 3),
                                dtype="u2", fillvalue=4)
        part[5:9, 2:15] = 8


def case_partial_edge_chunks_unfiltered(d):
    """H5Pset_chunk_opts' DONT_FILTER_PARTIAL_CHUNKS (which h5py does not
    wrap; set through h5py's own libhdf5): edge chunks stored unfiltered."""
    import ctypes
    import glob

    libs = os.path.join(os.path.dirname(h5py.__file__), "..", "h5py.libs", "libhdf5-*.so*")
    lib = ctypes.CDLL(glob.glob(libs)[0])
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((5, 4, 3))
    dcpl.set_deflate(4)
    dcpl.set_fletcher32()
    assert lib.H5Pset_chunk_opts(ctypes.c_int64(dcpl.id), ctypes.c_uint(0x0002)) == 0
    with h5py.File(d / "f.h5", "w", libver="latest") as f:
        fx.low_level(f, "edges_unfiltered", h5py.h5t.STD_I16LE, _x("<i2") - 50, dcpl=dcpl)


def case_layout_versions_1_and_2(d):
    """The port's writer's file with its version 3 layout messages
    rewritten in place as versions 1 (contiguous) and 2 (chunked), which
    HDF5 before 1.6 wrote."""
    path = d / "f.h5"
    data, rows = _x("<f4") / 3, _x("i2")
    with hdf5.File(path, "w") as f:
        f.create_dataset("contiguous", data=data)
        f.create_appendable("chunked", rows.shape[1:], rows.dtype, chunk_rows=8).append(rows)
    with hdf5.File(path) as f:
        contiguous = f["contiguous"]._layout.address
        chunked = f["chunked"]._layout.address
    raw = bytearray(path.read_bytes())
    for old, new in (
            (struct.pack("<BBQQ", 3, 1, contiguous, data.nbytes),
             struct.pack("<BBB5xQI", 1, 1, 1, contiguous, 37)),
            (struct.pack("<BBBQ4I", 3, 2, 4, chunked, 8, 6, 10, 2),
             struct.pack("<BBB5xQ4I", 2, 4, 2, chunked, 8, 6, 10, 2))):
        at = raw.find(old)
        assert at > 0 and raw.find(old, at + 1) < 0
        raw[at : at + len(new)] = new
    path.write_bytes(bytes(raw))


def case_fletcher32(d):
    for libver in ("earliest", "latest"):
        with h5py.File(d / f"{libver}.h5", "w", libver=libver) as f:
            f.create_dataset("x", data=_x("<i4"), chunks=(8, 6, 10), fletcher32=True)
            f.create_dataset("odd", data=_x("u1", (37, 3, 3)), chunks=(5, 3, 3), fletcher32=True)


def case_lzf(d):
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("repeats", data=np.tile(np.arange(60, dtype="<f4"), (37, 1)), chunks=(8, 60),
                         compression="lzf")
        f.create_dataset("incompressible", data=_x(), chunks=(8, 6, 10), compression="lzf")
        f.create_dataset("shuffled", data=_x("<i8") // 7, chunks=(8, 6, 10), compression="lzf",
                         shuffle=True)
        f.create_dataset("fixture_pipeline", data=fx.cifar_images(40)[0], chunks=(1, 32, 32, 3),
                         maxshape=(None, 32, 32, 3), compression="lzf", shuffle=True, fletcher32=True)


def case_scaleoffset_integers(d):
    with h5py.File(d / "f.h5", "w") as f:
        for dtype in ("i1", "u2", "<i4", "<i8", ">i4"):
            f.create_dataset(f"auto_{dtype}", data=(_x(dtype) // 3) - (2 if dtype[-2] == "i" else 0),
                             chunks=(8, 6, 10), scaleoffset=0)
        f.create_dataset("fill", data=_x("i4") * 5, chunks=(8, 6, 10), scaleoffset=0, fillvalue=-7)
        f.create_dataset("fixed_bits", data=_x("i2") % 16, chunks=(8, 6, 10), scaleoffset=5)
        f.create_dataset("constant", data=np.full((20, 4), 9, "i4"), chunks=(8, 4), scaleoffset=0)
        f.create_dataset("wide", data=np.array([-(2**40), 2**40, 0, 5], "i8"), chunks=(4,),
                         scaleoffset=0)


def case_scaleoffset_floats(d):
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("f4_d2", data=(_x("f4") - 100) / 7, chunks=(8, 6, 10), scaleoffset=2)
        f.create_dataset("f8_d3", data=_x("f8") / 9, chunks=(8, 6, 10), scaleoffset=3)
        f.create_dataset("f4_fill", data=_x("f4") / 3, chunks=(8, 6, 10), scaleoffset=1, fillvalue=0.5)
        f.create_dataset("f8_be", data=(_x("f8") / 9).astype(">f8"), chunks=(8, 6, 10), scaleoffset=2)


def case_nbit(d):
    with h5py.File(d / "f.h5", "w") as f:
        fx.low_level(f, "i32_p12_o4", fx.reduced_int(12, 4), (_x("i4") - 128) * 3,
                     dcpl=fx.nbit_dcpl((8, 6, 10)))
        fx.low_level(f, "u16_p9", fx.reduced_int(9, 0, h5py.h5t.STD_U16LE), _x("u2") * 2,
                     dcpl=fx.nbit_dcpl((8, 6, 10)))
        fx.low_level(f, "be_p20_o7", fx.reduced_int(20, 7, h5py.h5t.STD_I32BE), _x("i4") * 999 - 9,
                     dcpl=fx.nbit_dcpl((5, 6, 10)))
        fx.low_level(f, "full_i8", h5py.h5t.STD_I8LE, _x("i1"), dcpl=fx.nbit_dcpl((8, 6, 10)))
        member = fx.reduced_int(9, 1, h5py.h5t.STD_I16LE)
        comp = h5py.h5t.create(h5py.h5t.COMPOUND, 16)
        comp.insert(b"a", 0, member)
        comp.insert(b"f", 4, h5py.h5t.IEEE_F32LE)
        comp.insert(b"arr", 8, h5py.h5t.array_create(fx.reduced_int(10, 2, h5py.h5t.STD_U16LE), (3,)))
        comp.insert(b"o", 14, h5py.h5t.STD_B8LE)
        rec = np.zeros(37, [("a", "<i2"), ("f", "<f4"), ("arr", "<u2", (3,)), ("o", "u1")])
        rec["a"] = np.arange(37) - 30
        rec["f"] = np.arange(37) / 4
        rec["arr"] = np.arange(111).reshape(37, 3) % 7
        rec["o"] = np.arange(37) * 5
        mem = h5py.h5t.create(h5py.h5t.COMPOUND, rec.dtype.itemsize)
        for name in rec.dtype.names:
            base = {"a": h5py.h5t.NATIVE_INT16, "f": h5py.h5t.NATIVE_FLOAT, "o": h5py.h5t.STD_B8LE,
                    "arr": h5py.h5t.array_create(h5py.h5t.NATIVE_UINT16, (3,))}[name]
            mem.insert(name.encode(), rec.dtype.fields[name][1], base)
        fx.low_level(f, "compound", comp, rec, dcpl=fx.nbit_dcpl((8,)), mtype=mem)


def case_enum_and_bool(d):
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("bool", data=_x() > 100)
        f.create_dataset("bool_chunked", data=_x() > 30, chunks=(8, 6, 10), compression="gzip")
        for base in ("i1", "u2", ">i4"):
            colours = h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 42}, basetype=base)
            f.create_dataset(f"enum_{base}", data=np.array([0, 1, 42], base)[_x() % 3], dtype=colours)
        f.attrs["flag"] = np.bool_(True)
        f.attrs["flags"] = np.array([True, False, True])
        f.attrs.create("colour", 42, dtype=h5py.enum_dtype({"RED": 0, "BLUE": 42}, basetype="i1"))


def case_compound(d):
    inner = np.dtype([("a", "<i2"), ("b", "<f8", (2,))], align=True)
    outer = np.dtype({"names": ["n", "inner", "c", "flag"], "formats": ["u1", inner, "S3", "?"],
                      "offsets": [0, 8, 40, 43], "itemsize": 48})
    rec = np.zeros(37, outer)
    rec["n"] = np.arange(37)
    rec["inner"]["a"] = -np.arange(37)
    rec["inner"]["b"] = np.arange(74).reshape(37, 2) / 4
    rec["c"] = [b"ab", b"cde", b"", b"x"] * 9 + [b"z"]
    rec["flag"] = np.arange(37) % 3 == 0
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("nested", data=rec)
        f.create_dataset("chunked", data=rec, chunks=(5,), compression="gzip")
        f.create_dataset("packed", data=np.zeros(4, [("x", ">f4"), ("y", "<i8")]))
        f.create_dataset("complex64", data=(np.arange(6) + 1j * np.arange(6)[::-1]).astype("c8"))
        f.create_dataset("complex128_be", data=(np.arange(6) * 1j - 2).astype(">c16"))
        f.attrs["record"] = rec[3]
        f.attrs["records"] = rec[:4]
    with h5py.File(d / "latest.h5", "w", libver="latest") as f:  # compound message version 3
        f.create_dataset("nested", data=rec, chunks=(5,), maxshape=(None,))


def case_opaque_bitfield_array(d):
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("opaque", data=np.frombuffer(bytes(range(60)), "V6"))
        for name, t, arr in (("bits8", h5py.h5t.STD_B8LE, np.arange(7, dtype="u1") * 37),
                             ("bits32_be", h5py.h5t.STD_B32BE, np.arange(7, dtype=">u4") * 3**15)):
            fx.low_level(f, name, t, arr, mtype=t)
        pairs = h5py.h5t.array_create(h5py.h5t.STD_I32LE, (2, 3))
        fx.low_level(f, "array", pairs, np.arange(24, dtype="<i4").reshape(4, 2, 3), mtype=pairs,
                     shape=(4,))
        f.attrs.create("array_attr", np.arange(6, dtype="f8").reshape(2, 3), dtype=np.dtype(("f8", (3,))))


def case_variable_length(d):
    seqs = np.empty(37, object)
    seqs[:] = [np.arange(n % 6, dtype="i4") * (n - 2) for n in range(37)]
    floats = np.empty(3, object)
    floats[:] = [np.array([1.5, 2.5]), np.array([]), np.array([-1.0])]
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("ints", data=seqs, dtype=h5py.vlen_dtype("i4"))
        f.create_dataset("ints_chunked", data=seqs, dtype=h5py.vlen_dtype("i4"), chunks=(5,))
        f.create_dataset("ascii", data=[b"a", b"bc", b""], dtype=h5py.string_dtype("ascii"))
        f.create_dataset("utf8_2d", data=np.array([["é", "x"], ["", "yy"]], object),
                         dtype=h5py.string_dtype())
        f.create_dataset("unwritten", shape=(3,), dtype=h5py.vlen_dtype("f8"))
        f.attrs.create("floats", floats, dtype=h5py.vlen_dtype("f8"))
        f.attrs["ascii_attr"] = np.array(b"bytes", dtype=h5py.string_dtype("ascii"))


def case_reduced_precision_integers(d):
    with h5py.File(d / "f.h5", "w") as f:
        fx.low_level(f, "i32_p14_o3", fx.reduced_int(14, 3), np.arange(-20, 20, dtype="i4") * 111)
        fx.low_level(f, "u8_p3_o5", fx.reduced_int(3, 5, h5py.h5t.STD_U8LE), np.arange(40, dtype="u1"))
        fx.low_level(f, "i64_be_p40", fx.reduced_int(40, 0, h5py.h5t.STD_I64BE),
                     np.arange(-20, 20, dtype="i8") * 2**33)


def case_committed_datatypes(d):
    for libver in ("earliest", "latest"):
        with h5py.File(d / f"{libver}.h5", "w", libver=libver) as f:
            f["point"] = np.dtype([("x", "<f4"), ("y", "<i8")])
            f["label"] = h5py.enum_dtype({"CAT": 0, "DOG": 1}, basetype="u1")
            point = f["point"]
            f["point"].attrs["unit"] = "metre"
            f.create_dataset("points", data=np.array([(1.5, -2), (3, 4)], point.dtype), dtype=point)
            f.create_dataset("labels", data=np.array([0, 1, 1], "u1"), dtype=f["label"])
            f["points"].attrs.create("origin", np.array((0.5, 9), point.dtype), dtype=point)


def case_fixed_strings(d):
    with h5py.File(d / "f.h5", "w") as f:
        f.create_dataset("ascii", data=np.array([b"ab", b"cdef", b""], "S4"))
        f.create_dataset("utf8", data=np.array(["é".encode(), b"ab"], dtype=h5py.string_dtype("utf-8", 4)))
        f.attrs["fixed"] = np.bytes_(b"abc")


def case_references(d):
    """Dimension scales and labels; object and region references in
    attributes, datasets (chunked too) and a compound."""
    fx.write_references(d / "latest.h5")
    fx.write_references(d / "earliest.h5", libver="earliest")  # version 1 selections


def case_virtual_datasets(d):
    fx.write_vds(d)


def case_virtual_datasets_earliest(d):
    """Version 1 and 2 selections in the mappings."""
    fx.write_vds(d, libver="earliest")


def case_virtual_dataset_sources_missing(d):
    """The CIFAR-10 virtual shard without its halves, then with one."""
    fx.write_cifar_vds(d / "vds.h5", rows=16)
    images, labels = fx.cifar_images(8)
    with h5py.File(d / "cifar10_half1.h5", "w") as f:
        f.create_dataset("data", data=images)
        f.create_dataset("labels", data=labels)


def case_external_raw_data(d):
    fx.write_external(d)


def case_szip(d):
    fx.write_szip(d / "f.h5")
    fx.write_cifar_szip(d / "cifar.h5", rows=8)


def case_committed_fixtures(d):
    """The committed fixtures themselves, beside their external link's
    target, their virtual datasets' sources and their external raw data."""
    for p in testdata.HDF5_DIR.iterdir():
        if p.suffix in (".h5", ".bin"):
            shutil.copy(p, d / p.name)


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_as_h5py_reads(tmp_path, monkeypatch, case):
    """Each file read from its own directory and from another: where
    external raw data is named relative to the working directory, h5py's
    reads fail from the other, and the port's must fail alike."""
    CASES[case](tmp_path)
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    failed = {}
    for cwd in (tmp_path, elsewhere):
        monkeypatch.chdir(cwd)
        _FAILED_READS.clear()
        versions = {p.name: _same_file(p) for p in sorted(tmp_path.glob("*.h5"))}
        failed[cwd.name] = sorted({path for path, _ in _FAILED_READS})
    assert versions
    if case in ("superblock_3", "superblock_2"):
        assert set(versions.values()) == {int(case[-1])}
    external = ["/rows", "/two_slots"] if case in ("external_raw_data", "committed_fixtures") else []
    assert failed == {tmp_path.name: [], "elsewhere": external}


def test_dense_storage_and_indexes_are_the_ones_meant(tmp_path):
    """The cases reach what they name: dense links and attributes in a
    fractal heap, a v2 B-tree with internal nodes, the chunk indexes."""
    case_dense_links_deep(tmp_path)
    with hdf5.File(tmp_path / "f.h5") as f:
        r = f._reader
        info = f["g"]._links.info
        heap, btree = struct.unpack_from("<QQ", info, 2)
        assert not r.undefined(heap) and r.mm[r.addr(btree) + 12] > 0  # the B-tree's depth
        assert r.heap(heap).root_rows > 0  # an indirect root block
    kinds = {}
    for case, names in ((case_chunk_index_single, ("single", "single_filtered")),
                        (case_chunk_index_implicit, ("implicit",)),
                        (case_chunk_index_fixed_array, ("fixed", "fixed_filtered")),
                        (case_chunk_index_extensible_array, ("grows", "axis1")),
                        (case_chunk_index_btree2, ("deep",))):
        sub = tmp_path / case.__name__
        sub.mkdir()
        case(sub)
        with hdf5.File(sub / "f.h5") as f:
            kinds.update({n: f[n]._layout.index for n in names})
    assert kinds == {"single": "single", "single_filtered": "single", "implicit": "implicit",
                     "fixed": "farray", "fixed_filtered": "farray", "grows": "earray",
                     "axis1": "earray", "deep": "btree2"}
    sub = tmp_path / "headers"
    sub.mkdir()
    case_header_times_phases_continuations(sub)
    assert b"OCHK" in (sub / "f.h5").read_bytes()
    with hdf5.File(sub / "f.h5") as f:
        flags, _ = f._reader.header(f._reader.root)
        assert flags & 0x04 == 0  # the root tracks no attribute order: 4-byte message headers
    for case, name in ((case_partial_edge_chunks_unfiltered, "edges_unfiltered"),):
        sub = tmp_path / name
        sub.mkdir()
        case(sub)
        with hdf5.File(sub / "f.h5") as f:
            assert f[name]._layout.skip_edge_filters


def test_lookup3_and_fletcher32_match_the_librarys():
    """lookup3 against the test vectors of Jenkins' lookup3.c, fletcher32 on
    one word; every read above verifies both against what HDF5 wrote."""
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551  # lookup3.c's self-test
    assert hdf5.fletcher32(b"\x01\x02") == (0x0102 << 16) | 0x0102


# -- what stays refused (beside tests/test_torch_port_hdf5.py's) -------------------


def test_shared_message_table_is_refused(tmp_path):
    """A superblock extension whose shared-message table (h5py cannot make
    one) is made by retyping its file-space message, checksum restored."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="latest", fs_strategy="page", fs_persist=True) as f:
        f.create_dataset("x", data=np.arange(3))
    with hdf5.File(path) as f:
        r = f._reader
        extension = r.u(r.addr(0) + 12 + r.O, r.O)
    raw = bytearray(path.read_bytes())
    pos = extension
    flags = raw[pos + 5]
    start = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0) + (1 << (flags & 3))
    end = start + int.from_bytes(raw[start - (1 << (flags & 3)) : start], "little")
    p = start
    while p < end and raw[p] != 0x17:  # the file-space info message
        p += (6 if flags & 0x04 else 4) + int.from_bytes(raw[p + 1 : p + 3], "little")
    assert p < end
    raw[p] = 0x0F
    raw[end : end + 4] = struct.pack("<I", hdf5.lookup3(bytes(raw[pos:end])))
    path.write_bytes(bytes(raw))
    with pytest.raises(NotImplementedError, match="shared object header messages"):
        hdf5.File(path)


def test_corrupted_metadata_checksum_raises(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["marker"] = np.frombuffer(b"corrupt me", "S10")[0]
    raw = bytearray(path.read_bytes())
    at = raw.find(b"corrupt me")
    raw[at] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError, match="checksum"):
        hdf5.File(path)
    with h5py.File(path, "r") as f, pytest.raises(KeyError, match="checksum"):
        f.attrs["marker"]


def test_corrupted_fletcher32_chunk_raises(tmp_path):
    path = tmp_path / "f.h5"
    data = np.tile(np.frombuffer(b"fletcher32 chunk", "u1"), (8, 1))
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=data, chunks=(4, 16), fletcher32=True)
    raw = bytearray(path.read_bytes())
    at = raw.find(b"fletcher32 chunk")
    raw[at] ^= 0x01
    path.write_bytes(bytes(raw))
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["x"][4:], data[4:])  # the other chunk is intact
        with pytest.raises(OSError, match="fletcher32"):
            f["x"][...]
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["x"][...]


# -- the JAX package's readers on the same files -------------------------------------


def test_jax_checkpoint_copied_to_libver_latest_loads_alike(tmp_path):
    """A JAX checkpoint of 12 edges that h5py copied into a libver "latest"
    file (the root's links dense): the JAX package's load and the port's
    give array-equal params and momenta, and load_edge the same edge."""
    params, moms = fx.checkpoint_params(edges=12)
    src = jax_ckpt.save(str(tmp_path / "jax"), "many", params, moms, step=21, timestamp="1")
    dst = tmp_path / "latest.h5"
    with h5py.File(src, "r") as s, h5py.File(dst, "w", libver="latest") as t:
        for key, value in s.attrs.items():
            t.attrs[key] = value
        for name in s:
            s.copy(s[name], t, name=name)
    with hdf5.File(dst) as f:
        heap = struct.unpack_from("<Q", f._links.info, 2)[0]
        assert not f._reader.undefined(heap)  # dense links
    got, got_moms, step = ckpt.load(str(dst))
    want, want_moms, want_step = jax_ckpt.load(str(dst))
    assert step == want_step == 21 and sorted(got) == sorted(want) == sorted(params)
    for edge in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[edge][k], np.asarray(want[edge][k]))
            np.testing.assert_array_equal(got_moms[edge][k], np.asarray(want_moms[edge][k]))
            np.testing.assert_array_equal(got[edge][k], params[edge][k])
    one, jax_one = ckpt.load_edge(str(dst), "edge10"), jax_ckpt.load_edge(str(dst), "edge10")
    for k in ("w", "b"):
        np.testing.assert_array_equal(one[k], np.asarray(jax_one[k]))


def test_jax_hdf5_stream_reads_the_fixture_formats_alike(tmp_path):
    """The fixture shard's formats (libver "latest", extensible-array
    index, lzf + shuffle + fletcher32) at 40 rows, and a libver "latest"
    mean file: the JAX HDF5Stream's rows and _load_mean_std against the
    port's, array-equal."""
    images, labels = fx.cifar_images(40, seed=5)
    fx.write_cifar_shard(tmp_path / "shard.h5", images, labels)
    fx.write_mean(tmp_path / "mean.h5", images)
    text = f"""
        name: "shard" batch_size: 8
        data_config {{ layer_name: "input" data_type: HDF5 file_pattern: "{tmp_path / 'shard.h5'}"
                      dataset_name: "data" image_size: 32 raw_image_size: 32 num_colors: 3 }}
        data_config {{ layer_name: "labels" data_type: HDF5
                      file_pattern: "{tmp_path / 'shard.h5'}" dataset_name: "labels" }}
    """
    ours_cfg, jax_cfg = pt_config.parse_dataset_config(text), jax_config.parse_dataset_config(text)
    rng = np.random.default_rng(0)
    for ours_s, jax_s in zip(ours_cfg.data_config, jax_cfg.data_config):
        a, b = datahandler.HDF5Stream(ours_s), jax_datahandler.HDF5Stream(jax_s)
        try:
            assert a.num_rows == b.num_rows == 40
            for idx in (rng.integers(0, 40, 16), np.arange(40), np.array([39, 39, 0, 7, 7])):
                got, want = a.read_rows(idx), b.read_rows(idx)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        finally:
            a.close()
            b.close()
    for got, want in zip(datahandler._load_mean_std(str(tmp_path / "mean.h5")),
                         jax_datahandler._load_mean_std(str(tmp_path / "mean.h5"))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- the committed fixtures ---------------------------------------------------------


def test_fixture_digests_are_h5pys():
    """digests.json says what h5py reads from each committed fixture (from
    the fixtures' directory, against which the external raw data's names
    resolve), which stays under 1 MB in all."""
    want = json.loads(testdata.HDF5_DIGESTS.read_text())
    assert list(want) == list(fx.FIXTURES)
    for name, entries in want.items():
        assert fx.h5py_digests(testdata.HDF5_DIR / name) == entries, name
    assert sum(p.stat().st_size for p in testdata.HDF5_DIR.iterdir()) < 1 << 20


_NO_H5PY = """
import sys
sys.modules["h5py"] = None
import numpy as np
from convnet_tpu_torch import checkpoint, testdata
count, nbytes, problems = testdata.check_hdf5_fixtures()
assert not problems, problems
params, moms, step = checkpoint.load(str(testdata.HDF5_DIR / "checkpoint_latest.h5"))
assert step == 9 and len(params) == 10 and moms is not None
print(count, sys.modules["h5py"] is None)
"""


def test_fixtures_read_with_h5py_blocked():
    proc = subprocess.run([sys.executable, "-c", _NO_H5PY], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, blocked = proc.stdout.split()
    assert int(count) > 50 and blocked == "True"
