"""The port's committed HDF5 fixtures, written with h5py, and their digests
as h5py reads them:

    python tests/torch_port_hdf5_fixtures.py

writes convnet_tpu_torch/testdata/hdf5/*.h5 (and the external raw data
files *.bin) and digests.json (see convnet_tpu_torch/testdata/__init__.py).
It imports h5py, which no module of the port may, so it lives beside the
tests; the tests (tests/test_torch_port_hdf5_formats.py,
tests/test_torch_port_hdf5_references.py) write the same formats with its
functions. Every array comes from numpy with a fixed seed.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import h5py
import numpy as np

REPO = Path(__file__).resolve().parent.parent

CIFAR_ROWS, CIFAR_SIZE, CIFAR_CLASSES = 256, 32, 10
CHECKPOINT_EDGES = 10  # past 8 links: the root group's links are dense


def cifar_images(n: int, seed: int = 0, noise: int = 8):
    """n uint8 32x32x3 images and int32 labels: each image an 8x8 grid of
    4x4-pixel blocks, each block a colour of its class's palette of four
    plus a little noise (up to `noise` either way), so that LZF finds
    repeats in every row."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CIFAR_CLASSES, n).astype(np.int32)
    palettes = rng.integers(0, 256, (CIFAR_CLASSES, 4, 3))
    blocks = palettes[labels[:, None, None], rng.integers(0, 4, (n, 8, 8))]
    blocks = np.clip(blocks + rng.integers(-noise, noise + 1, blocks.shape), 0, 255).astype(np.uint8)
    return blocks.repeat(4, axis=1).repeat(4, axis=2), labels


def write_cifar_shard(path, images, labels):
    """A CIFAR-10 shard as a libver "latest" file: images chunked a row a
    chunk with an unlimited first axis (an extensible-array index), labels
    by 64 rows, both through lzf, shuffle and fletcher32."""
    with h5py.File(path, "w", libver="latest") as f:
        for name, arr, rows in (("data", images, 1), ("labels", labels, 64)):
            f.create_dataset(name, data=arr, maxshape=(None,) + arr.shape[1:],
                             chunks=(rows,) + arr.shape[1:], compression="lzf", shuffle=True,
                             fletcher32=True)


def mean_std(images):
    x = images.astype(np.float64)
    mean = x.mean(0)
    return mean, np.sqrt(np.maximum((x**2).mean(0) - mean**2, 1e-12))


def write_mean(path, images):
    """The full-pixel mean and std of `images` (compute_mean's datasets) as
    a libver "latest" file."""
    mean, std = mean_std(images)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("mean", data=mean.astype(np.float32))
        f.create_dataset("std", data=std.astype(np.float32))


def checkpoint_params(edges: int = CHECKPOINT_EDGES, seed: int = 3):
    rng = np.random.default_rng(seed)
    params = {f"edge{i:02d}": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                               "b": rng.standard_normal(3).astype(np.float32)}
              for i in range(edges)}
    moms = {k: {n: v * 0.5 for n, v in p.items()} for k, p in params.items()}
    return params, moms


def write_checkpoint(path, params, moms, step=9):
    """The JAX package's checkpoint layout (a group per edge with w, b,
    w_mom, b_mom; step, model_name and timestamp attributes), libver
    "latest": past 8 edges the root's links are dense."""
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["step"] = step
        f.attrs["model_name"] = "many_edges"
        f.attrs["timestamp"] = "20261018000000"
        for edge, leaves in params.items():
            g = f.create_group(edge)
            g.create_dataset("w", data=leaves["w"])
            g.create_dataset("b", data=leaves["b"])
            g.create_dataset("w_mom", data=moms[edge]["w"])
            g.create_dataset("b_mom", data=moms[edge]["b"])


def reduced_int(precision: int, offset: int, base=h5py.h5t.STD_I32LE):
    t = base.copy()
    t.set_precision(precision)
    t.set_offset(offset)
    return t


def low_level(group, name, tid, data, dcpl=None, mtype=None, shape=None):
    """A dataset of file type `tid` (which h5py's high level cannot make),
    written from `data`; `mtype` is the memory type where numpy's is not
    the one to convert from, `shape` the dataspace where it is not
    data's."""
    space = h5py.h5s.create_simple(data.shape if shape is None else shape)
    ds = h5py.h5d.create(group.id, name.encode(), tid, space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data), mtype=mtype)


def nbit_dcpl(chunks):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    return dcpl


def write_formats(path, external: str):
    """One libver "latest" file of small datasets, one a format feature:
    dense attributes on the root, dense and creation-ordered groups, hard,
    soft and external links (to `external`'s "/mean"), every chunk index,
    the filters, and the datatypes."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 255, (37, 6, 10)).astype(np.uint8)
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(12):  # past 8 attributes: dense storage
            f.attrs[f"attr{i:02d}"] = np.float32(i * 1.5)
        f.attrs["note"] = "dense attribute storage"
        c = f.create_group("chunk_indexes")
        c.create_dataset("single", data=x, chunks=x.shape)
        c.create_dataset("single_filtered", data=x, chunks=x.shape, compression="gzip")
        early = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        early.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        c.create_dataset("implicit", data=x, chunks=(5, 4, 3), dcpl=early)
        c.create_dataset("fixed_array", data=x, chunks=(5, 4, 3))
        c.create_dataset("fixed_array_paged", data=rng.integers(-9, 9, 1100).astype("i2"),
                         chunks=(1,))
        ea = c.create_dataset("extensible_array", shape=(300, 6), maxshape=(None, 6), chunks=(1, 6),
                              dtype="i4", fillvalue=-1)
        ea[:120] = rng.integers(0, 1000, (120, 6))
        ea[200:290] = rng.integers(0, 1000, (90, 6))
        c.create_dataset("extensible_array_axis1", data=x[:, :, 0].T.copy(), maxshape=(6, None),
                         chunks=(4, 3))
        c.create_dataset("btree2", data=x[:, :, 1], maxshape=(None, None), chunks=(2, 3))
        c.create_dataset("btree2_filtered", data=x[:, :, 2], maxshape=(None, None), chunks=(4, 3),
                         compression="gzip", shuffle=True)
        g = f.create_group("filters")
        g.create_dataset("fletcher32", data=x, chunks=(8, 6, 10), fletcher32=True)
        g.create_dataset("lzf", data=np.tile(np.arange(60, dtype="<f4"), (37, 1)), chunks=(8, 60),
                         compression="lzf")
        g.create_dataset("lzf_incompressible", data=x, chunks=(8, 6, 10), compression="lzf")
        g.create_dataset("scaleoffset_int", data=(x.astype("i4") - 100) * 7, chunks=(8, 6, 10),
                         scaleoffset=0)
        g.create_dataset("scaleoffset_float", data=x.astype("f8") / 7, chunks=(8, 6, 10),
                         scaleoffset=3)
        low_level(g, "nbit", reduced_int(12, 4), (x.astype("i4") - 128) * 3,
                  dcpl=nbit_dcpl((8, 6, 10)))
        t = f.create_group("types", track_order=True)  # listed in creation order
        t.create_dataset("zz_bool", data=x[:, 0, :] > 100)
        colours = h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 7}, basetype="u2")
        t.create_dataset("enum", data=np.array([0, 1, 7], "u2")[x[:, 0, :] % 3], dtype=colours)
        inner = np.dtype([("a", "<i2"), ("b", "<f8", (2,))], align=True)
        outer = np.dtype({"names": ["n", "inner", "c"], "formats": ["u1", inner, "S3"],
                          "offsets": [0, 8, 40], "itemsize": 48})
        rec = np.zeros(5, outer)
        rec["n"] = np.arange(5)
        rec["inner"]["a"] = -np.arange(5)
        rec["inner"]["b"] = np.arange(10).reshape(5, 2) / 4
        rec["c"] = [b"ab", b"cde", b"", b"x", b"yz"]
        t.create_dataset("compound", data=rec)
        t.create_dataset("complex", data=(np.arange(6) + 1j * np.arange(6)[::-1]).astype("c8"))
        t.create_dataset("opaque", data=np.frombuffer(bytes(range(24)), "V4"))
        low_level(t, "bitfield", h5py.h5t.STD_B16LE, np.arange(9, dtype="<u2") * 513,
                  mtype=h5py.h5t.STD_B16LE)
        seqs = np.empty(4, object)
        seqs[:] = [np.arange(n, dtype="i4") * (n - 2) for n in (0, 1, 3, 6)]
        t.create_dataset("vlen_int", data=seqs, dtype=h5py.vlen_dtype("i4"))
        t["committed"] = np.dtype([("x", "<f4"), ("y", "<i8")])
        t.create_dataset("uses_committed", data=np.array([(1.5, -2), (3, 4)], t["committed"].dtype),
                         dtype=t["committed"])
        t["uses_committed"].attrs.create("typed", np.array((2.5, 7), t["committed"].dtype),
                                         dtype=t["committed"])
        pairs = h5py.h5t.array_create(h5py.h5t.STD_I32LE, (2, 3))
        low_level(t, "array_type", pairs, np.arange(24, dtype="<i4").reshape(4, 2, 3), mtype=pairs,
                  shape=(4,))
        low_level(t, "reduced_int", reduced_int(10, 3), np.arange(-20, 20, dtype="i4") * 11)
        t.create_dataset("fixed_utf8", data=np.array(["é".encode(), b"ab"], dtype=h5py.string_dtype("utf-8", 4)))
        t.create_dataset("vlen_str", data=["a", "ccé"], dtype=h5py.string_dtype())
        links = f.create_group("links")
        links["hard"] = t["enum"]
        links["soft"] = h5py.SoftLink("/chunk_indexes/fixed_array")
        links["target"] = np.arange(3.0)
        links["relative"] = h5py.SoftLink("target")
        links["dangling"] = h5py.SoftLink("/nowhere")
        links["external"] = h5py.ExternalLink(external, "/mean")
        many = f.create_group("many", track_order=True)
        for i in range(20):  # dense links, in creation order
            many.create_dataset(f"m{(i * 7) % 20:02d}", data=np.array([i], "i2"))


# -- references, virtual datasets, external raw data, szip ---------------------------


def write_references(path, libver="latest"):
    """A dataset with a dimension scale attached and its axes labelled
    (DIMENSION_LIST, a vlen of object references, on the dataset;
    REFERENCE_LIST, a compound holding one, on the scale), and object and
    region references in attributes and in datasets: regular and
    irregular hyperslabs, points, all and none, a null reference of each
    kind, a chunked reference dataset, and a compound with a reference."""
    with h5py.File(path, "w", libver=libver) as f:
        data = f.create_dataset("data", data=np.arange(24, dtype=np.float32).reshape(6, 4) / 3)
        x = f.create_dataset("x", data=np.arange(6) * 1.5)
        x.make_scale("x")
        data.dims[0].attach_scale(x)
        data.dims[0].label = "row"
        data.dims[1].label = "column"
        t = f.create_dataset("t", data=np.arange(30, dtype=">i2").reshape(5, 6))
        g = f.create_group("g")
        g.attrs["target"] = t.ref
        f.attrs["group"] = g.ref
        f.attrs["region"] = t.regionref[1:4, ::2]
        f.attrs["refs"] = np.array([t.ref, g.ref, f.ref], dtype=h5py.ref_dtype)
        f.create_dataset("objects", data=[t.ref, g.ref, x.ref, h5py.Reference()], dtype=h5py.ref_dtype)
        f.create_dataset("objects_chunked", data=[data.ref, t.ref] * 5, dtype=h5py.ref_dtype,
                         chunks=(3,), compression="gzip")
        space = t.id.get_space()
        space.select_hyperslab((0, 0), (2, 2))
        space.select_hyperslab((1, 1), (3, 3), op=h5py.h5s.SELECT_OR)  # an L of blocks: flat
        points = t.id.get_space()
        points.select_elements(np.array([[4, 5], [0, 0], [2, 3], [0, 0]]))
        nothing = t.id.get_space()
        nothing.select_none()
        regions = [t.regionref[1:3, ::2], t.regionref[[0, 2], 1:3], t.regionref[...],
                   t.regionref[np.arange(30).reshape(5, 6) % 4 == 1], t.regionref[2],
                   h5py.h5r.create(f.id, b"t", h5py.h5r.DATASET_REGION, space),
                   h5py.h5r.create(f.id, b"t", h5py.h5r.DATASET_REGION, points),
                   h5py.h5r.create(f.id, b"t", h5py.h5r.DATASET_REGION, nothing),
                   h5py.RegionReference()]
        f.create_dataset("regions", data=regions, dtype=h5py.regionref_dtype)
        pair = np.dtype([("obj", h5py.ref_dtype), ("n", "<i4")])
        f.create_dataset("pairs", data=np.array([(t.ref, 1), (g.ref, 2)], pair))


VDS_SHARD_ROWS, VDS_COLUMNS = 12, 8


def vds_shard(i: int) -> np.ndarray:
    return (np.arange(VDS_SHARD_ROWS * VDS_COLUMNS).reshape(VDS_SHARD_ROWS, VDS_COLUMNS) * 3
            + 50 * i).astype(np.uint8)


def write_vds(directory: Path, libver="latest"):
    """vds_shard{0,1,2}.h5 (uint8 shards of 12 x 8: the first chunked with
    an unlimited first axis, the others contiguous) and vds.h5, whose
    virtual datasets map them from their sibling files: "rows" stacks
    shard 0, an unmapped band, shard 1 at every other row, and a source
    in a file that does not exist (fill value 7); "blocks" maps part rows
    and columns; "same_file" a dataset of its own file ("."). vds_printf.h5
    maps vds_shard%b.h5 through an unlimited printf mapping and shard 0
    through an unlimited strided one (h5py's low-level set_virtual)."""
    for i in range(3):
        with h5py.File(directory / f"vds_shard{i}.h5", "w", libver=libver) as f:
            kw = dict(chunks=(4, VDS_COLUMNS), maxshape=(None, VDS_COLUMNS)) if i == 0 else {}
            f.create_dataset("data", data=vds_shard(i), **kw)
    n, c = VDS_SHARD_ROWS, VDS_COLUMNS
    rows = h5py.VirtualLayout(shape=(4 * n + 6, c), dtype="u1")
    rows[0:n] = h5py.VirtualSource("vds_shard0.h5", "data", shape=(n, c))
    rows[n + 3 : 3 * n + 3 : 2] = h5py.VirtualSource("vds_shard1.h5", "data", shape=(n, c))
    rows[3 * n + 6 :] = h5py.VirtualSource("vds_missing.h5", "data", shape=(n, c))
    blocks = h5py.VirtualLayout(shape=(n, 2 * c), dtype="u1")
    blocks[2:8, 3:9] = h5py.VirtualSource("vds_shard2.h5", "data", shape=(n, c))[4:10, 1:7]
    blocks[0, :] = h5py.VirtualSource("vds_shard1.h5", "data", shape=(n, c))[0:2, :]
    with h5py.File(directory / "vds.h5", "w", libver=libver) as f:
        f.create_virtual_dataset("rows", rows, fillvalue=7)
        f.create_virtual_dataset("blocks", blocks, fillvalue=255)
        own = f.create_dataset("own", data=np.arange(40, dtype="<i4").reshape(10, 4))
        same = h5py.VirtualLayout(shape=(5, 8), dtype="<i4")
        same[:, 0:4] = h5py.VirtualSource(own)[0:10:2]
        same[:, 4:8] = h5py.VirtualSource(own)[1:10:2]
        f.create_virtual_dataset("same_file", same, fillvalue=-1)
    with h5py.File(directory / "vds_printf.h5", "w", libver=libver) as f:
        top = h5py.h5s.UNLIMITED
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        vspace = h5py.h5s.create_simple((n, c), (top, c))
        vspace.select_hyperslab((1, 0), (top, 1), (n + 2, 1), (n, c))
        dcpl.set_virtual(vspace, b"vds_shard%b.h5", b"data", h5py.h5s.create_simple((n, c)))
        dcpl.set_fill_value(np.array(9, "u1"))
        h5py.h5d.create(f.id, b"printf", h5py.h5t.STD_U8LE, vspace, dcpl=dcpl)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        vspace = h5py.h5s.create_simple((n, c), (top, c))
        vspace.select_hyperslab((2, 0), (top, 1), (3, 1), (2, c))
        sspace = h5py.h5s.create_simple((n, c), (top, c))
        sspace.select_hyperslab((0, 0), (1, 1), (1, 1), (top, c))
        dcpl.set_virtual(vspace, b"vds_shard0.h5", b"data", sspace)
        h5py.h5d.create(f.id, b"unlimited", h5py.h5t.STD_U8LE, vspace, dcpl=dcpl)


def write_cifar_vds(path, rows: int = CIFAR_ROWS):
    """A virtual CIFAR-10 shard: "data" and "labels" stacked from the
    halves in cifar10_half0.h5 and cifar10_half1.h5 beside it (which the
    fixtures do not hold: chip_smoke.py and the tests write them from the
    CIFAR-10 fixture shard with the port's writer)."""
    half = rows // 2
    with h5py.File(path, "w", libver="latest") as f:
        for name, shape, dtype in (("data", (CIFAR_SIZE, CIFAR_SIZE, 3), "u1"), ("labels", (), "<i4")):
            layout = h5py.VirtualLayout(shape=(rows,) + shape, dtype=dtype)
            for i in range(2):
                layout[i * half : (i + 1) * half] = h5py.VirtualSource(
                    f"cifar10_half{i}.h5", name, shape=(half,) + shape)
            f.create_virtual_dataset(name, layout)


def write_external(directory: Path):
    """external.h5, whose datasets' raw data lie in external_0.bin and
    external_1.bin beside it under relative names: "two_slots" over a
    slot of each file (the second of unlimited size, running past its
    file's end), "rows" over three slots whose ends fall inside rows."""
    rng = np.random.default_rng(7)
    (directory / "external_0.bin").write_bytes(rng.integers(0, 256, 100, np.uint8).tobytes())
    (directory / "external_1.bin").write_bytes(rng.integers(0, 256, 90, np.uint8).tobytes())
    with h5py.File(directory / "external.h5", "w") as f:
        f.create_dataset("two_slots", shape=(30,), dtype="<i4",
                         external=[("external_0.bin", 8, 40), ("external_1.bin", 10, h5py.h5f.UNLIMITED)])
        f.create_dataset("rows", shape=(6, 5), dtype=">u2",
                         external=[("external_1.bin", 0, 14), ("external_0.bin", 3, 33),
                                   ("external_1.bin", 40, 13)])


def szip_dcpl(chunks, coding: int, pixels_per_block: int):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    dcpl.set_szip(coding, pixels_per_block)
    return dcpl


def szip_data(dtype, shape=(23, 27), seed=11):
    """Rows that reach every szip option: smooth ramps (split samples),
    flat rows (zero blocks), rows of small steps (the second extension)
    and rows of noise (blocks stored as they are)."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(-40, 41, shape), 1)
    x[4:9] = 3
    x[10:14] = np.cumsum(rng.integers(-1, 2, (4, shape[1])), 1)
    info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
    x[17:19] = rng.integers(info.min if info else -1000, info.max if info else 1000, (2, shape[1]))
    if info is None:
        return (x / 7).astype(dtype)
    return np.clip(x + (0 if info.min < 0 else 128), info.min, info.max).astype(dtype)


def write_szip(path):
    """szip chunks (8 x 10 of 23 x 27: edge chunks on both axes) in NN and
    EC modes at int8, int16, int32 and float32, little- and big-endian
    (LSB and MSB), 8 and 16 pixels a block; a 24-bit integer (5-bit block
    IDs) and a 12-bit one; and CIFAR-10 images at a row a chunk."""
    nn, ec = h5py.h5z.SZIP_NN_OPTION_MASK, h5py.h5z.SZIP_EC_OPTION_MASK
    with h5py.File(path, "w", libver="latest") as f:
        for dtype in ("i1", "<i2", ">i2", "<i4", ">i4", "<f4", ">f4"):
            for coding, ppb in (("nn", 8), ("ec", 16)):
                f.create_dataset(f"{coding}_{dtype.replace('<', 'le_').replace('>', 'be_')}",
                                 data=szip_data(dtype), chunks=(8, 10), compression="szip",
                                 compression_opts=(coding, ppb))
        for precision, base in ((24, h5py.h5t.STD_I32LE), (12, h5py.h5t.STD_I16BE)):
            data = np.clip(szip_data("<i4"), -(2 ** (precision - 1)), 2 ** (precision - 1) - 1)
            for coding, mask in (("nn", nn), ("ec", ec)):
                low_level(f, f"{coding}_int{precision}", reduced_int(precision, 0, base), data,
                          dcpl=szip_dcpl((8, 10), mask, 8))


CIFAR_SZIP_ROWS = 128


def write_cifar_szip(path, rows: int = CIFAR_SZIP_ROWS):
    """A CIFAR-10 shard through szip (NN, 8 pixels a block): grey images
    of four flat 16x16 quadrants, a row a chunk, and labels."""
    images, labels = cifar_images(rows, seed=4, noise=0)
    images = np.repeat(images[:, ::16, ::16, :1], 16, 1).repeat(16, 2).repeat(3, 3)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("data", data=images, chunks=(1,) + images.shape[1:], compression="szip",
                         compression_opts=("nn", 8))
        f.create_dataset("labels", data=labels, chunks=(min(64, rows),), compression="szip")


# -- shared object header messages, filtered fractal heaps, non-IEEE floats ------------


def libhdf5():
    """h5py's own bundled libhdf5, through ctypes, for the properties that
    h5py does not offer (the library is the one h5py's modules loaded, so
    property lists pass between the two by their ids)."""
    import ctypes
    import glob

    libs = os.path.join(os.path.dirname(h5py.__file__), "..", "h5py.libs", "libhdf5-*.so*")
    return ctypes.CDLL(glob.glob(libs)[0])


def _set(plist, *calls):
    """Each (function, unsigned arguments...) of libhdf5 on the property list."""
    import ctypes

    lib = libhdf5()
    for name, *args in calls:
        if getattr(lib, name)(ctypes.c_int64(plist.id), *(ctypes.c_uint(a) for a in args)) < 0:
            raise RuntimeError(f"{name}{tuple(args)} failed")
    return plist


# a shared-message index's message types (H5O_SHMESG_*_FLAG: 1 << the type)
SHARE_DATASPACE, SHARE_DATATYPE, SHARE_FILL, SHARE_PIPELINE, SHARE_ATTRIBUTE = (
    1 << 0x1, 1 << 0x3, 1 << 0x5, 1 << 0xB, 1 << 0xC)
SHARE_ALL = SHARE_DATASPACE | SHARE_DATATYPE | SHARE_FILL | SHARE_PIPELINE | SHARE_ATTRIBUTE


def sohm_file(path, indexes=((SHARE_ALL, 8),), phase=None, libver="earliest"):
    """An h5py File whose file creation properties hold a shared-message
    table: (message types, minimum message size) an index, and the list's
    phase change (the most messages a list holds, the fewest a B-tree
    does), as `h5repack --ssize` sets them. The superblock is version 2
    (libver "earliest": SOHM needs a superblock extension) or 3."""
    fcpl = _set(h5py.h5p.create(h5py.h5p.FILE_CREATE), ("H5Pset_shared_mesg_nindexes", len(indexes)),
                *(("H5Pset_shared_mesg_index", i, mask, size) for i, (mask, size) in enumerate(indexes)),
                *([("H5Pset_shared_mesg_phase_change", *phase)] if phase else []))
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    if libver == "latest":
        fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))


def _sohm_contents(f, rng, attrs_each: int):
    """Datasets and groups whose messages repeat, so that the table shares
    them: two groups of chunked datasets with one dataspace, datatype,
    fill value and pipeline, a contiguous one, a dataset of a committed
    datatype, and `attrs_each` attributes on each object, most of them
    the same on every object (a shared attribute with a shared dataspace
    and datatype), one a variable-length string."""
    f["point"] = np.dtype([("x", "<f4"), ("n", "<i2")])
    for gname in ("a", "b"):
        g = f.create_group(gname)
        for dname, comp in (("x", "gzip"), ("y", "lzf")):
            ds = g.create_dataset(dname, data=rng.standard_normal((13, 6)).astype("<f4"), chunks=(4, 3),
                                  compression=comp, shuffle=True, fillvalue=-1.5)
            ds.attrs["note"] = f"{gname}/{dname}"
        g.create_dataset("flat", data=np.arange(24, dtype=">i2").reshape(4, 6))
        pts = np.zeros(5, f["point"].dtype)
        pts["x"], pts["n"] = rng.standard_normal(5), np.arange(5)
        g.create_dataset("points", data=pts, dtype=f["point"])
    for obj in (f, f["a"], f["b"], f["a/x"], f["b/x"], f["a/points"]):
        for i in range(attrs_each):
            obj.attrs[f"shared{i:02d}"] = np.arange(6, dtype="<f8") * i
        obj.attrs["scale"] = np.array([0.5, 2.0], "<f4")


def write_sohm(directory: Path):
    """sohm_list.h5 (superblock 2: two list indexes, dataspaces and
    datatypes in one, fill values, pipelines and attributes in the other)
    and sohm_btree.h5 (superblock 3: one index of every type, past its
    phase change to a v2 B-tree, dense attributes shared)."""
    rng = np.random.default_rng(20)
    with sohm_file(directory / "sohm_list.h5", indexes=(
            (SHARE_DATASPACE | SHARE_DATATYPE, 8),
            (SHARE_FILL | SHARE_PIPELINE | SHARE_ATTRIBUTE, 8))) as f:
        _sohm_contents(f, rng, 3)
    with sohm_file(directory / "sohm_btree.h5", phase=(4, 2), libver="latest") as f:
        _sohm_contents(f, rng, 10)  # past 8 attributes: dense storage


CIFAR_SOHM_ROWS = 128


def write_cifar_sohm(path, rows: int = CIFAR_SOHM_ROWS):
    """The CIFAR-10 fixture shard's first `rows` rows as `h5repack --ssize`
    leaves a file: every message type shared (one index), the layouts and
    filters kept (a row a chunk through lzf, shuffle and fletcher32;
    unfiltered, 128 rows would be 393 KB), and attributes on both
    datasets and on the root."""
    images, labels = cifar_images(CIFAR_ROWS)
    with sohm_file(path) as f:
        f.attrs["source"] = "cifar10_train_latest.h5"
        for name, arr, chunk in (("data", images[:rows], 1), ("labels", labels[:rows], 64)):
            ds = f.create_dataset(name, data=arr, maxshape=(None,) + arr.shape[1:],
                                  chunks=(chunk,) + arr.shape[1:], compression="lzf", shuffle=True,
                                  fletcher32=True)
            ds.attrs["rows"] = np.int64(rows)
            ds.attrs["source"] = "cifar10_train_latest.h5"


def write_sohm_checkpoint(src, dst):
    """A copy of the checkpoint `src`, every group, dataset and attribute
    made anew in a file that shares every message type."""
    with h5py.File(src, "r") as f, sohm_file(dst) as g:
        def copy(a, b):
            b.attrs.update(a.attrs)
            for name, item in a.items():
                if isinstance(item, h5py.Group):
                    copy(item, b.create_group(name))
                else:
                    b.create_dataset(name, data=item[()]).attrs.update(item.attrs)
        copy(f, g)


HUGE_ATTRIBUTE = 1100  # int32 elements: past the attribute heap's 4096-byte managed objects


def write_filtered_heap(path):
    """Groups whose dense links lie in a fractal heap with I/O filters
    (H5Pset_deflate, and H5Pset_fletcher32 before it, on the group's
    creation properties; links dense from the first): "deflate" holds 150
    links (direct blocks under indirect ones) and a soft link of 100,000
    characters (a huge object, in the heap's B-tree, filtered);
    "fletcher32" holds 30. Both hold 12 attributes and one of
    HUGE_ATTRIBUTE elements (HDF5 keeps a group's attributes in a heap of
    its own, unfiltered)."""
    with h5py.File(path, "w", libver="latest") as f:
        target = f.create_dataset("target", data=np.arange(5, dtype="<i4"))
        for name, calls, links in (
                ("deflate", [("H5Pset_deflate", 6)], 150),
                ("fletcher32", [("H5Pset_fletcher32",), ("H5Pset_deflate", 1)], 30)):
            gcpl = _set(h5py.h5p.create(h5py.h5p.GROUP_CREATE), *calls,
                        ("H5Pset_link_phase_change", 0, 0))
            g = h5py.Group(h5py.h5g.create(f.id, name.encode(), gcpl=gcpl))
            for i in range(links):
                g[f"link{i:03d}"] = target
            g.create_dataset("own", data=np.arange(links, dtype="<u2"))
            if name == "deflate":
                g["long"] = h5py.SoftLink("/" + "x" * 60_000)
            for i in range(12):
                g.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype="<f8")
            g.attrs["huge"] = np.arange(HUGE_ATTRIBUTE, dtype="<i4")


def float_type(size, sign, epos, esize, mpos, msize, bias, order="<", norm=h5py.h5t.NORM_IMPLIED,
               offset=0, precision=None):
    """An HDF5 float type of any layout (TypeFloatID's set_fields and
    set_ebias): field positions from the element's least significant bit,
    the precision bits from `offset`."""
    t = (h5py.h5t.IEEE_F32LE if size <= 4 else h5py.h5t.IEEE_F64LE).copy()
    if size > t.get_size():
        t.set_size(size)
        t.set_precision(8 * size)
    t.set_fields(sign, epos, esize, mpos, msize)
    t.set_precision(precision or 8 * size - offset)
    t.set_offset(offset)
    t.set_size(size)
    t.set_ebias(bias)
    t.set_norm(norm)
    t.set_order(h5py.h5t.ORDER_BE if order == ">" else h5py.h5t.ORDER_LE)
    return t


# name: (size, sign, exponent position and size, mantissa position and size,
# bias[, normalization, offset, precision])
FLOAT_LAYOUTS = {
    "bf16": (2, 15, 7, 8, 0, 7, 127),  # read as float32
    "e7m24": (4, 31, 24, 7, 0, 24, 63),  # read as float64
    "f8_bias1000": (8, 63, 52, 11, 0, 52, 1000),  # read as long double
    "fp8_e4m3": (1, 7, 3, 4, 0, 3, 7),  # read as float16
    "stored_lead": (4, 31, 23, 8, 0, 23, 127, h5py.h5t.NORM_NONE),  # float32, leading 1 stored
    "offset": (4, 27, 20, 7, 0, 20, 63, h5py.h5t.NORM_IMPLIED, 2, 28),  # precision from bit 2
}


def float_patterns(layout, count: int, rng) -> np.ndarray:
    """Bit patterns of a float layout, (n, size) uint8 least significant
    byte first: every pattern of a layout of 16 bits or fewer, else ±0,
    ±inf, NaNs, the least and largest denormals, the least normals, the
    largest finite values, and `count` random patterns."""
    size, sign, epos, esize, mpos, msize = layout[:6]
    if size <= 2:
        return np.arange(1 << (8 * size), dtype=f"<u{size}").view(np.uint8).reshape(-1, size)
    top, mtop = (1 << esize) - 1, (1 << msize) - 1
    special = [(e, m) for e in (0, 1, top - 1, top) for m in (0, 1, mtop >> 1, mtop)]
    values = [(s << sign) | (e << epos) | (m << mpos) for s in (0, 1) for e, m in special]
    raw = np.array([v.to_bytes(size, "little") for v in values], dtype=f"V{size}").view(np.uint8)
    return np.concatenate([raw.reshape(-1, size), rng.integers(0, 256, (count, size), np.uint8)])


def write_floats(path):
    """Non-IEEE floats (h5py reads each in the smallest numpy float that
    holds it, HDF5 converting): each layout of FLOAT_LAYOUTS in both byte
    orders over float_patterns (every bf16 and fp8 pattern), chunked
    through shuffle and deflate; a float marked VAX-order in a version 1
    datatype message (HDF5 and h5py read it big-endian); bf16 from float32
    values (HDF5 rounding
    them on the way in) and as an attribute; a compound with a bf16
    member; and long double as numpy holds it (written as it is); libver
    "latest"."""
    rng = np.random.default_rng(21)
    with h5py.File(path, "w", libver="latest") as f:
        for name, layout in FLOAT_LAYOUTS.items():
            raw = float_patterns(layout, 500, rng)
            for order in "<>":
                t = float_type(*layout[:7], order, *layout[7:])
                data = np.ascontiguousarray(raw[:, ::-1] if order == ">" else raw)
                data = data.view(f"V{layout[0]}").reshape(-1)
                chunk = min(len(data), 4096)
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk((chunk,))
                dcpl.set_shuffle()
                dcpl.set_deflate(6)
                low_level(f, f"{name}_{'le' if order == '<' else 'be'}", t, data, dcpl=dcpl, mtype=t)
        vax = float_type(*FLOAT_LAYOUTS["e7m24"])
        vax.set_order(h5py.h5t.ORDER_VAX)  # in a version 1 datatype message: read as big-endian
        low_level(f, "e7m24_vax_flag", vax, float_patterns(FLOAT_LAYOUTS["e7m24"], 100, rng)
                  .view("V4").reshape(-1), mtype=vax)
        bf16 = float_type(*FLOAT_LAYOUTS["bf16"])
        values = np.concatenate([rng.standard_normal(64) * 10.0 ** rng.integers(-40, 39, 64),
                                 [np.inf, -np.inf, np.nan, 0.0, -0.0, 3.0e38, 1e-45]]).astype("<f4")
        low_level(f, "bf16_from_float32", bf16, values, mtype=h5py.h5t.IEEE_F32LE)
        pair = h5py.h5t.create(h5py.h5t.COMPOUND, 8)
        pair.insert(b"x", 0, bf16)
        pair.insert(b"n", 4, h5py.h5t.STD_I32LE)
        rec = np.zeros(6, [("x", "<u2"), ("pad", "<u2"), ("n", "<i4")])
        rec["x"] = [0x3F80, 0xC000, 0x7F80, 0x0081, 0x0001, 0x8000]  # no NaN: numpy compares no NaN in a record
        rec["n"] = np.arange(6)
        mem = h5py.h5t.create(h5py.h5t.COMPOUND, 8)
        mem.insert(b"x", 0, bf16)
        mem.insert(b"n", 4, h5py.h5t.STD_I32LE)
        low_level(f, "compound_bf16", pair, rec.view("V8").reshape(-1), mtype=mem)
        space = h5py.h5s.create_simple((4,))
        attr = h5py.h5a.create(f.id, b"bf16", bf16, space)
        attr.write(np.array([0x3F80, 0x4049, 0xFF80, 0x0080], "<u2").view("V2"), mtype=bf16)
        ld = (rng.standard_normal(40) * 10.0 ** rng.integers(-300, 300, 40)).astype(np.longdouble)
        f.create_dataset("long_double_le", data=ld)
        f.create_dataset("long_double_be", data=ld.astype(ld.dtype.newbyteorder(">")))


def h5py_digests(path) -> dict:
    """Each dataset's digest as h5py reads it, references by their
    objects' names (testdata.dereferencer), read from the file's
    directory, against which external raw data names resolve."""
    from convnet_tpu_torch.testdata import datasets, dereferencer, describe

    here = os.getcwd()
    os.chdir(Path(path).parent)
    try:
        with h5py.File(Path(path).name, "r") as f:
            deref = dereferencer(f, h5py.Reference, h5py.RegionReference)
            return {p: describe(ds[()], deref) for p, ds in datasets(f)}
    finally:
        os.chdir(here)


FIXTURES = ("cifar10_train_latest.h5", "cifar10_mean_latest.h5", "checkpoint_latest.h5",
            "formats_latest.h5", "references_latest.h5", "references_earliest.h5",
            "vds_shard0.h5", "vds_shard1.h5", "vds_shard2.h5", "vds.h5", "vds_printf.h5",
            "cifar10_vds.h5", "external.h5", "szip.h5", "cifar10_szip.h5", "sohm_list.h5",
            "sohm_btree.h5", "cifar10_sohm.h5", "filtered_heap.h5", "floats.h5")


def write_all(directory: Path):
    """Every fixture and digests.json, in `directory`."""
    directory.mkdir(parents=True, exist_ok=True)
    images, labels = cifar_images(CIFAR_ROWS)
    write_cifar_shard(directory / "cifar10_train_latest.h5", images, labels)
    write_mean(directory / "cifar10_mean_latest.h5", images)
    write_checkpoint(directory / "checkpoint_latest.h5", *checkpoint_params())
    write_formats(directory / "formats_latest.h5", "cifar10_mean_latest.h5")
    write_references(directory / "references_latest.h5")
    write_references(directory / "references_earliest.h5", libver="earliest")
    write_vds(directory)
    write_cifar_vds(directory / "cifar10_vds.h5")
    write_external(directory)
    write_szip(directory / "szip.h5")
    write_cifar_szip(directory / "cifar10_szip.h5")
    write_sohm(directory)
    write_cifar_sohm(directory / "cifar10_sohm.h5")
    write_filtered_heap(directory / "filtered_heap.h5")
    write_floats(directory / "floats.h5")
    digests = {name: h5py_digests(directory / name) for name in FIXTURES}
    (directory / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    return digests


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    from convnet_tpu_torch.testdata import HDF5_DIR

    written = write_all(HDF5_DIR)
    sizes = {p.name: p.stat().st_size for p in sorted(HDF5_DIR.iterdir())}
    print(json.dumps({"datasets": sum(len(v) for v in written.values()), "bytes": sizes,
                      "total_bytes": sum(sizes.values())}))
