"""The port's committed HDF5 fixtures, written with h5py, and their digests
as h5py reads them:

    python tests/torch_port_hdf5_fixtures.py

writes convnet_tpu_torch/testdata/hdf5/*.h5 and digests.json (see
convnet_tpu_torch/testdata/__init__.py). It imports h5py, which no module
of the port may, so it lives beside the tests; the tests
(tests/test_torch_port_hdf5_formats.py) write the same formats with its
functions. Every array comes from numpy with a fixed seed.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import h5py
import numpy as np

REPO = Path(__file__).resolve().parent.parent

CIFAR_ROWS, CIFAR_SIZE, CIFAR_CLASSES = 256, 32, 10
CHECKPOINT_EDGES = 10  # past 8 links: the root group's links are dense


def cifar_images(n: int, seed: int = 0):
    """n uint8 32x32x3 images and int32 labels: each image an 8x8 grid of
    4x4-pixel blocks, each block a colour of its class's palette of four
    plus a little noise, so that LZF finds repeats in every row."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CIFAR_CLASSES, n).astype(np.int32)
    palettes = rng.integers(0, 256, (CIFAR_CLASSES, 4, 3))
    blocks = palettes[labels[:, None, None], rng.integers(0, 4, (n, 8, 8))]
    blocks = np.clip(blocks + rng.integers(-8, 9, blocks.shape), 0, 255).astype(np.uint8)
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


def write_all(directory: Path):
    """Every fixture and digests.json, in `directory`."""
    from convnet_tpu_torch.testdata import datasets, describe

    directory.mkdir(parents=True, exist_ok=True)
    images, labels = cifar_images(CIFAR_ROWS)
    write_cifar_shard(directory / "cifar10_train_latest.h5", images, labels)
    write_mean(directory / "cifar10_mean_latest.h5", images)
    write_checkpoint(directory / "checkpoint_latest.h5", *checkpoint_params())
    write_formats(directory / "formats_latest.h5", "cifar10_mean_latest.h5")
    digests = {}
    for name in ("cifar10_train_latest.h5", "cifar10_mean_latest.h5", "checkpoint_latest.h5",
                 "formats_latest.h5"):
        with h5py.File(directory / name) as f:
            digests[name] = {p: describe(ds[()]) for p, ds in datasets(f)}
    (directory / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    return digests


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    from convnet_tpu_torch.testdata import HDF5_DIR

    written = write_all(HDF5_DIR)
    sizes = {p.name: p.stat().st_size for p in sorted(HDF5_DIR.iterdir())}
    print(json.dumps({"datasets": sum(len(v) for v in written.values()), "bytes": sizes,
                      "total_bytes": sum(sizes.values())}))
