"""The HDF5 formats the port's reader (convnet_tpu_torch/hdf5.py) read last:
references (so that datasets with dimension scales open), virtual
datasets, raw data in external files and szip, against h5py and against
the JAX package's readers (HDF5Stream, _load_mean_std and
checkpoint.load, all through h5py) on the same files; and the formats
the reader still refuses, each named in its error.

tests/test_torch_port_hdf5_formats.py holds every dataset and attribute
of these files to h5py's read (its cases references, virtual_datasets,
external_raw_data and szip); this file holds the paths that users take
through them.
"""

import mmap
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


def _streams(path, *names, batch=8):
    """(the port's HDF5Stream, the JAX package's) over each dataset."""
    text = f'name: "s" batch_size: {batch}\n' + "".join(
        f'data_config {{ layer_name: "{n}" data_type: HDF5 file_pattern: "{path}" '
        f'dataset_name: "{n}" }}\n' for n in names)
    ours, theirs = pt_config.parse_dataset_config(text), jax_config.parse_dataset_config(text)
    return [(datahandler.HDF5Stream(a), jax_datahandler.HDF5Stream(b))
            for a, b in zip(ours.data_config, theirs.data_config)]


def _same_streams(pairs, extra_rows=()):
    """Every row, shuffled rows with repeats, and `extra_rows` (modulo the
    stream's rows), array-equal between each pair; both closed after."""
    try:
        for a, b in pairs:
            n = a.num_rows
            assert n == b.num_rows
            rng = np.random.default_rng(n)
            for idx in (np.arange(n), rng.integers(0, n, 2 * n), np.asarray(extra_rows, np.int64) % n):
                if not len(idx):  # h5py cannot read an empty selection of rows
                    continue
                got, want = a.read_rows(idx), b.read_rows(idx)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)
    finally:
        for a, b in pairs:
            a.close()
            b.close()


# -- references: the fault, and dimension scales -------------------------------------


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_dimension_scaled_datasets_stream_as_in_jax(tmp_path, libver):
    """A shard whose images and labels carry a dimension scale (the
    DIMENSION_LIST attribute, a vlen of object references, which the port
    could not parse before, so that it could not open the dataset at
    all), and a mean file whose mean carries one: the JAX HDF5Stream and
    _load_mean_std against the port's, array-equal."""
    images, labels = fx.cifar_images(24, seed=2)
    with h5py.File(tmp_path / "shard.h5", "w", libver=libver) as f:
        data = f.create_dataset("data", data=images, chunks=(4, 32, 32, 3), compression="gzip")
        f.create_dataset("labels", data=labels)
        index = f.create_dataset("index", data=np.arange(24))
        index.make_scale("image index")
        data.dims[0].attach_scale(index)
        f["labels"].dims[0].attach_scale(index)
        data.dims[3].label = "colour"
    with h5py.File(tmp_path / "mean.h5", "w", libver=libver) as f:
        mean, std = fx.mean_std(images)
        f.create_dataset("mean", data=mean.astype(np.float32))
        f.create_dataset("std", data=std.astype(np.float32))
        channel = f.create_dataset("channel", data=np.arange(3))
        channel.make_scale("channel")
        f["mean"].dims[2].attach_scale(channel)
    with hdf5.File(tmp_path / "shard.h5") as f:
        assert [f[r].name for r in f["data"].attrs["DIMENSION_LIST"][0]] == ["/index"]
    _same_streams(_streams(tmp_path / "shard.h5", "data", "labels"), extra_rows=[23, 0, 23])
    for got, want in zip(datahandler._load_mean_std(str(tmp_path / "mean.h5")),
                         jax_datahandler._load_mean_std(str(tmp_path / "mean.h5"))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_checkpoint_with_reference_attributes_loads_alike(tmp_path):
    """A JAX checkpoint whose datasets h5py gave reference attributes (a
    dimension scale on each w, an object reference to its momentum, a
    region reference into its bias): checkpoint.load and load_edge of both
    packages give array-equal params and momenta."""
    params, moms = fx.checkpoint_params(edges=3)
    path = jax_ckpt.save(str(tmp_path / "jax"), "refs", params, moms, step=5, timestamp="1")
    with h5py.File(path, "a") as f:
        for edge in params:
            g = f[edge]
            rows = g.create_dataset("rows", data=np.arange(4))  # beside w, b and their momenta
            rows.make_scale("rows")
            g["w"].dims[0].attach_scale(rows)
            g["w"].attrs["momentum"] = g["w_mom"].ref
            g["w"].attrs["bias_head"] = g["b"].regionref[0:2]
    got, got_moms, step = ckpt.load(path)
    want, want_moms, want_step = jax_ckpt.load(path)
    assert step == want_step == 5 and sorted(got) == sorted(want)
    for edge in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[edge][k], np.asarray(want[edge][k]))
            np.testing.assert_array_equal(got_moms[edge][k], np.asarray(want_moms[edge][k]))
    one, jax_one = ckpt.load_edge(path, "edge01"), jax_ckpt.load_edge(path, "edge01")
    for k in ("w", "b"):
        np.testing.assert_array_equal(one[k], np.asarray(jax_one[k]))
    with hdf5.File(path) as f:
        w = f["edge01/w"]
        assert f[w.attrs["momentum"]].name == "/edge01/w_mom"
        np.testing.assert_array_equal(f["edge01/b"][w.attrs["bias_head"]], params["edge01"]["b"][:2])


def _flat(value):
    """The references in a value: itself, or those in its elements and
    fields."""
    if isinstance(value, (h5py.Reference, hdf5.Reference)):
        yield value
    elif isinstance(value, (np.ndarray, np.void)) and value.dtype.names:
        for name in value.dtype.names:
            yield from _flat(value[name])
    elif isinstance(value, np.ndarray) and value.dtype.hasobject:
        for x in value.reshape(-1):
            yield from _flat(x)


def _references(obj, prefix=""):
    """(where, reference) of each reference in an object's attributes and,
    for a group, in its members' and its datasets' elements."""
    for key, value in obj.attrs.items():
        yield from ((f"{prefix}@{key}", x) for x in _flat(value))
    for name in obj.keys() if hasattr(obj, "keys") else []:
        item = obj[name]
        yield from _references(item, f"{prefix}/{name}")
        if hasattr(item, "shape") and item.dtype.hasobject:
            yield from ((f"{prefix}/{name}[]", x) for x in _flat(item[()]))


@pytest.mark.parametrize("name", ["references_latest.h5", "references_earliest.h5"])
def test_references_open_objects_under_h5pys_names(name):
    """Every reference of the fixture, in attributes (DIMENSION_LIST,
    REFERENCE_LIST's compound, a group's) and datasets: null where h5py's
    is; otherwise `f[ref]` opens an object of h5py's class and name."""
    path = testdata.HDF5_DIR / name
    with hdf5.File(path) as mine, h5py.File(path, "r") as theirs:
        got, want = list(_references(mine)), list(_references(theirs))
        assert [w for w, _ in got] == [w for w, _ in want] and len(want) > 20
        kinds = {"Group": hdf5.Group, "Dataset": hdf5.Dataset}
        for (where, a), (_, b) in zip(got, want):
            assert bool(a) == bool(b), where
            if b:
                x, y = mine[a], theirs[b]
                assert x.name == y.name, (where, x.name, y.name)
                assert isinstance(x, kinds[type(y).__name__]), where
        with pytest.raises(ValueError):
            mine[hdf5.Reference()]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_region_references_read_as_h5pys(libver):
    """`ds[regref]` for each region of the fixture: regular hyperslabs in
    their block shape ((2, 3) for [1:3, ::2]), an irregular one and
    points flat in HDF5's order, all, none; a region of another dataset
    raises ValueError, as in h5py."""
    path = testdata.HDF5_DIR / f"references_{libver}.h5"
    with hdf5.File(path) as mine, h5py.File(path, "r") as theirs:
        shapes = []
        for a, b in zip(mine["regions"][()], theirs["regions"][()]):
            if not b:
                assert not a
                continue
            got, want = mine["t"][a], theirs["t"][b]
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            shapes.append(got.shape)
        assert shapes[0] == (2, 3) and (12,) in shapes and (4,) in shapes and (0, 0) in shapes
        region = mine.attrs["region"]
        np.testing.assert_array_equal(mine[region][region], theirs["t"][theirs.attrs["region"]])
        with pytest.raises(ValueError):
            mine["data"][region]


# -- virtual datasets ----------------------------------------------------------------


def test_hdf5_stream_over_virtual_datasets_matches_jax(tmp_path, monkeypatch):
    """The JAX HDF5Stream and the port's over the fixture's virtual
    datasets, from another working directory (sources resolve against the
    virtual file's): the stacked shards with their unmapped band (fill 7)
    and the rows of a missing source file (fill 7), the part-row blocks,
    the same-file mapping, and the unlimited printf and strided mappings
    (shapes as HDF5 sizes them at open)."""
    monkeypatch.chdir(tmp_path)
    n = fx.VDS_SHARD_ROWS
    with hdf5.File(testdata.HDF5_DIR / "vds.h5") as f:
        rows = f["rows"][...]
    np.testing.assert_array_equal(rows[:n], fx.vds_shard(0))
    np.testing.assert_array_equal(rows[n + 3 : 3 * n + 3 : 2], fx.vds_shard(1))
    assert (rows[n : n + 3] == 7).all() and (rows[3 * n + 6 :] == 7).all()  # unmapped, missing
    _same_streams(_streams(testdata.HDF5_DIR / "vds.h5", "rows", "blocks", "same_file"),
                  extra_rows=[3 * n + 7, n + 1, 0, 3 * n + 7])
    pairs = _streams(testdata.HDF5_DIR / "vds_printf.h5", "printf", "unlimited")
    assert [a.num_rows for a, _ in pairs] == [1 + 2 * (n + 2) + n, 2 + (n // 2 - 1) * 3 + 2]
    _same_streams(pairs)


def test_cifar_virtual_shard_batches_as_the_shard(tmp_path):
    """The CIFAR-10 fixture shard's halves written by the port's writer
    beside a copy of cifar10_vds.h5: DataHandlers from the CIFAR-10
    template over the virtual shard and over the shard give array-equal
    batches, and the JAX HDF5Stream reads the virtual shard alike."""
    with hdf5.File(testdata.CIFAR_SHARD) as f:
        images, labels = f["data"][...], f["labels"][...]
    half = len(labels) // 2
    for i in range(2):
        with hdf5.File(tmp_path / f"cifar10_half{i}.h5", "w") as f:
            f.create_appendable("data", images.shape[1:], images.dtype, chunk_rows=16).append(
                images[i * half : (i + 1) * half])
            f.create_dataset("labels", data=labels[i * half : (i + 1) * half])
    shutil.copy(testdata.HDF5_DIR / "cifar10_vds.h5", tmp_path / "cifar10_vds.h5")
    template = (REPO / "examples" / "cifar10" / "cifar10_train_data.pbtxt").read_text()
    template = template.replace("pipeline_loads: true", "pipeline_loads: false").replace(
        "/data/cifar10/mean.h5", str(testdata.CIFAR_MEAN))
    handlers = [datahandler.DataHandler(pt_config.parse_dataset_config(
        template.replace("/data/cifar10/train.h5", str(path))))
        for path in (tmp_path / "cifar10_vds.h5", testdata.CIFAR_SHARD)]
    try:
        for _ in range(4):
            x, y = (h.get_batch() for h in handlers)
            assert set(x) == set(y)
            for k in y:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
    finally:
        for h in handlers:
            h.close()
    _same_streams(_streams(tmp_path / "cifar10_vds.h5", "data", "labels"), extra_rows=[half, half - 1])


def test_corrupted_virtual_dataset_mappings_raise(tmp_path):
    """A byte of vds.h5's mappings flipped (a source file's name, in the
    global heap): the mappings' checksum no longer matches, and the port
    raises OSError naming it where h5py fails to open the dataset."""
    for p in testdata.HDF5_DIR.glob("vds*.h5"):
        shutil.copy(p, tmp_path / p.name)
    raw = bytearray((tmp_path / "vds.h5").read_bytes())
    at = raw.find(b"vds_shard1.h5\0data\0")
    assert at > 0
    raw[at + 9] ^= 0x01
    (tmp_path / "vds.h5").write_bytes(bytes(raw))
    with hdf5.File(tmp_path / "vds.h5") as f:
        with pytest.raises(OSError, match="virtual dataset mappings: checksum mismatch"):
            f["rows"]
        np.testing.assert_array_equal(f["own"][...], np.arange(40).reshape(10, 4))
    with h5py.File(tmp_path / "vds.h5", "r") as f, pytest.raises((OSError, KeyError)):
        f["rows"][...]


# -- raw data in external files --------------------------------------------------------


def test_external_raw_data_streams_through_memory_maps(tmp_path, monkeypatch):
    """External raw data from the fixtures' directory: the port's
    HDF5Stream reads each slot's file through a memory map, rows across a
    slot's end and past a file's end (zeros) as the JAX stream does."""
    for p in testdata.HDF5_DIR.glob("external*"):
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.chdir(tmp_path)
    pairs = _streams(tmp_path / "external.h5", "rows", "two_slots")
    layout = pairs[0][0]._ds._layout
    _same_streams(pairs, extra_rows=[5, 2, 2])
    assert layout.external is not None and layout.external._maps == {}  # closed with the file
    with hdf5.File(tmp_path / "external.h5") as f:
        f["rows"][[1, 4]]
        maps = f["rows"]._layout.external._maps
        assert sorted(maps) == ["external_0.bin", "external_1.bin"]
        assert all(isinstance(mm, mmap.mmap) for mm, _ in maps.values())


_PREFIXED = """
import os, sys
import numpy as np
import h5py
from convnet_tpu_torch import hdf5
os.chdir(sys.argv[2])
with h5py.File(sys.argv[1], "r") as f, hdf5.File(sys.argv[1]) as g:
    for name in ("rows", "two_slots"):
        assert np.array_equal(f[name][...], g[name][...]), name
print("same")
"""


@pytest.mark.parametrize("prefix", ["${ORIGIN}", "${ORIGIN}/", "DIR"])
def test_external_file_prefix_as_h5pys(tmp_path, prefix):
    """HDF5_EXTFILE_PREFIX, which HDF5 reads when the library starts (so
    h5py's side runs in a process of its own): "${ORIGIN}" the external
    file's directory, or a directory named outright; both packages then
    read the raw data from another working directory, alike."""
    data = tmp_path / "data"
    data.mkdir()
    (tmp_path / "elsewhere").mkdir()
    for p in testdata.HDF5_DIR.glob("external*"):
        shutil.copy(p, data / p.name)
    env = dict(os.environ, PYTHONPATH=str(REPO),
               HDF5_EXTFILE_PREFIX=prefix.replace("DIR", str(data)))
    proc = subprocess.run([sys.executable, "-c", _PREFIXED, str(data / "external.h5"),
                           str(tmp_path / "elsewhere")], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["same"], proc.stderr


# -- szip ------------------------------------------------------------------------------


def test_szip_shard_streams_as_in_jax():
    """The committed CIFAR-10 szip shard through both HDF5Streams; the time
    spent in the filter counted in the layout's decode_seconds."""
    pairs = _streams(testdata.HDF5_DIR / "cifar10_szip.h5", "data", "labels")
    layout = pairs[0][0]._ds._layout
    _same_streams(pairs)
    assert layout.filters[0][0] == 4 and layout.decode_seconds > 0


def test_szip_chunk_that_ends_early_raises(tmp_path):
    """A chunk whose szip stream stops before the elements it says it
    holds: OSError from the port, as from h5py."""
    path = tmp_path / "short.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", shape=(64,), chunks=(64,), dtype="u1", compression="szip")
        ds.id.write_direct_chunk((0,), struct.pack("<I", 64) + b"\x05", filter_mask=0)
    with hdf5.File(path) as f, pytest.raises(OSError, match="szip data ends early"):
        f["x"][...]
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["x"][...]


# -- what stays refused ---------------------------------------------------------------
# (plugin filters: tests/test_torch_port_hdf5.py and
# tests/test_torch_port_hdf5_shared.py, which holds the floats h5py cannot
# read; shared-message tables, filtered fractal heaps and non-IEEE floats
# read since: tests/test_torch_port_hdf5_shared.py)


def _three_byte_integer(path):
    """A 3-byte integer, which h5py gives numpy's "<i3", which numpy has
    not (HDF5 converts on write)."""
    t = h5py.h5t.STD_I32LE.copy()
    t.set_precision(24)
    t.set_size(3)
    with h5py.File(path, "w") as f:
        fx.low_level(f, "x", t, np.arange(6, dtype="<i4") - 3, mtype=h5py.h5t.NATIVE_INT32)


def _revised_reference(path):
    """An object reference dataset whose datatype message is rewritten as
    HDF5 1.12's revised object reference (version 4, type 2), which h5py
    does not write (superblock 0: no checksum to restore)."""
    with h5py.File(path, "w") as f:
        f.create_dataset("t", data=np.arange(3))
        f.create_dataset("x", data=[f["t"].ref], dtype=h5py.ref_dtype)
    raw = bytearray(path.read_bytes())
    at = raw.find(bytes([0x17, 0, 0, 0, 8, 0, 0, 0]))
    assert at > 0
    raw[at : at + 2] = bytes([0x47, 0x02])
    path.write_bytes(bytes(raw))


def _msb_set_float(path):
    """A float whose mantissa's leading bit is always set, which HDF5 does
    not convert for h5py ("normalization method not implemented yet")."""
    t = fx.float_type(4, 31, 23, 8, 0, 23, 127, norm=h5py.h5t.NORM_MSBSET)
    with h5py.File(path, "w") as f:
        fx.low_level(f, "x", t, np.array([0x3F800000, 0x40490FDB], "<u4").view("V4"), mtype=t)


@pytest.mark.parametrize("kind,named", [
    ("three_byte_integer", "3-byte integer"), ("revised_reference", "revised reference"),
    ("msb_set_float", "leading bit is always set")])
def test_still_refused_formats_raise_naming_them(tmp_path, kind, named):
    """Kinds of file h5py does not read either: NotImplementedError naming
    what the file holds, where h5py's read fails too."""
    path = tmp_path / f"{kind}.h5"
    {"three_byte_integer": _three_byte_integer, "revised_reference": _revised_reference,
     "msb_set_float": _msb_set_float}[kind](path)
    with pytest.raises(NotImplementedError, match=named):
        with hdf5.File(path) as f:
            for name in f:
                item = f[name]
                for member in (item.keys() if hasattr(item, "keys") else [None]):
                    (item[member] if member else item)[...]
    with h5py.File(path, "r") as f, pytest.raises(Exception):
        for name in f:
            f[name][...]
