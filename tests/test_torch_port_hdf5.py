"""The port's own HDF5 reader and writer (convnet_tpu_torch/hdf5.py) against
h5py, an independent implementation, and the port's HDF5 paths against
the JAX package's on the same files: checkpoints both ways, HDF5 streams
with a mean file, the extract CLI's output, and the data tools of
convnet_tpu_torch/tools against their tools/*.py counterparts.

h5py writes the files the reader is held to and reads the files the
writer makes; every comparison is array-equal unless a tolerance is named.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from torch_port_parity import jax_reference_numerics  # noqa: E402,F401  (autouse fixture)

from convnet_tpu import checkpoint as jax_ckpt  # noqa: E402
from convnet_tpu import config as jax_config  # noqa: E402
from convnet_tpu import model as jax_model  # noqa: E402
from convnet_tpu.cli import extract as jax_extract  # noqa: E402
from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler  # noqa: E402
from convnet_tpu.data.datawriter import DataWriter as JaxDataWriter  # noqa: E402
from convnet_tpu.graph import build_graph as jax_build_graph  # noqa: E402
from convnet_tpu_torch import checkpoint as ckpt  # noqa: E402
from convnet_tpu_torch import config as pt_config  # noqa: E402
from convnet_tpu_torch import hdf5  # noqa: E402
from convnet_tpu_torch.cli import extract  # noqa: E402
from convnet_tpu_torch.data.datahandler import DataHandler  # noqa: E402
from convnet_tpu_torch.data.datawriter import DataWriter  # noqa: E402
from convnet_tpu_torch.tools import compute_mean, dump_activations, make_hdf5_dataset  # noqa: E402
from convnet_tpu_torch.tools import make_raw_cache  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DIGITS = REPO / "examples" / "digits" / "digits_pretrained.h5"
RNG_SHAPE = (37, 6, 10)  # 37 rows: chunks of 5 or 8 rows leave a partial edge chunk


def _x(dtype="u1", seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, RNG_SHAPE).astype(dtype)


# name -> (h5py create_dataset keywords, the data)
DATASETS = {
    "contiguous_f4": ({}, _x("<f4") / 7),
    "chunked_partial_edges": ({"chunks": (5, 4, 3)}, _x()),
    "deflate": ({"chunks": (8, 6, 10), "compression": "gzip"}, _x()),
    "shuffle_deflate": ({"chunks": (8, 3, 10), "compression": "gzip", "shuffle": True},
                        _x("<f4") / 3),
    "shuffle_only_f8": ({"chunks": (3, 6, 10), "shuffle": True}, _x("<f8") / 3),
    "empty": ({}, np.zeros((0, 3), np.float32)),
    "empty_chunked": ({"chunks": (4, 3), "maxshape": (None, 3)}, np.zeros((0, 3), np.float32)),
    "u1": ({}, _x("u1")),
    "i4": ({}, _x("i4") - 100),
    "i8": ({}, _x("i8") * -(2**40)),
    "f2": ({}, _x("f2") / 5),
    "f4": ({}, _x("f4") / 5),
    "f8": ({}, _x("f8") / 5),
    "big_endian_i4": ({}, (_x("i4") - 100).astype(">i4")),
    "big_endian_f8_chunked": ({"chunks": (6, 6, 10)}, (_x("f8") / 9).astype(">f8")),
    "one_d_i8": ({}, np.arange(-5, 50, dtype=np.int64)),
}


@pytest.fixture(scope="module")
def h5py_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "written_by_h5py.h5"
    with h5py.File(path, "w") as f:
        for name, (kw, data) in DATASETS.items():
            f.create_dataset(name, data=data, **kw)
        f.create_dataset("scalar_f8", data=2.5)
        f.create_dataset("scalar_i8", data=np.int64(-7))
        f.create_dataset("unwritten", shape=(4, 3), dtype="f4")
        f.create_dataset("unwritten_fill", shape=(4, 3), dtype="i4", fillvalue=9)
        # a compact dataset: its elements inside the object header
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((6, 2))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(12, dtype=np.int16).reshape(6, 2))
        f.create_dataset("vlen_strings", data=np.array(["a", "bb", "ccé"], dtype=object),
                         dtype=h5py.string_dtype())
        f.attrs["fixed"] = np.bytes_(b"abc")
        f.attrs["vlen"] = "héllo"
        f.attrs["step"] = 12
        f.attrs["fixed_array"] = np.array([b"ab", b"cde"])
        f.attrs["vlen_array"] = ["x", "yy"]
        f.attrs["f4_array"] = np.arange(5, dtype=np.float32)
        f.attrs["be_scalar"] = np.array(3, ">i2")
        f.attrs["empty"] = h5py.Empty("f4")
    return path


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_reads_h5py_datasets(h5py_file, name):
    """Every layout, filter pipeline and dtype: the whole array, a slice,
    an unsorted integer array with repeats, an integer and a negative one,
    each as h5py gives it; an index past the first axis raises TypeError."""
    with hdf5.File(h5py_file) as f, h5py.File(h5py_file) as g:
        a, b = f[name], g[name]
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a[...], b[...])
        assert a[...].dtype == b.dtype
        n = b.shape[0]
        np.testing.assert_array_equal(a[2:n - 3], b[2:n - 3])
        np.testing.assert_array_equal(a[::4], b[...][::4])
        if n:
            idx = np.array([n - 1, 3, 3, 0, n // 2, 3])
            np.testing.assert_array_equal(a[idx], b[...][idx])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[-1], b[-1])
            with pytest.raises(TypeError):
                a[idx, 1:3]
        else:
            assert a[np.array([], np.int64)].shape == (0,) + b.shape[1:]


@pytest.mark.parametrize("name", ["scalar_f8", "scalar_i8", "unwritten", "unwritten_fill",
                                  "compact", "vlen_strings"])
def test_reads_h5py_special_datasets(h5py_file, name):
    """Scalars, datasets with no storage yet (their fill value), compact
    storage and variable-length strings (bytes, as h5py gives them)."""
    with hdf5.File(h5py_file) as f, h5py.File(h5py_file) as g:
        a, b = f[name][()], g[name][()]
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)
        if np.ndim(b):
            assert a.dtype == b.dtype and f[name].shape == g[name].shape


def test_reads_h5py_attributes_with_h5py_types(h5py_file):
    with hdf5.File(h5py_file) as f, h5py.File(h5py_file) as g:
        assert list(f.attrs) == list(g.attrs)
        for key, want in g.attrs.items():
            got = f.attrs[key]
            if isinstance(want, h5py.Empty):
                assert got is None
                continue
            assert type(got) is type(want), key
            np.testing.assert_array_equal(got, want)
            assert getattr(got, "dtype", None) == getattr(want, "dtype", None), key
        assert f.attrs.get("missing", 4) == 4 and "vlen" in f.attrs


@pytest.mark.parametrize("members", [9, 200, 2000])
def test_reads_h5py_groups_of_many_members(tmp_path, members):
    """h5py splits a group's B-tree past 2K = 8 links a leaf and 32
    children a node: 9 members give two leaves, 200 and 2000 a tree of
    several levels."""
    path = tmp_path / "g.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("many")
        for i in range(members):
            g.create_dataset(f"d{i:05d}" if i % 2 else f"z{i}", data=np.array([i], np.int32))
    with hdf5.File(path) as f, h5py.File(path) as g:
        assert list(f["many"].keys()) == list(g["many"].keys())
        for name in g["many"]:
            assert f["many"][name][0] == g["many"][name][0]
            assert isinstance(f[f"many/{name}"], hdf5.Dataset)
        r = f._reader
        btree = f["many"]._links[0]
        assert (r.mm[r.addr(btree) + 5] > 0) == (members > 9)  # the root node's level


def test_reads_object_header_continuations(tmp_path):
    """Attributes added after creation go to continuation blocks."""
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("d", data=np.arange(4.0))
        for i in range(40):
            d.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype=np.int32)
            f.attrs[f"r{i:02d}"] = f"value {i}"
    with hdf5.File(path) as f, h5py.File(path) as g:
        assert dict(f.attrs) == dict(g.attrs)
        assert list(f["d"].attrs) == list(g["d"].attrs)
        for k, v in g["d"].attrs.items():
            np.testing.assert_array_equal(f["d"].attrs[k], v)
        np.testing.assert_array_equal(f["d"][...], g["d"][...])


def test_reads_the_shipped_digits_checkpoint():
    """examples/digits/digits_pretrained.h5, which the JAX package's
    checkpoint.save wrote through h5py."""
    with hdf5.File(DIGITS) as f, h5py.File(DIGITS) as g:
        assert dict(f.attrs) == dict(g.attrs)
        assert list(f.keys()) == list(g.keys())
        for edge in g:
            assert isinstance(f[edge], hdf5.Group) and list(f[edge]) == list(g[edge])
            for leaf in g[edge]:
                np.testing.assert_array_equal(f[edge][leaf][...], g[edge][leaf][...])
    got, moms, step = ckpt.load(str(DIGITS))
    want, jmoms, jstep = jax_ckpt.load(str(DIGITS))
    assert step == jstep == 800 and (moms is None) == (jmoms is None)
    for edge in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[edge][k], np.asarray(want[edge][k]))


@pytest.mark.parametrize("members", [1, 9, 200, 2000])
def test_h5py_reads_what_hdf5_writes(tmp_path, members):
    """Names, shapes, dtypes, attribute values and attribute types, and the
    data, as h5py reads them; groups of many members take several SNOD
    leaves and B-tree levels."""
    path = tmp_path / "w.h5"
    rng = np.random.default_rng(members)
    data = {f"m{i:04d}": rng.standard_normal((3, 2)).astype(np.float32) for i in range(members)}
    arrays = {"u1": _x("u1"), "i4": _x("i4") - 9, "i8": _x("i8") * -(2**40), "f2": _x("f2"),
              "f8": _x("f8") / 3, "be": _x(">i4"), "scalar": np.float32(1.5),
              "empty": np.zeros((0, 4), np.float32), "one": np.ones(1, np.int16)}
    with hdf5.File(path, "w") as f:
        f.attrs["step"] = 41
        f.attrs["model_name"] = "narrow é"
        f.attrs["rate"] = 0.25
        f.attrs["fixed"] = b"bytes"
        f.attrs["vector"] = np.arange(4, dtype=np.float32)
        g = f.create_group("members")
        g.attrs["timestamp"] = "20261017"
        for name, arr in data.items():
            g.create_dataset(name, data=arr)
        for name, arr in arrays.items():
            f.create_dataset(f"arrays/{name}", data=arr)
        f.create_group("empty_group")
    with h5py.File(path) as f, hdf5.File(path) as mine:
        assert list(f.keys()) == ["arrays", "empty_group", "members"]
        assert list(f["members"]) == sorted(data) and len(f["empty_group"]) == 0
        assert {k: type(v) for k, v in f.attrs.items()} == {
            "fixed": np.bytes_, "model_name": str, "rate": np.float64, "step": np.int64,
            "vector": np.ndarray}
        assert f.attrs["step"] == 41 and f.attrs["model_name"] == "narrow é"
        assert f.attrs["fixed"] == b"bytes" and f["members"].attrs["timestamp"] == "20261017"
        np.testing.assert_array_equal(f.attrs["vector"], np.arange(4, dtype=np.float32))
        for name, arr in data.items():
            np.testing.assert_array_equal(f["members"][name][...], arr)
        for name, arr in arrays.items():
            ds = f["arrays"][name]
            assert ds.shape == arr.shape and ds.dtype == arr.dtype, name
            np.testing.assert_array_equal(ds[()], arr)
        # and the port reads its own file as h5py does
        assert {k: type(v) for k, v in mine.attrs.items()} == {
            k: type(v) for k, v in f.attrs.items()}
        for name, arr in arrays.items():
            np.testing.assert_array_equal(mine["arrays"][name][()], arr)


@pytest.mark.parametrize("dims,batches", [(10, [7, 4100, 3]), (300, [128, 128, 57]),
                                          (4096, [100, 200, 300]), (4096, [])])
def test_datawriter_as_jax_writer(tmp_path, dims, batches):
    """The port's DataWriter (chunks written as they fill) against the JAX
    package's (h5py): h5py reads the same shape, chunk shape, maxshape,
    dtype and rows from both."""
    rng = np.random.default_rng(dims)
    rows = [rng.standard_normal((n, dims)).astype(np.float32) for n in batches]
    ours, ref = tmp_path / "ours.h5", tmp_path / "ref.h5"
    for writer, path in ((DataWriter, ours), (JaxDataWriter, ref)):
        with writer(str(path), {"fc7": dims, "fc6": dims // 2 + 1}) as w:
            for r in rows:
                w.append({"fc7": r, "fc6": r[:, : dims // 2 + 1]})
    with h5py.File(ours) as a, h5py.File(ref) as b:
        assert list(a) == list(b) == ["fc6", "fc7"]
        for name in b:
            x, y = a[name], b[name]
            assert (x.shape, x.chunks, x.maxshape, x.dtype) == (y.shape, y.chunks, y.maxshape, y.dtype)
            np.testing.assert_array_equal(x[...], y[...])
    with hdf5.File(ours) as a, h5py.File(ref) as b:
        np.testing.assert_array_equal(a["fc7"][...], b["fc7"][...])


def test_appendable_holds_one_chunk_and_writes_chunks_as_they_fill(tmp_path):
    path = tmp_path / "a.h5"
    f = hdf5.File(path, "w")
    ds = f.create_appendable("x", (4,), np.float32, chunk_rows=3)
    ds.append(np.ones((7, 4), np.float32))
    assert ds.shape == (7, 4) and len(ds._chunks) == 2 and ds._buffer.shape == (3, 4)
    assert f._writer.fh.tell() >= 96 + 2 * 3 * 4 * 4  # the two full chunks went to the file
    f.close()
    with h5py.File(path) as g:
        np.testing.assert_array_equal(g["x"][...], np.ones((7, 4), np.float32))


# -- checkpoints -----------------------------------------------------------------

NET = """
name: "narrow"
seed: 5
layer { name: "input" is_input: true num_channels: 3 image_size: 8 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "pool1" num_channels: 8 }
layer { name: "fc7" num_channels: 12 activation: RECTIFIED_LINEAR }
layer { name: "output" is_output: true num_channels: 5 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.1 }
edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 2 stride: 2 }
edge { source: "pool1" dest: "fc7" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
edge { source: "fc7" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
"""


def _jax_params():
    g = jax_build_graph(jax_config.parse_model(NET))
    params = {n: {k: np.asarray(v) for k, v in p.items()}
              for n, p in jax_model.init_params(g, seed=3).items()}
    moms = {n: {k: v * 0.5 - 0.01 for k, v in p.items()} for n, p in params.items()}
    return g, params, moms


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(got[name][k]), np.asarray(want[name][k]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_in_the_other_package(tmp_path, writer):
    g, params, moms = _jax_params()
    save = ckpt.save if writer == "port" else jax_ckpt.save
    path = save(str(tmp_path), "narrow", params, moms, step=17, timestamp="20261017000000")
    load = jax_ckpt.load if writer == "port" else ckpt.load
    got, got_moms, step = load(path, expected_shapes=jax_model.param_shapes(g))
    assert int(step) == 17
    _assert_trees_equal(got, params)
    _assert_trees_equal(got_moms, moms)
    with h5py.File(path) as f:
        assert {k: type(v) for k, v in f.attrs.items()} == {
            "model_name": str, "step": np.int64, "timestamp": str}
        assert f.attrs["timestamp"] == "20261017000000" and f.attrs["model_name"] == "narrow"


def test_port_and_jax_checkpoints_are_read_alike_by_h5py(tmp_path):
    _, params, moms = _jax_params()
    a = ckpt.save(str(tmp_path / "a"), "narrow", params, moms, step=2, timestamp="1")
    b = jax_ckpt.save(str(tmp_path / "b"), "narrow", params, moms, step=2, timestamp="1")
    with h5py.File(a) as x, h5py.File(b) as y:
        assert list(x) == list(y) and dict(x.attrs) == dict(y.attrs)
        for edge in y:
            assert list(x[edge]) == list(y[edge])
            for leaf in y[edge]:
                assert x[edge][leaf].dtype == y[edge][leaf].dtype
                np.testing.assert_array_equal(x[edge][leaf][...], y[edge][leaf][...])


# -- streams, mean files and the extract CLI ------------------------------------


def _image_set(directory: Path, chunked: bool, rows=40, size=10):
    """uint8 images and int32 labels written by h5py, contiguous or chunked
    with a partial edge chunk, and the mean file of each package's tool."""
    rng = np.random.default_rng(7)
    path = directory / ("chunked.h5" if chunked else "contiguous.h5")
    with h5py.File(path, "w") as f:
        kw = {"chunks": (16, size, size, 3)} if chunked else {}
        f.create_dataset("data", data=rng.integers(0, 256, (rows, size, size, 3), dtype=np.uint8), **kw)
        f.create_dataset("labels", data=rng.integers(0, 5, rows).astype(np.int32))
    return path


def _data_text(path, mean, batch=8, randomize="true", pipeline="false", normalize="true"):
    return f"""
        name: "h" batch_size: {batch} randomize_cpu: {randomize} pipeline_loads: {pipeline}
        random_access_chunk_size: 3
        data_config {{ layer_name: "input" data_type: HDF5 file_pattern: "{path}"
                      dataset_name: "data" image_size: 8 raw_image_size: 10 num_colors: 3
                      can_translate: true can_flip: true mean_file: "{mean}"
                      normalize: {normalize} }}
        data_config {{ layer_name: "labels" data_type: HDF5 file_pattern: "{path}"
                      dataset_name: "labels" }}
    """


@pytest.mark.parametrize("chunked", [False, True], ids=["contiguous", "chunked"])
def test_hdf5_stream_with_mean_file_matches_jax(tmp_path, chunked):
    path = _image_set(tmp_path, chunked)
    mean = tmp_path / "mean.h5"
    assert compute_mean.main([str(path), str(mean)]) == 0
    text = _data_text(path, mean)
    ours = DataHandler(pt_config.parse_dataset_config(text), seed=4)
    ref = JaxDataHandler(jax_config.parse_dataset_config(text), seed=4)
    try:
        for _ in range(12):  # past two epochs
            a, b = ours.get_batch(), ref.get_batch()
            assert a["input"].shape == (8, 10, 10, 3) and a["labels"].dtype == np.int32
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        (_, m, s), (_, jm, js) = ours.jitter_specs()["input"], ref.jitter_specs()["input"]
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(s, js)
        for (a, va), (b, vb) in zip(ours.iter_epoch(), ref.iter_epoch()):
            assert va == vb
            np.testing.assert_array_equal(a["input"], b["input"])
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("chunked", [False, True], ids=["contiguous", "chunked"])
def test_extract_cli_matches_jax_over_hdf5(tmp_path, chunked):
    """One checkpoint, one HDF5 data config with a mean file: the port's
    extract CLI (its writer) against the JAX CLI's (h5py), f32, within 1e-4
    of the largest |feature|; every row once."""
    path = _image_set(tmp_path, chunked, rows=37)
    mean = tmp_path / "mean.h5"
    assert compute_mean.main([str(path), str(mean)]) == 0
    data = tmp_path / "data.pbtxt"
    data.write_text(_data_text(path, mean, batch=16, randomize="false"))
    model = tmp_path / "narrow.pbtxt"
    model.write_text(NET)
    _, params, moms = _jax_params()
    c = ckpt.save(str(tmp_path), "narrow", params, moms, step=3)
    ours, ref = tmp_path / "ours.h5", tmp_path / "ref.h5"
    argv = [str(model), str(data), "--checkpoint", c, "--layers", "fc7", "pool1"]
    assert extract.main(argv + ["--output", str(ours), "--device", "cpu"]) == 0
    assert jax_extract.main(argv + ["--output", str(ref)]) == 0
    with hdf5.File(ours) as a, h5py.File(ref) as b:
        for name in ("fc7", "pool1"):
            got, want = a[name][...], b[name][...]
            assert got.shape == want.shape == (37, {"fc7": 12, "pool1": 128}[name])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# -- what the port refuses -------------------------------------------------------
# (libver "latest" files, version 2 object headers, lzf, fletcher32 and
# compound types read since, and szip, references, virtual datasets and
# external raw data since: tests/test_torch_port_hdf5_formats.py holds them
# to h5py; tests/test_torch_port_hdf5_references.py holds the other
# refusals, the formats file the shared-message table's)


def _unsupported(kind, f):
    if kind == "plugin_filter":  # a chunk that says lz4 (id 32004) made it
        ds = f.create_dataset("x", shape=(8,), chunks=(8,), dtype="u1", compression=32004,
                              allow_unknown_filter=True)
        ds.id.write_direct_chunk((0,), bytes(range(8)), filter_mask=0)


@pytest.mark.parametrize("kind,named", [("plugin_filter", "plugin filter id 32004")])
def test_unsupported_features_raise_naming_them(tmp_path, kind, named):
    path = tmp_path / f"{kind}.h5"
    with h5py.File(path, "w") as f:
        _unsupported(kind, f)
    with pytest.raises(NotImplementedError, match=named):
        with hdf5.File(path) as f:
            for name in f:
                f[name][...]


def test_writer_refuses_what_it_cannot_store(tmp_path):
    with hdf5.File(tmp_path / "r.h5", "w") as f:
        with pytest.raises(TypeError):
            f.create_dataset("o", data=np.array([{"a": 1}], dtype=object))
        with pytest.raises(TypeError):
            f.attrs["flag"] = True
        f.create_dataset("x", data=np.ones(2))
        with pytest.raises(ValueError, match="taken"):
            f.create_dataset("x", data=np.ones(2))
    with hdf5.File(tmp_path / "r.h5") as f:
        with pytest.raises(OSError):
            f.create_group("g")
        with pytest.raises(KeyError):
            f["nothing"]
    with pytest.raises(OSError):
        hdf5.File(DIGITS.parent / "digits.pbtxt")


# -- the tools -------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4096, 7])
def test_make_raw_cache_is_byte_equal(tmp_path, chunk):
    """Read in one piece, and 7 rows at a time with a partial last read:
    the same bytes as the JAX tool's."""
    from tools.make_raw_cache import main as jax_main

    path = _image_set(tmp_path, chunked=True)
    for name in ("data", "labels"):
        a, b = tmp_path / f"ours_{name}.cache", tmp_path / f"ref_{name}.cache"
        assert make_raw_cache.main([str(path), name, str(a), "--chunk", str(chunk)]) == 0
        assert jax_main([str(path), name, str(b)]) == 0
        assert a.read_bytes() == b.read_bytes()
        assert json.loads(Path(f"{a}.json").read_text()) == json.loads(Path(f"{b}.json").read_text())


@pytest.mark.parametrize("per_channel", [False, True])
def test_compute_mean_is_array_equal(tmp_path, per_channel):
    from tools.compute_mean import main as jax_main

    path = _image_set(tmp_path, chunked=per_channel)
    flags = ["--per-channel"] if per_channel else []
    a, b = tmp_path / "ours.h5", tmp_path / "ref.h5"
    assert compute_mean.main([str(path), str(a), "--chunk", "7", *flags]) == 0
    assert jax_main([str(path), str(b), "--chunk", "7", *flags]) == 0
    with h5py.File(a) as x, h5py.File(b) as y:
        for k in ("mean", "std"):
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            np.testing.assert_array_equal(x[k][...], y[k][...])


def test_make_hdf5_dataset_rows_match(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    from convnet_tpu_torch.data.image_iterators import decode_and_resize
    from tools.make_hdf5_dataset import main as jax_main

    rng = np.random.default_rng(2)
    names = []
    for i in range(5):
        img = rng.integers(0, 256, (12 + i, 9 + 2 * i, 3), dtype=np.uint8)
        names.append(f"im{i}.png")
        Image.fromarray(img).save(tmp_path / names[-1])
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "labels.txt").write_text("\n".join(str(i % 3) for i in range(5)) + "\n")
    a, b = tmp_path / "ours.h5", tmp_path / "ref.h5"
    argv = [str(tmp_path / "list.txt"), "--size", "8", "--labels", str(tmp_path / "labels.txt")]
    assert make_hdf5_dataset.main([argv[0], str(a), *argv[1:]]) == 0
    assert jax_main([argv[0], str(b), *argv[1:]]) == 0
    with h5py.File(a) as x, h5py.File(b) as y:
        assert x["data"].shape == y["data"].shape == (5, 8, 8, 3)
        np.testing.assert_array_equal(x["data"][...], y["data"][...])
        np.testing.assert_array_equal(x["labels"][...], y["labels"][...])
        for i, n in enumerate(names):
            np.testing.assert_array_equal(x["data"][i], decode_and_resize(str(tmp_path / n), 8, 3))


def test_dump_activations_within_1e4(tmp_path):
    from tools.dump_activations import main as jax_main

    model = tmp_path / "narrow.pbtxt"
    model.write_text(NET)
    _, params, moms = _jax_params()
    c = ckpt.save(str(tmp_path), "narrow", params, moms, step=1)
    a, b = tmp_path / "ours.h5", tmp_path / "ref.h5"
    argv = [str(model), "--checkpoint", c, "--batch-size", "3", "--seed", "2"]
    assert dump_activations.main([argv[0], str(a), *argv[1:], "--device", "cpu"]) == 0
    assert jax_main([argv[0], str(b), *argv[1:]]) == 0
    with h5py.File(a) as x, h5py.File(b) as y:
        assert sorted(x) == sorted(y) and dict(x.attrs) == dict(y.attrs)
        for k in y:
            want = y[k][...]
            np.testing.assert_allclose(x[k][...], want, rtol=0,
                                       atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=k)
