"""The last HDF5 files that h5py opens and the port's reader
(convnet_tpu_torch/hdf5.py) refused: shared object header messages (a
superblock extension's shared-message table, its indexes as lists and as
v2 B-trees), fractal heaps with I/O filters, and non-IEEE floats; against
h5py and against the JAX package's readers on the same files.

Each committed fixture (tests/torch_port_hdf5_fixtures.py writes them) is
held to h5py's read with tests/test_torch_port_hdf5_formats.py's
comparison (keys in order, attributes, dtypes with h5py's metadata,
values whole and by rows), the floats also bit for bit; the float
conversion is held to HDF5's own conversion (h5py.h5t.convert) into
layouts narrower than the source, where values round, overflow and fall
to denormals; then the CIFAR-10 template over the SOHM shard against the
JAX DataHandler, a checkpoint rewritten with SOHM through both packages'
checkpoint.load, check_graph's device, and what still raises.
"""

import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

import torch_port_hdf5_fixtures as fx  # noqa: E402
from test_torch_port_hdf5_formats import _same_file  # noqa: E402

from convnet_tpu import checkpoint as jax_ckpt  # noqa: E402
from convnet_tpu import config as jax_config  # noqa: E402
from convnet_tpu.cli import grad_check as jax_grad_check  # noqa: E402
from convnet_tpu.data import jitter as jax_jitter  # noqa: E402
from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler  # noqa: E402
from convnet_tpu_torch import checkpoint as ckpt  # noqa: E402
from convnet_tpu_torch import config as pt_config  # noqa: E402
from convnet_tpu_torch import hdf5  # noqa: E402
from convnet_tpu_torch import testdata  # noqa: E402
from convnet_tpu_torch.cli import grad_check  # noqa: E402
from convnet_tpu_torch.data import jitter as pt_jitter  # noqa: E402
from convnet_tpu_torch.data.datahandler import DataHandler  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NEW_FIXTURES = ("sohm_list.h5", "sohm_btree.h5", "cifar10_sohm.h5", "filtered_heap.h5", "floats.h5")


def _bits(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def _shared_reads(monkeypatch):
    """A Counter of (message type) of each message read from a
    shared-message heap from now on."""
    from collections import Counter

    seen = Counter()
    read = hdf5._Reader.shared_heap_message

    def spy(self, mtype, hid):
        seen[mtype] += 1
        return read(self, mtype, hid)

    monkeypatch.setattr(hdf5._Reader, "shared_heap_message", spy)
    return seen


# -- each fixture against h5py --------------------------------------------------------


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_new_fixtures_read_as_h5py_reads(tmp_path, monkeypatch, name):
    """Keys, attributes, dtypes with metadata and values, whole and by
    rows, as h5py reads them (a copy read from its own directory and from
    another); the floats' and their attributes' bytes too."""
    shutil.copy(testdata.HDF5_DIR / name, tmp_path / name)
    for cwd in (tmp_path, REPO):
        monkeypatch.chdir(cwd)
        _same_file(tmp_path / name)
    with hdf5.File(tmp_path / name) as mine, h5py.File(tmp_path / name, "r") as theirs:
        for path, ds in testdata.datasets(theirs):
            if ds.dtype.kind != "f" and not (ds.dtype.names and "x" in ds.dtype.names):
                continue
            got, want = mine[path][()], ds[()]
            assert got.dtype == want.dtype and _bits(got) == _bits(want), path
            rows = np.random.default_rng(len(want)).integers(0, len(want), 50)
            assert _bits(mine[path][rows]) == _bits(want[rows]), path
        for key in theirs.attrs:
            assert _bits(mine.attrs[key]) == _bits(theirs.attrs[key]), key


@pytest.mark.parametrize("name,superblock,kinds", [
    ("sohm_list.h5", 2, [0, 0]), ("sohm_btree.h5", 3, [1]), ("cifar10_sohm.h5", 2, [0])])
def test_shared_messages_come_from_the_tables_heaps(monkeypatch, name, superblock, kinds):
    """The files reach what they are for: a superblock of the version
    named, indexes of the kinds named (a list; a v2 B-tree past the phase
    change), each index's masks as set, and every shareable type read from
    a shared-message heap: dataspace, datatype, fill value, filter
    pipeline and attribute (in the dense attribute storage of the B-tree
    file too)."""
    seen = _shared_reads(monkeypatch)
    with hdf5.File(testdata.HDF5_DIR / name) as f:
        r = f._reader
        assert r.mm[r.addr(0) + 8] == superblock
        assert [ix.kind for ix in r._sohm] == kinds
        masks = [ix.mask for ix in r._sohm]
        for _, ds in testdata.datasets(f):
            ds.attrs, ds[()]
    if name == "sohm_list.h5":
        assert masks == [fx.SHARE_DATASPACE | fx.SHARE_DATATYPE,
                         fx.SHARE_FILL | fx.SHARE_PIPELINE | fx.SHARE_ATTRIBUTE]
    else:
        assert masks == [fx.SHARE_ALL]
    # the pipelines of cifar10_sohm.h5 differ (shuffle's element size) and
    # HDF5 keeps each in its header; a fill value may be the old message
    wanted = {0x1, 0x3, 0x5, 0xC} | ({0xB} if name != "cifar10_sohm.h5" else set())
    assert wanted <= set(seen) | ({0x5} if 0x4 in seen else set()), seen
    if name == "sohm_btree.h5":
        with hdf5.File(testdata.HDF5_DIR / name) as f:
            info = next(d for t, d, _ in f._reader.messages(f["a/x"]._addr) if t == 0x15)
            assert not f._reader.undefined(struct.unpack_from("<Q", info, 2)[0])  # dense attributes


def test_filtered_heap_reaches_indirect_blocks_and_a_huge_object():
    """The deflated link heap's root is an indirect block whose direct
    blocks are filtered, and its 60,000-character soft link is a
    filtered huge object (read through the heap's B-tree): the link opens
    where h5py's does."""
    with hdf5.File(testdata.HDF5_DIR / "filtered_heap.h5") as f, \
            h5py.File(testdata.HDF5_DIR / "filtered_heap.h5", "r") as g:
        r = f._reader
        heaps = {}
        for name in ("deflate", "fletcher32"):
            heap_addr = struct.unpack_from("<Q", f[name]._links.info, 2)[0]
            heaps[name] = r.heap(heap_addr)
        assert [fid for fid, _ in heaps["deflate"].filters] == [1]
        assert [fid for fid, _ in heaps["fletcher32"].filters] == [3, 1]
        assert heaps["deflate"].root_rows > 0 and not r.undefined(heaps["deflate"].huge_btree)
        assert f["deflate"]._table()["long"] == hdf5._SoftLink("/" + "x" * 60_000)
        assert heaps["deflate"]._images  # direct blocks decoded
        assert g["deflate"].get("long", getlink=True).path == "/" + "x" * 60_000
        assert len(f["deflate"]) == len(g["deflate"]) == 152
        np.testing.assert_array_equal(f["deflate/link149"][...], g["deflate/link149"][...])


# -- non-IEEE floats ----------------------------------------------------------------


@pytest.mark.parametrize("order", ["<", ">"])
def test_every_bf16_pattern_converts_bit_for_bit(order):
    """All 65,536 bf16 patterns, read as h5py's float32 of the file's byte
    order: the bytes of each equal h5py's (signed zeros, denormals,
    infinities, and NaN as HDF5 gives it, all mantissa bits set)."""
    name = f"bf16_{'le' if order == '<' else 'be'}"
    with hdf5.File(testdata.HDF5_DIR / "floats.h5") as f, \
            h5py.File(testdata.HDF5_DIR / "floats.h5", "r") as g:
        got, want = f[name][...], g[name][...]
    assert got.dtype == want.dtype == np.dtype(f"{order}f4") and got.shape == (65536,)
    assert _bits(got) == _bits(want)
    patterns = np.arange(65536, dtype=np.uint32)
    finite = (patterns & 0x7F80) != 0x7F80
    widened = (patterns[finite] << 16).view("<f4")  # bf16 is float32's top half
    np.testing.assert_array_equal(got.astype("<f4")[finite].view("<u4"), widened.view("<u4"))
    assert np.isnan(got[~finite & ((patterns & 0x7F) != 0)]).all()


# (source layout, target layout) through HDF5's conversion, narrower targets
_NARROWER = [
    ("f8_to_e7m24", fx.float_type(8, 63, 52, 11, 0, 52, 1023), (4, 31, 24, 7, 0, 24, 63)),
    ("f4_to_bf16", fx.float_type(4, 31, 23, 8, 0, 23, 127), fx.FLOAT_LAYOUTS["bf16"]),
    ("f4_to_fp8", fx.float_type(4, 31, 23, 8, 0, 23, 127), fx.FLOAT_LAYOUTS["fp8_e4m3"]),
    ("stored_lead_to_f2", fx.float_type(4, 31, 23, 8, 0, 23, 127, norm=h5py.h5t.NORM_NONE),
     (2, 15, 10, 5, 0, 10, 15)),
    ("ld_to_stored_lead_3", fx.float_type(16, 79, 64, 15, 0, 64, 16383, norm=h5py.h5t.NORM_NONE),
     (3, 23, 16, 7, 0, 16, 63, h5py.h5t.NORM_NONE)),
]


@pytest.mark.parametrize("case,src,dst", _NARROWER, ids=[c[0] for c in _NARROWER])
def test_float_conversion_is_hdf5s_into_narrower_layouts(case, src, dst):
    """_convert_float against HDF5's conversion (h5py.h5t.convert, the
    library's soft float conversion) where values must round (half up,
    but not up to infinity from the largest exponent), overflow to
    infinity, turn denormal or vanish: random patterns and the source's
    special ones, bit for bit."""
    rng = np.random.default_rng(len(case))
    size = src.get_size()
    fields = src.get_fields()
    layout = (size,) + fields + (src.get_ebias(),)
    raw = fx.float_patterns(layout, 4000, rng)
    if size > 8:  # x87 patterns with the leading bit as HDF5 writes it
        raw[:, 7] |= 0x80
    dst_type = fx.float_type(*dst[:7], "<", *dst[7:])
    dsize = dst_type.get_size()
    buf = np.zeros(len(raw) * max(size, dsize), np.uint8)  # converted in place, packed
    buf[: raw.size] = raw.reshape(-1)
    h5py.h5t.convert(src, dst_type, len(raw), buf)
    want = buf[: len(raw) * dsize].reshape(-1, dsize)
    norm = lambda t: t.get_norm() == h5py.h5t.NORM_IMPLIED  # noqa: E731
    s_layout = hdf5._FloatLayout(*fields, src.get_ebias(), norm(src))
    d_layout = hdf5._FloatLayout(*dst_type.get_fields(), dst_type.get_ebias(), norm(dst_type))
    got = hdf5._convert_float(raw, s_layout, d_layout, dst_type.get_size())
    bad = np.flatnonzero((got != want).any(1))
    assert not len(bad), [(raw[i].tobytes()[::-1].hex(), got[i].tobytes()[::-1].hex(),
                           want[i].tobytes()[::-1].hex()) for i in bad[:5]]


@pytest.mark.parametrize("kind,named", [
    ("vax", "VAX-order float"), ("msb_set", "leading bit is always set"),
    ("no_numpy_float", "no numpy float holds")])
def test_floats_h5py_cannot_read_stay_refused(tmp_path, kind, named):
    """A float h5py gives no dtype (VAX order, in a version 3 datatype
    message: HDF5 writes version 1, which reads big-endian, so the message
    is rewritten), one HDF5 does not convert (the mantissa's leading bit
    always set) and one no numpy float holds (a 15-bit exponent of a huge
    bias): NotImplementedError naming it, where h5py fails too."""
    path = tmp_path / "f.h5"
    t = fx.float_type(4, 31, 23, 8, 0, 23, 127)
    if kind == "vax":
        t.set_order(h5py.h5t.ORDER_VAX)
    elif kind == "msb_set":
        t.set_norm(h5py.h5t.NORM_MSBSET)
    else:
        t = fx.float_type(4, 31, 16, 15, 0, 16, 30000)
    with h5py.File(path, "w") as f:  # superblock 0: no checksum over the message
        data = np.array([0, 1, 0x3F800000, 0x40490FDB], "<u4").view("V4")
        fx.low_level(f, "x", t, data, mtype=t)
    if kind == "vax":
        raw = bytearray(path.read_bytes())
        at = raw.find(bytes([0x11, 0x61, 0x1F, 0x00, 0x04, 0, 0, 0]))
        assert at > 0
        raw[at] = 0x31
        path.write_bytes(bytes(raw))
    with pytest.raises(NotImplementedError, match=named):
        with hdf5.File(path) as f:
            f["x"][...]
    with h5py.File(path, "r") as f, pytest.raises(Exception):
        f["x"][...]


# -- the paths users take: digests, the CIFAR-10 template, checkpoints ---------------


def test_check_hdf5_fixtures_holds_the_new_fixtures(tmp_path, monkeypatch):
    """check_hdf5_fixtures reads the new fixtures to their digests, and
    reports a digest they no longer meet."""
    count, nbytes, problems = testdata.check_hdf5_fixtures()
    assert not problems
    digests = json.loads(testdata.HDF5_DIGESTS.read_text())
    assert all(name in digests for name in NEW_FIXTURES)
    assert set(digests["floats.h5"]) >= {"/bf16_le", "/bf16_be", "/long_double_le"}
    digests["floats.h5"]["/bf16_be"]["sha256"] = "0" * 64
    digests["sohm_btree.h5"]["/a/x"]["dtype"] = "float64"
    (tmp_path / "digests.json").write_text(json.dumps(digests))
    monkeypatch.setattr(testdata, "HDF5_DIGESTS", tmp_path / "digests.json")
    _, _, problems = testdata.check_hdf5_fixtures()
    assert len(problems) == 2
    assert any("floats.h5/bf16_be" in p for p in problems) and any("sohm_btree.h5/a/x" in p for p in problems)


def test_cifar_sohm_batches_as_the_jax_datahandler(monkeypatch):
    """The CIFAR-10 template over cifar10_sohm.h5 and the fixture mean file:
    the port's DataHandler and the JAX package's (its HDF5Stream through
    h5py) give array-equal batches from one seed, the same mean and std,
    and, with the same flips injected on both sides, the same jittered
    input (can_translate is off in the template: no crop to draw)."""
    template = (REPO / "examples" / "cifar10" / "cifar10_train_data.pbtxt").read_text()
    text = template.replace("pipeline_loads: true", "pipeline_loads: false").replace(
        "/data/cifar10/train.h5", str(testdata.HDF5_DIR / "cifar10_sohm.h5")).replace(
        "/data/cifar10/mean.h5", str(testdata.CIFAR_MEAN))
    ours = DataHandler(pt_config.parse_dataset_config(text), seed=3)
    theirs = JaxDataHandler(jax_config.parse_dataset_config(text), seed=3)
    flips = np.random.default_rng(9).random(128) < 0.5
    monkeypatch.setattr(jax_jitter, "sample_crop_flip", lambda *a, **k: (None, None, flips))
    try:
        assert ours.num_rows == theirs.num_rows == fx.CIFAR_SOHM_ROWS
        (spec, mean, std), (jspec, jmean, jstd) = ours.jitter_specs()["input"], theirs.jitter_specs()["input"]
        np.testing.assert_array_equal(mean, jmean)
        np.testing.assert_array_equal(std, jstd)
        zeros = torch.zeros(128, dtype=torch.int32)
        for _ in range(3):  # past an epoch of one batch
            a, b = ours.get_batch(), theirs.get_batch()
            for k in ("input", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            got = pt_jitter.jitter_batch(torch.from_numpy(a["input"]), spec, torch.from_numpy(mean),
                                         torch.from_numpy(std),
                                         crop=(zeros, zeros, torch.from_numpy(flips)))
            want = jax_jitter.jitter_batch(b["input"], jspec, object(), True, jmean, jstd)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    finally:
        ours.close()
        theirs.close()


def test_checkpoint_rewritten_with_shared_messages_loads_alike(tmp_path):
    """A JAX checkpoint made anew in a file whose messages are shared
    (every type): checkpoint.load and load_edge of both packages give the
    params and momenta array-equal, and the step."""
    params, moms = fx.checkpoint_params(edges=11)
    src = jax_ckpt.save(str(tmp_path / "jax"), "sohm", params, moms, step=17, timestamp="1")
    dst = tmp_path / "sohm.h5"
    fx.write_sohm_checkpoint(src, dst)
    with hdf5.File(dst) as f:
        assert f._reader._sohm and f._reader._sohm[0].mask == fx.SHARE_ALL
    got, got_moms, step = ckpt.load(str(dst))
    want, want_moms, want_step = jax_ckpt.load(str(dst))
    assert step == want_step == 17 and sorted(got) == sorted(want) == sorted(params)
    for edge in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[edge][k], np.asarray(want[edge][k]))
            np.testing.assert_array_equal(got_moms[edge][k], np.asarray(want_moms[edge][k]))
            np.testing.assert_array_equal(got[edge][k], params[edge][k])
    one, jax_one = ckpt.load_edge(str(dst), "edge07"), jax_ckpt.load_edge(str(dst), "edge07")
    for k in ("w", "b"):
        np.testing.assert_array_equal(one[k], np.asarray(jax_one[k]))


# -- check_graph's device ------------------------------------------------------------

TINY = """
name: "t"
layer { name: "input" is_input: true num_channels: 4 image_size: 6 }
layer { name: "h" num_channels: 8 activation: TANH }
layer { name: "output" is_output: true num_channels: 3 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "h" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.2 }
edge { source: "h" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0 }
"""  # tests/test_torch_port_cli.py's


def test_check_graph_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a device check_graph asks for the card, and raises where
    there is none (never a quiet fall back); with device="cpu" it checks
    on the CPU as before: the JAX CLI's samples, every edge within its
    tolerance, the same result twice."""
    from convnet_tpu_torch.graph import build_graph

    graph = build_graph(pt_config.parse_model(TINY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grad_check.check_graph(graph, 4, 5, log=lambda *_: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grad_check.check_graph(graph, 4, 5, log=lambda *_: None, device="cuda:0")
    logs = [[], []]
    results = [grad_check.check_graph(graph, 4, 5, log=log.append, device="cpu") for log in logs]
    assert results[0] == results[1] and logs[0] == logs[1]
    assert results[0][0] == 0 and results[0][1] < 2e-3
    jax_log = []
    from convnet_tpu.graph import build_graph as jax_build_graph

    jax_grad_check.check_graph(jax_build_graph(jax_config.parse_model(TINY)), 4, 5, log=jax_log.append)
    assert [l.split()[1] for l in logs[0]] == [l.split()[1] for l in jax_log]


# -- what still raises ---------------------------------------------------------------


def test_corrupted_shared_heap_id_raises(tmp_path):
    """A shared message of a dataset's header whose heap ID is changed by
    one byte, the header's checksum made anew: the ID is in no index's
    records, and the port raises OSError naming it."""
    path = tmp_path / "sohm_list.h5"
    shutil.copy(testdata.HDF5_DIR / "sohm_list.h5", path)
    with hdf5.File(path) as f:
        pos = f._reader.addr(f["a/x"]._addr)
    raw = bytearray(path.read_bytes())
    assert raw[pos : pos + 4] == b"OHDR"
    flags = raw[pos + 5]
    p = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    start = p + (1 << (flags & 0x03))
    end = start + int.from_bytes(raw[p:start], "little")
    head = 6 if flags & 0x04 else 4
    p = start
    while p < end and not (raw[p + 3] & 0x02 and raw[p + head : p + head + 2] == b"\x03\x01"):
        p += head + int.from_bytes(raw[p + 1 : p + 3], "little")  # to a message shared in the heap
    assert p < end
    raw[p + head + 3] ^= 0x40  # the heap ID's offset
    raw[end : end + 4] = struct.pack("<I", hdf5.lookup3(bytes(raw[pos:end])))
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError, match="heap ID"):
        with hdf5.File(path) as f:
            for _, ds in testdata.datasets(f):
                ds.attrs, ds[()]


def test_plugin_filter_in_a_shared_pipeline_still_raises(tmp_path):
    """A dataset whose shared filter pipeline names a plugin filter (lz4,
    id 32004, which h5py's stock build does not read either): the
    pipeline comes from the shared-message heap and the read raises
    NotImplementedError naming the filter."""
    path = tmp_path / "f.h5"
    with fx.sohm_file(path) as f:
        for name in ("x", "y"):
            ds = f.create_dataset(name, shape=(8,), chunks=(8,), dtype="u1", compression=32004,
                                  allow_unknown_filter=True)
            ds.id.write_direct_chunk((0,), bytes(range(8)), filter_mask=0)
    with hdf5.File(path) as f:
        assert f._reader._sohm
        with pytest.raises(NotImplementedError, match="plugin filter id 32004"):
            f["x"][...]
