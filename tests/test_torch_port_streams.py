"""The port's data streams against the JAX package's, on the CPU, over the
same files (made with numpy, PIL and either package's `write_raw_cache`):
RAW_CACHE through the port's g++-built gather (array-equal to its plain
version and to the JAX reader), IMAGE_RAW over JPEG, PNG and extensionless
JPEG lists (array-equal, the same reader taken), SLIDING_WINDOW and TXT
(array-equal), and the extract CLI over SLIDING_WINDOW (f32, within 1e-4:
the two frameworks' convolutions sum in other orders).

The JAX package's libjpeg loader is the one the port builds from its own
copy, `convnet_tpu_torch/native/dataloader.cc`, handed to the JAX module
for the test: the JAX package finds a prebuilt library only where `make
native` ran. The copy and the JAX package's `native/dataloader.cc`, each
built as it stands, decode the same JPEG files array-equal."""

import os
import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import checkpoint as jax_ckpt
from convnet_tpu import config
from convnet_tpu.cli import extract as jax_extract
from convnet_tpu.data import image_iterators as jax_images
from convnet_tpu.data import native as jax_native
from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch.cli import extract
from convnet_tpu_torch.data import image_iterators as pt_images
from convnet_tpu_torch.data import native as pt_native
from convnet_tpu_torch.data.datahandler import DataHandler

SIZES = [(30, 40), (52, 37), (24, 24), (41, 66), (33, 29)]


def _cfgs(text):
    return config.parse_dataset_config(text), pt_config.parse_dataset_config(text)


@pytest.fixture
def jax_loader_from_port(monkeypatch):
    """The JAX package's native module loads the port's build of its copy
    of native/dataloader.cc."""
    pt_native.library(pt_native.LOADER_SOURCE, ("-ljpeg",))
    path = pt_native._library_path(pt_native.LOADER_SOURCE, ("-ljpeg",))
    monkeypatch.setattr(jax_native, "_LIB_PATHS", [str(path)])
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available()


@pytest.fixture
def image_files(tmp_path):
    """Five JPEGs, three PNGs and an extensionless JPEG, of mixed sizes."""
    from PIL import Image

    rng = np.random.default_rng(21)
    files = {"jpeg": [], "png": [], "noext": []}
    for i, (h, w) in enumerate(SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        arr = np.stack([(xx * 5 + 17 * i) % 256, (yy * 3) % 256, ((xx + yy) * 2) % 256], -1)
        arr = np.clip(arr + rng.integers(-20, 21, arr.shape), 0, 255).astype(np.uint8)
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(arr).save(p, quality=90)
        files["jpeg"].append(str(p))
        if i < 3:
            q = tmp_path / f"img{i}.png"
            Image.fromarray(arr).save(q)
            files["png"].append(str(q))
    noext = tmp_path / "photo"
    shutil.copy(files["jpeg"][1], noext)
    files["noext"] = [files["jpeg"][0], str(noext)]
    lists = {}
    for kind, paths in files.items():
        lists[kind] = tmp_path / f"{kind}.txt"
        lists[kind].write_text("\n".join(paths))
    return lists


# ---------------------------------------------------------------------------
# RAW_CACHE
# ---------------------------------------------------------------------------


def _rows(kind):
    rng = np.random.default_rng(22)
    if kind == "uint8":
        return rng.integers(0, 256, (37, 6, 5, 3), dtype=np.uint8)
    return rng.normal(size=(37, 11)).astype(np.float32)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_raw_cache_written_by_either_reads_in_the_other(tmp_path, writer, kind):
    rows = _rows(kind)
    path = str(tmp_path / "x.cache")
    (jax_native.write_raw_cache if writer == "jax" else pt_native.write_raw_cache)(path, rows)
    idx = np.array([5, 0, 36, 5, 12])
    ours, ref = pt_native.RawCacheReader(path), jax_native.RawCacheReader(path)
    try:
        assert ours.num_rows == ref.num_rows == 37
        assert ours.row_shape == ref.row_shape == rows.shape[1:] and ours.dtype == rows.dtype
        got = ours.gather(idx)
        assert got.dtype == rows.dtype
        np.testing.assert_array_equal(got, ref.gather(idx))
        np.testing.assert_array_equal(got, rows[idx])
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("threads", [1, 4])
def test_cpp_gather_equals_reference(tmp_path, threads):
    rows = _rows("uint8")
    path = str(tmp_path / "x.cache")
    pt_native.write_raw_cache(path, rows)
    reader = pt_native.RawCacheReader(path, threads=threads)
    idx = np.random.default_rng(23).integers(0, 37, 64)
    np.testing.assert_array_equal(reader.gather(idx), pt_native.raw_cache_gather_reference(path, idx))
    assert reader.gather(np.array([], np.int64)).shape == (0, 6, 5, 3)
    with pytest.raises(IndexError, match="outside"):
        reader.gather(np.array([37]))
    reader.close()
    reader.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        reader.gather(idx)


def test_bad_raw_cache_and_failed_build_raise(tmp_path, monkeypatch):
    """A file that is not a raw cache raises; a build that fails raises
    with the compiler's message (no quiet fall back to numpy)."""
    path = tmp_path / "bad.cache"
    path.write_bytes(b"NOPE" + bytes(60))
    (tmp_path / "bad.cache.json").write_text('{"dtype": "uint8", "shape": [4]}')
    with pytest.raises(ValueError, match="bad raw cache"):
        pt_native.RawCacheReader(str(path))
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pt_native.library(broken)
    assert not any((tmp_path / "build").glob("*.so"))


RAW_DATA = """
name: "rc" batch_size: 8 randomize_cpu: {randomize} randomize_gpu: {window}
random_access_chunk_size: 3 pipeline_loads: {pipeline}
data_config {{ layer_name: "input" data_type: RAW_CACHE file_pattern: "{images}"
              raw_image_size: 6 image_size: 4 num_colors: 3 can_translate: true }}
data_config {{ layer_name: "labels" data_type: RAW_CACHE file_pattern: "{labels}" }}
"""


@pytest.mark.parametrize("randomize,window,pipeline", [
    (False, False, False), (True, False, True), (True, True, False), (False, True, True),
])
def test_raw_cache_handler_batches_match_jax(tmp_path, randomize, window, pipeline):
    rng = np.random.default_rng(24)
    images = rng.integers(0, 256, (45, 6, 6, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 45).astype(np.int32)
    pt_native.write_raw_cache(str(tmp_path / "i.cache"), images)
    pt_native.write_raw_cache(str(tmp_path / "l.cache"), labels)
    jcfg, cfg = _cfgs(RAW_DATA.format(randomize=str(randomize).lower(), window=str(window).lower(),
                                      pipeline=str(pipeline).lower(), images=tmp_path / "i.cache",
                                      labels=tmp_path / "l.cache"))
    ours, ref = DataHandler(cfg, seed=5), JaxDataHandler(jcfg, seed=5)
    try:
        assert ours.backends() == {"input": "native", "labels": "native"}
        for _ in range(13):  # past two epochs of 5 batches
            a, b = ours.get_batch(), ref.get_batch()
            for k in ("input", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert a["input"].shape == (8, 6, 6, 3) and a["labels"].shape == (8,)
    finally:
        ours.close()
        ref.close()


def test_reset_raw_cache_stream(tmp_path):
    """reset() keeps the reader open (tests/test_data.py's round-1 bug)."""
    imgs = np.random.RandomState(4).randint(0, 255, (32, 4, 4, 1), dtype=np.uint8)
    pt_native.write_raw_cache(str(tmp_path / "x.cache"), imgs)
    cfg = pt_config.parse_dataset_config(f"""
        name: "rcr" batch_size: 8 pipeline_loads: true
        data_config {{ layer_name: "input" data_type: RAW_CACHE
                      file_pattern: "{tmp_path / 'x.cache'}" image_size: 4 num_colors: 1 }}""")
    dh = DataHandler(cfg, seed=0)
    dh.get_batch()
    dh.reset()
    assert dh.get_batch()["input"].shape == (8, 4, 4, 1)
    dh.close()
    with pytest.raises(RuntimeError):
        dh.reset()


# ---------------------------------------------------------------------------
# IMAGE_RAW, SLIDING_WINDOW, TXT
# ---------------------------------------------------------------------------


def _image_raw(listfile, size=24, crop=20):
    return _cfgs(f"""
        name: "imgs" batch_size: 2 randomize_cpu: false pipeline_loads: false
        data_config {{ layer_name: "input" data_type: IMAGE_RAW file_pattern: "{listfile}"
                      image_size: {crop} raw_image_size: {size} num_colors: 3 }}""")


@pytest.mark.parametrize("kind,backend", [("jpeg", "native"), ("png", "pil"), ("noext", "native")])
def test_image_raw_matches_jax(image_files, jax_loader_from_port, kind, backend):
    jcfg, cfg = _image_raw(image_files[kind])
    ours = pt_images.RawImageStream(cfg.data_config[0])
    ref = jax_images.RawImageStream(jcfg.data_config[0])
    try:
        assert ours.backend == backend
        assert (ref._native is not None) == (backend == "native")
        idx = np.arange(ours.num_rows)[::-1]
        got = ours.read_rows(idx)
        assert got.shape == (len(idx), 24, 24, 3) and got.dtype == np.uint8 and got.std() > 1
        np.testing.assert_array_equal(got, ref.read_rows(idx))
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("size,colors", [(24, 3), (16, 1), (40, 3)])
def test_port_loader_decodes_as_the_jax_packages(image_files, monkeypatch, size, colors):
    """The port's copy of the libjpeg loader and the JAX package's
    `native/dataloader.cc`, each built as it stands with g++ -ljpeg, decode,
    resize and crop the same JPEG files array-equal (40: an upscale of the
    24-pixel sides)."""
    jax_source = Path(pt_native.__file__).resolve().parents[2] / "native" / "dataloader.cc"
    assert jax_source != pt_native.LOADER_SOURCE
    pt_native.library(jax_source, ("-ljpeg",))
    monkeypatch.setattr(jax_native, "_LIB_PATHS",
                        [str(pt_native._library_path(jax_source, ("-ljpeg",)))])
    monkeypatch.setattr(jax_native, "_lib", None)
    paths = image_files["jpeg"].read_text().split("\n") + image_files["noext"].read_text().split("\n")
    idx = np.arange(len(paths))[::-1]
    ours = pt_native.NativeImageLoader(paths, size, colors, threads=3)
    try:
        got = ours.load(idx)
    finally:
        ours.close()
    want = jax_native.NativeImageLoader(paths, size, colors, threads=3).load(idx)
    assert got.shape == (len(paths), size, size, colors) and got.std() > 1
    np.testing.assert_array_equal(got, want)


def test_image_raw_keeps_why_it_took_pil(image_files, monkeypatch):
    """A JPEG list whose native loader fails takes PIL, as the JAX stream
    does, and the stream and its handler's log keep the loader's error."""
    from convnet_tpu_torch.data import native

    def broken(*args, **kwargs):
        raise RuntimeError("building dataloader.cc failed: jpeglib.h: No such file")

    _, cfg = _image_raw(image_files["png"])
    dh = DataHandler(cfg)
    assert dh.backend_log() == [
        "stream input is read by the pil reader (the list holds files that are not JPEGs)"]
    dh.close()
    monkeypatch.setattr(native, "NativeImageLoader", broken)
    _, cfg = _image_raw(image_files["jpeg"])
    dh = DataHandler(cfg)
    s = dh.streams["input"]
    assert s.backend == "pil" and "jpeglib.h: No such file" in s.backend_reason
    assert dh.backend_log() == [f"stream input is read by the pil reader ({s.backend_reason})"]
    assert dh.get_batch()["input"].shape == (2, 24, 24, 3)
    dh.close()


def test_all_jpeg_sniff_matches_jax(image_files, tmp_path):
    fake = tmp_path / "fake"
    fake.write_bytes(b"\x89PNG\r\n")
    lists = [image_files["noext"].read_text().split("\n"), [str(fake)],
             image_files["png"].read_text().split("\n"), ["missing_file"]]
    for paths in lists:
        assert pt_images.RawImageStream._all_jpeg(paths) == jax_images.RawImageStream._all_jpeg(paths)
    assert [pt_images.RawImageStream._all_jpeg(p) for p in lists] == [True, False, False, False]


def test_reset_image_raw_stream(image_files):
    _, cfg = _image_raw(image_files["jpeg"])
    cfg.pipeline_loads = True
    dh = DataHandler(cfg, seed=0)
    dh.get_batch()
    dh.reset()
    assert dh.get_batch()["input"].shape == (2, 24, 24, 3)
    dh.close()


def test_decode_and_resize_matches_jax(image_files):
    paths = image_files["jpeg"].read_text().split("\n")[:3] + image_files["png"].read_text().split("\n")[:1]
    for path in paths:
        for size, colors in ((24, 3), (16, 1)):
            np.testing.assert_array_equal(pt_images.decode_and_resize(path, size, colors),
                                          jax_images.decode_and_resize(path, size, colors))


WINDOW = """
name: "win" batch_size: 4 randomize_cpu: false pipeline_loads: false
data_config {{ layer_name: "input" data_type: SLIDING_WINDOW file_pattern: "{listfile}"
              image_size: 16 window_stride: {stride} {raw} num_colors: 3 }}
"""


@pytest.mark.parametrize("stride,raw", [(8, ""), (5, "raw_image_size: 20")])
def test_sliding_window_matches_jax(image_files, stride, raw):
    jcfg, cfg = _cfgs(WINDOW.format(listfile=image_files["jpeg"], stride=stride, raw=raw))
    ours, ref = DataHandler(cfg), JaxDataHandler(jcfg)
    try:
        assert ours.num_rows == ref.num_rows > 5
        for (a, va), (b, vb) in zip(ours.iter_epoch(), ref.iter_epoch()):
            assert va == vb
            np.testing.assert_array_equal(a["input"], b["input"])
        assert a["input"].shape == (4, 16, 16, 3)
    finally:
        ours.close()
        ref.close()


def test_txt_stream_matches_jax(tmp_path):
    rows = np.random.default_rng(25).normal(size=(9, 12)).round(5)
    np.savetxt(tmp_path / "m.txt", rows)
    jcfg, cfg = _cfgs(f"""
        name: "t" batch_size: 3 randomize_cpu: true pipeline_loads: false
        data_config {{ layer_name: "input" data_type: TXT file_pattern: "{tmp_path / 'm.txt'}"
                      image_size: 2 num_colors: 3 }}""")
    ours, ref = DataHandler(cfg, seed=2), JaxDataHandler(jcfg, seed=2)
    try:
        for _ in range(5):
            a, b = ours.get_batch()["input"], ref.get_batch()["input"]
            assert a.dtype == np.float32 and a.shape == (3, 2, 2, 3)
            np.testing.assert_array_equal(a, b)
    finally:
        ours.close()
        ref.close()


WINDOW_MODEL = """
name: "windows" seed: 4
layer { name: "input" is_input: true num_channels: 3 image_size: 16 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "fc2" is_output: true num_channels: 5 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.1 init_bias: 0.1 }
edge { source: "conv1" dest: "fc2" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
"""


def test_extract_cli_over_sliding_window_matches_jax(image_files, tmp_path, capsys):
    from convnet_tpu import model as jax_model
    from convnet_tpu.graph import build_graph

    model = tmp_path / "windows.pbtxt"
    model.write_text(WINDOW_MODEL)
    data = tmp_path / "data.pbtxt"
    data.write_text(WINDOW.format(listfile=image_files["jpeg"], stride=8, raw=""))
    graph = build_graph(config.parse_model(WINDOW_MODEL))
    params = {n: {k: np.asarray(v) for k, v in p.items()}
              for n, p in jax_model.init_params(graph, 4).items()}
    ckpt = jax_ckpt.save(str(tmp_path), "windows", params, None, step=0)
    outs = {}
    for name, main, extra in (("jax", jax_extract.main, []), ("port", extract.main,
                                                                ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.h5")
        assert main([str(model), str(data), "--checkpoint", ckpt, "--output", outs[name],
                     "--layers", "fc2", "conv1", *extra]) == 0
    with h5py.File(outs["jax"]) as fj, h5py.File(outs["port"]) as fp:
        for layer in ("fc2", "conv1"):
            want, got = fj[layer][...], fp[layer][...]
            assert got.shape == want.shape and got.shape[0] > 5
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert os.path.exists(outs["port"])
