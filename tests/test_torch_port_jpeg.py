"""The port's JPEG decoder (`convnet_tpu_torch/native/jpeg_decode.h`, bound
as `data.native.jpeg_decode_file` and used by the loader) against libjpeg,
on the CPU: the same files, from seeded numpy images, decoded by the port
and by a reference harness over the system's libjpeg (libjpeg-turbo 2.1.5
here) at the loader's settings, array-equal at every DCT scale the
loader's min_side rule reaches and at 1 and 3 colours; the files libjpeg
refuses refused alike; the port's loader against the JAX package's
`native/dataloader.cc` built with g++ -ljpeg; and the committed fixtures'
digests against the harness. The harness and the files come from
`tests/torch_port_jpeg_fixtures.py`; where g++ cannot build it (no
jpeglib.h), the tests that need it skip."""

import ctypes
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_port_jpeg_fixtures as fx
from convnet_tpu.data import native as jax_native
from convnet_tpu_torch import testdata
from convnet_tpu_torch.data import native as pt_native


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    try:
        return fx.build_harness(tmp_path_factory.mktemp("ref_jpeg"))
    except fx.NoLibjpeg as e:
        pytest.skip(f"g++ cannot build the libjpeg harness here: {e}")


def _scale(arr, h, w):
    """The denominator of the DCT scale a decode of an h x w file took."""
    return next(d for d in (1, 2, 4, 8) if arr.shape[:2] == (-(-h // d), -(-w // d)))


def _assert_decodes_alike(harness, path, h, w, scales=None):
    """Port and libjpeg decode `path` array-equal at every min_side of
    `fx.min_sides` and both colour counts; returns the scales reached."""
    seen = set()
    for colors in (1, 3):
        for ms in fx.min_sides(h, w):
            want = fx.ref_decode(harness, path, colors, ms)
            got = pt_native.jpeg_decode_file(str(path), colors, ms)
            assert want is not None, f"libjpeg refused {path.name} at {colors} colours"
            assert got is not None, f"the port refused {path.name} at {colors} colours, min_side {ms}"
            assert got.shape == want.shape, (path.name, colors, ms)
            np.testing.assert_array_equal(got, want, err_msg=f"{path.name} colors={colors} min_side={ms}")
            seen.add(_scale(got, h, w))
    if scales is not None:
        assert seen == scales
    return seen


@pytest.mark.parametrize("h,w", fx.SIZES, ids=[f"{w}x{h}" for h, w in fx.SIZES])
@pytest.mark.parametrize("variant", list(fx.VARIANTS))
def test_decode_equals_libjpeg(harness, tmp_path, variant, h, w):
    """Each kind of PIL JPEG at each size: array-equal to libjpeg at scales
    1/1 to 1/8 (those the shorter side reaches) and at 1 and 3 colours."""
    path = tmp_path / f"{variant}.jpg"
    path.write_bytes(fx.jpeg_bytes(variant, h, w))
    reachable = {d for d in (1, 2, 4, 8) if d == 1 or min(h, w) // d >= 1}
    _assert_decodes_alike(harness, path, h, w, scales=reachable)


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("key", list(fx.FACTORS))
def test_decode_sampling_factors_equals_libjpeg(harness, tmp_path, key, progressive):
    """Sampling factors PIL does not write (h1v2 chroma through the h1v2
    upsampler, 4:1:1 and 3:1 through box replication, luma smaller than
    chroma, mixed chroma), from libjpeg's encoder: array-equal, each size
    with edges that end inside a block and inside an MCU."""
    for h, w in [(7, 9), (37, 61), (450, 600)]:
        path = tmp_path / f"{key}_{h}x{w}.jpg"
        fx.encode_factors(harness, path, fx.FACTORS[key], h, w, progressive=progressive)
        _assert_decodes_alike(harness, path, h, w)


# the comparison of _assert_decodes_alike in a process whose libjpeg-turbo
# runs its C code (JSIMD_FORCENONE), for data whose coefficients overflow
# the 16-bit lanes of its x86 SIMD IDCTs
_C_PATH = """
import sys
from pathlib import Path
sys.path[:0] = [sys.argv[1], str(Path(sys.argv[1]).parent)]
import test_torch_port_jpeg as t
import torch_port_jpeg_fixtures as fx
harness = fx.build_harness(sys.argv[2])
for path, h, w in zip(sys.argv[3::3], sys.argv[4::3], sys.argv[5::3]):
    t._assert_decodes_alike(harness, Path(path), int(h), int(w))
print("alike")
"""


def _assert_decodes_alike_c_path(tmp_path, files):
    env = dict(os.environ, JSIMD_FORCENONE="1")
    args = [str(a) for f in files for a in f]
    proc = subprocess.run([sys.executable, "-c", _C_PATH, str(Path(__file__).parent),
                           str(tmp_path / "c_path"), *args], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("alike"), proc.stderr[-3000:]


@pytest.mark.parametrize("key", list(fx.ARITH))
def test_decode_arithmetic_equals_libjpeg(harness, tmp_path, key):
    """Arithmetic-coded files (SOF9 and SOF10, from libjpeg's encoder):
    sequential and progressive, restart intervals, DAC conditioning other
    than the default, gray; whole, and cut in half. A cut arithmetic file
    decodes zero data past its end into coefficients that overflow 16 bits:
    there libjpeg-turbo's x86 SIMD IDCTs saturate where its C IDCTs (and
    the port) wrap, so the cut files are held to libjpeg-turbo's C path."""
    cut = []
    for h, w in [(7, 9), (37, 61), (450, 600)]:
        path = tmp_path / f"{key}_{h}x{w}.jpg"
        fx.encode_factors(harness, path, h=h, w=w, arith=True, **fx.ARITH[key])
        assert path.read_bytes()[2:].find(b"\xff\xc9" if "progressive" not in key else b"\xff\xca") > 0
        _assert_decodes_alike(harness, path, h, w)
        if h > 7:  # half of the smallest file ends inside its headers
            half = tmp_path / f"half_{path.name}"
            full = path.read_bytes()
            half.write_bytes(full[: len(full) // 2])
            cut.append((half, h, w))
    _assert_decodes_alike_c_path(tmp_path, cut)


@pytest.mark.parametrize("variant,fraction", [
    ("420", 0.5), ("444", 0.5), ("422", 0.3), ("gray", 0.5), ("restart_blocks", 0.5),
    ("restart_rows", 0.7), ("optimize", 0.5), ("progressive", 0.5), ("progressive", 0.06), ("progressive", 0.045),
    ("progressive444", 0.3), ("gray_progressive", 0.5), ("progressive_restart", 0.6),
])
def test_truncated_decodes_as_libjpeg(harness, tmp_path, variant, fraction):
    """A file cut short decodes as libjpeg decodes it, not refused: the
    blocks past the end with zero coefficients, those of a restart interval
    the cut falls in from zero bits; in a progressive file the first AC
    coefficients that lack bits estimated from the DC values around (block
    smoothing; 0.045 of the file holds the DC scan alone, 0.06 part of the
    next: where no AC bits came, the DC is smoothed too)."""
    h, w = 450, 600
    full = fx.jpeg_bytes(variant, h, w)
    path = tmp_path / "cut.jpg"
    path.write_bytes(full[: int(len(full) * fraction)])
    _assert_decodes_alike(harness, path, h, w)
    whole = tmp_path / "whole.jpg"
    whole.write_bytes(full)
    assert not np.array_equal(pt_native.jpeg_decode_file(str(path), 3),
                              pt_native.jpeg_decode_file(str(whole), 3))


@pytest.mark.parametrize("kind", ["cmyk", "png", "random"])
def test_refuses_what_libjpeg_refuses(harness, tmp_path, kind):
    """A CMYK JPEG (no conversion to RGB or gray), a PNG named .jpg and
    random bytes: refused by both decoders at every setting, and the
    loader zeroes the row and returns a negative count."""
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(fx.refused_bytes(kind))
    for colors in (1, 3):
        for ms in (0, 4):
            assert fx.ref_decode(harness, path, colors, ms) is None
            assert pt_native.jpeg_decode_file(str(path), colors, ms) is None
    _assert_the_loader_zeroes(path)


def _assert_the_loader_zeroes(path):
    """The loader zeroes the row of a refused file and returns -1."""
    lib = pt_native._loader_lib()
    arr = (ctypes.c_char_p * 1)(str(path).encode())
    handle = lib.loader_create(arr, 1, 8, 3, 1)
    try:
        out = np.full((1, 8, 8, 3), 7, np.uint8)
        idx = np.zeros(1, np.int64)
        assert lib.loader_load(handle, idx.ctypes.data, 1, out.ctypes.data) == -1
        assert not out.any()
    finally:
        lib.loader_destroy(handle)


@pytest.mark.parametrize("variant,h,w", [("420", 65500, 65500), ("gray", 23169, 23169)])
def test_refuses_a_header_too_large_to_hold(tmp_path, variant, h, w):
    """A file whose header asks for more coefficients than the decoder's
    bound (kMaxCoefBytes, 1 GiB) is refused before they are allocated,
    where libjpeg would decode it; here the file ends after its scan
    header. Gray 23169 x 23169 is the first square size past the bound."""
    data = bytearray(fx.jpeg_bytes(variant, 16, 16))
    pos = 2
    while data[pos + 1] != 0xDA:  # walk the segments to SOF0, then to SOS
        if data[pos + 1] == 0xC0:
            data[pos + 5:pos + 9] = struct.pack(">HH", h, w)
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    path = tmp_path / "huge.jpg"
    path.write_bytes(bytes(data[: pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]]))
    assert struct.pack(">HH", h, w) in path.read_bytes()
    for colors in (1, 3):
        for ms in (0, 256):
            assert pt_native.jpeg_decode_file(str(path), colors, ms) is None
    _assert_the_loader_zeroes(path)


@pytest.fixture(scope="module")
def loader_files(tmp_path_factory):
    """One file of each kind, of mixed sizes, and one cut in half."""
    d = tmp_path_factory.mktemp("loader_jpegs")
    paths = []
    for i, variant in enumerate(fx.VARIANTS):
        h, w = [(45, 60), (450, 600), (17, 33), (767, 1023)][i % 4]
        p = d / f"{variant}.jpg"
        p.write_bytes(fx.jpeg_bytes(variant, h, w))
        paths.append(str(p))
    full = fx.jpeg_bytes("420", 450, 600)
    (d / "cut.jpg").write_bytes(full[: len(full) // 2])
    paths.append(str(d / "cut.jpg"))
    return paths


@pytest.mark.parametrize("raw,colors", [(24, 3), (32, 1), (256, 3), (64, 1)])
def test_loader_decodes_as_the_jax_packages_libjpeg_build(harness, loader_files, monkeypatch,
                                                          raw, colors):
    """The port's loader (its own decoder, no libjpeg) and the JAX
    package's `native/dataloader.cc` built with g++ -ljpeg decode, resize
    and crop the same files array-equal (256: upscales of the small ones)."""
    jax_source = Path(pt_native.__file__).resolve().parents[2] / "native" / "dataloader.cc"
    pt_native.library(jax_source, ("-ljpeg",))
    monkeypatch.setattr(jax_native, "_LIB_PATHS",
                        [str(pt_native._library_path(jax_source, ("-ljpeg",)))])
    monkeypatch.setattr(jax_native, "_lib", None)
    idx = np.arange(len(loader_files))[::-1]
    ours = pt_native.NativeImageLoader(loader_files, raw, colors, threads=3)
    try:
        got = ours.load(idx)
    finally:
        ours.close()
    want = jax_native.NativeImageLoader(loader_files, raw, colors, threads=3).load(idx)
    assert got.shape == (len(loader_files), raw, raw, colors) and got.std() > 1
    np.testing.assert_array_equal(got, want)


def test_committed_digests_are_libjpegs(harness):
    """`testdata/jpeg/digests.json` holds libjpeg's decode of every
    committed fixture (so that the file cannot drift from libjpeg), and the
    fixtures cover every scale, both colour counts and the refusals."""
    want = json.loads(testdata.JPEG_DIGESTS.read_text())
    files = sorted(p.name for p in testdata.JPEG_DIR.glob("*.jpg"))
    assert sorted(want) == files and len(files) >= 30
    assert sum(p.stat().st_size for p in testdata.JPEG_DIR.iterdir()) < 300_000
    shapes = set()
    for name, entries in want.items():
        for key, entry in entries.items():
            colors, ms = (int(part.split("=")[1]) for part in key.split())
            arr = fx.ref_decode(harness, testdata.JPEG_DIR / name, colors, ms)
            assert (None if arr is None else testdata.describe(arr)) == entry, (name, key)
            if entry is not None:
                shapes.add(tuple(entry["shape"]))
    assert {(45, 60, 3), (23, 30, 3), (12, 15, 3), (6, 8, 1)} <= shapes
    assert all(want[f"refused_{k}.jpg"][key] is None
               for k in ("cmyk", "png", "random") for key in want[f"refused_{k}.jpg"])


def test_check_jpeg_fixtures():
    """The port's decoder matches every digest (what `chip_smoke.py` runs
    on the card's machine, where there is no libjpeg)."""
    count, nbytes, problems = testdata.check_jpeg_fixtures()
    assert problems == []
    want = json.loads(testdata.JPEG_DIGESTS.read_text())
    assert count == sum(len(e) for e in want.values()) and nbytes > 0


def test_the_loaders_build_is_keyed_by_its_header(tmp_path, monkeypatch):
    """An edit to `jpeg_decode.h` alone gives the loader a new build path,
    so no stale build of the old decoder is loaded."""
    for name in ("dataloader.cc", "jpeg_decode.h"):
        (tmp_path / name).write_bytes((pt_native.LOADER_SOURCE.parent / name).read_bytes())
    source = tmp_path / "dataloader.cc"
    before = pt_native._library_path(source, pt_native.LOADER_LIBS)
    assert before == pt_native._library_path(pt_native.LOADER_SOURCE, pt_native.LOADER_LIBS)
    (tmp_path / "jpeg_decode.h").write_text((tmp_path / "jpeg_decode.h").read_text() + "\n// edit\n")
    assert pt_native._library_path(source, pt_native.LOADER_LIBS) != before
