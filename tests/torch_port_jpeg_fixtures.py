"""The port's committed JPEG fixtures and their digests as libjpeg decodes
them:

    python tests/torch_port_jpeg_fixtures.py

writes convnet_tpu_torch/testdata/jpeg/*.jpg and digests.json (see
convnet_tpu_torch/testdata/__init__.py). The digests come from the
reference harness below, a few lines of C++ over the system's libjpeg
(libjpeg-turbo 2.1.5 where this was written), built with g++ -ljpeg; it
decodes with the settings of the loader's `DecodeJpeg`. The tests
(tests/test_torch_port_jpeg.py) make the same kinds of files with these
functions. Every image comes from numpy with a fixed seed; PIL writes the
JPEGs, and the harness's libjpeg encoder writes the sampling factors PIL
cannot.
"""

from __future__ import annotations

import ctypes
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# libjpeg's decode at DecodeJpeg's settings (out_color_space RGB or
# GRAYSCALE, the power-of-2 scale_denom from min_side, all else at its
# default), behind jpeg_decode_file's signature; and libjpeg's encoder at
# given sampling factors. Warnings are silent; errors return -1.
HARNESS = r"""
#include <cstddef>
#include <cstdio>
#include <jpeglib.h>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

struct Err { jpeg_error_mgr pub; jmp_buf jb; };
static void on_error(j_common_ptr c) { longjmp(reinterpret_cast<Err*>(c->err)->jb, 1); }
static void on_message(j_common_ptr, int) {}

extern "C" int ref_decode_file(const char* path, int colors, int min_side, uint8_t* out,
                               int64_t cap, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  Err err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_message;
  std::vector<uint8_t> pix;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = colors == 1 ? JCS_GRAYSCALE : JCS_RGB;
  if (min_side > 0) {
    const int shorter = cinfo.image_width < cinfo.image_height ? cinfo.image_width
                                                               : cinfo.image_height;
    int denom = 1;
    while (denom < 8 && shorter / (denom * 2) >= min_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const size_t row = (size_t)cinfo.output_width * cinfo.output_components;
  pix.resize(row * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW r = pix.data() + row * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &r, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  if ((int64_t)pix.size() > cap || !out) return -2;
  memcpy(out, pix.data(), pix.size());
  return 0;
}

extern "C" int ref_encode_file(const char* path, const uint8_t* pixels, int w, int h,
                               int comps, const int* factors, int quality, int progressive,
                               int arith, int restart_interval, const int* dac) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  jpeg_compress_struct c;
  Err err;
  c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_message;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&c);
    fclose(f);
    return -1;
  }
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = comps;
  c.in_color_space = comps == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  for (int i = 0; i < comps; ++i) {
    c.comp_info[i].h_samp_factor = factors[i] >> 4;
    c.comp_info[i].v_samp_factor = factors[i] & 15;
  }
  if (progressive) jpeg_simple_progression(&c);
  c.arith_code = arith ? TRUE : FALSE;
  c.restart_interval = restart_interval;
  for (int i = 0; i < NUM_ARITH_TBLS; ++i) {
    c.arith_dc_L[i] = dac[0];
    c.arith_dc_U[i] = dac[1];
    c.arith_ac_K[i] = dac[2];
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW r = const_cast<uint8_t*>(pixels) + (size_t)c.next_scanline * w * comps;
    jpeg_write_scanlines(&c, &r, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(f);
  return 0;
}
"""


class NoLibjpeg(RuntimeError):
    """g++ could not build the harness: no jpeglib.h or libjpeg here."""


def build_harness(directory) -> ctypes.CDLL:
    """The harness built with g++ -ljpeg into `directory`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    src, lib = directory / "ref_jpeg.cc", directory / "libref_jpeg.so"
    src.write_text(HARNESS)
    proc = subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", str(src), "-o",
                           str(lib), "-ljpeg"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise NoLibjpeg(proc.stderr)
    h = ctypes.CDLL(str(lib))
    for name in ("ref_decode_file",):
        fn = getattr(h, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    h.ref_encode_file.restype = ctypes.c_int
    h.ref_encode_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
    return h


def ref_decode(harness, path, colors: int, min_side: int):
    """libjpeg's decode of the file, as `native.jpeg_decode_file` returns
    the port's: (H, W, colors) uint8, or None where libjpeg refuses it."""
    w, h = ctypes.c_int(), ctypes.c_int()
    out = np.empty(0, np.uint8)
    for _ in range(2):
        rc = harness.ref_decode_file(str(path).encode(), colors, min_side, out.ctypes.data,
                                     out.size, ctypes.byref(w), ctypes.byref(h))
        if rc == -2:
            out = np.empty(w.value * h.value * colors, np.uint8)
            continue
        break
    return out.reshape(h.value, w.value, colors) if rc == 0 else None


def image(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """Ramps in each channel plus uniform noise: edges, flat areas and
    detail for every block size."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 3 % 256], -1)
    arr = np.clip(base + rng.integers(-40, 41, base.shape), 0, 255).astype(np.uint8)
    return arr[..., 0] if gray else arr


# PIL's save options of each kind of file; "gray" saves a one-channel image
VARIANTS = {
    "444": dict(subsampling=0),
    "422": dict(subsampling=1),
    "420": dict(subsampling=2),
    "progressive": dict(progressive=True),
    "progressive444": dict(progressive=True, subsampling=0),
    "optimize": dict(optimize=True),
    "restart_blocks": dict(restart_marker_blocks=3),
    "restart_rows": dict(restart_marker_rows=1),
    "progressive_restart": dict(progressive=True, restart_marker_blocks=2),
    "gray": dict(gray=True),
    "gray_progressive": dict(gray=True, progressive=True),
    "adobe_rgb": dict(keep_rgb=True, subsampling=0),
    "quality100": dict(quality=100),
    "ones": dict(qtables=[[1] * 64, [1] * 64], subsampling=0),
}
# sampling factors (h << 4 | v of Y, Cb, Cr) that only libjpeg's encoder
# writes here (PIL's "4:1:1" is its 4:2:0): h1v2 chroma, 4:1:1, 1:4, luma
# below chroma, mixed chroma, 3:1 (whole-factor replication)
FACTORS = {
    "h1v2": (0x12, 0x11, 0x11),
    "h4v1": (0x41, 0x11, 0x11),
    "h1v4": (0x14, 0x11, 0x11),
    "luma_small": (0x11, 0x22, 0x11),
    "mixed": (0x22, 0x12, 0x21),
    "h2v1_h1v2": (0x21, 0x12, 0x12),
    "h3v1": (0x31, 0x11, 0x11),
}
# arithmetic-coded files (SOF9, SOF10), which PIL does not write: the
# options of encode_factors for each
ARITH = {
    "sequential": dict(factors=(0x22, 0x11, 0x11)),
    "progressive": dict(factors=(0x22, 0x11, 0x11), progressive=True),
    "h2v1_restarts": dict(factors=(0x21, 0x11, 0x11), restart_interval=3),
    "progressive_restarts": dict(factors=(0x11, 0x11, 0x11), progressive=True, restart_interval=2),
    "conditioning": dict(factors=(0x22, 0x11, 0x11), dac=(1, 3, 10), quality=100),
    "gray_progressive": dict(factors=(0x11, 0, 0), gray=True, progressive=True, dac=(0, 0, 1)),
}
SIZES = [(1, 1), (7, 9), (17, 33), (450, 600), (767, 1023)]


def jpeg_bytes(variant: str, h: int, w: int) -> bytes:
    """A PIL JPEG of `variant` (a key of VARIANTS) at h x w."""
    from PIL import Image

    kw = dict(VARIANTS[variant])
    gray = kw.pop("gray", False)
    buf = io.BytesIO()
    Image.fromarray(image(h, w, h * 7 + w, gray)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def encode_factors(harness, path, factors, h: int, w: int, progressive: bool = False,
                   arith: bool = False, restart_interval: int = 0, dac=(0, 1, 5),
                   gray: bool = False, quality: int = 90) -> None:
    """A libjpeg JPEG at the given sampling factors (Y's alone for `gray`),
    Huffman- or arithmetic-coded (`dac`: the DC tables' L and U and the AC
    tables' Kx of its conditioning)."""
    arr = np.ascontiguousarray(image(h, w, h * 5 + w, gray))
    facs = (ctypes.c_int * 3)(*factors)
    if harness.ref_encode_file(str(path).encode(), arr.ctypes.data, w, h, 1 if gray else 3, facs,
                               quality, int(progressive), int(arith), restart_interval,
                               (ctypes.c_int * 3)(*dac)) != 0:
        raise RuntimeError(f"libjpeg could not encode {path}")


def refused_bytes(kind: str) -> bytes:
    """Files libjpeg refuses: a CMYK JPEG, a PNG, random bytes."""
    from PIL import Image

    arr = image(24, 32, 5)
    buf = io.BytesIO()
    if kind == "cmyk":
        Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
    elif kind == "png":
        Image.fromarray(arr).save(buf, "PNG")
    else:
        return np.random.default_rng(9).integers(0, 256, 4000, dtype=np.uint8).tobytes()
    return buf.getvalue()


def min_sides(h: int, w: int):
    """min_side values whose DCT scale is 1/1 (0: no scaling), 1/2, 1/4 and
    1/8 where the shorter side allows: the loader's rule takes the smallest
    scale whose shorter side still covers min_side."""
    shorter = min(h, w)
    return [0] + sorted({max(1, shorter // d) for d in (2, 4, 8)})


# the committed fixtures: small files of every kind, their digests at each
# scale and colour count
FIXTURE_SIZES = [(17, 33), (45, 60)]


def write_fixtures(out_dir: Path, harness) -> dict:
    from convnet_tpu_torch import testdata

    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.jpg"):
        old.unlink()
    names = []
    for variant in VARIANTS:
        for h, w in FIXTURE_SIZES:
            name = f"{variant}_{h}x{w}.jpg"
            (out_dir / name).write_bytes(jpeg_bytes(variant, h, w))
            names.append(name)
    for key, factors in FACTORS.items():
        name = f"factors_{key}_45x60.jpg"
        encode_factors(harness, out_dir / name, factors, 45, 60)
        names.append(name)
    for key in ("sequential", "progressive", "conditioning"):
        name = f"arith_{key}_45x60.jpg"
        encode_factors(harness, out_dir / name, h=45, w=60, arith=True, **ARITH[key])
        names.append(name)
    for variant in ("420", "restart_blocks", "progressive", "progressive444"):
        name = f"truncated_{variant}_45x60.jpg"
        full = jpeg_bytes(variant, 45, 60)
        (out_dir / name).write_bytes(full[: len(full) // 2])
        names.append(name)
    for kind in ("cmyk", "png", "random"):
        name = f"refused_{kind}.jpg"
        (out_dir / name).write_bytes(refused_bytes(kind))
        names.append(name)
    digests = {}
    for name in sorted(names):
        entries = {}
        for colors in (1, 3):
            for ms in (0, 4, 8, 16):  # 45x60 reaches 1/8 at 4; 17x33 1/4 at 4
                arr = ref_decode(harness, out_dir / name, colors, ms)
                entries[f"colors={colors} min_side={ms}"] = (
                    None if arr is None else testdata.describe(arr))
        digests[name] = entries
    (out_dir / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    return digests


if __name__ == "__main__":
    import tempfile

    from convnet_tpu_torch import testdata

    with tempfile.TemporaryDirectory() as tmp:
        d = write_fixtures(testdata.JPEG_DIR, build_harness(tmp))
    total = sum(p.stat().st_size for p in testdata.JPEG_DIR.iterdir())
    print(f"{len(d)} files, {total} bytes in {testdata.JPEG_DIR}")
