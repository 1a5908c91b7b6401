"""The native data loaders, built with g++ at first use and bound through
ctypes (counterpart of `convnet_tpu/data/native.py`).

- `RawCacheReader` gathers rows of a raw cache (a memory-mapped,
  fixed-stride row store; `write_raw_cache` writes one) with the port's
  own C++ source, `convnet_tpu_torch/native/raw_cache.cc`: a pool of
  threads copies the rows, off the interpreter's lock. It needs g++ and
  nothing else. A failed build raises with g++'s messages: there is no
  quiet fall back to numpy. `raw_cache_gather_reference` is the plain
  version (a numpy memmap read), for the tests.
- `NativeImageLoader` decodes JPEG lists with the port's counterpart of
  the JAX package's libjpeg loader, `convnet_tpu_torch/native/dataloader.cc`,
  whose decoder (`native/jpeg_decode.h`) gives libjpeg-turbo's bytes with
  no library behind it: g++ builds it with no flag but `CXX_FLAGS`
  (`LOADER_LIBS` is empty). It is built only when an all-JPEG IMAGE_RAW
  stream opens it, or when `jpeg_decode_file` decodes one file (the tests
  and the committed fixtures' check).
- `lzf_decompress` decodes one chunk of h5py's lzf filter for
  `convnet_tpu_torch/hdf5.py` with `convnet_tpu_torch/native/lzf.cc`; it
  is built when a file's first lzf chunk is read. `szip_decompress` does
  the same for HDF5's szip filter with `convnet_tpu_torch/native/szip.cc`.

Each library is keyed by a hash of its source and flags and lives under
`<checkout>/build/convnet_tpu_torch/`; it is built in a temporary
directory and renamed into place, so concurrent or interrupted builds
never leave a half-written file. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "convnet_tpu_torch"
RAW_CACHE_SOURCE = _PKG / "native" / "raw_cache.cc"
LOADER_SOURCE = _PKG / "native" / "dataloader.cc"
LOADER_LIBS = ()  # the decoder is the port's own: no libjpeg
LZF_SOURCE = _PKG / "native" / "lzf.cc"
SZIP_SOURCE = _PKG / "native" / "szip.cc"
# native/Makefile's flags
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
HEADER = 16  # "CNTC" | uint32 version | uint64 row_bytes

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _library_path(source: Path, libs) -> Path:
    """Where the build of `source` lives: keyed by the flags, the source and
    every header beside it that it includes (dataloader.cc's jpeg_decode.h)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    text = source.read_bytes()
    h.update(text)
    for name in sorted(set(re.findall(rb'#include "([^"]+)"', text))):
        h.update((source.parent / name.decode()).read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _build(source: Path, out: Path, libs) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = ["g++", *CXX_FLAGS, str(source), "-o", lib, *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"building {source.name} needs g++, which was not found") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}) building {source.name}:\n{' '.join(cmd)}\n"
                f"{proc.stderr}"
            )
        os.replace(lib, out)


def library(source: Path, libs=()) -> ctypes.CDLL:
    """The shared library of `source`, built with g++ on first use."""
    key = str(source)
    with _lock:
        if key not in _libs:
            path = _library_path(source, libs)
            if not path.exists():
                _build(source, path, libs)
            _libs[key] = ctypes.CDLL(str(path))
        return _libs[key]


def _raw_cache_lib() -> ctypes.CDLL:
    lib = library(RAW_CACHE_SOURCE)
    lib.cache_open.restype = ctypes.c_void_p
    lib.cache_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.cache_num_rows.restype = ctypes.c_int64
    lib.cache_num_rows.argtypes = [ctypes.c_void_p]
    lib.cache_row_bytes.restype = ctypes.c_int64
    lib.cache_row_bytes.argtypes = [ctypes.c_void_p]
    lib.cache_gather.restype = ctypes.c_int
    lib.cache_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.cache_close.argtypes = [ctypes.c_void_p]
    return lib


def _loader_lib() -> ctypes.CDLL:
    lib = library(LOADER_SOURCE, LOADER_LIBS)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_load.restype = ctypes.c_int
    lib.loader_load.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.jpeg_decode_file.restype = ctypes.c_int
    lib.jpeg_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def jpeg_decode_file(path, num_colors: int, min_side: int = 0):
    """One JPEG file decoded by the loader's decoder as the loader decodes
    it before the resize: (H, W, num_colors) uint8 at the power-of-2 DCT
    scale whose shorter side still covers `min_side` (0: full size), or
    None where libjpeg would refuse the file."""
    lib = _loader_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    # room for 100:1 compression; a file that packs tighter is decoded again
    out = np.empty(max(os.path.getsize(path) * 100, 1 << 22), np.uint8)
    for _ in range(2):  # the first call reports the size when out is short
        rc = lib.jpeg_decode_file(os.fsencode(path), num_colors, min_side, out.ctypes.data,
                                  out.size, ctypes.byref(w), ctypes.byref(h))
        if rc == -2:
            out = np.empty(w.value * h.value * num_colors, np.uint8)
            continue
        break
    if rc != 0:
        return None
    return out[: h.value * w.value * num_colors].reshape(h.value, w.value, num_colors)


def _lzf_lib() -> ctypes.CDLL:
    lib = library(LZF_SOURCE)
    lib.lzf_decode.restype = ctypes.c_int64
    lib.lzf_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    return lib


def lzf_decompress(data: bytes, size: int) -> bytes:
    """One LZF block decoded, as h5py's lzf filter decodes a chunk: into
    `size` bytes first, a buffer grown by len(data) while it is too small.
    Data that is not LZF raises OSError."""
    lib = _lzf_lib()
    while True:
        out = np.empty(max(size, 1), np.uint8)
        n = lib.lzf_decode(data, len(data), out.ctypes.data, size)
        if n >= 0:
            return out[:n].tobytes()
        if n != -1:
            raise OSError("invalid data for LZF decompression")
        size += max(len(data), 1)


def _szip_lib() -> ctypes.CDLL:
    lib = library(SZIP_SOURCE)
    lib.szip_decode.restype = ctypes.c_int64
    lib.szip_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def szip_decompress(data: bytes, size: int, options_mask: int, pixels_per_block: int,
                    bits_per_pixel: int, pixels_per_scanline: int) -> bytes:
    """One szip chunk (without HDF5's size header) decoded into `size`
    bytes, as libaec's SZ_BufftoBuffDecompress decodes it with the szip
    filter's parameters. Data that is not szip raises OSError."""
    lib = _szip_lib()
    out = np.empty(max(size, 1), np.uint8)
    n = lib.szip_decode(data, len(data), out.ctypes.data, size, options_mask, pixels_per_block,
                        bits_per_pixel, pixels_per_scanline)
    if n < 0:
        raise OSError({-1: "szip data ends early", -2: "invalid szip data",
                       -3: f"szip parameters libaec refuses: options {options_mask}, "
                           f"{pixels_per_block} pixels a block, {bits_per_pixel} bits a pixel, "
                           f"{pixels_per_scanline} a scanline"}[n])
    return out[:n].tobytes()


def _read_sidecar(path: str):
    with open(path + ".json") as f:
        meta = json.load(f)
    dtype, shape = np.dtype(meta["dtype"]), tuple(meta["shape"])
    return dtype, shape, int(dtype.itemsize * np.prod(shape))


class NativeImageLoader:
    """Decodes batches of JPEG files into (N, S, S, C) uint8 with the C++
    worker pool (libjpeg-turbo's DCT-scaled decode, bit for bit; bilinear
    shorter-side resize; center crop)."""

    def __init__(self, paths: List[str], raw_size: int, num_colors: int, threads: int = 8):
        self._lib = _loader_lib()
        self._raw, self._colors = raw_size, num_colors
        self._paths_bytes = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(paths))(*self._paths_bytes)
        self._handle = self._lib.loader_create(arr, len(paths), raw_size, num_colors, threads)
        if not self._handle:
            raise RuntimeError("loader_create failed")

    def load(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self._raw, self._raw, self._colors), np.uint8)
        rc = self._lib.loader_load(self._handle, idx.ctypes.data, len(idx), out.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"native loader failed on batch (rc={rc})")
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RawCacheReader:
    """Rows of a raw cache gathered by the port's C++ core. The `.json`
    sidecar gives each row's dtype and shape."""

    def __init__(self, path: str, threads: int = 4):
        self.dtype, self.row_shape, self.row_bytes = _read_sidecar(path)
        self._lib = _raw_cache_lib()
        self._handle = self._lib.cache_open(path.encode(), threads)
        if not self._handle:
            raise ValueError(f"bad raw cache file: {path}")
        have = self._lib.cache_row_bytes(self._handle)
        if have != self.row_bytes:
            self.close()
            raise ValueError(f"{path}: sidecar row size mismatch ({have} vs {self.row_bytes})")
        self.num_rows = int(self._lib.cache_num_rows(self._handle))

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Rows `indices` as one (len(indices), *row_shape) array."""
        if self._handle is None:
            raise RuntimeError("RawCacheReader is closed")
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.row_bytes), np.uint8)
        rc = self._lib.cache_gather(self._handle, idx.ctypes.data, len(idx), out.ctypes.data)
        if rc != 0:
            raise IndexError(f"cache_gather failed: an index outside [0, {self.num_rows})")
        return out.view(self.dtype).reshape((len(idx),) + self.row_shape)

    def close(self):
        if self._handle is not None:
            self._lib.cache_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def raw_cache_gather_reference(path: str, indices: np.ndarray) -> np.ndarray:
    """Plain version of `RawCacheReader.gather`: the same rows through a
    numpy memmap."""
    dtype, shape, row_bytes = _read_sidecar(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    if bytes(raw[:4]) != b"CNTC":
        raise ValueError(f"bad raw cache magic in {path}")
    n = (raw.size - HEADER) // row_bytes
    rows = raw[HEADER: HEADER + n * row_bytes].reshape(n, row_bytes)
    out = np.ascontiguousarray(rows[np.asarray(indices, dtype=np.int64)])
    return out.view(dtype).reshape((len(out),) + shape)


def write_raw_cache(path: str, rows, chunk_rows: int = 4096) -> None:
    """Write (N, ...) rows as a raw cache and its JSON sidecar (the JAX
    package's format: either package reads what the other writes). `rows`
    is an array or anything with `shape`, `dtype` and first-axis slices,
    such as an `hdf5.Dataset`; it is read `chunk_rows` rows at a time."""
    row_shape = tuple(rows.shape[1:])
    dtype = np.dtype(rows.dtype)
    with open(path, "wb") as f:
        f.write(b"CNTC")
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<Q", dtype.itemsize * int(np.prod(row_shape))))
        for s in range(0, rows.shape[0], chunk_rows):
            np.ascontiguousarray(rows[s : s + chunk_rows]).tofile(f)
    with open(path + ".json", "w") as f:
        json.dump({"dtype": dtype.name, "shape": list(row_shape)}, f)
