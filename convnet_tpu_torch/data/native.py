"""The native data loaders, built with g++ at first use and bound through
ctypes (counterpart of `convnet_tpu/data/native.py`).

- `RawCacheReader` gathers rows of a raw cache (a memory-mapped,
  fixed-stride row store; `write_raw_cache` writes one) with the port's
  own C++ source, `convnet_tpu_torch/native/raw_cache.cc`: a pool of
  threads copies the rows, off the interpreter's lock. It needs g++ and
  nothing else. A failed build raises with g++'s messages: there is no
  quiet fall back to numpy. `raw_cache_gather_reference` is the plain
  version (a numpy memmap read), for the tests.
- `NativeImageLoader` decodes JPEG lists with the port's own copy of the
  JAX package's libjpeg loader, `convnet_tpu_torch/native/dataloader.cc`
  (g++, -ljpeg); it is built only when an all-JPEG IMAGE_RAW stream opens
  it.

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
# native/Makefile's flags; the raw cache links no libjpeg
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
HEADER = 16  # "CNTC" | uint32 version | uint64 row_bytes

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _library_path(source: Path, libs) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    h.update(source.read_bytes())
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
    lib = library(LOADER_SOURCE, ("-ljpeg",))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_load.restype = ctypes.c_int
    lib.loader_load.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _read_sidecar(path: str):
    with open(path + ".json") as f:
        meta = json.load(f)
    dtype, shape = np.dtype(meta["dtype"]), tuple(meta["shape"])
    return dtype, shape, int(dtype.itemsize * np.prod(shape))


class NativeImageLoader:
    """Decodes batches of JPEG files into (N, S, S, C) uint8 with the C++
    worker pool (libjpeg's DCT-scaled decode, bilinear shorter-side resize,
    center crop)."""

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
