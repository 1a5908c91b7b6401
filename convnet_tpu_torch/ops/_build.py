"""Build the port's CUDA kernels and bind them through ctypes.

Every `*.cu` file under `convnet_tpu_torch/csrc/` is compiled by nvcc for
`sm_90a` into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds). The library is keyed by a hash of
the sources and the flags and lives under `<checkout>/build/
convnet_tpu_torch/`; the first call in a checkout builds it, later calls
and processes load the file. Nothing here runs at import time: a machine
without nvcc imports the package and uses the kernels' plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "convnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry points and their argument types: every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    # z, bias, y, m, c, is_bf16, relu, blocked, n, alpha, beta, q, stream
    "cn_lrn_fwd": [_p, _p, _p, _i64, _i, _i, _i, _i, _i, _f, _f, _i, _p],
    # x, oy, ox, flip, mean, std, out, b, h, w, c, crop, s, p, scale, stream
    "cn_s2d_prologue": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _p],
}

_lib: Optional[ctypes.CDLL] = None
#: Seconds the last nvcc build took in this process (None: loaded from cache).
build_seconds: Optional[float] = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libconvnet_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent builder or an
    # interrupted build never leaves a half-written library at `out`
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {rc}")
