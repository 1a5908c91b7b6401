"""Build the port's CUDA kernels and bind them through ctypes.

Every `*.cu` file under `convnet_tpu_torch/csrc/` is compiled by nvcc for
`sm_90a`, one nvcc process per source, all started together, and the
objects are linked into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds). The library is keyed by a
hash of every file under `csrc/` (headers included) and of the flags, and
lives under `<checkout>/build/convnet_tpu_torch/`; the first call in a
checkout builds it, later calls and processes load the file. Nothing here
runs at import time: a machine without nvcc imports the package and uses
the kernels' plain versions.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_u32, _u64 = ctypes.c_uint32, ctypes.c_uint64
# C entry points and their argument types: every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    # z, bias, y, m, c, is_bf16, relu, blocked, n, alpha, beta, q, stream
    "cn_lrn_fwd": [_p, _p, _p, _i64, _i, _i, _i, _i, _i, _f, _f, _i, _p],
    # g, z, bias, dx, db, partial, max_blocks, m, c, is_bf16, relu, blocked, n,
    # alpha, beta, coef, q, stream
    "cn_lrn_bwd": [_p, _p, _p, _p, _p, _p, _i, _i64, _i, _i, _i, _i, _i, _f, _f, _f, _i, _p],
    # x, y, n, is_bf16, threshold, scale, key, group0, stream
    "cn_dropout": [_p, _p, _i64, _i, _u32, _f, _p, _u64, _p],
    # state, words, n_keys, keys, crop_w2, crop_w3, row0, b, base_y, range_y, base_x, range_x,
    # oy, ox, flips, stream
    "cn_step_draws": [_p, _p, _i, _p, _u32, _u32] + [_i] * 6 + [_p] * 4,
    # x, oy, ox, flip, mean, std, out, b, h, w, c, crop, s, p, scale, stream
    "cn_s2d_prologue": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _p],
    # x, y, b, h, w, c, oh, ow, k, s, pad, is_bf16, stream
    "cn_maxpool_fwd": [_p, _p] + [_i] * 10 + [_p],
    # z, bias, m, b, h, w, c, oh, ow, k, s, is_bf16, relu, blocked, n, alpha, beta, q,
    # stream
    "cn_pool_lrn_fwd": [_p] * 3 + [_i] * 12 + [_f, _f, _i, _p],
    # g, m, z, bias, dz, db, partial, max_blocks, b, h, w, c, oh, ow, k, s, is_bf16,
    # relu, blocked, n, alpha, beta, coef, q, stream
    "cn_pool_lrn_bwd": [_p] * 7 + [_i] * 13 + [_f, _f, _f, _i, _p],
    # a, b, o, m, n, tile_rows, tile_cols, stream
    "cn_copy_add": [_p, _p, _p, _i64, _i64, _i, _i, _p],
    # x, off_r, off_c, o, b, h, w, oh, ow, esize, row_base, row_mult, col_base,
    # col_mult, select, stream
    "cn_crop_window": [_p] * 4 + [_i] * 11 + [_p],
    # x, s, o, plan (host int64 array, gather._packed_plan), in_numel, in_esize, epilogue,
    # scale, k, stream
    "cn_relayout": [_p, _p, _p, ctypes.POINTER(_i64), _i64, _i, _i, _f, _i, _p],
    # x, oy, ox, fl, o, b, h, l, p, q, is_bf16, normalize, scale, shift, stream
    "cn_crop_deinterleave": [_p] * 5 + [_i] * 7 + [_f, _f, _p],
}

_lib: Optional[ctypes.CDLL] = None
#: Seconds the last nvcc build took in this process (None: loaded from cache).
build_seconds: Optional[float] = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _hashed_files():
    """Every file under csrc/, the shared headers included: a change to
    any of them builds a new library."""
    return sorted(p for p in CSRC.rglob("*") if p.is_file())


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
        h.update(str(src.relative_to(CSRC)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libconvnet_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(cmds) -> None:
    """Run the commands in parallel; raise with every failure's stderr."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent build or
    # an interrupted build never leaves a half-written library at `out`
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        _run([
            [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", obj]
            for src, obj in zip(_sources(), objs)
        ])
        lib = os.path.join(tmp, out.name)
        _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
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
