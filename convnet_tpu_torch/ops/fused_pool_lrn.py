"""Response norm -> max pool as one op with the reference's pool gradient
(counterpart of `convnet_tpu/ops/fused_pool_lrn.py`).

    m = maxpool(LRN(relu?(x + b)))        pool padding 0, ceil-mode windows

The gradient is upstream cuda-convnet's MaxPoolUndo: every input position
whose LRN output equals its window's max receives that window's cotangent,
so tied maxima (post-ReLU zeros tie all the time) credit every winner
(`maxpool2d_undo_reference`), where the unfused path credits one. The model
takes this op for the LRN -> pool chains of a train step only under
CONVNET_POOL_LRN_FUSED=1 (`pool_lrn_fusion_wanted`), as the JAX package
does (`convnet_tpu/model.py:268-365`).

Two CUDA kernels (`csrc/pool_lrn.cu`), each with a wrapper and a plain
PyTorch version:

- `pool_lrn_fwd` replaces the TPU kernel `_fused_fwd_kernel`
  (fused_pool_lrn.py:388): m without writing the LRN output y;
- `pool_lrn_bwd` replaces `_fused_bwd_kernel` (fused_pool_lrn.py:134):
  it recomputes y from x, credits the cotangent to every position where
  y equals the stored max, runs the LRN backward with the ReLU mask on
  that f32 sum, and returns dx and, with a bias, db (deterministic).

Each has a fast path for what the train step runs (a sliding window of
n = 5, beta = 0.75, rows of whole 16-byte words, aligned tensors, any
pool kernel and stride): a persistent grid of blocks that walk bands of
an image's rows with the next row in flight, each y computed once, 8
bf16 or 4 f32 channels a thread. Other windows, exponents and alignments
take generic kernels. The library picks the path from shapes, dtype and
alignment before it launches; the wrappers here are the same for both.

For a CPU tensor a wrapper runs the plain version (the port's plain LRN,
`maxpool_reference`, then `maxpool2d_undo_reference` in f32 and the plain
LRN backward); for a CUDA tensor it launches the kernel or raises. The
residuals are x (and b) and m: y is recomputed. The TPU's layout gates
(`_fused_backend`, fused_pool_lrn.py:508-537) are not ported, since the
card has no lane tiling: every 4-D chain whose pool has padding 0 fuses.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from convnet_tpu_torch.graph import conv_out_size
from convnet_tpu_torch.ops.lrn import (
    _bwd_math,
    _check_kernel_args,
    _fwd_math,
    norm_window_size,
    quarter_power,
)
from convnet_tpu_torch.ops.pool import maxpool2d_undo_reference, maxpool_reference

#: Launches of the CUDA kernels in this process (CPU calls do not count).
LAUNCHES = 0
BWD_LAUNCHES = 0

#: Most blocks the backward kernel runs: each writes one row of db
#: partial sums, which a second kernel adds up in a fixed order.
_BWD_MAX_BLOCKS = 1024


def pool_lrn_fusion_wanted() -> bool:
    """CONVNET_POOL_LRN_FUSED=1 routes a train step's LRN -> maxpool chains
    through `lrn_maxpool` (the JAX package's switch; off by default, since
    its gradient credits every tie)."""
    return os.environ.get("CONVNET_POOL_LRN_FUSED", "0") == "1"


def fusion_applicable(shape, pool_padding: int) -> bool:
    """Whether an LRN -> maxpool chain over an activation of this shape
    fuses: every 4-D one whose pool has padding 0."""
    return len(shape) == 4 and pool_padding == 0


def _pool_size(h: int, w: int, k: int, s: int):
    return conv_out_size(h, k, s, 0), conv_out_size(w, k, s, 0)


def _fwd_reference(z, n, alpha, beta, k, s, bias=None, relu=False, blocked=False):
    """The forward kernel's plain version: the plain LRN, then the pool."""
    return maxpool_reference(_fwd_math(z, n, alpha, beta, bias, relu, blocked), k, s)


def _bwd_reference(g, m, z, n, alpha, beta, k, s, bias=None, relu=False, blocked=False, y=None):
    """The backward kernel's plain version: y recomputed by the plain LRN
    (or the y given, e.g. the LRN kernel's), the all-ties pool-undo summed
    and kept in f32, the plain LRN backward. Returns (dz in z's dtype, db
    f32 or None)."""
    if y is None:
        y = _fwd_math(z, n, alpha, beta, bias, relu, blocked)
    g_lrn = maxpool2d_undo_reference(y.float(), m.float(), g.float(), k, s)
    return _bwd_math(g_lrn, z, n, alpha, beta, bias, relu, blocked)


def _check_shapes(name: str, z: torch.Tensor, k: int, s: int, bias, *pooled) -> None:
    if z.dim() != 4:
        raise ValueError(f"{name} takes (B, H, W, C), got shape {tuple(z.shape)}")
    b, h, w, c = z.shape
    want = (b, *_pool_size(h, w, k, s), c)
    for t in pooled:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: pooled shape {tuple(t.shape)} != {want}")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")


def pool_lrn_fwd(
    z: torch.Tensor,
    n: int,
    alpha: float,
    beta: float,
    k: int,
    s: int,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    blocked: bool = False,
) -> torch.Tensor:
    """maxpool_k,s(LRN(relu?(z + bias))): z (B, H, W, C) contiguous, bf16
    or f32; bias f32 (C,) or None. Returns m (B, OH, OW, C) in z's dtype.
    No autograd (see lrn_maxpool)."""
    _check_shapes("pool_lrn_fwd", z, k, s, bias)
    if z.device.type == "cpu":
        return _fwd_reference(z, n, alpha, beta, k, s, bias, relu, blocked)
    _check_kernel_args("pool_lrn_fwd", (z,), bias)
    b, h, w, c = z.shape
    oh, ow = _pool_size(h, w, k, s)
    m = torch.empty((b, oh, ow, c), dtype=z.dtype, device=z.device)
    if m.numel() == 0:
        return m
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(z.device):
        rc = _build.library().cn_pool_lrn_fwd(
            z.data_ptr(), None if bias is None else bias.data_ptr(), m.data_ptr(),
            b, h, w, c, oh, ow, k, s, int(z.dtype == torch.bfloat16), int(relu), int(blocked),
            n, alpha, beta, quarter_power(beta), torch.cuda.current_stream(z.device).cuda_stream,
        )
    _build.check(rc, "pool_lrn_fwd")
    LAUNCHES += 1
    return m


def pool_lrn_bwd(
    g: torch.Tensor,
    m: torch.Tensor,
    z: torch.Tensor,
    n: int,
    alpha: float,
    beta: float,
    k: int,
    s: int,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    blocked: bool = False,
):
    """Gradient of `pool_lrn_fwd` with respect to z, given the cotangent g
    of m = pool_lrn_fwd(z, ...): g, m (B, OH, OW, C) and z (B, H, W, C),
    contiguous, one dtype. Returns (dz, db): dz in z's dtype; db, when a
    bias is given, the f32 column sum of the f32 dz (per-block partial
    sums added in a fixed order, no atomics), else None."""
    _check_shapes("pool_lrn_bwd", z, k, s, bias, g, m)
    if z.device.type == "cpu":
        return _bwd_reference(g, m, z, n, alpha, beta, k, s, bias, relu, blocked)
    for name, t in (("g", g), ("m", m)):
        if t.dtype != z.dtype or t.device != z.device or not t.is_contiguous():
            raise TypeError(f"pool_lrn_bwd: {name} must be contiguous, with z's dtype and device")
    _check_kernel_args("pool_lrn_bwd", (z,), bias)
    b, h, w, c = z.shape
    oh, ow = m.shape[1], m.shape[2]
    dz = torch.empty_like(z)
    db = partial = None
    if bias is not None:
        db = torch.empty((c,), dtype=torch.float32, device=z.device)
        partial = torch.empty((_BWD_MAX_BLOCKS, c), dtype=torch.float32, device=z.device)
    if z.numel() == 0:
        return dz, db
    from convnet_tpu_torch.ops import _build

    global BWD_LAUNCHES
    with torch.cuda.device(z.device):
        rc = _build.library().cn_pool_lrn_bwd(
            g.data_ptr(), m.data_ptr(), z.data_ptr(),
            None if bias is None else bias.data_ptr(), dz.data_ptr(),
            None if db is None else db.data_ptr(),
            None if partial is None else partial.data_ptr(),
            _BWD_MAX_BLOCKS, b, h, w, c, oh, ow, k, s, int(z.dtype == torch.bfloat16),
            int(relu), int(blocked), n, alpha, beta, 2.0 * alpha * beta, quarter_power(beta),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _build.check(rc, "pool_lrn_bwd")
    BWD_LAUNCHES += 1
    return dz, db


class _LRNMaxPool(torch.autograd.Function):
    """lrn_maxpool over (B, H, W, C) z, the bias optional: residuals z (and
    b) and m; the backward kernel recomputes y."""

    @staticmethod
    def forward(ctx, z, b, conf):
        n, alpha, beta, k, s, relu, blocked = conf
        m = pool_lrn_fwd(z, n, alpha, beta, k, s, bias=b, relu=relu, blocked=blocked)
        ctx.save_for_backward(z, b, m)
        ctx.conf = conf
        return m

    @staticmethod
    def backward(ctx, g):
        z, b, m = ctx.saved_tensors
        n, alpha, beta, k, s, relu, blocked = ctx.conf
        # the cotangent enters the kernel in z's dtype (fused_pool_lrn.py:283)
        dz, db = pool_lrn_bwd(
            g.to(z.dtype).contiguous(), m, z, n, alpha, beta, k, s,
            bias=b, relu=relu, blocked=blocked,
        )
        return dz, db, None


def lrn_maxpool_bias(
    x: torch.Tensor,
    b: Optional[torch.Tensor],
    add_scale: float,
    pow_scale: float,
    frac_of_filters: float,
    blocked: bool,
    pool_kernel: int,
    pool_stride: int,
    pool_padding: int = 0,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """maxpool(response_norm_cross_map(x + b)) with the reference's pool
    gradient: x (B, H, W, C) is the producing conv's output without its
    (C,) bias b, which both kernels add in f32 (None: no bias); fuse_relu
    treats x + b as the pre-activation. The gradient reaches b only
    through the backward kernel's db."""
    if not fusion_applicable(x.shape, pool_padding):
        raise ValueError(
            f"lrn_maxpool fuses 4-D inputs with pool padding 0, got shape "
            f"{tuple(x.shape)} and padding {pool_padding}"
        )
    c = x.shape[-1]
    n = norm_window_size(c, frac_of_filters)
    conf = (n, add_scale / n, float(pow_scale), pool_kernel, pool_stride, fuse_relu, blocked)
    if b is not None:
        b = b.to(device=x.device, dtype=torch.float32).contiguous()
    return _LRNMaxPool.apply(x.contiguous(), b, conf)


def lrn_maxpool(
    x: torch.Tensor,
    add_scale: float,
    pow_scale: float,
    frac_of_filters: float,
    blocked: bool,
    pool_kernel: int,
    pool_stride: int,
    pool_padding: int = 0,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """maxpool(response_norm_cross_map(x)) with the reference's pool
    gradient (ties credit every winner)."""
    return lrn_maxpool_bias(
        x, None, add_scale, pow_scale, frac_of_filters, blocked,
        pool_kernel, pool_stride, pool_padding, fuse_relu,
    )
