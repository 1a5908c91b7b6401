"""Max pooling (counterpart of `convnet_tpu/ops/pool.py`).

Ceil-mode output size with -inf padding, cuda-convnet's rule for the last
window (`convnet_tpu_torch.graph.conv_out_size`), which is not torch's own
`ceil_mode`. The gradient credits each window's one winner, as XLA's
select-and-scatter does (pool.py:173-181) and ATen's max-pool backward.

`maxpool2d` dispatches on the tensor's device:

- a CUDA tensor takes the kernels: `csrc/maxpool_fwd.cu` (wrapper
  `maxpool_fwd`), which replaces the TPU kernel `_maxpool_kernel`
  (pool.py:87) for any geometry, and where autograd will want the gradient
  also writes each output value's argmax as its window tap ("taps": one
  byte a value); the backward `csrc/maxpool_bwd.cu` (wrapper `maxpool_bwd`)
  reads dy and the taps and writes dx once, ATen's bits;
- a CPU tensor takes `maxpool_reference`: an explicit -inf pad and ATen's
  `F.max_pool2d`, differentiated by autograd.

The kernels' plain versions, `maxpool_argmax_reference` and
`maxpool_bwd_reference`, repeat their scan and their sums in PyTorch: the
tests hold them to `F.max_pool2d`'s autograd on the CPU and the kernels to
ATen on the card.

`maxpool2d_undo_reference` is upstream cuda-convnet's MaxPoolUndo, where
every tie is credited (pool.py:213-258): the gradient of the fused
LRN -> pool path (ops/fused_pool_lrn.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from convnet_tpu_torch.graph import conv_out_size
from convnet_tpu_torch.ops.conv import ceil_mode_padding

#: Launches of the CUDA kernels in this process (CPU calls do not count):
#: the forward, with or without taps, and the backward.
LAUNCHES = 0
BWD_LAUNCHES = 0


def maxpool_reference(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """The CPU's pool and the kernel's yardstick (any device).
    x: (B, H, W, C) NHWC -> NHWC, contiguous."""
    plo_h, phi_h = ceil_mode_padding(x.shape[1], kernel, stride, padding)
    plo_w, phi_w = ceil_mode_padding(x.shape[2], kernel, stride, padding)
    xt = x.permute(0, 3, 1, 2)  # channels_last NCHW view
    if plo_h or phi_h or plo_w or phi_w:
        xt = F.pad(xt, (plo_w, phi_w, plo_h, phi_h), value=float("-inf"))
    y = F.max_pool2d(xt, kernel, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def taps_dtype(kernel: int) -> torch.dtype:
    """The taps' dtype: one byte where a window's k * k taps fit in it."""
    return torch.uint8 if kernel * kernel <= 256 else torch.int32


def _padded(h: int, w: int, kernel: int, stride: int, padding: int):
    """((lo, hi) rows, (lo, hi) columns, output rows, output columns)."""
    return (ceil_mode_padding(h, kernel, stride, padding),
            ceil_mode_padding(w, kernel, stride, padding),
            conv_out_size(h, kernel, stride, padding), conv_out_size(w, kernel, stride, padding))


def maxpool_argmax_reference(x: torch.Tensor, kernel: int, stride: int,
                             padding: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version with taps: (y, taps), y as
    `maxpool_reference` gives it and taps (B, OH, OW, C) in `taps_dtype`,
    each value's window tap i * k + j (padding counted). ATen's scan: from
    -inf at tap 0, a tap replaces the max where it is larger or a NaN, so
    the first of equal maxima and the last NaN win."""
    b, h, w, c = x.shape
    (plo_h, phi_h), (plo_w, phi_w), oh, ow = _padded(h, w, kernel, stride, padding)
    xp = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h), value=float("-inf"))
    m = torch.full((b, oh, ow, c), float("-inf"), dtype=x.dtype, device=x.device)
    taps = torch.zeros((b, oh, ow, c), dtype=taps_dtype(kernel), device=x.device)
    for i in range(kernel):
        for j in range(kernel):
            v = xp[:, i:i + stride * (oh - 1) + 1:stride, j:j + stride * (ow - 1) + 1:stride]
            take = (v > m) | v.isnan()
            m = torch.where(take, v, m)
            taps = taps.masked_fill(take, i * kernel + j)
    return m, taps


def maxpool_bwd_reference(dy: torch.Tensor, taps: torch.Tensor, h: int, w: int, kernel: int,
                          stride: int, padding: int = 0) -> torch.Tensor:
    """The backward kernel's plain version: dx (B, h, w, C) in dy's dtype
    from dy and the taps, summed as ATen's NHWC max-pool backward sums: in
    f32 from +0, the windows over a position in order of output row, then
    column, rounded once; where one window alone covers a position, dy's
    bits where it won and +0 elsewhere."""
    b, oh, ow, c = dy.shape
    (plo_h, phi_h), (plo_w, phi_w), _, _ = _padded(h, w, kernel, stride, padding)
    shape = (b, h + plo_h + phi_h, w + plo_w + phi_w, c)
    acc = torch.zeros(shape, dtype=torch.float32, device=dy.device)
    one = torch.zeros(shape, dtype=dy.dtype, device=dy.device)
    dyf = dy.float()
    # window rows ascend at a position as its tap row i descends
    for i in reversed(range(kernel)):
        for j in reversed(range(kernel)):
            rows = slice(i, i + stride * (oh - 1) + 1, stride)
            cols = slice(j, j + stride * (ow - 1) + 1, stride)
            hit = taps == i * kernel + j
            acc[:, rows, cols] += torch.where(hit, dyf, 0.0)
            one[:, rows, cols] = torch.where(hit, dy, one[:, rows, cols])

    def windows(n, count):
        """How many of `count` windows cover each of n padded rows (or
        columns)."""
        at = torch.arange(n, device=dy.device)[:, None] - stride * torch.arange(count,
                                                                                device=dy.device)
        return ((at >= 0) & (at < kernel)).sum(1)

    single = ((windows(shape[1], oh) == 1)[:, None] & (windows(shape[2], ow) == 1)[None, :])
    dx = torch.where(single[None, :, :, None], one, acc.to(dy.dtype))
    return dx[:, plo_h:plo_h + h, plo_w:plo_w + w].contiguous()


def _check(t: torch.Tensor, name: str, arg: str) -> None:
    """Raise unless t is a contiguous bf16 or f32 CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {t.dtype} (bf16 or f32 only)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def maxpool_fwd(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
                taps: bool = False):
    """The forward kernel's wrapper, no autograd: x (B, H, W, C) contiguous
    bf16 or f32 -> y, or (y, taps) with `taps`. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if x.dim() != 4:
        raise ValueError(f"maxpool_fwd takes (B, H, W, C), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        if taps:
            return maxpool_argmax_reference(x, kernel, stride, padding)
        return maxpool_reference(x, kernel, stride, padding)
    _check(x, "maxpool_fwd", "x")
    b, h, w, c = x.shape
    oh = conv_out_size(h, kernel, stride, padding)
    ow = conv_out_size(w, kernel, stride, padding)
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    t = torch.empty(y.shape, dtype=taps_dtype(kernel), device=x.device) if taps else None
    if y.numel():
        from convnet_tpu_torch.ops import _build

        global LAUNCHES
        with torch.cuda.device(x.device):
            rc = _build.library().cn_maxpool_fwd(
                x.data_ptr(), y.data_ptr(), None if t is None else t.data_ptr(), b, h, w, c, oh,
                ow, kernel, stride, padding, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        _build.check(rc, "maxpool_fwd")
        LAUNCHES += 1
    return (y, t) if taps else y


def maxpool_bwd(dy: torch.Tensor, taps: torch.Tensor, h: int, w: int, kernel: int, stride: int,
                padding: int = 0) -> torch.Tensor:
    """The backward kernel's wrapper: dx (B, h, w, C) from dy (B, OH, OW, C)
    contiguous bf16 or f32 and the forward's taps. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if dy.dim() != 4:
        raise ValueError(f"maxpool_bwd takes (B, OH, OW, C), got shape {tuple(dy.shape)}")
    if dy.device.type == "cpu":
        return maxpool_bwd_reference(dy, taps, h, w, kernel, stride, padding)
    _check(dy, "maxpool_bwd", "dy")
    b, oh, ow, c = dy.shape
    if (oh, ow) != (conv_out_size(h, kernel, stride, padding),
                    conv_out_size(w, kernel, stride, padding)):
        raise ValueError(f"maxpool_bwd: dy {tuple(dy.shape)} is no pool of {h}x{w}")
    if (taps.shape != dy.shape or taps.dtype != taps_dtype(kernel) or taps.device != dy.device
            or not taps.is_contiguous()):
        raise ValueError(f"maxpool_bwd: taps {tuple(taps.shape)} {taps.dtype} do not fit dy")
    dx = torch.empty((b, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel():
        from convnet_tpu_torch.ops import _build

        global BWD_LAUNCHES
        with torch.cuda.device(dy.device):
            rc = _build.library().cn_maxpool_bwd(
                dy.data_ptr(), taps.data_ptr(), dx.data_ptr(), b, h, w, c, oh, ow, kernel, stride,
                padding, int(dy.dtype == torch.bfloat16),
                torch.cuda.current_stream(dy.device).cuda_stream,
            )
        _build.check(rc, "maxpool_bwd")
        BWD_LAUNCHES += 1
    return dx


class _MaxPool(torch.autograd.Function):
    """The forward kernel with taps; the backward kernel from dy and the
    taps alone (x is not kept)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y, taps = maxpool_fwd(x.contiguous(), kernel, stride, padding, taps=True)
        ctx.save_for_backward(taps)
        ctx.conf = (x.shape[1], x.shape[2], kernel, stride, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        (taps,) = ctx.saved_tensors
        return maxpool_bwd(g.contiguous(), taps, *ctx.conf), None, None, None


def maxpool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> NHWC, contiguous; ceil-mode output size. On
    the card the kernels (with taps only where autograd will want the
    gradient), on the CPU `maxpool_reference`."""
    if x.device.type == "cpu":
        return maxpool_reference(x, kernel, stride, padding)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool.apply(x, kernel, stride, padding)
    return maxpool_fwd(x.contiguous(), kernel, stride, padding)


def maxpool2d_undo_reference(
    x: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,
    kernel: int,
    stride: int,
    padding: int = 0,
) -> torch.Tensor:
    """cuda-convnet's MaxPoolUndo (`convnet_tpu/ops/pool.py:213-258`): every
    input position EQUAL to its window's max receives that window's
    cotangent, so ties credit every winner. x: the pool input (B, H, W, C);
    y = the pool of x; g: the cotangent of y. Returns dx in x's dtype,
    summed in f32 (pass f32 tensors to keep the f32 sum)."""
    b, h, w, c = x.shape
    pad_h = ceil_mode_padding(h, kernel, stride, padding)
    pad_w = ceil_mode_padding(w, kernel, stride, padding)
    oh, ow = y.shape[1], y.shape[2]
    dev = x.device
    xf, yf, gf = x.float(), y.float(), g.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    for ki in range(kernel):
        ii = ki - pad_h[0] + stride * torch.arange(oh, device=dev)
        vi = (ii >= 0) & (ii < h)
        ic = ii.clamp(0, h - 1)
        for kj in range(kernel):
            # the input positions tap (ki, kj) of each window covers
            jj = kj - pad_w[0] + stride * torch.arange(ow, device=dev)
            vj = (jj >= 0) & (jj < w)
            jc = jj.clamp(0, w - 1)
            valid = (vi[:, None] & vj[None, :])[None, :, :, None]
            patch = xf[:, ic[:, None], jc[None, :], :]  # (B, oh, ow, C)
            hit = (patch == yf) & valid
            contrib = torch.where(hit, gf, torch.zeros((), device=dev))
            # accumulate: clamped invalid taps repeat an edge position
            dx.index_put_((bi, ic[None, :, None], jc[None, None, :]), contrib, accumulate=True)
    return dx.to(x.dtype)


def avgpool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Average pooling (DOWNSAMPLE edges, `convnet_tpu/ops/pool.py:198-210`;
    AVGPOOL edges, whose windows are whole): x (B, H, W, C) NHWC
    zero-padded by the ceil-mode padding, each window summed and divided
    by kernel^2, padded taps included. The pad is explicit because
    F.avg_pool2d's own padding is symmetric; ATen's pool reads the NHWC
    tensor as a channels-last NCHW view."""
    plo_h, phi_h = ceil_mode_padding(x.shape[1], kernel, stride, padding)
    plo_w, phi_w = ceil_mode_padding(x.shape[2], kernel, stride, padding)
    if plo_h or phi_h or plo_w or phi_w:
        x = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h))
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()
