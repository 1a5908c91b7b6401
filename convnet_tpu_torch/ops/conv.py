"""Convolution and fully connected edges.

Counterpart of `convnet_tpu/ops/conv.py`. The contraction runs in cuDNN
(`F.conv2d`) and cuBLAS (`torch.matmul`), as the JAX package left it to
XLA. Activations are NHWC at this boundary; their NCHW views are
channels_last tensors, so cuDNN reads and writes the NHWC bytes in place.
Weights are HWIO.

Precision: in bf16 mode the operands are bf16, accumulation is f32 and the
output is bf16 (`conv.py:345-352`). In f32 mode cuDNN's TF32 is turned
off for the forward and for both gradients (`_ExactF32Conv`), as the JAX
package runs f32 at Precision.HIGHEST in both directions. The gradients
otherwise come from autograd, as the JAX package left them to XLA.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from convnet_tpu_torch.graph import conv_out_size


@dataclass
class S2DInput:
    """A batch already in space-to-depth form (B, H/s, W/s, s*s*Cin),
    channel order (row-phase, col-phase, cin), made by the input prologue
    (ops/s2d_relayout.py) so the strided first conv runs as a stride-1
    conv over it."""

    x: torch.Tensor
    stride: int


def ceil_mode_padding(
    in_size: int, kernel: int, stride: int, padding: int
) -> Tuple[int, int]:
    """Asymmetric (lo, hi) padding of the cuda-convnet ceil convention:
    the last window may hang off the padded input and is completed with
    extra high-side padding."""
    out = conv_out_size(in_size, kernel, stride, padding)
    hi = (out - 1) * stride + kernel - in_size - padding
    return (padding, max(hi, 0))


def s2d_regroup_weight(w: torch.Tensor, s: int) -> torch.Tensor:
    """(kh, kw, cin, cout) -> the stride-1 kernel over the space-to-depth
    view, (kh'/s, kw'/s, s*s*cin, cout) with kh' = kh rounded up to a
    multiple of s; channel order (row-phase, col-phase, cin)."""
    kh, kw, cin, cout = w.shape
    khp, kwp = -(-kh // s) * s, -(-kw // s) * s
    w = F.pad(w, (0, 0, 0, 0, 0, kwp - kw, 0, khp - kh))
    return (
        w.reshape(khp // s, s, kwp // s, s, cin, cout)
        .permute(0, 2, 1, 3, 4, 5)
        .reshape(khp // s, kwp // s, s * s * cin, cout)
    )


@contextlib.contextmanager
def _exact_f32():
    """Turn cuDNN's TF32 off for an f32 conv (the reference's HIGHEST)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class _ExactF32Conv(torch.autograd.Function):
    """An f32 conv whose forward and both gradients run with TF32 off:
    autograd would run dgrad and wgrad after `_exact_f32` has restored
    cuDNN's default (TF32 on)."""

    @staticmethod
    def forward(ctx, xt, wt, stride, padding, groups):
        ctx.save_for_backward(xt, wt)
        ctx.conf = (stride, padding, groups)
        with _exact_f32():
            return F.conv2d(xt, wt, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        xt, wt = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        with _exact_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                gy, xt, wt, None, _pair(stride), _pair(padding), (1, 1), False, (0, 0),
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
            )
        return dx, dw, None, None, None


def _cast(x: torch.Tensor, w: torch.Tensor, compute_dtype):
    if compute_dtype is not None:
        return x.to(compute_dtype), w.to(compute_dtype)
    # f32-or-wider, as the reference's promote_types(x.dtype, float32)
    dt = torch.promote_types(x.dtype, torch.float32)
    return x.to(dt), w.to(dt)


def conv2d(
    x,
    w: torch.Tensor,
    stride: int,
    padding: int,
    compute_dtype=None,
    groups: int = 1,
) -> torch.Tensor:
    """Forward convolution with ceil-mode output size.

    x: (B, H, W, Cin) NHWC, or an S2DInput built for this edge's stride;
    w: (kh, kw, Cin/groups, Cout) HWIO. Returns NHWC, contiguous, in
    compute_dtype when it is set."""
    if isinstance(x, S2DInput):
        if groups > 1:
            raise ValueError(
                "grouped conv cannot consume an S2D input (the s2d fold "
                "interleaves all input channels)"
            )
        if x.stride != stride:
            raise ValueError(f"S2D input built for stride {x.stride}, edge has {stride}")
        w = s2d_regroup_weight(w, stride)
        x, stride, pads = x.x, 1, ((0, 0), (0, 0))
    else:
        kh, kw = w.shape[0], w.shape[1]
        if x.shape[3] != w.shape[2] * groups:
            raise ValueError(
                f"conv: input has {x.shape[3]} channels but the weight expects "
                f"{w.shape[2]}*{groups}"
            )
        pads = (
            ceil_mode_padding(x.shape[1], kh, stride, padding),
            ceil_mode_padding(x.shape[2], kw, stride, padding),
        )
    x, w = _cast(x, w, compute_dtype)
    xt = x.permute(0, 3, 1, 2)  # NCHW view of NHWC bytes: channels_last
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    (plo_h, phi_h), (plo_w, phi_w) = pads
    if plo_h == phi_h and plo_w == phi_w:
        pad_arg = (plo_h, plo_w)
    else:
        xt = F.pad(xt, (plo_w, phi_w, plo_h, phi_h))
        pad_arg = 0
    if x.dtype == torch.float32:
        y = _ExactF32Conv.apply(xt, wt, stride, pad_arg, groups)
    else:
        y = F.conv2d(xt, wt, stride=stride, padding=pad_arg, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def fc(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Fully connected edge. x: (B, H, W, C) NHWC, flattened in H*W*C
    order (the checkpoint's order, `convnet_tpu/ops/conv.py:400`);
    w: (H*W*C, units). Returns (B, units) in compute_dtype when set."""
    xf = x.reshape(x.shape[0], -1)
    xf, w = _cast(xf, w, compute_dtype)
    return torch.matmul(xf, w)


def conv_onetoone(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """1x1 channel-mixing edge (CONV_ONETOONE, `convnet_tpu/ops/conv.py:
    382-397`): x (B, H, W, Cin) NHWC times w (Cin, Cout) over the channel
    axis. Returns NHWC in compute_dtype when it is set."""
    x, w = _cast(x, w, compute_dtype)
    return torch.matmul(x, w)
