"""Locally connected (untied-weight) edges (counterpart of
`convnet_tpu/ops/local.py`).

A LOCAL edge has convolution geometry but a filter of its own at every
output site: w is (out_h, out_w, k*k*Cin, Cout). Each site's patch is
ordered (Cin, kh, kw), channel slowest, as `lax.conv_general_dilated_local`
orders it and as checkpoints store it (docs/checkpoint_format.md).

The JAX package computes this outside any Pallas kernel, so the port does
it with library calls: one gather of the patches and one batched product
over the sites (`torch.bmm`, cuBLAS on the card), and in the backward two
batched products and the patches' adjoint as k*k strided adds. The
patches are kept as (sites, k*k*Cin, B), batch innermost, so the gather
and the adds move whole runs of B elements: in NHWC order the patch's
channel-slowest order would make every read a stride-Cin one. `_Local` is
an autograd Function so that the f32 path runs all three products with
TF32 off, as `_ExactF32Conv` does for the conv; its residual is the one
patch tensor.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from convnet_tpu_torch.graph import conv_out_size
from convnet_tpu_torch.ops.conv import _cast, ceil_mode_padding


def local_weight_shape(
    out_h: int, out_w: int, kernel: int, in_channels: int, out_channels: int
) -> Tuple[int, int, int, int]:
    return (out_h, out_w, kernel * kernel * in_channels, out_channels)


@contextlib.contextmanager
def _exact_f32_matmul():
    """Turn cuBLAS's TF32 off for an f32 product (the reference's HIGHEST)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _patches(x: torch.Tensor, kernel: int, stride: int, pads) -> torch.Tensor:
    """(B, H, W, C) -> (out_h*out_w, C*k*k, B): each site's patches as
    columns, in (C, kh, kw) order; one copy of x to (H, W, C, B), then one
    gather. ceil_mode_padding pads so that exactly out_h x out_w windows fit."""
    (plo_h, phi_h), (plo_w, phi_w) = pads
    xb = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h)).permute(1, 2, 3, 0).contiguous()
    v = xb.unfold(0, kernel, stride).unfold(1, kernel, stride)  # (oh, ow, C, B, kh, kw)
    oh, ow, c, b = v.shape[:4]
    return v.permute(0, 1, 2, 4, 5, 3).reshape(oh * ow, c * kernel * kernel, b)


class _Local(torch.autograd.Function):
    """y[b, site] = patch[site, :, b] @ w[site]; x and w already in the
    compute dtype. Returns (B, out_h, out_w, Cout), contiguous."""

    @staticmethod
    def forward(ctx, x, w, kernel, stride, pads):
        oh, ow, kkc, cout = w.shape
        p = _patches(x, kernel, stride, pads)
        ctx.save_for_backward(p, w)
        ctx.conf = (kernel, stride, pads, tuple(x.shape))
        with _exact_f32_matmul():
            y = torch.bmm(p.transpose(1, 2), w.view(oh * ow, kkc, cout))  # (sites, B, Cout)
        return y.view(oh, ow, -1, cout).permute(2, 0, 1, 3).contiguous()

    @staticmethod
    def backward(ctx, gy):
        p, w = ctx.saved_tensors
        kernel, stride, ((plo_h, phi_h), (plo_w, phi_w)), (b, h, wd, c) = ctx.conf
        oh, ow, kkc, cout = w.shape
        g = gy.to(w.dtype).permute(1, 2, 0, 3).reshape(oh * ow, b, cout)  # (sites, B, Cout)
        dx = dw = None
        with _exact_f32_matmul():
            if ctx.needs_input_grad[1]:
                dw = torch.bmm(p, g).view(w.shape)
            if ctx.needs_input_grad[0]:
                dp = torch.bmm(w.view(oh * ow, kkc, cout), g.transpose(1, 2))  # (sites, C*k*k, B)
        if ctx.needs_input_grad[0]:
            # the gather's adjoint: each of the k*k taps adds its slice of
            # the patches' gradient into the padded (H, W, C, B) image, in
            # f32 or wider, so a bf16 dx is rounded once, after the sum
            dpv = dp.view(oh, ow, c, kernel, kernel, b)
            acc = torch.zeros((h + plo_h + phi_h, wd + plo_w + phi_w, c, b),
                              dtype=torch.promote_types(dp.dtype, torch.float32), device=dp.device)
            span_h, span_w = stride * (oh - 1) + 1, stride * (ow - 1) + 1
            for i in range(kernel):
                for j in range(kernel):
                    acc[i : i + span_h : stride, j : j + span_w : stride] += dpv[:, :, :, i, j]
            dx = acc[plo_h : plo_h + h, plo_w : plo_w + wd].permute(3, 0, 1, 2)
            dx = dx.to(w.dtype).contiguous()
        return dx, dw, None, None, None


def local_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    padding: int,
    kernel: int,
    compute_dtype=None,
) -> torch.Tensor:
    """x: (B, H, W, Cin) NHWC; w: (out_h, out_w, kernel*kernel*Cin, Cout),
    one filter per output site. Ceil-mode output size, as conv2d. Returns
    NHWC in compute_dtype when it is set, else f32 or wider."""
    pads = (
        ceil_mode_padding(x.shape[1], kernel, stride, padding),
        ceil_mode_padding(x.shape[2], kernel, stride, padding),
    )
    oh = conv_out_size(x.shape[1], kernel, stride, padding)
    ow = conv_out_size(x.shape[2], kernel, stride, padding)
    if w.dim() != 4 or tuple(w.shape[:3]) != (oh, ow, kernel * kernel * x.shape[3]):
        raise ValueError(
            f"local edge: weight {tuple(w.shape)} does not fit input {tuple(x.shape)} "
            f"(expected ({oh}, {ow}, {kernel * kernel * x.shape[3]}, Cout))"
        )
    x, w = _cast(x, w, compute_dtype)
    return _Local.apply(x, w, kernel, stride, pads)
