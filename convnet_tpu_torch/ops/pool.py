"""Max pooling (counterpart of `convnet_tpu/ops/pool.py`).

Ceil-mode output size with -inf padding, cuda-convnet's rule for the last
window (`convnet_tpu_torch.graph.conv_out_size`), which is not torch's own
`ceil_mode`. Two forwards, chosen as the JAX package chooses
(`pool.py:52-60`, CONVNET_POOL_BACKEND):

- by default `maxpool_reference`: an explicit -inf pad and ATen's
  `F.max_pool2d`, differentiated by autograd (ATen's max-pool backward:
  one winner per window, as XLA's select-and-scatter credits one);
- with CONVNET_POOL_BACKEND=pallas, the CUDA kernel `csrc/maxpool_fwd.cu`
  (wrapper `maxpool_fwd`), which replaces the TPU kernel `_maxpool_kernel`
  (pool.py:87). Its gradient is still the single-winner one, rederived from
  x in the backward, as the JAX package pairs its Pallas forward with
  select-and-scatter (pool.py:173-181). The TPU's layout gates
  (`_pool_form`) are not ported: the kernel takes every geometry.

`maxpool2d_undo_reference` is upstream cuda-convnet's MaxPoolUndo, where
every tie is credited (pool.py:213-258): the gradient of the fused
LRN -> pool path (ops/fused_pool_lrn.py).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from convnet_tpu_torch.graph import conv_out_size
from convnet_tpu_torch.ops.conv import ceil_mode_padding

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def pool_kernel_wanted() -> bool:
    """CONVNET_POOL_BACKEND: "pallas" takes the kernel; "auto" and "xla"
    the default ATen path (the JAX package's switch and meaning)."""
    return os.environ.get("CONVNET_POOL_BACKEND", "auto") == "pallas"


def maxpool_reference(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """The kernel's plain version (any device), and the default forward.
    x: (B, H, W, C) NHWC -> NHWC, contiguous."""
    plo_h, phi_h = ceil_mode_padding(x.shape[1], kernel, stride, padding)
    plo_w, phi_w = ceil_mode_padding(x.shape[2], kernel, stride, padding)
    xt = x.permute(0, 3, 1, 2)  # channels_last NCHW view
    if plo_h or phi_h or plo_w or phi_w:
        xt = F.pad(xt, (plo_w, phi_w, plo_h, phi_h), value=float("-inf"))
    y = F.max_pool2d(xt, kernel, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def maxpool_fwd(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """The max pool kernel's wrapper, no autograd: x (B, H, W, C)
    contiguous bf16 or f32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.dim() != 4:
        raise ValueError(f"maxpool_fwd takes (B, H, W, C), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return maxpool_reference(x, kernel, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_fwd: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"maxpool_fwd: dtype {x.dtype} (bf16 or f32 only)")
    if not x.is_contiguous():
        raise ValueError("maxpool_fwd: x must be contiguous")
    b, h, w, c = x.shape
    oh = conv_out_size(h, kernel, stride, padding)
    ow = conv_out_size(w, kernel, stride, padding)
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_maxpool_fwd(
            x.data_ptr(), y.data_ptr(), b, h, w, c, oh, ow, kernel, stride, padding,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "maxpool_fwd")
    LAUNCHES += 1
    return y


class _MaxPool(torch.autograd.Function):
    """The kernel's forward; the backward is ATen's single-winner max-pool
    gradient, rederived from the residual x alone."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.save_for_backward(x)
        ctx.conf = (kernel, stride, padding)
        return maxpool_fwd(x.contiguous(), kernel, stride, padding)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(maxpool_reference(xx, *ctx.conf), xx, g)
        return dx, None, None, None


def maxpool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> NHWC, contiguous; ceil-mode output size."""
    if pool_kernel_wanted():
        return _MaxPool.apply(x, kernel, stride, padding)
    return maxpool_reference(x, kernel, stride, padding)


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
    """Average pooling (DOWNSAMPLE edges, `convnet_tpu/ops/pool.py:198-210`):
    x (B, H, W, C) NHWC zero-padded by the ceil-mode padding, each window
    summed and divided by kernel^2, padded taps included. The pad is
    explicit because F.avg_pool2d's own padding is symmetric."""
    plo_h, phi_h = ceil_mode_padding(x.shape[1], kernel, stride, padding)
    plo_w, phi_w = ceil_mode_padding(x.shape[2], kernel, stride, padding)
    xt = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h)).permute(0, 3, 1, 2)
    y = F.avg_pool2d(xt, kernel, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()
