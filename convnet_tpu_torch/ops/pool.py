"""Max pooling (counterpart of `convnet_tpu/ops/pool.py`'s XLA path).

Ceil-mode output size with -inf padding, written as an explicit pad and
a plain `F.max_pool2d` rather than torch's own `ceil_mode`, whose rule for
the last window is not cuda-convnet's (`convnet_tpu.graph.conv_out_size`).
The gradient is ATen's max-pool backward through the pad, one winner per
window, as XLA's select-and-scatter credits one (pool.py:17-21).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convnet_tpu_torch.ops.conv import ceil_mode_padding


def maxpool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> NHWC, contiguous."""
    plo_h, phi_h = ceil_mode_padding(x.shape[1], kernel, stride, padding)
    plo_w, phi_w = ceil_mode_padding(x.shape[2], kernel, stride, padding)
    xt = x.permute(0, 3, 1, 2)  # channels_last NCHW view
    if plo_h or phi_h or plo_w or phi_w:
        xt = F.pad(xt, (plo_w, phi_w, plo_h, phi_h), value=float("-inf"))
    y = F.max_pool2d(xt, kernel, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()
