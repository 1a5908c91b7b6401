"""Resampling and colour-space edges (counterpart of
`convnet_tpu/ops/resample.py`): UPSAMPLE replicates each pixel factor^2
times, DOWNSAMPLE averages factor x factor blocks, RGBTOYUV maps RGB to
YUV by the ITU-R BT.601 matrix. All take and return NHWC tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from convnet_tpu_torch.ops.pool import avgpool2d


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour replication: (B, H, W, C) -> (B, H*f, W*f, C)."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Block average: (B, H, W, C) -> (B, H/f, W/f, C)."""
    return avgpool2d(x, kernel=factor, stride=factor)


# ITU-R BT.601 full-range RGB -> YUV, [rgb, yuv] (the JAX package's matrix)
_RGB2YUV = np.array(
    [
        [0.299, -0.14713, 0.615],
        [0.587, -0.28886, -0.51499],
        [0.114, 0.436, -0.10001],
    ],
    dtype=np.float32,
)


def rgb_to_yuv(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB -> YUV, the math in f32, the result in x's dtype.
    The matrix enters as f32 scalars, so no host-to-device copy is made."""
    xf = x.float()
    m = _RGB2YUV.tolist()
    out = [xf[..., 0] * m[0][d] + xf[..., 1] * m[1][d] + xf[..., 2] * m[2][d] for d in range(3)]
    return torch.stack(out, dim=-1).to(x.dtype)
