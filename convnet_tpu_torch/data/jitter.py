"""Jitter spec and the eval crop (counterpart of `convnet_tpu/data/jitter.py`).

The JAX package's `JitterSpec` cannot be imported without JAX (its module
imports jax), so the port has its own, with the same fields. Only the eval
branch of `jitter_batch` is ported: a center crop and the scale/mean/std
affine, for inputs the space-to-depth prologue does not take. Random
crops and flips come with the train step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class JitterSpec:
    """Static per-stream augmentation spec."""

    image_size: int
    can_translate: bool = False
    can_flip: bool = False
    scale: float = 1.0
    normalize: bool = False

    def __post_init__(self):
        if self.image_size <= 0:
            raise ValueError("image_size must be positive")


def center_offsets(h: int, w: int, crop: int):
    """(oy, ox) of the eval center crop."""
    return (h - crop) // 2, (w - crop) // 2


def jitter_batch(
    x: torch.Tensor,
    spec: JitterSpec,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Eval jitter: x (B, H, W, C) uint8 or float -> f32 (B, S, S, C),
    S = spec.image_size, center-cropped, then x*scale, -mean, /std.

    mean/std broadcast against the crop (scalar, (C,) or (S, S, C)); a
    raw-size (H, W, C) mean or std applies before the crop, as in the
    reference."""
    b, h, w, c = x.shape
    s = spec.image_size
    if h < s or w < s:
        raise ValueError(f"raw image {h}x{w} smaller than crop {s}")
    raw_mean = mean is not None and mean.dim() >= 2 and mean.shape[-3] == h
    raw_std = std is not None and std.dim() >= 2 and std.shape[-3] == h
    if raw_mean or raw_std:
        x = x.float()
        if spec.scale != 1.0:
            x = x * spec.scale
        if raw_mean:
            x = x - mean.float()
            mean = None
        if mean is None and raw_std:
            x = x / std.float()
            std = None
    if h > s or w > s:
        cy, cx = center_offsets(h, w, s)
        x = x[:, cy : cy + s, cx : cx + s, :]
    x = x.float()
    if spec.scale != 1.0 and not (raw_mean or raw_std):
        x = x * spec.scale
    if mean is not None:
        x = x - mean.float()
    if std is not None:
        x = x / std.float()
    return x
