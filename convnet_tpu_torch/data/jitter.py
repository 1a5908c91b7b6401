"""Jitter spec, crop sampling and the crop for inputs the space-to-depth
prologue does not take (counterpart of `convnet_tpu/data/jitter.py`).

The JAX package's `JitterSpec` cannot be imported without JAX (its module
imports jax), so the port has its own, with the same fields. Random crop
origins and flips come from a `torch.Generator` the caller seeds; the
draws are not the JAX package's (threefry), so parity tests inject them.
The TPU's one-hot crop contractions are not ported: an index gather
selects the same pixels.
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


def sample_crop_flip(
    gen: torch.Generator, b: int, h: int, w: int, s: int, can_translate: bool, can_flip: bool
):
    """Per-image crop origins and flips drawn from `gen`, on its device:
    (oy, ox, flips), int32 (B,), int32 (B,), bool (B,), each None when
    not drawn (no translation possible or wanted; no flips)."""
    dev = gen.device
    flips = None
    if can_flip:
        flips = torch.rand((b,), generator=gen, device=dev) < 0.5
    oy = ox = None
    if can_translate and (h > s or w > s):
        oy = torch.randint(0, h - s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        ox = torch.randint(0, w - s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    return oy, ox, flips


def crop_flip(x: torch.Tensor, s: int, oy: torch.Tensor, ox: torch.Tensor, flips) -> torch.Tensor:
    """Per-image s x s crops at (oy, ox), mirrored where flips: the same
    pixels as the reference's one-hot contractions select."""
    b = x.shape[0]
    ii = torch.arange(s, device=x.device)
    rows = oy.long()[:, None] + ii  # (B, S)
    cols = ii.expand(b, s)
    if flips is not None:
        cols = torch.where(flips.bool()[:, None], s - 1 - cols, cols)
    cols = ox.long()[:, None] + cols
    bi = torch.arange(b, device=x.device)[:, None, None]
    return x[bi, rows[:, :, None], cols[:, None, :]]


def jitter_batch(
    x: torch.Tensor,
    spec: JitterSpec,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
    *,
    train: bool = False,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """x (B, H, W, C) uint8 or float -> f32 (B, S, S, C), S =
    spec.image_size, cropped, then x*scale, -mean, /std.

    Eval: the center crop. Train: a random crop origin (can_translate)
    and a random horizontal flip (can_flip) per image, drawn from `gen`
    (on x's device) by `sample_crop_flip`. mean/std broadcast against the crop (scalar,
    (C,) or (S, S, C)); a raw-size (H, W, C) mean or std applies before
    the crop, as in the reference."""
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
    if train and (spec.can_flip or spec.can_translate) and gen is None:
        raise ValueError("train jitter needs a generator")
    oy, ox, flips = (
        sample_crop_flip(gen, b, h, w, s, spec.can_translate, spec.can_flip)
        if train
        else (None, None, None)
    )
    if oy is None and flips is not None:
        cy, cx = center_offsets(h, w, s)
        oy = torch.full((b,), cy, dtype=torch.int32, device=x.device)
        ox = torch.full((b,), cx, dtype=torch.int32, device=x.device)
    if oy is not None:
        x = crop_flip(x, s, oy, ox, flips)
    elif h > s or w > s:
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
