"""Jitter spec, crop sampling and the crop for inputs the space-to-depth
prologue does not take (counterpart of `convnet_tpu/data/jitter.py`).

The JAX package's `JitterSpec` cannot be imported without JAX (its module
imports jax), so the port has its own, with the same fields. Random crop
origins and flips are drawn on the device from the (seed, step) tensor
that the device holds, by the port's Philox (`ops.dropout.step_draws`,
keyed by the field's crc32), so a replayed CUDA graph of a train step
draws new crops at every step; the draws are not the JAX package's
(threefry), so parity tests inject them. The TPU's one-hot crop
contractions are not ported: an index gather selects the same pixels.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from convnet_tpu_torch.ops.dropout import CropDraw, step_draws

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


def crop_draw(field: str, b: int, h: int, w: int, s: int, can_translate: bool,
              can_flip: bool, row0: int = 0) -> Optional[CropDraw]:
    """The draw of one field's crops (None when there is nothing to draw):
    origins uniform over [0, H - S] x [0, W - S] when translating, else the
    center crop; flips when can_flip; for rows row0 .. row0 + b - 1 of the
    global batch. The key's counter word is crc32 of the field's name, the
    same in every process (hash() is salted)."""
    if not (can_translate or can_flip):
        return None
    cy, cx = center_offsets(h, w, s)
    ry, rx = (h - s + 1, w - s + 1) if can_translate else (1, 1)
    return CropDraw(zlib.crc32(field.encode()), 1, b, 0 if can_translate else cy, ry,
                    0 if can_translate else cx, rx, can_flip, row0)


def sample_crop_flip(
    rng: torch.Tensor, field: str, b: int, h: int, w: int, s: int, can_translate: bool,
    can_flip: bool,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Per-image crop origins and flips of one field at one step, drawn on
    rng's device from rng = int64 (seed, step): (oy, ox, flips), int32
    (B,), int32 (B,), bool (B,) or None without flips; all None when
    nothing is drawn."""
    draw = crop_draw(field, b, h, w, s, can_translate, can_flip)
    if draw is None:
        return None, None, None
    return step_draws(rng, (), draw)[1]


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
    crop: Optional[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]] = None,
) -> torch.Tensor:
    """x (B, H, W, C) uint8 or float -> f32 (B, S, S, C), S =
    spec.image_size, cropped, then x*scale, -mean, /std.

    crop: (oy, ox, flips) of a train step (`sample_crop_flip`); None takes
    the eval center crop. mean/std broadcast against the crop (scalar,
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
    if crop is not None:
        x = crop_flip(x, s, *crop)
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
