"""The train step's random draws as the port makes them, frozen here so
that the reference draws the same dropout masks and crops without
importing the port: Philox4x32-10 keyed by the 64-bit seed, a step's
keys at counter (step, step >> 32, layer, 0), a field's crop key at
(step, step >> 32, crc32(field), 1), an image's crop bits at counter
(row, 0, 0, 0) under that key, and a dropout element's bits at counter
(element // 4, element >> 34, 0, 0), word element % 4.

If the port changes how it draws, the reference no longer follows it and
the check fails: the draws are part of what the port promises (a run
resumed from a checkpoint replays the same stream)."""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mul_hi_lo(a: int, c):
    """(hi, lo) words of a * c, a < 2^32, c an int64 tensor or int in
    [0, 2^32), from 16-bit halves so that no int64 product overflows."""
    p_lo = a * (c & 0xFFFF)
    p_hi = a * (c >> 16)
    low = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (low >> 32), low & _M32


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11): four counter words (ints or
    int64 tensors), two key words (ints or int64 tensors)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mul_hi_lo(_PHILOX_M[0], c0)
        hi1, lo1 = _mul_hi_lo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_key(seed: int) -> Tuple[int, int]:
    return seed & _M32, (seed >> 32) & _M32


def layer_key(seed: int, step: int, layer: int) -> Tuple[int, int]:
    """The dropout key of non-input layer number `layer` at `step`."""
    out = philox4x32((step & _M32, (step >> 32) & _M32, layer & _M32, 0), _seed_key(seed))
    return out[0], out[1]


def crops(seed: int, step: int, field: str, batch: int, raw: int, crop: int, device,
          translate: bool = True, flip: bool = True):
    """(oy, ox, flips) of each image of a train batch: origins uniform
    over [0, raw - crop] (or the centre), flips where the bit says so
    (or None)."""
    key = philox4x32((step & _M32, (step >> 32) & _M32, zlib.crc32(field.encode()) & _M32, 1),
                     _seed_key(seed))[:2]
    j = torch.arange(batch, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    bits = philox4x32((j, zero, zero, zero), key)
    centre = (raw - crop) // 2
    if translate:
        n = raw - crop + 1
        oy, ox = (bits[0] * n) >> 32, (bits[1] * n) >> 32
    else:
        oy = ox = torch.full((batch,), centre, dtype=torch.int64, device=device)
    flips = (bits[2] >> 31).bool() if flip else None
    return oy, ox, flips


def keep_mask(n: int, key: Tuple[int, int], rate: float, device) -> torch.Tensor:
    """Which of n elements dropout keeps: bits >= min(rate * 2^32, 2^32 - 1)."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32((groups & _M32, groups >> 32, zero, zero), key)
    bits = torch.stack(words, dim=-1).reshape(-1)[:n]
    return bits >= min(int(rate * (1 << 32)), (1 << 32) - 1)


def crop_images(x: torch.Tensor, crop: int, oy: torch.Tensor, ox: torch.Tensor,
                flips: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, W, C) -> (B, crop, crop, C): the crop at (oy, ox), mirrored
    left to right where flips."""
    b = x.shape[0]
    i = torch.arange(crop, device=x.device)
    rows = oy.long()[:, None] + i
    cols = i.expand(b, crop)
    if flips is not None:
        cols = torch.where(flips[:, None], crop - 1 - cols, cols)
    cols = ox.long()[:, None] + cols
    bi = torch.arange(b, device=x.device)[:, None, None]
    return x[bi, rows[:, :, None], cols[:, None, :]]
