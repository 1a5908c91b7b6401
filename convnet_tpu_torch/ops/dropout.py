"""Inverted dropout with a mask redrawn in the backward (counterpart of
`convnet_tpu/ops/dropout.py`).

    keep = bits >= min(floor(rate * 2^32), 2^32 - 1)
    y    = where(keep, x * dtype(1 / (1 - rate)), 0)     in x's dtype

as the TPU kernel `_mask_kernel` (dropout.py:58) keeps and scales. The
bits come from Philox4x32-10, written out here (`philox4x32`) and in the
CUDA kernel `csrc/dropout.cu`: the key is derived from (seed, step,
layer index) and the counter is the element's index, so the plain
version and the kernel draw the identical mask on any device. They are
not the JAX package's bits (threefry or the TPU's hardware generator):
the two packages agree on the keep rule and scaling, not on the mask.

`dropout_apply` is the kernel's wrapper: for a CPU tensor it runs the
plain version, `dropout_reference`; for a CUDA tensor it launches the
kernel or raises. `dropout` is the autograd Function over it: the
backward redraws the mask from the key and applies it to the cotangent,
so nothing is stored (dropout.py:103-129).
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mul_hi_lo(a: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of a * c for a < 2^32 and int64 c in
    [0, 2^32), from 16-bit halves so no int64 product overflows."""
    p_lo = a * (c & 0xFFFF)  # < 2^48
    p_hi = a * (c >> 16)  # < 2^48
    low = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (low >> 32), low & _M32


def philox4x32(counter, key: Tuple[int, int]):
    """Philox4x32-10 (Salmon et al., SC'11, Random123's philox4x32_R with
    10 rounds). counter: four 32-bit words, each a Python int or an int64
    tensor (broadcast together); key: two 32-bit ints. Returns the four
    output words, of the counter's type, in [0, 2^32)."""
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


def derive_key(seed: int, *words: int) -> Tuple[int, int]:
    """Two 32-bit key words from a 64-bit seed and up to four 32-bit
    words: Philox keyed by the seed at counter `words`. Distinct words
    give unrelated keys, so one seed feeds independent streams."""
    if len(words) > 4:
        raise ValueError("derive_key takes at most four counter words")
    ctr = [w & _M32 for w in words] + [0] * (4 - len(words))
    out = philox4x32(ctr, (seed & _M32, (seed >> 32) & _M32))
    return out[0], out[1]


def dropout_key(seed: int, step: int, layer: int) -> Tuple[int, int]:
    """The mask's key for one layer at one train step."""
    return derive_key(seed, step, step >> 32, layer, 0)


def keep_threshold(rate: float) -> int:
    """Bits at or above this are kept: rate * 2^32, capped at 2^32 - 1."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _scale(rate: float, dtype) -> torch.Tensor:
    """1 / (1 - rate) rounded to dtype, as the kernel multiplies by it."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype)


def dropout_bits(n: int, key: Tuple[int, int], offset: int = 0, device="cpu") -> torch.Tensor:
    """The mask's 32-bit words for elements offset .. offset+n-1 (int64)."""
    if offset % 4:
        raise ValueError(f"offset {offset} is not a multiple of 4")
    groups = torch.arange(offset // 4, (offset + n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32((groups & _M32, groups >> 32, zero, zero), key)
    return torch.stack(words, dim=-1).reshape(-1)[:n]


def dropout_reference(
    x: torch.Tensor, rate: float, key: Tuple[int, int], offset: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    keep = dropout_bits(x.numel(), key, offset, x.device).view(x.shape) >= keep_threshold(rate)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # filled on the device: copying _scale's CPU tensor over waits for the card
    scale = torch.full((), float(_scale(rate, x.dtype)), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, zero)


def dropout_apply(
    x: torch.Tensor, rate: float, key: Tuple[int, int], offset: int = 0
) -> torch.Tensor:
    """Mask and scale x (contiguous, bf16 or f32 on the card) with the
    mask of `key`; element i of x takes the bits of element offset + i.
    No autograd (see `dropout`)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside (0, 1)")
    if x.device.type == "cpu":
        return dropout_reference(x, rate, key, offset)
    if x.device.type != "cuda":
        raise ValueError(f"dropout: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dropout: dtype {x.dtype} (bf16 or f32 only)")
    if not x.is_contiguous():
        raise ValueError("dropout: x must be contiguous")
    if offset % 4:
        raise ValueError(f"offset {offset} is not a multiple of 4")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_dropout(
            x.data_ptr(), y.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            keep_threshold(rate), float(_scale(rate, x.dtype)), key[0], key[1], offset // 4,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "dropout")
    LAUNCHES += 1
    return y


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, key):
        ctx.rate, ctx.key = rate, key
        return dropout_apply(x.contiguous(), rate, key)

    @staticmethod
    def backward(ctx, g):
        # the same key draws the same mask: nothing was stored
        return dropout_apply(g.contiguous(), ctx.rate, ctx.key), None, None


def dropout(x: torch.Tensor, rate: float, seed: int, step: int = 0, layer: int = 0) -> torch.Tensor:
    """y = x * mask / (1 - rate), the mask drawn from (seed, step, layer)
    in both the forward and the backward. rate 0 is the identity."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x, float(rate), dropout_key(seed, step, layer))
