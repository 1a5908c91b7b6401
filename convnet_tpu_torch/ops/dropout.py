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
so nothing is stored (dropout.py:103-129). The kernel reads its key from
device memory.

`step_draws` derives a train step's keys, and one input field's crop
origins and flips, on the device from the (seed, step) tensor that the
device holds (`cn_step_draws` in the same CUDA source; `step_draws_reference`
is its plain version). So a CUDA graph of the step, which replays every
argument it captured, draws new masks and crops at each replay as the
step tensor advances, and the draws do not depend on how the steps are
launched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

#: Launches of the CUDA kernels in this process (CPU calls do not count):
#: the dropout kernel's and the step-draws kernel's.
LAUNCHES = 0
DRAW_LAUNCHES = 0
#: Keys one step_draws call derives at most (the kernel's KeyWords).
MAX_KEYS = 16

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


Key = Union[Tuple[int, int], torch.Tensor]


def keep_threshold(rate: float) -> int:
    """Bits at or above this are kept: rate * 2^32, capped at 2^32 - 1."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _scale(rate: float, dtype) -> torch.Tensor:
    """1 / (1 - rate) rounded to dtype, as the kernel multiplies by it."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype)


def _key_words(key: Key, device):
    """A key's two words as Python ints (host key) or int64 scalars on
    `device` (a key tensor of shape (2,))."""
    if isinstance(key, torch.Tensor):
        k = key.to(device=device, dtype=torch.int64)
        return k[0], k[1]
    return key


def dropout_bits(n: int, key: Key, offset: int = 0, device="cpu") -> torch.Tensor:
    """The mask's 32-bit words for elements offset .. offset+n-1 (int64)."""
    if offset % 4:
        raise ValueError(f"offset {offset} is not a multiple of 4")
    groups = torch.arange(offset // 4, (offset + n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32((groups & _M32, groups >> 32, zero, zero), _key_words(key, device))
    return torch.stack(words, dim=-1).reshape(-1)[:n]


def dropout_reference(x: torch.Tensor, rate: float, key: Key, offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device). key: (k0, k1)
    ints, or an int64 tensor of shape (2,)."""
    keep = dropout_bits(x.numel(), key, offset, x.device).view(x.shape) >= keep_threshold(rate)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # filled on the device: copying _scale's CPU tensor over waits for the card
    scale = torch.full((), float(_scale(rate, x.dtype)), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, zero)


def dropout_apply(x: torch.Tensor, rate: float, key: Key, offset: int = 0) -> torch.Tensor:
    """Mask and scale x (contiguous, bf16 or f32 on the card) with the
    mask of `key`; element i of x takes the bits of element offset + i.
    On the card the kernel reads the key from an int64 (2,) tensor on x's
    device; a (k0, k1) pair of ints is copied there first (which waits for
    the card). No autograd (see `dropout`)."""
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
    if not isinstance(key, torch.Tensor):
        key = torch.tensor(key, dtype=torch.int64, device=x.device)
    if key.shape != (2,) or key.dtype != torch.int64 or key.device != x.device:
        raise TypeError(f"dropout: key must be an int64 (2,) tensor on {x.device}")
    key = key.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_dropout(
            x.data_ptr(), y.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            keep_threshold(rate), float(_scale(rate, x.dtype)), key.data_ptr(), offset // 4,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "dropout")
    LAUNCHES += 1
    return y


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, key, offset):
        ctx.rate, ctx.key, ctx.offset = rate, key, offset
        return dropout_apply(x.contiguous(), rate, key, offset)

    @staticmethod
    def backward(ctx, g):
        # the same key and offset draw the same mask: nothing was stored
        return dropout_apply(g.contiguous(), ctx.rate, ctx.key, ctx.offset), None, None, None


def dropout(x: torch.Tensor, rate: float, key: Key, offset: int = 0) -> torch.Tensor:
    """y = x * mask / (1 - rate), the mask drawn from `key` (an int64 (2,)
    tensor, as step_draws derives it on the device, or `dropout_key`'s
    pair of ints) in both the forward and the backward; element i of x
    takes the bits of element offset + i (a multiple of 4), so a rank that
    holds rows of a larger batch draws what one device draws for them.
    rate 0 is the identity."""
    if rate <= 0.0:
        return x
    if offset % 4:
        raise ValueError(f"dropout: element offset {offset} is not a multiple of 4 (the "
                         "mask's bits come four to a counter)")
    return _Dropout.apply(x, float(rate), key, int(offset))


# ---------------------------------------------------------------------------
# A train step's draws, on the device
# ---------------------------------------------------------------------------


class CropDraw(NamedTuple):
    """One input field's crop draw: its key's counter words (w2, w3), the
    batch b, and per axis the origin base + a uniform draw from
    [0, range); flips: whether to draw flips; row0: the global batch row
    of image 0, whose counter the draw of image t takes as row0 + t, so a
    rank that holds rows row0 .. row0 + b - 1 draws their crops."""

    w2: int
    w3: int
    b: int
    base_y: int
    range_y: int
    base_x: int
    range_x: int
    flips: bool
    row0: int = 0


def _uniform(bits, base: int, n: int) -> torch.Tensor:
    """base + floor(bits * n / 2^32): the kernel's multiply-high."""
    return (base + ((bits * n) >> 32)).to(torch.int32)


def step_draws_reference(
    state: torch.Tensor, words: Sequence[Tuple[int, int]], crop: Optional[CropDraw] = None
):
    """Plain version of `step_draws` (any device)."""
    dev = state.device
    seed, step = state[0], state[1]
    key = (seed & _M32, (seed >> 32) & _M32)
    ctr = (step & _M32, (step >> 32) & _M32)
    # one Philox a key, the words as host ints: nothing is copied to the device
    rows = [torch.stack(philox4x32((*ctr, w2 & _M32, w3 & _M32), key)[:2]) for w2, w3 in words]
    keys = torch.stack(rows) if rows else torch.empty((0, 2), dtype=torch.int64, device=dev)
    if crop is None:
        return keys, None
    fk = philox4x32((*ctr, crop.w2 & _M32, crop.w3 & _M32), key)[:2]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    j = torch.arange(crop.row0, crop.row0 + crop.b, dtype=torch.int64, device=dev)
    bits = philox4x32((j, zero, zero, zero), fk)
    flips = (bits[2] >> 31).bool() if crop.flips else None
    return keys, (_uniform(bits[0], crop.base_y, crop.range_y),
                  _uniform(bits[1], crop.base_x, crop.range_x), flips)


def step_draws(
    state: torch.Tensor, words: Sequence[Tuple[int, int]], crop: Optional[CropDraw] = None
):
    """A train step's random draws from state = int64 (seed, step) on its
    device, in one launch on the card. Returns (keys, crops): keys, int64
    (len(words), 2), row i derive_key(seed, step, step >> 32, *words[i]);
    crops, with `crop`, (oy int32 (b,), ox int32 (b,), flips bool (b,) or
    None) drawn from that field's key for global rows crop.row0 ..
    crop.row0 + b - 1, else None. A CPU state takes the
    plain version."""
    if state.shape != (2,) or state.dtype != torch.int64:
        raise TypeError("step_draws: state must be an int64 (seed, step) tensor")
    if len(words) > MAX_KEYS:
        raise ValueError(f"step_draws: {len(words)} keys, at most {MAX_KEYS}")
    if crop is not None and not (0 < crop.range_y < 2**31 and 0 < crop.range_x < 2**31):
        raise ValueError(f"step_draws: crop ranges {crop.range_y}, {crop.range_x}")
    if crop is not None and not (0 <= crop.row0 and crop.row0 + crop.b <= 2**31):
        raise ValueError(f"step_draws: crop rows {crop.row0} .. {crop.row0 + crop.b - 1}")
    if state.device.type == "cpu":
        return step_draws_reference(state, words, crop)
    if state.device.type != "cuda":
        raise ValueError(f"step_draws: no kernel for device {state.device}")
    if not words and (crop is None or crop.b == 0):
        raise ValueError("step_draws: nothing to draw")
    import ctypes

    dev = state.device
    keys = torch.empty((len(words), 2), dtype=torch.int64, device=dev)
    flat = [w & _M32 for pair in words for w in pair]
    host_words = (ctypes.c_uint32 * max(1, len(flat)))(*flat)
    oy = ox = flips = None
    b = 0
    if crop is not None and crop.b > 0:
        b = crop.b
        oy = torch.empty((b,), dtype=torch.int32, device=dev)
        ox = torch.empty((b,), dtype=torch.int32, device=dev)
        flips = torch.empty((b,), dtype=torch.bool, device=dev) if crop.flips else None
    c = crop or CropDraw(0, 0, 0, 0, 1, 0, 1, False)
    from convnet_tpu_torch.ops import _build

    global DRAW_LAUNCHES
    state = state.contiguous()
    with torch.cuda.device(dev):
        rc = _build.library().cn_step_draws(
            state.data_ptr(), ctypes.addressof(host_words), len(words),
            keys.data_ptr() if words else None, c.w2 & _M32, c.w3 & _M32, c.row0, b,
            c.base_y, c.range_y, c.base_x, c.range_x,
            None if oy is None else oy.data_ptr(), None if ox is None else ox.data_ptr(),
            None if flips is None else flips.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "step_draws")
    DRAW_LAUNCHES += 1
    return keys, (None if crop is None else (oy, ox, flips))
