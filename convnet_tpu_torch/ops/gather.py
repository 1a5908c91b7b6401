"""The gather probes' kernels (counterparts of the `pallas_call` sites of
`tools/r5_probe_gather{,2,3,4}.py`, ROADMAP Queue B rows 15-29), on no
model's path: `tools/gather_probe.py` runs each probe's function through
them.

- `crop_window`: a per-image window of each image, its origin a static
  base plus a multiple of a per-image offset read on the device
  (`csrc/crop_window.cu`).
- `relayout`: an output-indexed gather over a view of up to four dims
  (sizes, input strides, rolls, flips) with a small epilogue
  (`csrc/relayout.cu`); `_relayout_plan` reduces the map on the host and
  picks the kernel's route.
- `crop_deinterleave`: stage 1 of the gather design of the per-image crop:
  crop, normalize, deinterleave into the (rp, p) x (cpc, q) layout, and
  flip (`csrc/crop_deinterleave.cu`).

Each wrapper runs its plain version (`*_reference`, the same arguments)
for a CPU tensor, launches its kernel for a CUDA tensor, and raises for any
other device; a kernel that fails to build or launch raises. Offsets,
flags and the probes' scalar `s` are int32 tensors on the input's device,
the counterpart of a scalar prefetch, so no launch waits for the host: a
CPU call checks that every window lies inside its input, while on the card
an image whose window leaves its input is written as zeros
(`crop_window`) or NaN (`crop_deinterleave`), as the plain versions also
write it. `relayout`'s map is static, and checked on every device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

#: Launches of each CUDA kernel in this process (CPU calls do not count).
CROP_WINDOW_LAUNCHES = 0
RELAYOUT_LAUNCHES = 0
CROP_DEINTERLEAVE_LAUNCHES = 0

EPILOGUES = ("copy", "scale_u8", "row_flag_col0", "row_below_s", "antidiagonal")
_ROLL_BY_S, _MIRROR_IF_S = 1, 2
#: The deinterleave's phases: stride 4 on rows, 4 pixels x 3 channels on columns.
ROW_PHASES, COL_PHASES = 4, 12
#: crop_deinterleave's normalize of a u8 input, the probes' (v * 1/255) - 0.45
SCALE, SHIFT = 1 / 255.0, 0.45


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_offsets(name: str, x: torch.Tensor, *offs: Optional[torch.Tensor], n: int) -> None:
    for o in offs:
        if o is None:
            continue
        if o.dtype != torch.int32 or o.device != x.device or o.shape != (n,):
            raise TypeError(f"{name}: offsets and flags must be int32 ({n},) on {x.device}, got "
                            f"{o.dtype} {tuple(o.shape)} on {o.device}")
        if not o.is_contiguous():
            raise ValueError(f"{name}: offsets and flags must be contiguous")


def _batched(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() == 2:
        return x.unsqueeze(0)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, H, W) or (H, W), got {tuple(x.shape)}")
    return x


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


# -- crop_window ----------------------------------------------------------------


def _origins(x3, row_off, col_off, row_base, row_mult, col_base, col_mult, select):
    b = x3.shape[0]
    dev = x3.device

    def origin(off, base, mult):
        o = torch.zeros(b, dtype=torch.int64, device=dev) if off is None else off.long()
        if select is not None:
            o = torch.where(o == select, o, torch.zeros_like(o))
        return base + mult * o

    return origin(row_off, row_base, row_mult), origin(col_off, col_base, col_mult)


def crop_window_reference(x: torch.Tensor, rows: int, cols: int, *,
                          row_off: Optional[torch.Tensor] = None,
                          col_off: Optional[torch.Tensor] = None, row_base: int = 0,
                          row_mult: int = 1, col_base: int = 0, col_mult: int = 1,
                          select: Optional[int] = None, outside: str = "zero") -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): see crop_window.
    An image whose window leaves its input is zeros, as on the card,
    whatever `outside` says (the wrapper's check on the CPU)."""
    x3 = _batched(x, "crop_window")
    b, h, w = x3.shape
    dev = x3.device
    r0, c0 = _origins(x3, row_off, col_off, row_base, row_mult, col_base, col_mult, select)
    inside = (r0 >= 0) & (r0 + rows <= h) & (c0 >= 0) & (c0 + cols <= w)
    ri = (r0.view(b, 1) + torch.arange(rows, device=dev)).clamp(0, h - 1)
    ci = (c0.view(b, 1) + torch.arange(cols, device=dev)).clamp(0, w - 1)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    v = x3[bi, ri.view(b, rows, 1), ci.view(b, 1, cols)]
    out = torch.where(inside.view(b, 1, 1), v, torch.zeros((), dtype=x.dtype, device=dev))
    return out if x.dim() == 3 else out[0]


def crop_window(x: torch.Tensor, rows: int, cols: int, *,
                row_off: Optional[torch.Tensor] = None, col_off: Optional[torch.Tensor] = None,
                row_base: int = 0, row_mult: int = 1, col_base: int = 0, col_mult: int = 1,
                select: Optional[int] = None, outside: str = "raise") -> torch.Tensor:
    """o[b, r, c] = x[b, r0[b] + r, c0[b] + c] for r < rows, c < cols, with
    r0 = row_base + row_mult * row_off[b] and c0 = col_base + col_mult *
    col_off[b] (an absent offset is 0); with `select`, an offset counts only
    where it equals select (else 0). x: (B, H, W) or (H, W) of 1, 2 or
    2-byte elements (u8, bf16); the offsets int32 (B,) on x's device. On the CPU a
    window that leaves its input raises, unless outside="zero": the image is
    then zeros (the probe p18's function); on the card such an image is
    written as zeros, whatever `outside` says."""
    if outside not in ("raise", "zero"):
        raise ValueError(f"crop_window: outside must be 'raise' or 'zero', got {outside!r}")
    x3 = _batched(x, "crop_window")
    b, h, w = x3.shape
    if rows < 1 or cols < 1:
        raise ValueError(f"crop_window: a {rows} x {cols} window")
    if x.element_size() not in (1, 2):
        raise TypeError(f"crop_window: elements of 1 or 2 bytes, got {x.dtype}")
    _check_offsets("crop_window", x, row_off, col_off, n=b)
    kw = dict(row_off=row_off, col_off=col_off, row_base=row_base, row_mult=row_mult,
              col_base=col_base, col_mult=col_mult, select=select)
    if _device(x, "crop_window") == "cpu":
        if outside == "raise" and b:
            r0, c0 = _origins(x3, row_off, col_off, row_base, row_mult, col_base, col_mult, select)
            if int(r0.min()) < 0 or int(r0.max()) + rows > h:
                raise ValueError(f"crop_window: a row origin outside [0, {h - rows}]")
            if int(c0.min()) < 0 or int(c0.max()) + cols > w:
                raise ValueError(f"crop_window: a column origin outside [0, {w - cols}]")
        return crop_window_reference(x, rows, cols, **kw)
    if not x.is_contiguous():
        raise ValueError("crop_window: x must be contiguous")
    out = torch.empty((b, rows, cols), dtype=x.dtype, device=x.device)
    if b == 0:
        return out if x.dim() == 3 else out[0]
    from convnet_tpu_torch.ops import _build

    global CROP_WINDOW_LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_crop_window(
            x.data_ptr(), None if row_off is None else row_off.data_ptr(),
            None if col_off is None else col_off.data_ptr(), out.data_ptr(), b, h, w, rows, cols,
            x.element_size(), row_base, row_mult, col_base, col_mult,
            -1 if select is None else select, _stream(x),
        )
    _build.check(rc, "crop_window")
    CROP_WINDOW_LAUNCHES += 1
    return out if x.dim() == 3 else out[0]


# -- relayout ---------------------------------------------------------------------


class Dim(NamedTuple):
    """One dim of relayout's view: `size` output coordinates, `stride`
    input elements a step (negative: the dim runs backwards from `base`),
    a static `roll` (out[i] reads coordinate (i - roll) mod size, as
    jnp.roll), `roll_by_s`: add s[0] to the roll, `mirror_if_s`: read
    coordinate size - 1 - i where s[0] > 0 (before the roll)."""
    size: int
    stride: int
    roll: int = 0
    roll_by_s: bool = False
    mirror_if_s: bool = False


def _read_box(dims: Sequence[Dim], base: int) -> Tuple[int, int]:
    lo = hi = base
    for d in dims:
        span = d.stride * (d.size - 1)
        lo, hi = (lo + span, hi) if span < 0 else (lo, hi + span)
    return lo, hi


#: relayout's kernel routes (csrc/relayout.cu): "run", one 16-byte output
#: word a thread, read as a contiguous input run where the innermost dim
#: steps by +1 or -1 (a copy or a reverse; where that dim mirrors, the
#: card picks which by s[0]), element by element elsewhere; "tile", a
#: shared-memory transpose of the unit-stride dim and the innermost one.
RELAYOUT_ROUTES = ("run", "tile")
_ROW_EPILOGUES = ("row_flag_col0", "row_below_s")


class RelayoutPlan(NamedTuple):
    """relayout's map as the kernel runs it (_relayout_plan): `dims` in
    output order, each still a Dim, from `base`; `unit` is the tile
    route's dim read with stride +-1 (the run route's innermost dim)."""
    route: str
    dims: Tuple[Dim, ...]
    base: int
    unit: int


def _plain_dim(d: Dim) -> bool:
    """A dim that neither rolls nor mirrors."""
    return d.roll % d.size == 0 and not d.roll_by_s and not d.mirror_if_s


@functools.lru_cache(maxsize=256)
def _relayout_plan(dims: Tuple[Dim, ...], base: int = 0,
                   epilogue: str = "copy") -> RelayoutPlan:
    """Reduce a map without changing what it computes: drop dims of size 1
    (their coordinate is 0), merge neighbours d, d + 1 where stride_d ==
    size_{d+1} * stride_{d+1} and neither rolls or mirrors, then pick the
    route. The row epilogues key on dim 0, which is kept whole; the
    anti-diagonal reads nothing, so only its first and last dims' output
    coordinates count and the dims between them become one."""
    if epilogue == "antidiagonal":
        if len(dims) == 1:
            return RelayoutPlan("run", (Dim(dims[0].size, 0),), 0, 0)
        mid = math.prod(d.size for d in dims[1:-1])
        kept = [Dim(dims[0].size, 0)] + [Dim(mid, 0)] * (mid > 1) + [Dim(dims[-1].size, 0)]
        return RelayoutPlan("run", tuple(kept), 0, len(kept) - 1)
    pinned = epilogue in _ROW_EPILOGUES
    kept = [d for i, d in enumerate(dims) if d.size > 1 or (pinned and i == 0)] or [Dim(1, 1)]
    out = [kept[0]]
    for d in kept[1:]:
        p = out[-1]
        if (not (pinned and len(out) == 1) and _plain_dim(p) and _plain_dim(d)
                and p.stride == d.size * d.stride):
            out[-1] = Dim(p.size * d.size, d.stride)
        else:
            out.append(d)
    units = [j for j, d in enumerate(out[:-1]) if abs(d.stride) == 1]
    if abs(out[-1].stride) == 1 or not units:
        return RelayoutPlan("run", tuple(out), base, len(out) - 1)
    return RelayoutPlan("tile", tuple(out), base, units[-1])


@functools.lru_cache(maxsize=256)
def _packed_plan(dims: Tuple[Dim, ...], base: int, epilogue: str):
    """The plan as cn_relayout reads it: rank, route, base, unit, then
    each dim's size, stride, static roll and flags (host int64s)."""
    plan = _relayout_plan(dims, base, epilogue)
    fields = [len(plan.dims), RELAYOUT_ROUTES.index(plan.route), plan.base, plan.unit]
    for d in plan.dims:
        fields += [d.size, d.stride, d.roll,
                   _ROLL_BY_S * d.roll_by_s + _MIRROR_IF_S * d.mirror_if_s]
    return (ctypes.c_int64 * len(fields))(*fields)


def relayout_reference(x: torch.Tensor, dims: Sequence[Dim], *, base: int = 0,
                       s: Optional[torch.Tensor] = None, epilogue: str = "copy",
                       scale: float = 1.0, k: int = 0,
                       shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): see relayout."""
    dev = x.device
    n = len(dims)
    out_shape = tuple(shape) if shape is not None else tuple(d.size for d in dims)

    def along(d: int, t: torch.Tensor) -> torch.Tensor:  # t (size_d,) broadcast on dim d
        return t.view([-1 if i == d else 1 for i in range(n)])

    if epilogue == "antidiagonal":
        a = along(0, torch.arange(dims[0].size, device=dev))
        z = along(n - 1, torch.arange(dims[-1].size, device=dev))
        one = (a < k) & (z < k) & (a + z == k - 1)
        return one.expand([d.size for d in dims]).to(torch.bfloat16).reshape(out_shape)
    s0 = (s[0].long() if s is not None else torch.zeros((), dtype=torch.long, device=dev))
    off = torch.full((), base, dtype=torch.long, device=dev)
    coords = []
    for i, d in enumerate(dims):
        c = torch.arange(d.size, device=dev)
        if d.mirror_if_s:
            c = torch.where(s0 > 0, d.size - 1 - c, c)
        shift = d.roll + (s0 if d.roll_by_s else 0)
        c = torch.remainder(c - shift, d.size)
        coords.append(c)
        off = off + along(i, c) * d.stride
    flat = x.reshape(-1)
    v = flat[off]
    if epilogue == "copy":
        out = v
    elif epilogue == "scale_u8":
        out = (v.float() * torch.full((), scale, dtype=torch.float32, device=dev)).to(torch.bfloat16)
    else:
        if epilogue == "row_flag_col0":
            keep = flat[base + along(0, coords[0]) * dims[0].stride].float() > 0
        else:  # row_below_s
            keep = along(0, torch.arange(dims[0].size, device=dev)) < s0
        out = torch.where(keep, v, (v.float() * 2).to(torch.bfloat16))
    return out.reshape(out_shape)


def relayout(x: torch.Tensor, dims: Sequence[Dim], *, base: int = 0,
             s: Optional[torch.Tensor] = None, epilogue: str = "copy", scale: float = 1.0,
             k: int = 0, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The output, of the dims' sizes in order (reshaped to `shape` if
    given), gathered from x (any shape, read as its flat elements): element
    (i_0, ..., i_{n-1}) reads x.flatten()[base + sum_d stride_d * c_d], c_d
    the coordinate that i_d maps to under the dim's mirror and roll (Dim).
    s: int32 on x's device, s[0] the probes' scalar (absent: 0). Epilogues
    (EPILOGUES): "copy" (any 1 or 2-byte element); "scale_u8", u8 -> f32
    * scale -> bf16; "row_flag_col0", bf16 v where the element at (c_0, 0,
    ..., 0) is > 0, else 2v; "row_below_s", bf16 v where i_0 < s[0], else
    2v; "antidiagonal", no input read: bf16 1 where i_0 + i_{n-1} == k - 1
    with both below k, else 0. Every read must lie inside x, on every
    device."""
    name = "relayout"
    if epilogue not in EPILOGUES:
        raise ValueError(f"{name}: epilogue {epilogue!r} not in {EPILOGUES}")
    if not 1 <= len(dims) <= 4 or any(d.size < 1 for d in dims):
        raise ValueError(f"{name}: one to four dims of size >= 1, got {list(dims)}")
    numel = math.prod(d.size for d in dims)
    if shape is not None and torch.Size(shape).numel() != numel:
        raise ValueError(f"{name}: shape {tuple(shape)} does not hold {numel} elements")
    if epilogue != "antidiagonal":
        lo, hi = _read_box(dims, base)
        if lo < 0 or hi >= x.numel():
            raise ValueError(f"{name}: the map reads elements {lo}..{hi} of {x.numel()}")
    want = {"scale_u8": torch.uint8, "row_flag_col0": torch.bfloat16,
            "row_below_s": torch.bfloat16}.get(epilogue)
    if want is not None and x.dtype != want:
        raise TypeError(f"{name}: epilogue {epilogue} takes {want}, got {x.dtype}")
    if x.element_size() not in (1, 2):
        raise TypeError(f"{name}: elements of 1 or 2 bytes, got {x.dtype}")
    if s is not None:
        if s.dtype != torch.int32 or s.device != x.device or s.numel() < 1:
            raise TypeError(f"{name}: s must be int32 on {x.device}")
    kw = dict(base=base, s=s, epilogue=epilogue, scale=scale, k=k, shape=shape)
    if _device(x, name) == "cpu":
        return relayout_reference(x, dims, **kw)
    if not x.is_contiguous() or (s is not None and not s.is_contiguous()):
        raise ValueError(f"{name}: x and s must be contiguous")
    out = torch.empty([d.size for d in dims], device=x.device,
                      dtype=x.dtype if epilogue == "copy" else torch.bfloat16)
    packed = _packed_plan(tuple(Dim(*d) for d in dims), base, epilogue)
    from convnet_tpu_torch.ops import _build

    global RELAYOUT_LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_relayout(
            x.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(), packed,
            x.numel(), x.element_size(), EPILOGUES.index(epilogue), scale, k, _stream(x),
        )
    _build.check(rc, name)
    RELAYOUT_LAUNCHES += 1
    return out if shape is None else out.view(tuple(shape))


# -- crop_deinterleave ------------------------------------------------------------


def _deinterleave_index(p: int, q: int, dev: torch.device):
    """(input row of each output row, input column of each output column
    unflipped, and flipped), each relative to the crop's origin."""
    r = torch.arange(ROW_PHASES * p, device=dev)
    rows = ROW_PHASES * (r % p) + r // p  # out row rp * p + pp <- in row 4 pp + rp
    c = torch.arange(COL_PHASES * q, device=dev)
    qq, cpc = c % q, c // q
    cp, ch = cpc // 3, cpc % 3
    cols = COL_PHASES * qq + 3 * cp + ch
    flipped = COL_PHASES * (q - 1 - qq) + 3 * (3 - cp) + ch
    return rows, cols, flipped


def crop_deinterleave_reference(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                                fl: Optional[torch.Tensor] = None, *, p: int = 56,
                                q: int = 56) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): see
    crop_deinterleave. An image whose crop leaves its input is NaN, as on
    the card."""
    x3 = _batched(x, "crop_deinterleave")
    b, h, l = x3.shape
    dev = x3.device
    rows, cols, flipped = _deinterleave_index(p, q, dev)
    y0, x0 = oy.long(), 3 * ox.long()
    inside = (y0 >= 0) & (y0 + ROW_PHASES * p <= h) & (x0 >= 0) & (x0 + COL_PHASES * q <= l)
    ri = (y0.view(b, 1) + rows).clamp(0, h - 1)
    cc = cols.expand(b, -1) if fl is None else torch.where(fl.view(b, 1) > 0, flipped, cols)
    ci = (x0.view(b, 1) + cc).clamp(0, l - 1)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    v = x3[bi, ri.view(b, -1, 1), ci.view(b, 1, -1)].float()
    if x.dtype == torch.uint8:
        # a multiply, then a subtract, each rounded to f32 (no FMA)
        v = v * torch.full((), SCALE, dtype=torch.float32, device=dev)
        v = v - torch.full((), SHIFT, dtype=torch.float32, device=dev)
    # NaN's bits as the kernel writes them (0x7fc0): a bf16 fill, not a cast
    # of an f32 NaN, which gives other bits on the card
    nan = torch.full((), float("nan"), dtype=torch.bfloat16, device=dev)
    out = torch.where(inside.view(b, 1, 1), v.to(torch.bfloat16), nan)
    return out if x.dim() == 3 else out[0]


def crop_deinterleave(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                      fl: Optional[torch.Tensor] = None, *, p: int = 56,
                      q: int = 56) -> torch.Tensor:
    """Stage 1 of the gather design: for each image of x ((B, H, L) or
    (H, L), L = 3 x width) the crop of 4p rows from row oy[b] and 12q
    elements from column 3 * ox[b], as bf16 (B, 4p, 12q) in the (rp, p) x
    (cpc, q) layout: out[b, rp*p + pp, cpc*q + qq] = f(x[b, oy + 4pp + rp,
    3ox + 12qq' + cpc']) with cpc = 3cp + c, and qq' = q - 1 - qq, cp' = 3 -
    cp where fl[b] > 0 (the horizontal flip). f is (v * SCALE) - SHIFT in
    f32, each rounded, then bf16, for a u8 x; the identity for a bf16 x. oy,
    ox, fl: int32 (B,) on x's device (fl optional). On the CPU a crop that
    leaves its input raises; on the card that image is written as NaN."""
    name = "crop_deinterleave"
    x3 = _batched(x, name)
    b, h, l = x3.shape
    if x.dtype not in (torch.uint8, torch.bfloat16):
        raise TypeError(f"{name}: x must be uint8 or bf16, got {x.dtype}")
    if p < 1 or q < 1:
        raise ValueError(f"{name}: p = {p}, q = {q}")
    _check_offsets(name, x, oy, ox, fl, n=b)
    kw = dict(p=p, q=q)
    if _device(x, name) == "cpu":
        if b and (int(oy.min()) < 0 or int(oy.max()) + ROW_PHASES * p > h):
            raise ValueError(f"{name}: oy outside [0, {h - ROW_PHASES * p}]")
        if b and (int(ox.min()) < 0 or 3 * int(ox.max()) + COL_PHASES * q > l):
            raise ValueError(f"{name}: ox outside [0, {(l - COL_PHASES * q) // 3}]")
        return crop_deinterleave_reference(x, oy, ox, fl, **kw)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    out = torch.empty((b, ROW_PHASES * p, COL_PHASES * q), dtype=torch.bfloat16, device=x.device)
    if b == 0:
        return out if x.dim() == 3 else out[0]
    from convnet_tpu_torch.ops import _build

    global CROP_DEINTERLEAVE_LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_crop_deinterleave(
            x.data_ptr(), oy.data_ptr(), ox.data_ptr(), None if fl is None else fl.data_ptr(),
            out.data_ptr(), b, h, l, p, q, int(x.dtype == torch.bfloat16),
            int(x.dtype == torch.uint8), SCALE, SHIFT, _stream(x),
        )
    _build.check(rc, name)
    CROP_DEINTERLEAVE_LAUNCHES += 1
    return out if x.dim() == 3 else out[0]
