"""The gather probes on the card: the function of each sub-probe of
`tools/r5_probe_gather{,2,3,4}.py` (ROADMAP Queue B rows 15-29), computed
by the port's kernels and timed. Prints one JSON line per sub-probe:

    python -m convnet_tpu_torch.tools.gather_probe [--device cuda|cpu]
        [--seed N] [--calls 20] [--batch 4096] [--trace] [--probes P21,P24]

The TPU scripts are compile-only: each lowers one Mosaic primitive of a
gather form of the per-image crop (uint8 256 x 256 x 3 -> bf16 224 x 224,
flip, deinterleave) and reports whether it compiled, on zeros. Here each
sub-probe's function runs on seeded random inputs through one of three
kernels (`ops/gather.py`): `crop_window` (a per-image window: the row and
column DMAs, the dynamic and static slices, the slice switches),
`relayout` (an output-indexed gather with a small epilogue: rolls, strided
slices, transposes, flips, casts, selects, the one-hot) and
`crop_deinterleave` (stage 1 of the design: crop, normalize, deinterleave,
flip). PROBES lists them with their TPU sites; each entry builds the
probe's arguments in the TPU function's order, so the CPU tests hand the
same arguments to the TPU function in interpret mode.

Each line: the probe's name and row, its kernel and site, the input and
output shapes, `max_abs_err` of the kernel against its plain version on the
same inputs, `ms` (on the card `utils/card.py device_ms`: --calls calls
queued behind a spin kernel, launches hidden, median of 3 runs; on the CPU
the host clock with a synchronize), `plain_ms`, and where one PyTorch call
computes the same function (`torch.roll`, `torch.flip`, a permute or a
strided slice made contiguous, `clone`, `index_select`, advanced
indexing, `torch.mul` into a bf16 output) its name and `library_ms`, else
"none" and null (P19, P19b, P25a, P24, P31: no single call computes a
per-row select, the one-hot or stage 1); `bound_ms`, the
bytes the function must move (the output once, the input elements it
reads once, the offsets) over 3.35 TB/s, or its operations over 67
TFLOP/s where that is larger; the device's name and power limit, and
every kernel's launches (`ops.launch_counts()`) while that line was
measured. The single-block probes run at their own shapes (a few hundred
KB: launch-bound); the per-image probes also at --batch images. One last
line times `crop_deinterleave` with flips against `ops/s2d_relayout.py`
`jitter_s2d`'s train form (random crops and flips, scale 1/255, mean 0.45)
on the same --batch uint8 images and crops. Inputs are drawn from --seed.
--trace adds to each single-block line the torch.profiler durations of
the kernel's and the library call's device activities, the gaps between
calls left out, and how many traces that took (a trace that dropped
activities is taken again). EDGES holds the geometries that only the card checks run
(every branch of the three kernels).
The run's device is the card unless --device cpu is given; with no card it
exits before measuring anything.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from convnet_tpu_torch import ops
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.ops import gather
from convnet_tpu_torch.ops.gather import Dim, crop_deinterleave, crop_window, relayout
from convnet_tpu_torch.ops.s2d_relayout import jitter_s2d
from convnet_tpu_torch.utils import card

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
WARMUP = 3
#: the bench's batch: the one the gather design was drawn for
BATCH = 4096
S_LEN = 8  # the probes' prefetched scalar vector


class Geometry(NamedTuple):
    """The probes' shapes: b images of h rows and l lanes (3 channels a
    pixel) cropped to 4p rows and 12q lanes (the probes: 8, 256, 768, 56,
    56, so 224 x 672)."""
    b: int = 8
    h: int = 256
    l: int = 768
    p: int = 56
    q: int = 56

    @property
    def w(self) -> int:
        return gather.ROW_PHASES * self.p

    @property
    def cw(self) -> int:
        return gather.COL_PHASES * self.q


PROBE = Geometry()
#: a shape with no power of two: 7 images of 252 x 760 cropped to 220 x 660
RAGGED = Geometry(b=7, h=252, l=760, p=55, q=55)


class Draw:
    """Seeded inputs on a device. Values: normal draws rounded to bf16, or
    uniform bytes (numpy on the CPU, a torch.Generator on the card).
    Offsets and scalars (numpy, then copied): uniform in [0, hi] with
    mode "random", else at the range's two ends in turn, starting from 0
    ("low") or from hi ("high"). With `unaligned`, each tensor starts one
    element past a 16-byte boundary."""

    def __init__(self, device: torch.device, seed: int, mode: str = "random",
                 unaligned: bool = False):
        self.device, self.mode, self.unaligned = device, mode, unaligned
        self.rng = np.random.default_rng(seed)
        self.gen = None
        if device.type != "cpu":
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(seed)

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        if not self.unaligned:
            return t
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    def bf16(self, shape) -> torch.Tensor:
        if self.gen is None:
            t = torch.from_numpy(self.rng.standard_normal(shape, dtype=np.float32))
        else:
            t = torch.randn(shape, generator=self.gen, device=self.device)
        return self._place(t.to(torch.bfloat16))

    def u8(self, shape) -> torch.Tensor:
        if self.gen is None:
            t = torch.from_numpy(self.rng.integers(0, 256, shape, dtype=np.uint8))
        else:
            t = torch.randint(0, 256, shape, generator=self.gen, device=self.device,
                              dtype=torch.uint8)
        return self._place(t)

    def ints(self, n: int, hi: int) -> np.ndarray:
        """int32 (n,) in [0, hi] by the mode."""
        if self.mode == "random":
            return self.rng.integers(0, hi + 1, n).astype(np.int32)
        ends = [0, hi] if self.mode == "low" else [hi, 0]
        return np.array([ends[i % 2] for i in range(n)], np.int32)

    def scalar(self, hi: int) -> np.ndarray:
        """The probes' (8,) int32 scalar vector, s[0] in [0, hi] by the mode."""
        return self.ints(S_LEN, hi)

    def t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)


class Case(NamedTuple):
    """One sub-probe at one geometry: `args` in the TPU function's order;
    `call(fn, *args)` runs the probe's function through fn, the kernel's
    wrapper or its plain version (the same arguments); `library`, one
    PyTorch call computing the same function on these inputs (None where
    there is none), and its name."""
    args: tuple
    call: Callable
    library: Optional[Callable[[], torch.Tensor]]
    library_name: str


class Probe(NamedTuple):
    name: str  # as the TPU script prints it, without its suffix
    row: int  # ROADMAP Queue B row
    site: str  # the TPU function and its pallas_call
    kernel: str  # crop_window, relayout or crop_deinterleave
    build: Callable[[Geometry, Draw], Case]
    per_image: bool = False  # also run at --batch images
    ops: int = 0  # arithmetic operations an output element


KERNELS = {
    "crop_window": (crop_window, gather.crop_window_reference),
    "relayout": (relayout, gather.relayout_reference),
    "crop_deinterleave": (crop_deinterleave, gather.crop_deinterleave_reference),
}


# -- crop_window ------------------------------------------------------------------


def _rows(g: Geometry, d: Draw, mult: int = 1) -> Case:
    """o[b] = x[b, mult * oy[b] : + W, :] (P1, P1-fix, P1c; P23 at mult 8)."""
    oy = d.ints(g.b, (g.h - g.w) // mult)
    x = d.bf16((g.b, g.h, g.l))
    ri = torch.as_tensor(mult * oy[:, None] + np.arange(g.w), device=d.device)
    bi = torch.arange(g.b, device=d.device).view(-1, 1)
    return Case((d.t(oy), x), lambda f, oy, x: f(x, g.w, g.l, row_off=oy, row_mult=mult),
                lambda: x[bi, ri], "advanced indexing")


def _cols(g: Geometry, d: Draw) -> Case:
    """o[b] = x[b, :, 3 ox[b] : + CW] (P13b)."""
    ox = d.ints(g.b, (g.l - g.cw) // 3)
    x = d.bf16((g.b, g.w, g.l))
    ci = torch.as_tensor(3 * ox[:, None] + np.arange(g.cw), device=d.device).view(g.b, 1, -1)
    bi = torch.arange(g.b, device=d.device).view(-1, 1, 1)
    wi = torch.arange(g.w, device=d.device).view(1, -1, 1)
    return Case((d.t(ox), x), lambda f, ox, x: f(x, g.w, g.cw, col_off=ox, col_mult=3),
                lambda: x[bi, wi, ci], "advanced indexing")


def _block_rows(g: Geometry, d: Draw, hi: int, mult: int = 1, select=None) -> Case:
    """One (H, L) block: rows from mult * s[0] (P7, P8, P27), or from s[0]
    where it equals select, else 0 (P26)."""
    s = d.scalar(hi)
    x = d.bf16((g.h, g.l))
    r0 = mult * int(s[0]) if select is None or s[0] == select else 0
    idx = torch.arange(r0, r0 + g.w, device=d.device)
    return Case((d.t(s), x),
                lambda f, s, x: f(x, g.w, g.l, row_off=s[:1], row_mult=mult, select=select),
                lambda: x.index_select(0, idx), "index_select")


def _block_cols(g: Geometry, d: Draw, outside: str = "raise") -> Case:
    """One (W, L) block: lanes from 3 s[0] (P28; P18 with zeros where s[0]
    leaves 0..(L - CW) / 3)."""
    s = d.scalar((g.l - g.cw) // 3)
    x = d.bf16((g.w, g.l))
    idx = torch.arange(3 * int(s[0]), 3 * int(s[0]) + g.cw, device=d.device)
    return Case((d.t(s), x),
                lambda f, s, x: f(x, g.w, g.cw, col_off=s[:1], col_mult=3, outside=outside),
                lambda: x.index_select(1, idx), "index_select")


def _static_window(g: Geometry, d: Draw, rows, cols, row_base=0, col_base=0) -> Case:
    """A static slice of one (H, L) block (P9, P10)."""
    s = d.scalar(0)
    x = d.bf16((g.h, g.l))
    view = x[row_base:row_base + rows, col_base:col_base + cols]
    lib = view.clone if view.is_contiguous() else view.contiguous
    return Case((d.t(s), x),
                lambda f, s, x: f(x, rows, cols, row_base=row_base, col_base=col_base),
                lib, "clone of a slice" if view.is_contiguous() else "contiguous of a slice")


# -- relayout ---------------------------------------------------------------------


def _map(g: Geometry, d: Draw, dims, *, shape=None, base=0, in_shape=None, s_hi=0,
         epilogue="copy", scale=1.0, k=0, u8=False,
         library: Optional[Callable] = None, library_name: str = "none") -> Case:
    """One block through relayout's map; library(x, s0) builds the PyTorch
    call, given the block and s[0] on the host."""
    s = d.scalar(s_hi)
    x = (d.u8 if u8 else d.bf16)(in_shape or (g.h, g.l))
    kw = dict(base=base, epilogue=epilogue, scale=scale, k=k, shape=shape)
    lib = None if library is None else (lambda: library(x, int(s[0])))
    return Case((d.t(s), x), lambda f, s, x: f(x, dims, s=s, **kw), lib, library_name)


def _roll(g, d, axis, dynamic):
    """A roll of one (H, L) block along axis, by s[0] (P2, P3) or by 5
    (P2b, P3b)."""
    roll, by_s = [0, 0], [False, False]
    if dynamic:
        by_s[axis] = True
    else:
        roll[axis] = 5
    dims = [Dim(g.h, g.l, roll[0], by_s[0]), Dim(g.l, 1, roll[1], by_s[1])]
    return _map(g, d, dims, s_hi=(g.h, g.l)[axis] - 1 if dynamic else 0,
                library=lambda x, s0: torch.roll(x, s0 if dynamic else 5, axis),
                library_name="torch.roll")


def _probe_p20(g, d):
    """P20 at its consistent shape: (8, 12, q, 96) [img, cpc, q, rest] with
    q reversed ((2016, 256) at the probes' q)."""
    rows = 8 * 12 * g.q * 96 // 256
    dims = [Dim(8, 12 * g.q * 96), Dim(12, g.q * 96), Dim(g.q, -96), Dim(96, 1)]
    return _map(g, d, dims, base=(g.q - 1) * 96, shape=(rows, 256), in_shape=(rows, 256),
                library=lambda x, s0: torch.flip(x.view(8, 12, g.q, 96), [2]).view(rows, 256),
                library_name="torch.flip")


def _flip_qcp(g, d, when_s):
    """The q and cp flip of a (W, CW) [(rp, p), (cpc, q)] block (P20b), or,
    where s[0] > 0, else a copy (P22)."""
    if when_s:
        dims = [Dim(g.w, g.cw), Dim(4, 3 * g.q, mirror_if_s=True), Dim(3, g.q),
                Dim(g.q, 1, mirror_if_s=True)]
        base = 0
    else:
        dims = [Dim(g.w, g.cw), Dim(4, -3 * g.q), Dim(3, g.q), Dim(g.q, -1)]
        base = 10 * g.q - 1

    def lib(x, s0):
        if when_s and s0 <= 0:
            return x.clone()
        return torch.flip(x.view(g.w, 4, 3, g.q), [1, 3]).view(g.w, g.cw)

    return _map(g, d, dims, base=base, shape=(g.w, g.cw), in_shape=(g.w, g.cw),
                s_hi=1 if when_s else 0, library=lib,
                library_name="torch.flip, or clone where s[0] <= 0" if when_s else "torch.flip")


def _scale_u8(g, d):
    """P14a/b: u8 -> f32 * 0.5 -> bf16, which torch.mul computes into a
    bf16 output (in f32, then rounded to nearest even)."""
    out = torch.empty(_I(g), dtype=torch.bfloat16, device=d.device)
    return _map(g, d, [Dim(g.h, g.l), Dim(g.l, 1)], epilogue="scale_u8", scale=0.5, u8=True,
                library=lambda x, s0: torch.mul(x, 0.5, out=out),
                library_name="torch.mul(x, 0.5, out=o), o bf16")


def _crop_block(g: Geometry, d: Draw) -> Case:
    """P21: the deinterleave chain on one bf16 (W, CW) crop."""
    s = d.scalar(0)
    x = d.bf16((g.w, g.cw))
    zero = d.t(np.zeros(1, np.int32))
    return Case((d.t(s), x), lambda f, s, x: f(x, zero, zero, p=g.p, q=g.q),
                lambda: x.view(g.p, 4, g.q, 12).permute(1, 0, 3, 2).reshape(g.w, g.cw),
                "permute(1, 0, 3, 2) made contiguous")


def _stage1(g: Geometry, d: Draw, flips: bool) -> Case:
    """P24 (oy = 0, ox, flips) and P31 (oy, ox, no flip): u8 images."""
    oy = np.zeros(g.b, np.int32) if flips else d.ints(g.b, g.h - g.w)
    ox = d.ints(g.b, (g.l - g.cw) // 3)
    x = d.u8((g.b, g.h, g.l))
    kw = dict(p=g.p, q=g.q)
    if flips:
        fl = d.ints(g.b, 1)
        return Case((d.t(oy), d.t(ox), d.t(fl), x),
                    lambda f, oy, ox, fl, x: f(x, oy, ox, fl, **kw), None, "none")
    return Case((d.t(oy), d.t(ox), x), lambda f, oy, ox, x: f(x, oy, ox, None, **kw), None,
                "none")


G1, G2, G3, G4 = (f"tools/r5_probe_gather{n}.py" for n in ("", "2", "3", "4"))
_I = lambda g: (g.h, g.l)  # noqa: E731  (the wave-1 and -2 value block)
_C = lambda g: (g.w, g.cw)  # noqa: E731  (the wave-3 and -4 value block)

PROBES: List[Probe] = [
    Probe("P1", 15, f"{G1}:86 p1", "crop_window", _rows, per_image=True),
    Probe("P2", 16, f"{G1}:107 p2", "relayout", lambda g, d: _roll(g, d, 0, True)),
    Probe("P3", 16, f"{G1}:107 p3", "relayout", lambda g, d: _roll(g, d, 1, True)),
    Probe("P4", 16, f"{G1}:107 p4", "relayout", lambda g, d: _map(
        g, d, [Dim(g.p, 4 * g.l), Dim(g.l, 1)],
        library=lambda x, s0: x[0:g.w:4].contiguous(), library_name="x[0:224:4].contiguous()")),
    Probe("P5", 16, f"{G1}:107 p5", "relayout", lambda g, d: _map(
        g, d, [Dim(4, g.l), Dim(g.h // 4, 4 * g.l), Dim(g.l, 1)], shape=_I(g),
        library=lambda x, s0: x.view(g.h // 4, 4, g.l).permute(1, 0, 2).reshape(_I(g)),
        library_name="permute(1, 0, 2) made contiguous")),
    Probe("P6", 16, f"{G1}:107 p6", "relayout", lambda g, d: _map(
        g, d, [Dim(g.h // 4, 4 * g.l), Dim(g.l, 1)], base=g.l,
        library=lambda x, s0: x.view(g.h // 4, 4, g.l)[:, 1].contiguous(),
        library_name="x[:, 1] of a (64, 4, L) view made contiguous")),
    Probe("P7", 16, f"{G1}:107 p7", "crop_window", lambda g, d: _block_rows(g, d, g.h - g.w)),
    Probe("P2b", 16, f"{G1}:107 p2b", "relayout", lambda g, d: _roll(g, d, 0, False)),
    Probe("P3b", 16, f"{G1}:107 p3b", "relayout", lambda g, d: _roll(g, d, 1, False)),
    Probe("P8", 16, f"{G1}:107 p8", "crop_window",
          lambda g, d: _block_rows(g, d, (g.h - g.w) // 8, mult=8)),
    Probe("P9", 16, f"{G1}:107 p9", "crop_window",
          lambda g, d: _static_window(g, d, g.w, g.l, row_base=3)),
    Probe("P10", 16, f"{G1}:107 p10", "crop_window",
          lambda g, d: _static_window(g, d, g.h, 128, col_base=5)),
    Probe("P1-fix", 17, f"{G2}:73 p1_fix", "crop_window", _rows, per_image=True),
    Probe("P13b", 18, f"{G2}:104 p13b", "crop_window", _cols, per_image=True),
    Probe("P14a", 19, f"{G2}:126 p14a", "relayout", _scale_u8, ops=1),
    Probe("P14b", 19, f"{G2}:126 p14b", "relayout", _scale_u8, ops=1),
    Probe("P15a", 19, f"{G2}:126 p15a", "relayout", lambda g, d: _map(
        g, d, [Dim(g.h, g.l), Dim(g.l, -1)], base=g.l - 1,
        library=lambda x, s0: torch.flip(x, [1]), library_name="torch.flip")),
    Probe("P15b", 19, f"{G2}:126 p15b", "relayout", lambda g, d: _map(
        g, d, [Dim(g.h, -g.l), Dim(g.l, 1)], base=(g.h - 1) * g.l,
        library=lambda x, s0: torch.flip(x, [0]), library_name="torch.flip")),
    Probe("P15c", 19, f"{G2}:126 p15c", "relayout", lambda g, d: _map(
        g, d, [Dim(g.h // 4, -4 * g.l), Dim(4, g.l), Dim(g.l, 1)], shape=_I(g),
        base=(g.h // 4 - 1) * 4 * g.l,
        library=lambda x, s0: torch.flip(x.view(g.h // 4, 4, g.l), [0]).view(_I(g)),
        library_name="torch.flip")),
    Probe("P16", 19, f"{G2}:126 p16", "relayout", lambda g, d: _map(
        g, d, [Dim(4, g.h // 4 * g.l), Dim(g.l, 1), Dim(g.h // 4, g.l)],
        shape=(4 * g.l, g.h // 4),
        library=lambda x, s0: x.view(4, g.h // 4, g.l).permute(0, 2, 1).reshape(4 * g.l, -1),
        library_name="permute(0, 2, 1) made contiguous")),
    Probe("P17a", 20, f"{G2}:181 p17a", "relayout", lambda g, d: _map(
        g, d, [Dim(g.h, g.l), Dim(g.l, 1)], in_shape=(2, g.h // 2, 8, g.l // 8),
        library=lambda x, s0: x.clone().view(_I(g)), library_name="clone")),
    Probe("P18", 19, f"{G2}:126 p18", "crop_window", lambda g, d: _block_cols(g, d, "zero")),
    Probe("P19", 19, f"{G2}:126 p19", "relayout", lambda g, d: _map(
        g, d, [Dim(g.h, g.l), Dim(g.l, 1)], epilogue="row_flag_col0"), ops=2),
    Probe("P20", 19, f"{G2}:126 p20", "relayout", _probe_p20),
    Probe("P21", 19, f"{G2}:126 p21", "crop_deinterleave", _crop_block),
    Probe("P1c", 21, f"{G3}:78 p1c", "crop_window", _rows, per_image=True),
    Probe("P23", 22, f"{G3}:101 p23", "crop_window", lambda g, d: _rows(g, d, mult=8),
          per_image=True),
    Probe("P20b", 23, f"{G3}:122 p20b", "relayout", lambda g, d: _flip_qcp(g, d, False)),
    Probe("P22", 24, f"{G3}:178 p22", "relayout", lambda g, d: _flip_qcp(g, d, True)),
    Probe("P19b", 23, f"{G3}:122 p19b", "relayout", lambda g, d: _map(
        g, d, [Dim(g.w, g.cw), Dim(g.cw, 1)], in_shape=_C(g), s_hi=g.w,
        epilogue="row_below_s"), ops=2),
    Probe("P24", 25, f"{G3}:229 p24", "crop_deinterleave", lambda g, d: _stage1(g, d, True),
          per_image=True, ops=2),
    Probe("P25a", 26, f"{G4}:69 p25a", "relayout", lambda g, d: _map(
        g, d, [Dim(g.w, g.cw), Dim(g.cw, 1)], in_shape=_C(g), epilogue="antidiagonal", k=g.q)),
    Probe("P25b", 26, f"{G4}:69 p25b", "relayout", lambda g, d: _map(
        g, d, [Dim(g.w, g.cw), Dim(12, g.q), Dim(g.q, -1)], base=g.q - 1, shape=_C(g),
        in_shape=_C(g), library=lambda x, s0: torch.flip(x.view(g.w, 12, g.q), [2]).view(_C(g)),
        library_name="torch.flip")),
    Probe("P25c", 26, f"{G4}:69 p25c", "relayout", lambda g, d: _map(
        g, d, [Dim(g.w, g.cw), Dim(4, -3 * g.q), Dim(3, g.q), Dim(g.q, 1)], base=9 * g.q,
        shape=_C(g), in_shape=_C(g),
        library=lambda x, s0: torch.flip(x.view(g.w, 4, 3, g.q), [1]).view(_C(g)),
        library_name="torch.flip")),
    Probe("P25d", 26, f"{G4}:69 p25d", "relayout", lambda g, d: _map(
        g, d, [Dim(g.w, g.cw), Dim(g.q, 1), Dim(12, g.q)], shape=_C(g), in_shape=_C(g),
        library=lambda x, s0: x.view(g.w, 12, g.q).permute(0, 2, 1).reshape(_C(g)),
        library_name="permute(0, 2, 1) made contiguous")),
    Probe("P26", 27, f"{G4}:141 p26", "crop_window",
          lambda g, d: _block_rows(g, d, 3, select=3)),
    Probe("P27", 28, f"{G4}:157 p27", "crop_window", lambda g, d: _block_rows(g, d, g.h - g.w)),
    Probe("P28", 28, f"{G4}:157 p28", "crop_window", _block_cols),
    Probe("P30", 26, f"{G4}:69 p30", "relayout", lambda g, d: _map(
        g, d, [Dim(g.cw, 1), Dim(g.w, g.cw)], in_shape=_C(g),
        library=lambda x, s0: x.t().contiguous(), library_name="t() made contiguous")),
    Probe("P31", 29, f"{G4}:219 p31", "crop_deinterleave", lambda g, d: _stage1(g, d, False),
          per_image=True, ops=2),
]
#: the TPU sites of each kernel's rows, for the kernels line of chip_smoke.py
SITES = {k: sorted({p.site.split()[0] for p in PROBES if p.kernel == k},
                   key=lambda s: (s.split(":")[0], int(s.split(":")[1]))) for k in KERNELS}


# -- edge geometries: every branch of the three gather kernels ----------------------


class Edge(NamedTuple):
    """A geometry that no sub-probe reaches, for the card's bit-for-bit
    checks (chip_smoke.py phase 12a, tests/test_torch_port_kernels.py)."""
    name: str
    kernel: str  # crop_window, relayout or crop_deinterleave
    build: Callable[[Draw], Case]


def _windows(b: int, h: int, w: int, rows: int, cols: int, u8: bool, col_off) -> Callable:
    """b images, their column origins col_off (an origin past w - cols
    leaves the input: zeros), row origins drawn."""
    def build(d: Draw) -> Case:
        x = (d.u8 if u8 else d.bf16)((b, h, w))
        oy, ox = d.t(d.ints(b, h - rows)), d.t(np.asarray(col_off, np.int32))
        return Case((oy, ox, x), lambda f, oy, ox, x: f(x, rows, cols, row_off=oy, col_off=ox,
                                                         outside="zero"), None, "none")
    return build


def _edge_map(in_shape, dims, *, base=0, s0=0, epilogue="copy", u8=False, scale=0.5,
              k=0) -> Callable:
    def build(d: Draw) -> Case:
        x = (d.u8 if u8 else d.bf16)(in_shape)
        s = d.t(np.array([s0] + [0] * (S_LEN - 1), np.int32))
        return Case((s, x), lambda f, s, x: f(x, dims, base=base, s=s, epilogue=epilogue,
                                              scale=scale, k=k), None, "none")
    return build


def _crops(h: int, l: int, p: int, q: int, oy, ox, fl=None, u8: bool = True) -> Callable:
    """len(ox) images of h x l, image i cropped to 4p x 12q from row oy[i]
    and pixel ox[i] (NaN where the crop leaves it), flipped by fl (None:
    no flags)."""
    def build(d: Draw) -> Case:
        x = (d.u8 if u8 else d.bf16)((len(ox), h, l))
        oy_, ox_ = (d.t(np.asarray(v, np.int32)) for v in (oy, ox))
        kw = dict(p=p, q=q)
        if fl is None:
            return Case((oy_, ox_, x), lambda f, oy, ox, x: f(x, oy, ox, None, **kw), None,
                        "none")
        fl_ = d.t(np.asarray(fl, np.int32))
        return Case((oy_, ox_, fl_, x), lambda f, oy, ox, fl, x: f(x, oy, ox, fl, **kw), None,
                    "none")
    return build


def _origins(n: int):
    """n images' (oy, ox, fl): crop origins 0..16 in turn (3 ox mod 16 takes
    all 16 values; 16 is flush with the right edge of the edges' images),
    rows 0 and 1 in turn (1 flush with the bottom), then a crop that leaves
    the input on the right and one at the bottom; flags -1, 0, 1, 2."""
    return ([i % 2 for i in range(n - 2)] + [0, 2], [i % 17 for i in range(n - 2)] + [17, 0],
            [i % 4 - 1 for i in range(n)])


_OY, _OX, _FL = _origins(19)
#: 66 and 44 images: on a card of up to 132 SMs, items of 16 and 8 of the
#: 20 crop rows (the last item 4 rows)
_OY66, _OX66, _FL66 = _origins(66)
_OY44, _OX44, _ = _origins(44)

EDGES: List[Edge] = [
    # crop_window: column origins of 0-15 elements (one image each), a row
    # of 261 elements (522 bytes, 261 bytes: no multiple of 16), an origin
    # that leaves the input, rows shorter than a word, B = 1
    Edge("column origins 0-15, bf16", "crop_window",
         _windows(17, 20, 300, 17, 261, False, list(range(16)) + [40])),
    Edge("column origins 0-15, u8", "crop_window",
         _windows(17, 20, 300, 17, 261, True, list(range(16)) + [40])),
    Edge("rows of 5 u8", "crop_window", _windows(4, 9, 30, 6, 5, True, [0, 3, 25, 26])),
    Edge("rows of 7 bf16", "crop_window", _windows(4, 9, 30, 6, 7, False, [0, 9, 23, 24])),
    Edge("B = 1", "crop_window", _windows(1, 256, 768, 224, 672, False, [31])),
    # relayout, run: a roll that splits a run of 203, in bf16 and u8
    Edge("roll splits a run, bf16", "relayout", _edge_map(
        (37, 203), [Dim(37, 203, roll_by_s=True), Dim(203, 1, roll=77)], s0=9)),
    Edge("roll by s splits a run, u8", "relayout", _edge_map(
        (19, 333), [Dim(19, 333), Dim(333, 1, roll_by_s=True)], s0=-100, u8=True)),
    # run reverse: runs of 203 (no multiple of 8 or 16), copy and u8 -> bf16
    Edge("reversed runs of 203, bf16", "relayout", _edge_map(
        (45, 203), [Dim(45, 203), Dim(203, -1)], base=202)),
    Edge("reversed runs of 203, u8", "relayout", _edge_map(
        (45, 203), [Dim(45, 203), Dim(203, -1, roll=5)], base=202, u8=True)),
    Edge("reversed runs of 203, u8 -> bf16", "relayout", _edge_map(
        (45, 203), [Dim(45, 203), Dim(203, -1)], base=202, u8=True, epilogue="scale_u8")),
    Edge("mirror and roll by s, s[0] = 3", "relayout", _edge_map(
        (45, 203), [Dim(45, 203), Dim(203, 1, roll_by_s=True, mirror_if_s=True)], s0=3)),
    Edge("mirror by s, s[0] = 0", "relayout", _edge_map(
        (45, 203), [Dim(45, 203, mirror_if_s=True), Dim(203, 1, mirror_if_s=True)])),
    Edge("u8 -> bf16 from an odd base", "relayout", _edge_map(
        (3, 1001), [Dim(2, 1001), Dim(997, 1)], base=3, u8=True, epilogue="scale_u8")),
    Edge("rank 4, a last partial word, u8", "relayout", _edge_map(
        (3, 5, 7, 11), [Dim(3, 385), Dim(7, 11), Dim(5, 77), Dim(11, 1)], u8=True)),
    # tile: ragged edges on both tile dims, the unit-stride dim first,
    # mirrored by s and the innermost dim rolled
    Edge("transpose of 45 x 203", "relayout", _edge_map(
        (45, 203), [Dim(203, 1), Dim(45, 203)])),
    Edge("tile, unit dim first, mirror and roll", "relayout", _edge_map(
        (5, 45, 37), [Dim(37, 1, mirror_if_s=True), Dim(5, 45 * 37), Dim(45, 37, roll=4)], s0=2)),
    Edge("tile, u8", "relayout", _edge_map(
        (45, 203), [Dim(203, 1), Dim(45, 203)], u8=True)),
    # the row epilogues through the tile (dim 0 the unit dim) and on one dim
    Edge("row below s, tile", "relayout", _edge_map(
        (45, 203), [Dim(203, 1), Dim(45, 203)], s0=100, epilogue="row_below_s")),
    Edge("row flag, tile", "relayout", _edge_map(
        (45, 203), [Dim(203, 1), Dim(45, 203)], epilogue="row_flag_col0")),
    Edge("row below s, one dim", "relayout", _edge_map(
        (300,), [Dim(300, 1)], s0=100, epilogue="row_below_s")),
    Edge("row flag, dim 0 of size 1", "relayout", _edge_map(
        (100,), [Dim(1, 50), Dim(50, 1)], epilogue="row_flag_col0")),
    # no dim steps by +-1: the run route, element by element
    Edge("no unit stride", "relayout", _edge_map((34, 7), [Dim(30, 7), Dim(11, 3)])),
    Edge("size-1 dims", "relayout", _edge_map(
        (40, 3), [Dim(1, 5), Dim(40, 3), Dim(1, 3), Dim(3, 1)])),
    # the anti-diagonal on one dim and on four
    Edge("antidiagonal, one dim", "relayout", _edge_map(
        (1,), [Dim(40, 0)], epilogue="antidiagonal", k=31)),
    Edge("antidiagonal, four dims", "relayout", _edge_map(
        (1,), [Dim(9, 0), Dim(3, 0), Dim(2, 0), Dim(21, 0)], epilogue="antidiagonal", k=9)),
    # crop_deinterleave: every byte offset of the crop's origin, u8 and
    # bf16, flips on and off, q % 8 == 0 (whole 16-byte words), another
    # even q (words across two cpc) and odd q (2-byte stores), items of one
    # crop row (few images) and of several with the last one short, crops
    # flush with the right and bottom edges and crops outside, B = 1, and
    # rows of 15,600 elements
    Edge("crop origins 0-16, q = 8, p = 3, u8, flips", "crop_deinterleave",
         _crops(13, 144, 3, 8, _OY, _OX, _FL)),
    Edge("crop origins 0-16, q = 8, p = 3, bf16, flips", "crop_deinterleave",
         _crops(13, 144, 3, 8, _OY, _OX, _FL, u8=False)),
    Edge("crop origins 0-16, q = 7, p = 5, u8, flips", "crop_deinterleave",
         _crops(22, 132, 5, 7, [2 * y for y in _OY], _OX, _FL)),
    Edge("crop origins 0-16, q = 7, p = 2, bf16", "crop_deinterleave",
         _crops(9, 132, 2, 7, _OY, _OX, u8=False)),
    Edge("crop origins 0-16, q = 10, p = 3, u8", "crop_deinterleave",
         _crops(13, 168, 3, 10, _OY, _OX)),
    Edge("66 images, items of 16 rows and 4, q = 8, u8, flips", "crop_deinterleave",
         _crops(21, 144, 5, 8, _OY66, _OX66, _FL66)),
    Edge("44 images, items of 8 rows and 4, q = 7, bf16", "crop_deinterleave",
         _crops(21, 132, 5, 7, _OY44, _OX44, u8=False)),
    Edge("B = 1, crop flush right and bottom, u8, flip", "crop_deinterleave",
         _crops(256, 768, 56, 56, [32], [32], [1])),
    Edge("q = 1300, u8, flips", "crop_deinterleave",
         _crops(13, 15609, 3, 1300, [0, 1, 0], [0, 3, 4], [1, 0, 1])),
    Edge("q = 1300, bf16, flips", "crop_deinterleave",
         _crops(9, 15609, 2, 1300, [1, 0, 2], [3, 0, 0], [0, 1, 1], u8=False)),
]


def run_edge(edge: Edge, case: Case, impl: str = "kernel") -> torch.Tensor:
    return case.call(KERNELS[edge.kernel][impl == "plain"], *case.args)


def run(probe: Probe, case: Case, impl: str = "kernel") -> torch.Tensor:
    """The probe's function on the case's arguments through its kernel's
    wrapper ("kernel") or plain version ("plain")."""
    return case.call(KERNELS[probe.kernel][impl == "plain"], *case.args)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Array-equal bit for bit (NaN payloads and the sign of zero
    included), shapes and dtypes too."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in f32, NaN where both are NaN counting as equal, one
    NaN as infinite."""
    a, b = a.float(), b.float()
    both = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both, torch.zeros((), device=a.device), (a - b).abs())
    diff = torch.nan_to_num(diff, nan=float("inf"))
    return diff.max().item() if diff.numel() else 0.0


def bound(out: torch.Tensor, case: Case, probe: Probe):
    """(bytes, ms, "bytes" or "operations"): the output written once, the
    input elements it needs read once (none for the one-hot), the offsets;
    operations over the card's f32 rate."""
    x = case.args[-1]
    reads = 0 if probe.name == "P25a" else out.numel() * x.element_size()
    offsets = sum(a.numel() * a.element_size() for a in case.args[:-1])
    nbytes = out.numel() * out.element_size() + reads + offsets
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = probe.ops * out.numel() / F32_OPS_PER_S * 1e3
    return nbytes, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _ms(fn, device: torch.device, calls: int) -> float:
    if device.type == "cuda":
        return card.device_ms(fn, k=calls)
    return card.host_ms(fn, device, iters=calls, warmup=WARMUP)


def measure(probe: Probe, g: Geometry, device: torch.device, calls: int, seed: int,
            facts: Dict, batch: Optional[int] = None) -> Dict:
    """One line: the sub-probe at geometry g."""
    case = probe.build(g, Draw(device, seed))
    before = ops.launch_counts()
    out = run(probe, case)
    err = max_abs_err(out, run(probe, case, "plain"))
    ms = _ms(lambda: run(probe, case), device, calls)
    plain_ms = _ms(lambda: run(probe, case, "plain"), device, calls)
    library_ms = None if case.library is None else _ms(case.library, device, calls)
    after = ops.launch_counts()
    nbytes, bound_ms, bound_by = bound(out, case, probe)
    return {
        "metric": "gather_probe", "probe": probe.name, "row": probe.row, "site": probe.site,
        "kernel": probe.kernel, "batch": batch,
        "in_shapes": [list(a.shape) for a in case.args], "in_dtype": str(case.args[-1].dtype),
        "out_shape": list(out.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library": case.library_name, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "calls": calls,
        "launches": {k: after[k] - before[k] for k in after}, **facts,
    }


def versus_jitter_s2d(device: torch.device, batch: int, calls: int, seed: int,
                      facts: Dict) -> Dict:
    """crop_deinterleave with flips against jitter_s2d's train form on the
    same uint8 images and crops."""
    d = Draw(device, seed)
    g = PROBE._replace(b=batch)
    x = d.u8((g.b, g.h, g.l))
    oy, ox, fl = (d.t(d.ints(g.b, hi)) for hi in (g.h - g.w, (g.l - g.cw) // 3, 1))
    flips = fl.bool()
    mean = torch.full((3,), gather.SHIFT, dtype=torch.float32, device=device)
    x4 = x.view(g.b, g.h, g.l // 3, 3)
    before = ops.launch_counts()
    stage1_ms = _ms(lambda: crop_deinterleave(x, oy, ox, fl), device, calls)
    s2d_ms = _ms(lambda: jitter_s2d(x4, oy, ox, flips, crop=g.w, kernel=11, stride=4,
                                    scale=gather.SCALE, mean=mean), device, calls)
    after = ops.launch_counts()
    return {
        "metric": "crop_deinterleave_vs_jitter_s2d", "batch": batch,
        "crop_deinterleave_ms": stage1_ms, "jitter_s2d_train_ms": s2d_ms,
        "ratio": stage1_ms / s2d_ms, "calls": calls,
        "launches": {k: after[k] - before[k] for k in after}, **facts,
    }


def traced(fn: Callable[[], object], calls: int, tries: int = 8) -> Tuple[Dict, int]:
    """The card's activities over `calls` calls of fn under torch.profiler
    (CUDA activity alone): by name, their count a call and mean µs. Their
    durations leave out the gaps between them that device_ms includes. A
    trace that holds fewer activities than calls (the profiler dropped
    some, or all: it has returned an empty trace now and then on the
    card) is taken again after a pause that grows with each try, up to
    `tries` traces. Returns the activities and the traces it took; raises
    RuntimeError if none holds them all."""
    import os
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for t in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)  # let CUPTI hand over the records before the flush
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        acts: Dict[str, List[float]] = {}
        for ev in events:
            if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                a = acts.setdefault(ev.get("name", ""), [0, 0.0])
                a[0] += 1
                a[1] += float(ev.get("dur", 0))
        if sum(n for n, _ in acts.values()) >= calls:
            return {name: {"per_call": n / calls, "mean_us": d / n}
                    for name, (n, d) in acts.items()}, t
        time.sleep(0.05 * t)
    raise RuntimeError(f"torch.profiler traced {sum(n for n, _ in acts.values())} device "
                       f"activities over {calls} calls in each of {tries} tries")


def probe_lines(device: torch.device, batch: int = BATCH, calls: int = 20, seed: int = 0,
                trace: bool = False, names: Optional[List[str]] = None) -> List[Dict]:
    """Every sub-probe's lines, or only those of `names` (then without the
    last line); with `trace`, on the card, each single-block line also
    holds `trace`: the kernel's and the library call's device activities
    (traced) and the traces they took."""
    facts = card.device_facts(device)
    unknown = set(names or ()) - {p.name for p in PROBES}
    if unknown:
        raise ValueError(f"no sub-probe {sorted(unknown)}")
    probes = [p for p in PROBES if names is None or p.name in names]
    lines = []
    for p in probes:
        line = measure(p, PROBE, device, calls, seed, facts)
        if trace and device.type == "cuda":
            case = p.build(PROBE, Draw(device, seed))
            kernel, tries = traced(lambda: run(p, case), calls)
            library, more = traced(case.library, calls) if case.library else (None, 0)
            line["trace"] = {"kernel": kernel, "library": library, "tries": tries + more}
        lines.append(line)
    for p in probes:
        if p.per_image:
            lines.append(measure(p, PROBE._replace(b=batch), device, calls, seed, facts, batch))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if names is None:
        lines.append(versus_jitter_s2d(device, batch, calls, seed, facts))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calls", type=int, default=20,
                   help="calls a timed run (on the card: queued behind one spin)")
    p.add_argument("--batch", type=int, default=BATCH,
                   help="images of the per-image probes' second line and of the last line")
    p.add_argument("--trace", action="store_true",
                   help="on the card, also trace each single-block line's kernel and library "
                        "call with torch.profiler (their device activities, gaps left out)")
    p.add_argument("--probes", metavar="P21,P24",
                   help="only these sub-probes (comma-separated), without the last line")
    add_device_argument(p)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    names = a.probes.split(",") if a.probes else None
    for line in probe_lines(dev, a.batch, a.calls, a.seed, a.trace, names):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
