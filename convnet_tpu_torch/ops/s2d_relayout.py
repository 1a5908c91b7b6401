"""The input prologue: raw uint8 batch -> the first conv's S2DInput.

Counterpart of `convnet_tpu/ops/s2d_relayout.py` (`jitter_s2d`) and of the
gate in `convnet_tpu/ops/prologue.py` (`prologue_plan`). For a strided
first conv the crop, flip, scale/mean/std affine, ceil-mode zero pad and
space-to-depth run as one pass, `s2d_prologue`, whose CUDA kernel
(`csrc/s2d_prologue.cu`) replaces the TPU kernel `_relayout_kernel`
(s2d_relayout.py:200) and the one-hot crop einsums that feed it. For a
CPU tensor the wrapper runs the plain PyTorch version,
`s2d_prologue_reference`; for a CUDA tensor it launches the kernel or
raises. Both are bit-exact with the JAX package's `jitter_s2d`.
"""

from __future__ import annotations

from typing import Optional

import torch

from convnet_tpu_torch.graph import ET, conv_out_size
from convnet_tpu_torch.ops.conv import S2DInput

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0

# The folded channel count s*s*Cin the space-to-depth route accepts: the
# JAX package's gate (ops/conv.py _MIN_CIN, _S2D_MAX_FOLDED_CIN), kept so
# both packages take the route for the same models.
_MIN_FOLDED_CIN = 16
_MAX_FOLDED_CIN = 128


def relayout_geometry(crop: int, kernel: int, stride: int) -> int:
    """P, the side of the space-to-depth grid, ceil-mode pad included
    (57 for AlexNet: crop 224, kernel 11, stride 4). The JAX function also
    returns P rounded up to 16 for the TPU's tiles; nothing here needs it."""
    p_out = conv_out_size(crop, kernel, stride, 0)
    khp = -(-kernel // stride) * stride
    return ((p_out - 1) * stride + khp) // stride


def prologue_plan(graph, layer_name: str):
    """The conv edge the prologue can feed from input layer `layer_name`,
    or None: bf16 compute, a single consumer that is a CONV with stride > 1,
    padding 0 and a folded channel count in the space-to-depth range."""
    if graph.compute_dtype != "bfloat16":
        return None
    consumers = [e for e in graph.edges if e.source == layer_name]
    if len(consumers) != 1:
        return None
    e = consumers[0]
    cin = graph.shapes[layer_name][2]
    if (
        e.edge_type != ET.CONV
        or e.num_groups != 1
        or e.stride <= 1
        or e.padding != 0
        or not (_MIN_FOLDED_CIN <= cin * e.stride * e.stride <= _MAX_FOLDED_CIN)
    ):
        return None
    return e


def s2d_prologue_reference(
    x: torch.Tensor,
    oy: torch.Tensor,
    ox: torch.Tensor,
    flips: Optional[torch.Tensor],
    *,
    crop: int,
    stride: int,
    p: int,
    scale: float = 1.0,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): bf16 (B, P, P,
    s*s*C) from uint8 (B, H, W, C). See `s2d_prologue`."""
    b, h, w, c = x.shape
    s = stride
    dev = x.device
    t = torch.arange(p * s, device=dev).view(p, s)  # t[p, phase] = s*p + phase
    valid = t < crop
    tc = t.clamp(max=crop - 1)
    rows = oy.long().view(b, 1, 1) + tc  # (B, P, s)
    cols = tc.expand(b, p, s)
    if flips is not None:
        cols = torch.where(flips.bool().view(b, 1, 1), crop - 1 - cols, cols)
    cols = ox.long().view(b, 1, 1) + cols
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    # (B, P, s, P, s, C): [b, p, rp, q, cp, :] = x[b, row(p, rp), col(q, cp), :]
    v = x[bi, rows.view(b, p, s, 1, 1), cols.view(b, 1, 1, p, s)].float()
    if scale != 1.0:
        # a fill on the device: torch.tensor(scale, device=dev) would copy
        # from pageable memory and wait for the card
        v = v * torch.full((), scale, dtype=torch.float32, device=dev)
    if mean is not None:
        v = v - mean.float()
    if std is not None:
        v = v / std.float()
    mask = valid.view(1, p, s, 1, 1, 1) & valid.view(1, 1, 1, p, s, 1)
    v = torch.where(mask, v, torch.zeros((), device=dev))
    return v.permute(0, 1, 3, 2, 4, 5).reshape(b, p, p, s * s * c).to(torch.bfloat16)


def s2d_prologue(
    x: torch.Tensor,
    oy: torch.Tensor,
    ox: torch.Tensor,
    flips: Optional[torch.Tensor],
    *,
    crop: int,
    stride: int,
    p: int,
    scale: float = 1.0,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Crop + flip + normalise + pad + space-to-depth, in one pass.

    x: uint8 (B, H, W, C) contiguous; oy, ox: int32 (B,) crop origins with
    0 <= oy <= H - crop, 0 <= ox <= W - crop; flips: (B,) bool or None;
    mean, std: f32 (C,) or None. Returns contiguous bf16 (B, P, P, s*s*C),
    channel order (row-phase, col-phase, cin): element (b, p, q, k) is
    cropped pixel (s*p + rp, s*q + cp), normalised as ((v*scale) - mean)
    / std in f32, or exactly 0 past the crop. Forward-only. For CPU
    tensors origins outside that range raise; on the card checking them
    would wait for the device, so the kernel writes NaN where a crop
    leaves the image instead of reading out of bounds."""
    if x.dim() != 4 or x.dtype != torch.uint8:
        raise TypeError(f"s2d_prologue: x must be uint8 (B,H,W,C), got {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    if crop > min(h, w):
        raise ValueError(f"crop {crop} larger than the {h}x{w} image")
    for name, v in (("mean", mean), ("std", std)):
        if v is not None and tuple(v.shape) != (c,):
            raise ValueError(f"s2d_prologue: {name} shape {tuple(v.shape)} != ({c},)")
    if x.device.type == "cpu":
        for name, o, lim in (("oy", oy, h - crop), ("ox", ox, w - crop)):
            if b and (int(o.min()) < 0 or int(o.max()) > lim):
                raise ValueError(f"s2d_prologue: {name} outside [0, {lim}]")
        return s2d_prologue_reference(
            x, oy, ox, flips, crop=crop, stride=stride, p=p, scale=scale, mean=mean, std=std
        )
    if x.device.type != "cuda":
        raise ValueError(f"s2d_prologue: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("s2d_prologue: x must be contiguous")
    for name, v, dt in (
        ("oy", oy, torch.int32), ("ox", ox, torch.int32),
        ("mean", mean, torch.float32), ("std", std, torch.float32),
    ):
        if v is not None and (v.dtype != dt or v.device != x.device or not v.is_contiguous()):
            raise TypeError(f"s2d_prologue: {name} must be contiguous {dt} on {x.device}")
    if oy.shape != (b,) or ox.shape != (b,):
        raise ValueError("s2d_prologue: oy and ox must have shape (B,)")
    if flips is not None:
        if flips.shape != (b,) or flips.device != x.device:
            raise ValueError("s2d_prologue: flips must be (B,) on x's device")
        # a bool tensor's bytes are 0 or 1: read them in place
        flips = (flips.view(torch.uint8) if flips.dtype == torch.bool
                 else flips.to(torch.uint8)).contiguous()
    out = torch.empty((b, p, p, stride * stride * c), dtype=torch.bfloat16, device=x.device)
    if b == 0:
        return out
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(x.device):
        rc = _build.library().cn_s2d_prologue(
            x.data_ptr(), oy.data_ptr(), ox.data_ptr(),
            None if flips is None else flips.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if std is None else std.data_ptr(),
            out.data_ptr(), b, h, w, c, crop, stride, p, scale,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "s2d_prologue")
    LAUNCHES += 1
    return out


def jitter_s2d(
    x: torch.Tensor,
    oy: torch.Tensor,
    ox: torch.Tensor,
    flips: Optional[torch.Tensor],
    *,
    crop: int,
    kernel: int,
    stride: int,
    scale: float = 1.0,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
) -> S2DInput:
    """Raw uint8 batch -> S2DInput for the first conv (kernel, stride):
    equal, element for element, to the center/jitter crop followed by the
    conv's own pad and space-to-depth."""
    p = relayout_geometry(crop, kernel, stride)
    xs = s2d_prologue(
        x, oy, ox, flips, crop=crop, stride=stride, p=p, scale=scale, mean=mean, std=std
    )
    return S2DInput(xs, stride)
