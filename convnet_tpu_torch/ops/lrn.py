"""Cross-map response normalization (AlexNet LRN), forward only.

Counterpart of `convnet_tpu/ops/lrn.py`:

    n         = max(1, round(frac_of_filters * C))
    window(i) = [i - n//2, i + (n-1)//2] clipped, or the size-n block of i
    x         = relu(z + b)          (bias and relu optional)
    y_i       = x_i * (1 + (add_scale/n) * sum_{j in window(i)} x_j^2)^(-pow_scale)

over the channel (last) axis, math in f32, output in the input's dtype.

`lrn_fwd` is the wrapper of the CUDA kernel `csrc/lrn_fwd.cu`, which
replaces the TPU kernels `_lrn_fwd_kernel` (lrn.py:212) and
`_lrn_fwd_kernel_r` (lrn.py:535). For a CPU tensor the wrapper runs the
kernel's plain PyTorch version, `_fwd_math`; for a CUDA tensor it
launches the kernel or raises. It is forward-only: no autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def norm_window_size(num_channels: int, frac: float) -> int:
    return max(1, int(round(frac * num_channels)))


def quarter_power(beta: float) -> int:
    """4*beta when beta is a quarter-integer in (0, 4], else 0: the case
    `_neg_pow` (and the kernel) build from reciprocal/rsqrt/sqrt."""
    q = round(4 * beta)
    return q if abs(4 * beta - q) <= 1e-9 and 0 < q <= 16 else 0


def _neg_pow(d: torch.Tensor, beta: float) -> torch.Tensor:
    """d ** (-beta) for d > 0, as `convnet_tpu/ops/lrn.py:_neg_pow`
    composes it: quarter-integer exponents from 1/d, rsqrt and sqrt, so
    that the rounding follows the reference's; others from pow."""
    q = quarter_power(beta)
    if q == 0:
        return torch.pow(d, -beta)
    out = None
    k, rem = divmod(q, 4)
    if k:
        inv = 1.0 / d
        out = inv
        for _ in range(k - 1):
            out = out * inv
    r = torch.rsqrt(d) if rem else None
    if rem >= 2:
        out = r if out is None else out * r
        rem -= 2
    if rem:
        qr = torch.sqrt(r)
        out = qr if out is None else out * qr
    return out


def _window_sum(v: torch.Tensor, n: int, blocked: bool) -> torch.Tensor:
    """Sum over each channel's window, by shifted adds over the last axis."""
    c = v.shape[-1]
    if blocked:
        if c % n == 0:
            blocks = v.reshape(*v.shape[:-1], c // n, n).sum(-1, keepdim=True)
            return blocks.expand(*v.shape[:-1], c // n, n).reshape(v.shape)
        i = torch.arange(c, device=v.device)
        band = ((i[:, None] // n) == (i[None, :] // n)).to(v.dtype)
        return v @ band  # blocked windows are symmetric
    vp = F.pad(v, (n // 2, (n - 1) // 2))
    s = vp[..., 0:c]
    for k in range(1, n):
        s = s + vp[..., k : k + c]
    return s


def _fwd_math(
    z: torch.Tensor,
    n: int,
    alpha: float,
    beta: float,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    blocked: bool = False,
) -> torch.Tensor:
    """The kernel's plain version (`convnet_tpu/ops/lrn.py:_fwd_math` plus
    the fused f32 bias add), on (..., C)."""
    x = z.float()
    if bias is not None:
        x = x + bias.float()
    if relu:
        x = torch.relu(x)
    d = 1.0 + alpha * _window_sum(x * x, n, blocked)
    return (x * _neg_pow(d, beta)).to(z.dtype)


def lrn_fwd(
    z: torch.Tensor,
    n: int,
    alpha: float,
    beta: float,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    blocked: bool = False,
) -> torch.Tensor:
    """Response norm over the rows of z: (M, C) contiguous, bf16 or f32;
    bias: f32 (C,) or None. Forward-only."""
    if z.dim() != 2:
        raise ValueError(f"lrn_fwd takes (M, C) rows, got shape {tuple(z.shape)}")
    m, c = z.shape
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    if z.device.type == "cpu":
        return _fwd_math(z, n, alpha, beta, bias, relu, blocked)
    if z.device.type != "cuda":
        raise ValueError(f"lrn_fwd: no kernel for device {z.device}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lrn_fwd: dtype {z.dtype} (bf16 or f32 only)")
    if not z.is_contiguous():
        raise ValueError("lrn_fwd: z must be contiguous")
    if bias is not None and (
        bias.dtype != torch.float32 or bias.device != z.device or not bias.is_contiguous()
    ):
        raise TypeError("lrn_fwd: bias must be a contiguous f32 tensor on z's device")
    y = torch.empty_like(z)
    if m == 0:
        return y
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(z.device):
        rc = _build.library().cn_lrn_fwd(
            z.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(),
            m, c, int(z.dtype == torch.bfloat16), int(relu), int(blocked), n,
            alpha, beta, quarter_power(beta),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _build.check(rc, "lrn_fwd")
    LAUNCHES += 1
    return y


def response_norm_reference(
    x: torch.Tensor,
    add_scale: float,
    pow_scale: float,
    frac_of_filters: float,
    blocked: bool = False,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch response norm over the last axis of x (any device):
    what `response_norm_cross_map_bias` computes, without the kernel."""
    n = norm_window_size(x.shape[-1], frac_of_filters)
    return _fwd_math(x, n, add_scale / n, float(pow_scale), bias, relu, blocked)


def response_norm_cross_map(
    x: torch.Tensor,
    add_scale: float,
    pow_scale: float,
    frac_of_filters: float,
    blocked: bool = False,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """LRN over the channel (last) axis of x, e.g. NHWC. fuse_relu treats
    x as the pre-activation and applies max(x, 0) in the kernel."""
    return response_norm_cross_map_bias(
        x, None, add_scale, pow_scale, frac_of_filters, blocked, fuse_relu
    )


def response_norm_cross_map_bias(
    x: torch.Tensor,
    b: Optional[torch.Tensor],
    add_scale: float,
    pow_scale: float,
    frac_of_filters: float,
    blocked: bool = False,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """response_norm_cross_map(x + b), the (C,) bias added in f32 inside
    the kernel: x is the producing conv's output without its bias, which
    the model defers here (convnet_tpu/model.py:287-303)."""
    c = x.shape[-1]
    n = norm_window_size(c, frac_of_filters)
    if b is not None:
        b = b.to(device=x.device, dtype=torch.float32).contiguous()
    y = lrn_fwd(
        x.reshape(-1, c), n, add_scale / n, float(pow_scale),
        bias=b, relu=fuse_relu, blocked=blocked,
    )
    return y.view(x.shape)
