"""Cross-map response normalization (AlexNet LRN), forward and backward.

Counterpart of `convnet_tpu/ops/lrn.py`:

    n         = max(1, round(frac_of_filters * C))
    window(i) = [i - n//2, i + (n-1)//2] clipped, or the size-n block of i
    x         = relu(z + b)          (bias and relu optional)
    y_i       = x_i * (1 + (add_scale/n) * sum_{j in window(i)} x_j^2)^(-pow_scale)

over the channel (last) axis, math in f32, output in the input's dtype.

Two CUDA kernels, each with a wrapper and a plain PyTorch version:

- `lrn_fwd` (`csrc/lrn_fwd.cu`, plain `_fwd_math`) replaces the TPU
  kernels `_lrn_fwd_kernel` (lrn.py:212), `_lrn_fwd_kernel_r` (:535) and
  the opt-in t-form `_lrn_fwd_kernel_t` (:447);
- `lrn_bwd` (`csrc/lrn_bwd.cu`, plain `_bwd_math`) replaces their
  backward kernels `_lrn_bwd_kernel` (:230), `_lrn_bwd_kernel_r` (:558)
  and `_lrn_bwd_kernel_t` (:455): it recomputes d from z, masks by the
  fused ReLU and, with a bias, also returns db summed from the f32 dx.

For a CPU tensor a wrapper runs the plain version; for a CUDA tensor it
launches the kernel or raises. `response_norm_cross_map` and
`response_norm_cross_map_bias` are autograd Functions over the two: the
only residual is the bias-less conv output z (and b), as in the
reference's custom VJPs (lrn.py:885-917, 1068-1114).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: Launches of the CUDA kernels in this process (CPU calls do not count).
LAUNCHES = 0
BWD_LAUNCHES = 0


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


def _neg_pow_pair(d: torch.Tensor, beta: float):
    """(d^-beta, d^-(beta+1)) for d > 0, as `convnet_tpu/ops/lrn.py:
    _neg_pow_pair` builds them: for quarter-integer beta both are
    products of qr = sqrt(rsqrt(d)) = d^(-1/4), raised by squaring (qr^3
    and qr^7 for beta = 0.75), so the rounding follows the reference's."""
    q = quarter_power(beta)
    if q == 0:
        pb = _neg_pow(d, beta)
        return pb, pb / d
    qr = torch.sqrt(torch.rsqrt(d))

    def power(k: int) -> torch.Tensor:
        # left-to-right binary powering: power(k) = power(k//2)^2 (* qr)
        r = qr
        for bit in bin(k)[3:]:
            r = r * r
            if bit == "1":
                r = r * qr
        return r

    return power(q), power(q + 4)


def _window_sum(v: torch.Tensor, n: int, blocked: bool, transpose: bool = False) -> torch.Tensor:
    """Sum over each channel's window, by shifted adds over the last axis.
    transpose: the transposed window [i - (n-1)//2, i + n//2], the set of
    j whose window holds i (blocked windows are symmetric)."""
    c = v.shape[-1]
    if blocked:
        if c % n == 0:
            blocks = v.reshape(*v.shape[:-1], c // n, n).sum(-1, keepdim=True)
            return blocks.expand(*v.shape[:-1], c // n, n).reshape(v.shape)
        i = torch.arange(c, device=v.device)
        band = ((i[:, None] // n) == (i[None, :] // n)).to(v.dtype)
        return v @ band  # blocked windows are symmetric
    lo, hi = n // 2, (n - 1) // 2
    if transpose:
        lo, hi = hi, lo
    vp = F.pad(v, (lo, hi))
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


def _bwd_math(
    g: torch.Tensor,
    z: torch.Tensor,
    n: int,
    alpha: float,
    beta: float,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    blocked: bool = False,
):
    """The backward kernel's plain version (`convnet_tpu/ops/lrn.py:
    _bwd_math`, with the bias added in f32 before the ReLU as in
    `_lrn_bwd_kernel`), on (..., C). Recomputes d from z. Returns (dx in
    z's dtype, db): db is the f32 column sum of the f32 dx when a bias
    is given, else None."""
    zf = z.float()
    if bias is not None:
        zf = zf + bias.float()
    x = torch.relu(zf) if relu else zf
    gf = g.float()
    d = 1.0 + alpha * _window_sum(x * x, n, blocked)
    pb, dpow = _neg_pow_pair(d, beta)
    inner = _window_sum(gf * x * dpow, n, blocked, transpose=True)
    dx = gf * pb - 2.0 * alpha * beta * x * inner
    if relu:
        dx = torch.where(zf > 0.0, dx, 0.0)
    db = dx.reshape(-1, dx.shape[-1]).sum(0) if bias is not None else None
    return dx.to(z.dtype), db


def _check_kernel_args(name: str, rows, bias) -> None:
    """Raise on what the CUDA kernels do not take."""
    z = rows[-1]
    if z.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {z.device}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {z.dtype} (bf16 or f32 only)")
    for t in rows:
        if t.dtype != z.dtype or t.device != z.device or t.shape != z.shape:
            raise TypeError(f"{name}: g and z must match in dtype, device and shape")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if bias is not None and (
        bias.dtype != torch.float32 or bias.device != z.device or not bias.is_contiguous()
    ):
        raise TypeError(f"{name}: bias must be a contiguous f32 tensor on z's device")


def _check_rows(name: str, z: torch.Tensor, bias) -> None:
    if z.dim() != 2:
        raise ValueError(f"{name} takes (M, C) rows, got shape {tuple(z.shape)}")
    c = z.shape[1]
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")


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
    bias: f32 (C,) or None. No autograd (see response_norm_cross_map)."""
    _check_rows("lrn_fwd", z, bias)
    m, c = z.shape
    if z.device.type == "cpu":
        return _fwd_math(z, n, alpha, beta, bias, relu, blocked)
    _check_kernel_args("lrn_fwd", (z,), bias)
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


#: Rows of the backward kernel's db scratch: each block of its persistent
#: grid (as many as fit on the card, capped at this) writes one row of
#: partial sums, which a second kernel adds up in a fixed order.
_BWD_MAX_BLOCKS = 1024


def lrn_bwd(
    g: torch.Tensor,
    z: torch.Tensor,
    n: int,
    alpha: float,
    beta: float,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    blocked: bool = False,
):
    """Gradient of `lrn_fwd` with respect to z, given the cotangent g.
    g, z: (M, C) contiguous, both bf16 or both f32; bias: f32 (C,) or
    None. Returns (dx, db): dx in z's dtype; db, when a bias is given,
    the f32 column sum of the f32 dx (deterministic: per-block partial
    sums added in a fixed order, no atomics), else None."""
    _check_rows("lrn_bwd", z, bias)
    if g.shape != z.shape:
        raise ValueError(f"lrn_bwd: g shape {tuple(g.shape)} != z shape {tuple(z.shape)}")
    m, c = z.shape
    if z.device.type == "cpu":
        return _bwd_math(g, z, n, alpha, beta, bias, relu, blocked)
    _check_kernel_args("lrn_bwd", (g, z), bias)
    dx = torch.empty_like(z)
    db = partial = None
    if bias is not None:
        db = torch.empty((c,), dtype=torch.float32, device=z.device)
        partial = torch.empty((_BWD_MAX_BLOCKS, c), dtype=torch.float32, device=z.device)
    if m == 0:
        return dx, db
    from convnet_tpu_torch.ops import _build

    global BWD_LAUNCHES
    with torch.cuda.device(z.device):
        rc = _build.library().cn_lrn_bwd(
            g.data_ptr(), z.data_ptr(),
            None if bias is None else bias.data_ptr(),
            dx.data_ptr(),
            None if db is None else db.data_ptr(),
            None if partial is None else partial.data_ptr(),
            _BWD_MAX_BLOCKS, m, c, int(z.dtype == torch.bfloat16), int(relu), int(blocked), n,
            alpha, beta, 2.0 * alpha * beta, quarter_power(beta),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _build.check(rc, "lrn_bwd")
    BWD_LAUNCHES += 1
    return dx, db


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


class _LRN(torch.autograd.Function):
    """LRN over (M, C) rows with the ReLU optionally fused: the residual
    is z alone, d is recomputed by the backward kernel (lrn.py:885-917)."""

    @staticmethod
    def forward(ctx, z, n, alpha, beta, relu, blocked):
        ctx.save_for_backward(z)
        ctx.conf = (n, alpha, beta, relu, blocked)
        return lrn_fwd(z, n, alpha, beta, relu=relu, blocked=blocked)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        n, alpha, beta, relu, blocked = ctx.conf
        # the cotangent enters the kernel in z's dtype (lrn.py:828)
        dx, _ = lrn_bwd(g.to(z.dtype).contiguous(), z, n, alpha, beta, relu=relu, blocked=blocked)
        return dx, None, None, None, None, None


class _LRNBias(torch.autograd.Function):
    """LRN over (M, C) rows of z + b, the (C,) f32 bias added in the
    kernels: residuals z and b; db comes out of the backward kernel,
    summed from the f32 dx before dx is rounded (lrn.py:1068-1114)."""

    @staticmethod
    def forward(ctx, z, b, n, alpha, beta, relu, blocked):
        ctx.save_for_backward(z, b)
        ctx.conf = (n, alpha, beta, relu, blocked)
        return lrn_fwd(z, n, alpha, beta, bias=b, relu=relu, blocked=blocked)

    @staticmethod
    def backward(ctx, g):
        z, b = ctx.saved_tensors
        n, alpha, beta, relu, blocked = ctx.conf
        dx, db = lrn_bwd(
            g.to(z.dtype).contiguous(), z, n, alpha, beta, bias=b, relu=relu, blocked=blocked
        )
        return dx, db, None, None, None, None, None


def response_norm_cross_map(
    x: torch.Tensor,
    add_scale: float,
    pow_scale: float,
    frac_of_filters: float,
    blocked: bool = False,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """LRN over the channel (last) axis of x, e.g. NHWC. fuse_relu treats
    x as the pre-activation and applies max(x, 0) in the kernel; the
    gradient is masked by x > 0."""
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
    the model defers here (convnet_tpu/model.py:287-303). The gradient
    reaches b only through the backward kernel's db, in f32."""
    c = x.shape[-1]
    n = norm_window_size(c, frac_of_filters)
    conf = (n, add_scale / n, float(pow_scale), fuse_relu, blocked)
    z = x.reshape(-1, c).contiguous()
    if b is None:
        y = _LRN.apply(z, *conf)
    else:
        y = _LRNBias.apply(z, b.to(device=x.device, dtype=torch.float32).contiguous(), *conf)
    return y.view(x.shape)
