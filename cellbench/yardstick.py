"""The benchmark's own arithmetic: the card's published peaks, the
operations and bytes of the work that the per-layer metrics time, shares
of a peak, and the statistics of a window. Plain Python; nothing here
reads the port."""

from __future__ import annotations

import statistics
from typing import Iterable, Optional, Sequence

#: Dense bf16 tensor-core FLOP/s and HBM bytes/s of the cards whose peaks
#: are known, by words their name holds: the H100 SXM part (NVIDIA's data
#: sheet; its HBM3 is the SXM part's memory). A card not listed has no
#: peak, and its shares of a peak are left out.
PEAKS = ((("H100", "HBM3"), 989e12, 3.35e12), (("H100", "SXM"), 989e12, 3.35e12))


def peaks(card_name: str):
    """(bf16 FLOP/s, HBM bytes/s) of the card, or (None, None)."""
    for words, flops, hbm in PEAKS:
        if all(w in card_name for w in words):
            return flops, hbm
    return None, None


def share(work: float, rate: Optional[float], seconds: float) -> Optional[float]:
    """work / rate / seconds in %: the least time the work needs at the
    peak rate, as a share of the time it took; None without a peak."""
    if rate is None or seconds <= 0:
        return None
    return 100.0 * work / rate / seconds


def lrn_bytes(rows: int, channels: int, elem: int = 2) -> int:
    """Least bytes of a response norm's forward and backward through the
    port's bias-taking op, each op's inputs read once and outputs written
    once: the forward reads z and the (C,) f32 bias and writes y; the
    backward reads the cotangent, z and the bias and writes dz and the f32
    bias gradient."""
    m = rows * channels * elem
    return (m + 4 * channels + m) + (2 * m + 4 * channels + m + 4 * channels)


def conv_train_flops(forward: int, input_grad: bool) -> int:
    """A convolution's FLOPs in a train step: the forward, the weight
    gradient, and the input gradient where the input has one."""
    return forward * (3 if input_grad else 2)


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 < q < 1) of all values, linear between order
    statistics (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def spread(values: Iterable[float]) -> float:
    """Distance between the first and third quartiles over the median, as
    `statistics.quantiles(values, n=4)` gives them."""
    v = list(values)
    q1, med, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / med
