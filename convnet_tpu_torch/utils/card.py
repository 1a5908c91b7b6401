"""The card a measurement runs on and how it is timed: its name and power
limit (nvidia-smi), its published bf16 peak, device milliseconds from CUDA
events and host milliseconds with a synchronize. The measuring entry points
(`bench`, `tools/bench_pipeline`, `tools/profile_alexnet`, `tools/sweep`)
and `chip_smoke.py` share them.

A result names the device it ran on: the card's name, or "cpu" with no
power limit and no utilization, so that a number from a CPU run is never
read as a device's."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

#: Dense bf16 tensor-core FLOP/s of the cards whose peak is known, by what
#: their name holds: the H100 SXM part (NVIDIA's data sheet; its HBM3 is
#: the SXM part's memory). A card not listed has no peak, and no mfu.
BF16_PEAKS = ((("H100", "HBM3"), 989e12), (("H100", "SXM"), 989e12))


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def power_limit_w(line: str) -> Optional[float]:
    """The watts of card_line's power limit, or None where nvidia-smi gave
    none ("[N/A]")."""
    try:
        return float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


def bf16_peak(name: str) -> Optional[float]:
    """The card's dense bf16 FLOP/s from its name, or None where it is not
    known (any card not in BF16_PEAKS, and the CPU): no peak is guessed."""
    for words, peak in BF16_PEAKS:
        if all(w in name for w in words):
            return peak
    return None


def device_facts(device: torch.device) -> Dict[str, object]:
    """{"device": the card's name or "cpu", "power_limit_w": watts or None}."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    return {"device": torch.cuda.get_device_name(device),
            "power_limit_w": power_limit_w(card_line())}


def mfu(images_per_sec: float, flops_per_image: float, device: torch.device) -> Optional[float]:
    """images/s x FLOPs an image over the card's bf16 peak; None off a card
    or on a card whose peak is not known."""
    if device.type != "cuda":
        return None
    peak = bf16_peak(torch.cuda.get_device_name(device))
    return None if peak is None else images_per_sec * flops_per_image / peak


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of fn(), timed with CUDA events around
    each call after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn: Callable[[], object], device: torch.device, iters: int = 20,
            warmup: int = 3) -> float:
    """Median host milliseconds of fn() followed by a synchronize of the
    device, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
