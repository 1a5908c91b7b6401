"""The card a measurement runs on and how it is timed: its name and power
limit (nvidia-smi), its published bf16 peak, device milliseconds from CUDA
events (around each call, or with the host's launches hidden behind a spin
kernel), the host's milliseconds to enqueue a call, and host milliseconds
with a synchronize. The measuring entry points (`bench`,
`tools/bench_pipeline`, `tools/profile_alexnet`, `tools/sweep`,
`tools/copy_probe`, `tools/serving_probe`) and `chip_smoke.py` share them.

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
#: cycles of torch.cuda._sleep a millisecond: a spin of at least 1 ms at
#: SM clocks up to 2 GHz
SPIN_CYCLES_PER_MS = 2e6


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


def device_ms(*calls: Callable[[], object], k: int = 20, reps: int = 3) -> float:
    """Device milliseconds per call of the work the callables enqueue, with
    the host's launch cost hidden. k calls, taking the callables in turn
    (each on its own inputs, so that no call finds its inputs in L2 from
    the call before), are queued behind a spin kernel that outlasts the
    host's enqueueing of all of them, and one pair of CUDA events around
    them times the card alone; the median of `reps` runs, over k. Each
    callable first runs once under torch.cuda.set_sync_debug_mode("error"),
    so a call that waits for the card raises instead of timing the host.
    A run in which the spin ended before the last call was queued is
    repeated with k halved (k calls of many small kernels can fill the
    CUDA launch queue, about a thousand launches, and the host then waits
    for the card whatever the spin), then with a longer spin."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(k):
        calls[i % len(calls)]()
    spin_ms = max(2.0, 2e3 * (time.perf_counter() - t0))  # twice the host's enqueue time
    torch.cuda.synchronize()
    runs = []
    while len(runs) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for i in range(k):
            calls[i % len(calls)]()
        end.record()
        hidden = not start.query()  # the spin still ran when the last call was queued
        end.synchronize()
        if hidden:
            runs.append(start.elapsed_time(end) / k)
        elif k > 1:
            k //= 2
        elif spin_ms > 4000:
            raise RuntimeError("the host could not queue the calls inside a 4 s spin")
        else:
            spin_ms *= 4
    return statistics.median(runs)


def enqueue_ms(fn: Callable[[], object], calls: int = 2, reps: int = 20) -> float:
    """Median host milliseconds to enqueue one call of fn (a forward or a
    train step of a few hundred launches) with the card held behind a spin
    that outlasts `calls` calls: the host's cost of a call apart from the
    card's time, while the card is busy. A run in which the spin ended
    first is repeated with a longer spin."""
    fn()
    torch.cuda.synchronize()
    spin_ms, runs = 50.0, []
    while len(runs) < reps:
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start = torch.cuda.Event()
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        spent = time.perf_counter() - t0
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            runs.append(spent * 1e3 / calls)
        elif spin_ms > 4000:
            raise RuntimeError("the host could not queue the calls inside a 4 s spin")
        else:
            spin_ms *= 4
    return statistics.median(runs)


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
