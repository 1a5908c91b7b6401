"""Timing on the card and reading the profiler's trace.

`device_ms` and `enqueue_ms` are the port's `utils/card.py` timers,
copied so that the yardstick stays with the benchmark: the card's time
of some work with the host's launches hidden behind a spin kernel, and
the host's time to enqueue it while the card is busy. `trace` runs calls
under torch.profiler and reduces the Chrome trace to the card's busy and
idle time, the operations that took the most of it, and the longest idle
gaps by the host operation that was running."""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: cycles of torch.cuda._sleep a millisecond: a spin of at least 1 ms at
#: SM clocks up to 2 GHz
SPIN_CYCLES_PER_MS = 2e6
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: characters of an operation's name kept in a breakdown
NAME_CHARS = 160


def device_ms(*calls: Callable[[], object], k: int = 20, reps: int = 3) -> float:
    """Device milliseconds a call of the work the callables enqueue (taken
    in turn), with the host's launches hidden: k calls queued behind a
    spin that outlasts their enqueueing, timed by one pair of CUDA events;
    the median of `reps` runs. A run whose spin ended before the last call
    was queued is repeated with k halved, then with a longer spin."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(k):
        calls[i % len(calls)]()
    spin_ms = max(2.0, 2e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    runs = []
    while len(runs) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for i in range(k):
            calls[i % len(calls)]()
        end.record()
        hidden = not start.query()
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
    """Median host milliseconds to enqueue one call of fn with the card
    held behind a spin that outlasts `calls` calls."""
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


def _events(calls: Callable[[], object], n: int, device: torch.device, host: bool) -> List[Dict]:
    """The Chrome trace events of n calls under torch.profiler: the card's
    activity, and the host's operators too where `host`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        for _ in range(n):
            calls()
        if cuda:
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def _device_spans(events: List[Dict]) -> List[Tuple[float, float, str]]:
    return sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)), ev.get("name", ""))
                  for ev in events if ev.get("cat") in _DEVICE_CATS and "ts" in ev)


def busy(events: List[Dict]) -> Optional[Dict]:
    """{"busy_s", "window_s", "device_ops"} of a trace: the union of the
    card's kernels, copies and sets, the time from the first one's start
    to the last one's end, and the 10 operations that took the most time
    ([name, seconds]); None where the trace holds no device activity."""
    spans = _device_spans(events)
    if not spans:
        return None
    total: Dict[str, float] = {}
    on, reach = 0.0, spans[0][0]
    for t0, t1, name in spans:
        total[name] = total.get(name, 0.0) + (t1 - t0) / 1e6
        if t1 > reach:
            on += t1 - max(t0, reach)
            reach = t1
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:10]
    # a kernel's name can run to a kilobyte of template arguments
    ops = [(n[:NAME_CHARS], s) for n, s in ops]
    return {"busy_s": on / 1e6, "window_s": (reach - spans[0][0]) / 1e6,
            "device_ops": [[n, s] for n, s in ops]}


def idle_gaps(events: List[Dict], top: int = 10) -> List[List]:
    """The card's idle gaps between its first and last operation, their
    seconds summed by the innermost host operation running at each gap's
    middle ("none" where the host ran nothing that the trace records);
    the `top` largest sums, [name, seconds]."""
    spans = _device_spans(events)
    host = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)), ev.get("name", ""))
            for ev in events if ev.get("cat") in _HOST_CATS and "ts" in ev]
    gaps: Dict[str, float] = {}
    reach = spans[0][1] if spans else 0.0
    for t0, t1, _ in spans[1:]:
        if t0 > reach:
            mid = (t0 + reach) / 2
            inner = [h for h in host if h[0] <= mid <= h[1]]
            name = max(inner, key=lambda h: h[0])[2] if inner else "none"
            gaps[name] = gaps.get(name, 0.0) + (t0 - reach) / 1e6
        reach = max(reach, t1)
    return [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def trace(call: Callable[[], object], n: int, device: torch.device) -> Optional[Dict]:
    """busy() of n calls, the card's activity alone recorded (recording
    the host's operators as well slows an eager host enough to idle the
    card)."""
    return busy(_events(call, n, device, host=False))


def gaps(call: Callable[[], object], n: int, device: torch.device) -> List[List]:
    """idle_gaps() of n calls, with the host's operators recorded."""
    return idle_gaps(_events(call, n, device, host=True))
