"""Wall-clock timers and torch.profiler capture (counterpart of
`convnet_tpu/utils/timers.py`)."""

from __future__ import annotations

import contextlib
import time

import torch


class Timer:
    """Accumulating wall-clock timer: `with t:` or start()/stop() add one
    interval to `total` (seconds) and one to `count`."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._start = None

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        dt = time.perf_counter() - self._start
        self.total += dt
        self.count += 1
        self._start = None
        return dt

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def start_trace(logdir: str, cuda: bool):
    """A started torch.profiler over the CPU (and the card when `cuda`),
    writing a TensorBoard-readable Chrome trace into `logdir` when it
    stops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    return prof


def stop_trace(prof, cuda: bool) -> None:
    """Stop once the traced device work is done, and write the trace."""
    if cuda:
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """Trace the block with torch.profiler into `logdir`: the host's
    operators, and the card's kernels when `device` is a CUDA device."""
    cuda = torch.device(device).type == "cuda"
    prof = start_trace(logdir, cuda)
    try:
        yield prof
    finally:
        stop_trace(prof, cuda)
