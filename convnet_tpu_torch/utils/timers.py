"""Wall-clock timers, named spans and torch.profiler capture (counterpart
of `convnet_tpu/utils/timers.py`).

A span names a stretch of the host's work in a torch.profiler trace:
while a profiler records, `span(name)` opens
`torch.profiler.record_function(name)`, an event in the profiler's own
session and on its clock, which the card's kernels share (Kineto's CUPTI
events), so that a trace can credit each kernel to the span that launched
it. With no profiler recording, a span is one check of the profiler's
Python flag (the check torch's own compiled code makes before its
record_function): it builds no string, allocates nothing, calls nothing
in the dispatcher, touches no device and never synchronizes. Names are
fixed strings, built once.

The port's spans: `trainer.step` (an eager step) holding `trainer.draws`,
`trainer.prologue`, `model.forward` (with `model.edge.<EDGE_TYPE>.<edge>`
for each edge's op and `model.layer.<layer>` for each layer's bias,
activation, dropout, store cast and an output layer's loss),
`model.backward`, `parallel.reduce` under a mesh and `optim.update`;
`trainer.capture` and `trainer.replay` for a captured step; and the
Trainer's `Timer`s `trainer.get_batch`, `.stack`, `.pin`, `.copy` and
`.launch`. The Predictor's forward takes the edge and layer spans too.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

#: what span() returns while no profiler records: reentrant, stateless
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: `record_function(name)` while a torch.profiler
    records, else a shared one that does nothing."""
    return _profiler.record_function(name) if _profiler._is_profiler_enabled else _OFF


class Timer:
    """Accumulating wall-clock timer of the span `name`: `with t:` or
    start()/stop() add one interval to `total` (seconds) and one to
    `count`; `with t:` also opens span(name)."""

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._start = None
        self._span = _OFF

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
        self._span = span(self.name)
        self._span.__enter__()
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        self._span.__exit__(*exc)
        self._span = _OFF


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
