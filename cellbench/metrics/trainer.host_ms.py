"""trainer.host_ms: the host's ms a step in the profiled stretch
(`cellbench.spans`): the mean length of its `trainer.step` spans, the
profiler's own cost for each operator included. Where a step launches
more operations than CUDA's launch queue holds and the card paces, the
host also waits inside the span for room in the queue, so the number
reads near the card's step and bounds the enqueue from above; where the
host paces, it exceeds the card's busy ms a step. For cells whose step
the spin of `trainer.enqueue_ms` cannot hold."""

from cellbench.spans import credited


def read(ctx):
    got = credited(ctx)
    return None if got is None else got["host_ms"]
