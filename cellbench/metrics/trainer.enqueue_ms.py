"""trainer.enqueue_ms: the host's median milliseconds to enqueue one
train step with the card held behind a spin (the cell's step function on
its state and batches)."""

from cellbench.measure import enqueue_ms


def read(ctx):
    if ctx.kind != "train" or ctx.device.type != "cuda":
        return None
    return enqueue_ms(ctx.program["step"])
