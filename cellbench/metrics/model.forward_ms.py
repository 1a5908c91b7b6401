"""model.forward_ms: the card's ms a step of the step's own forward and
loss (the span `model.forward` and its edge and layer spans), from the
profiled stretch (`cellbench.spans`)."""

from cellbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "model.forward")
