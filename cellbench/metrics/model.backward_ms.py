"""model.backward_ms: the card's ms a step of the step's own backward (the
operations launched while the step waits in the span `model.backward`),
from the profiled stretch (`cellbench.spans`)."""

from cellbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "model.backward")
