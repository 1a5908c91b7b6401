"""model.lrn_ms: the card's ms a step of the RESPONSE_NORM edges in the
step, forward (the spans `model.edge.RESPONSE_NORM.*`) and the backward
nodes they made, from the profiled stretch (`cellbench.spans`); the step's
own counterpart of `kernels.lrn_roofline`."""

from cellbench.spans import kind_ms


def read(ctx):
    return kind_ms(ctx, "RESPONSE_NORM")
