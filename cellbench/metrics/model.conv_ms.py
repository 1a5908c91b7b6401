"""model.conv_ms: the card's ms a step of the CONV edges in the step,
forward (the spans `model.edge.CONV.*`: the op, its weight and bias casts
and the bias add) and the backward nodes they made, from the profiled
stretch (`cellbench.spans`); the step's own counterpart of
`kernels.conv_roofline`."""

from cellbench.spans import kind_ms


def read(ctx):
    return kind_ms(ctx, "CONV")
