"""model.pool_ms: the card's ms a step of the MAXPOOL edges, forward (the
spans `model.edge.MAXPOOL.*`, a fused LRN -> pool call included) and the
backward nodes they made, from the profiled stretch (`cellbench.spans`)."""

from cellbench.spans import kind_ms


def read(ctx):
    return kind_ms(ctx, "MAXPOOL")
