"""model.concat_ms: the card's ms a step of the CONCAT edges in the step,
forward (the spans `model.edge.CONCAT.*`: each join's one copy) and the
backward nodes they made, from the profiled stretch (`cellbench.spans`);
the step's own counterpart of `kernels.concat_roofline`."""

from cellbench.spans import kind_ms


def read(ctx):
    return kind_ms(ctx, "CONCAT")
