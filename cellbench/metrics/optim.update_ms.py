"""optim.update_ms: the card's ms a step of the step's own SGD update of
every leaf (the span `optim.update` in `optim.apply_updates`), from the
profiled stretch (`cellbench.spans`)."""

from cellbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "optim.update")
