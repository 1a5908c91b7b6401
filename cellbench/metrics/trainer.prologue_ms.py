"""trainer.prologue_ms: the card's ms a step of the step's own draws and
input prologue (the spans `trainer.draws` and `trainer.prologue`: the
`step_draws` launches, the jitter or space-to-depth prologue), from the
profiled stretch (`cellbench.spans`)."""

from cellbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "trainer.draws", "trainer.prologue")
