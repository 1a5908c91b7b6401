"""device.idle_share.train: the share of the traced stretch of train
steps, from the card's first operation to its last, in which no kernel,
copy or set ran, in %."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
