"""serve.p95_mfu: one request's forward FLOPs at the card's bf16 peak, as
a share of the window's 95th percentile request time, in %."""

from cellbench.yardstick import quantile, share


def read(ctx):
    if ctx.kind != "serve":
        return None
    flops = ctx.net.flops_per_image() * ctx.window["batch"]
    return share(flops, ctx.peak_flops, quantile(ctx.window["ms"], 0.95) / 1e3)
