"""serve.mfu: the window's served images/s x the forward's FLOPs an image
over the card's bf16 peak, in %."""

from cellbench.yardstick import share


def read(ctx):
    if ctx.kind != "serve":
        return None
    return share(ctx.net.flops_per_image() * ctx.window["images_per_s"], ctx.peak_flops, 1.0)
