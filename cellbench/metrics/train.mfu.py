"""train.mfu: the window's train images/s x 3 x the forward's FLOPs an
image (conv, local and FC edges) over the card's bf16 peak, in %."""

from cellbench.yardstick import share


def read(ctx):
    if ctx.kind != "train":
        return None
    return share(3 * ctx.net.flops_per_image() * ctx.window["images_per_s"], ctx.peak_flops, 1.0)
