"""kernels.concat_roofline: the concatenating joins' forward through the
port's op (`ops.concat.concat_channels`, as the model calls it: a layer's
CONCAT sources, bf16 NHWC, side by side along the channels) at the cell's
batch and shapes: the least bytes (`concat_bytes`, below: each source
read once, the joined layer written once) at the card's HBM rate, as a
share of the card's measured time, in %. The backward hands each source a
view of the joined gradient and moves no bytes here; what its consumers
copy stays in their spans. None where the port has no such op."""

import torch

from cellbench.measure import device_ms
from cellbench.yardstick import share


def concat_bytes(positions: int, channels, elem: int = 2) -> int:
    """Least bytes of a join's forward: each source's positions x c_i
    elements read once, the joined positions x sum(c_i) written once."""
    return 2 * positions * sum(channels) * elem


def read(ctx):
    if ctx.kind != "train" or ctx.device.type != "cuda":
        return None
    try:
        from convnet_tpu_torch.ops.concat import concat_channels
    except ImportError:
        return None

    net, b, dev = ctx.net, ctx.window["batch"], ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    joins = {}  # joined layer -> its CONCAT edges, in forward order
    for e in net.edges:
        if e.kind == "CONCAT":
            joins.setdefault(e.dest, []).append(e)
    total_bytes, ms = 0, 0.0
    for name, inc in joins.items():
        srcs = [torch.randn((b, *net.shapes[e.source]), generator=gen, device=dev)
                .to(torch.bfloat16) for e in inc]

        def call(srcs=srcs):
            return concat_channels(srcs)

        ms += device_ms(call)
        total_bytes += concat_bytes(b * net.shapes[name][0] * net.shapes[name][1],
                                    [net.shapes[e.source][2] for e in inc])
        del srcs
    return share(total_bytes, ctx.peak_bytes, ms / 1e3) if ms else None
