"""kernels.conv_roofline: the CONV edges' forward and backward through the
port's op (`ops.conv.conv2d`, bf16, the first one over the prologue's
space-to-depth input as the model runs it) at the cell's batch and shapes:
their FLOPs (forward, weight gradient, and input gradient where the input
has one) at the card's bf16 peak, as a share of the card's measured time,
in %."""

import torch

from cellbench.measure import device_ms
from cellbench.yardstick import conv_train_flops, share


def read(ctx):
    if ctx.kind != "train" or ctx.device.type != "cuda":
        return None
    from convnet_tpu_torch.ops.conv import conv2d
    from convnet_tpu_torch.trainer import preprocess

    net, b, dev = ctx.net, ctx.window["batch"], ctx.device
    params = ctx.program["state"]["params"]
    first = preprocess(ctx.program["graph"], ctx.program["jitter"], ctx.program["batch"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flops, ms = 0, 0.0
    for e in net.edges:
        if e.kind != "CONV":
            continue
        oh, ow, oc = net.shapes[e.dest]
        w = params[e.name]["w"].detach().clone().requires_grad_(True)
        gy = torch.randn((b, oh, ow, oc), generator=gen, device=dev).to(torch.bfloat16)
        if net.layers[e.source].is_input:
            x, wrt = first[net.input.field], (w,)
        else:
            x = torch.randn((b, *net.shapes[e.source]), generator=gen, device=dev)
            x = x.to(torch.bfloat16).requires_grad_(True)
            wrt = (w, x)

        def call(x=x, w=w, gy=gy, e=e, wrt=wrt):
            y = conv2d(x, w, e.stride, e.padding, compute_dtype=torch.bfloat16)
            return torch.autograd.grad(y, wrt, gy)

        ms += device_ms(call)
        flops += conv_train_flops(net.edge_flops(e) * b, len(wrt) == 2)
    return share(flops, ctx.peak_flops, ms / 1e3) if ms else None
