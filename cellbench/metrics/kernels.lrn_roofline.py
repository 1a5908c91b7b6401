"""kernels.lrn_roofline: the RESPONSE_NORM edges' forward and backward
through the port's public op (`ops.lrn.response_norm_cross_map_bias`, as
the model calls it: the producing conv's bias deferred into it, its ReLU
fused) at the cell's batch and shapes, bf16: the least bytes
(`yardstick.lrn_bytes`) at the card's HBM rate, as a share of the card's
measured time, in %."""

import torch

from cellbench.measure import device_ms
from cellbench.yardstick import lrn_bytes, share


def read(ctx):
    if ctx.kind != "train" or ctx.device.type != "cuda":
        return None
    from convnet_tpu_torch.ops.lrn import response_norm_cross_map_bias

    net, b, dev = ctx.net, ctx.window["batch"], ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    total_bytes, ms = 0, 0.0
    for e in net.edges:
        if e.kind != "RESPONSE_NORM":
            continue
        h, w, c = net.shapes[e.source]
        relu = net.layers[e.source].activation == "RECTIFIED_LINEAR"
        z = torch.randn((b, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
        z.requires_grad_(True)
        bias = torch.full((c,), 0.1, device=dev, requires_grad=True)
        g = torch.randn((b, h, w, c), generator=gen, device=dev).to(torch.bfloat16)

        def call(z=z, bias=bias, g=g, e=e, relu=relu):
            y = response_norm_cross_map_bias(z, bias, e.add_scale, e.pow_scale, e.frac, False,
                                             relu)
            return torch.autograd.grad(y, (z, bias), g)

        ms += device_ms(call)
        total_bytes += lrn_bytes(b * h * w, c)
    return share(total_bytes, ctx.peak_bytes, ms / 1e3) if ms else None
