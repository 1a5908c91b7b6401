"""model.forward_device_ms: the card's milliseconds of the Predictor's own
forward over its own weights (the timed object's `_forward` and `params`)
on a request that it staged, with the host's launches hidden behind a
spin."""

import torch

from cellbench.measure import device_ms


def read(ctx):
    if ctx.kind != "serve" or ctx.device.type != "cuda":
        return None
    fwd, params, batch = (ctx.program[k] for k in ("forward", "params", "batch"))
    with torch.inference_mode():
        return device_ms(lambda: fwd(params, batch))
