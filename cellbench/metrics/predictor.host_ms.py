"""predictor.host_ms: the window's median request milliseconds less the
card's forward (model.forward_device_ms): staging, the copies, enqueueing
and the read-back."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    card = ctx.value("model.forward_device_ms")
    return None if card is None else ctx.program["median_ms"] - card
