"""predictor.p95_ms: the 95th percentile of every timed request's
milliseconds in the window, from the call to the returned arrays. A
per-layer metric, not an end-to-end one: between runs on the shared host
its spread needs a bound wider than the benchmark allows."""

from cellbench.yardstick import quantile


def read(ctx):
    if ctx.kind != "serve":
        return None
    return quantile(ctx.window["ms"], 0.95)
