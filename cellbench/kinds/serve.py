"""Serve cells: the port's Predictor, one client in a closed loop.

Traffic parameters: "batch" images a request, "raw" side of the uint8
images (the crop is the configuration's), "pool" distinct requests made
on the host from the seed and sent in turn, "warmup" requests before the
window, "trace_calls" requests profiled in a `--trace 1` run, "sample"
one request in how many whose answer is compared, drawn from the seed,
and "init" the weight rule (`cellbench.weights`).

Set-up builds `convnet_tpu_torch.predictor.Predictor(graph, weights,
batch_size=batch, jitter=<eval prologue: centre crop, x * scale - mean>,
raw_size=raw, input_dtype=np.uint8)` and sends the warm-up requests. The
window sends a request, waits for the returned arrays and sends the next,
for --seconds; each request is timed from the call to its return.
`serve_images_per_s` is all images answered over the window's seconds;
the 95th percentile of every request's milliseconds is the per-layer
`predictor.p95_ms`.

Once the window has closed, the Predictor is freed and the reference
that the configuration names (`ctx.cell.reference`) computes, in
float32, the output layer's probabilities of every pool request among
those sampled; `logit_gap` holds each sampled answer to it.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from cellbench import check, measure
from cellbench.weights import make_requests, make_weights


def run(ctx, seed: int, seconds: float, trace: bool, t_start: float):
    from convnet_tpu_torch import predictor
    from convnet_tpu_torch.data.jitter import JitterSpec

    cfg, tr, net, dev = ctx.cell.config, ctx.cell.traffic, ctx.net, ctx.device
    cuda = dev.type == "cuda"
    batch, pool_n, field = tr["batch"], tr["pool"], net.input.field
    graph = ctx.port_graph()
    channels = net.shapes[net.input.name][2]
    jitter = {field: (JitterSpec(cfg["crop"], scale=cfg["scale"]),
                      np.full((channels,), cfg["mean"], np.float32), None)}
    pred = predictor.Predictor(graph, make_weights(net, seed, dev, tr["init"]),
                               layers=[net.output.name], batch_size=batch, jitter=jitter,
                               raw_size=tr["raw"], input_dtype=np.uint8, device=dev)
    requests = make_requests(seed, pool_n, batch, tr["raw"], channels)
    # request i is compared where keep[i]: about one in `sample`, from the seed
    keep = np.random.default_rng(seed + 2).random(1 << 20) * tr["sample"] < 1.0
    keep[0] = True  # the window's first answer always
    calls = [0]

    def one():
        out = pred({field: requests[calls[0] % pool_n]})[net.output.name]
        calls[0] += 1
        return out

    for _ in range(tr["warmup"]):
        one()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    first, ms, answers = calls[0], [], []
    stretch, traced_s, traced = None, 0.0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace and stretch is None and time.perf_counter() - t0 >= seconds / 2:
            a, c = time.perf_counter(), calls[0]
            stretch = measure.trace(one, tr["trace_calls"], dev) or {}
            traced_s, traced = time.perf_counter() - a, calls[0] - c
            continue
        i = calls[0]
        a = time.perf_counter()
        out = one()
        ms.append((time.perf_counter() - a) * 1e3)
        if keep[(i - first) % keep.size]:
            answers.append((i % pool_n, out))
    window_s = time.perf_counter() - t0
    served = calls[0] - first
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    # the profiled stretch of a traced run is not the window's pace
    ctx.window = {"images_per_s": (served - traced) * batch / (window_s - traced_s),
                  "seconds": window_s, "calls": served, "batch": batch, "ms": ms}
    out = {"metrics": {"setup_s": setup_s, "serve_images_per_s": ctx.window["images_per_s"]},
           "attempted": served, "failed": 0, "memory_peak_bytes": peak,
           "layers": {}, "gaps": []}
    if trace:
        ctx.trace = stretch or None
        # the Predictor's own forward and weights, on a request that it staged
        staged = {field: pred._stage(field, requests[0], batch)}
        ctx.program = {"forward": pred._forward, "params": pred.params, "batch": staged,
                       "median_ms": statistics.median(ms)}
        out["layers"] = ctx.read_layers()
        out["gaps"] = measure.gaps(one, 3, dev) if cuda else []
    del pred, one
    ctx.release()

    params = make_weights(net, seed, dev, tr["init"])
    reference = {}
    with ctx.cell.reference.exact_f32(), torch.no_grad():
        for j in sorted({j for j, _ in answers}):
            x = net.prologue(torch.from_numpy(requests[j]).to(dev), cfg["crop"], cfg["scale"],
                             cfg["mean"])
            reference[j] = net.probabilities(params, x).double().cpu().numpy()
    out["failed"] = sum(1 for _, p in answers if not np.all(np.isfinite(p)))
    out["checks"] = {"logit_gap": check.logit_gap(answers, reference)}
    out["compared"] = len(answers)
    return out
