"""Train cells: the port's train step, one step a launch.

Traffic parameters: "batch" images a step, "raw" side of the uint8 images
(the crop is the configuration's), "pool" distinct batches made on the
card and cycled (at least 3), "warmup" steps after the first three,
"trace_steps" steps profiled in a `--trace 1` run, "init" the weight rule
(`cellbench.weights`).

Set-up builds one state from the seed's weights with zero momenta and one
step function, `convnet_tpu_torch.trainer.make_train_step(graph, jitter,
unroll=1)` with the train prologue (random crops and flips, x * scale -
mean), and drives that state through its first three steps with that
function, on three distinct batches (`follow`); then the warm-up steps,
and the window: steps for --seconds on the pool's batches in turn,
closed by a read of the last loss; `train_images_per_s` is all images
stepped over the window's seconds.

Once the window has closed (and, in a traced run, the per-layer metrics
are read), the same step function drives the state that the window left
through three more steps (`follow` again), from the pool's fourth batch
on, so that a batch that the first three did not take is held too. Then
the port's state is freed and the reference that the configuration
names (`ctx.cell.reference`) runs both stretches in float32 with the
same batches and draws: the first from the seed's weights, the second
from a copy of the state that the window left (the reference cannot
follow the window's hundreds of steps in less time than the window).
`correct` holds the gaps of the loss, the first gradient and the change
to their limits (`cellbench.check`; the second stretch's numbers are
named "after_...").
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cellbench import check, measure
from cellbench.weights import make_batches, make_weights


def run(ctx, seed: int, seconds: float, trace: bool, t_start: float):
    from convnet_tpu_torch import trainer
    from convnet_tpu_torch.data.jitter import JitterSpec

    cfg, tr, net, dev = ctx.cell.config, ctx.cell.traffic, ctx.net, ctx.device
    train_steps = ctx.cell.reference.train_steps
    cuda = dev.type == "cuda"
    batch, pool_n = tr["batch"], tr["pool"]
    if pool_n < 3 or tr["warmup"] < 1:
        raise ValueError("a train mix needs a pool of at least 3 batches and a warm-up step")
    graph = ctx.port_graph()
    channels = net.shapes[net.input.name][2]
    jitter = {net.input.field: (JitterSpec(cfg["crop"], True, True, scale=cfg["scale"]),
                                np.full((channels,), cfg["mean"], np.float32), None)}
    params = make_weights(net, seed, dev, tr["init"])
    state = {"params": params, "moms": {n: {k: torch.zeros_like(v) for k, v in p.items()}
                                        for n, p in params.items()},
             "step": 0, "seed": seed}
    pool = make_batches(seed, pool_n, batch, tr["raw"], channels,
                        net.output.channels, dev)
    step = trainer.make_train_step(graph, jitter, unroll=1)
    calls = [0]

    def one():
        m = step(state, pool[calls[0] % pool_n])
        calls[0] += 1
        return m

    coords = check.coordinates({f"{e}/{k}": s for e, p in net.param_shapes().items()
                                for k, s in p.items()}, seed, dev)
    program = follow(net, state, one, coords)
    for _ in range(tr["warmup"]):
        m = one()
    float(m["loss"])
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    first, t0 = calls[0], time.perf_counter()
    stretch, traced_s, traced = None, 0.0, 0
    while time.perf_counter() - t0 < seconds:
        if trace and stretch is None and time.perf_counter() - t0 >= seconds / 2:
            if cuda:  # the steps queued so far run in the window's time
                torch.cuda.synchronize(dev)
            a, c = time.perf_counter(), calls[0]
            stretch = measure.trace(one, tr["trace_steps"], dev) or {}
            traced_s, traced = time.perf_counter() - a, calls[0] - c
            continue
        m = one()
    last = float(m["loss"])
    window_s = time.perf_counter() - t0
    steps = calls[0] - first
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    # the profiled stretch of a traced run is not the window's pace
    ctx.window = {"images_per_s": (steps - traced) * batch / (window_s - traced_s),
                  "seconds": window_s, "calls": steps, "batch": batch}
    out = {"metrics": {"setup_s": setup_s, "train_images_per_s": ctx.window["images_per_s"]},
           "attempted": steps, "failed": 0 if np.isfinite(last) else steps,
           "memory_peak_bytes": peak, "layers": {}, "gaps": []}
    if trace:
        ctx.trace = stretch or None
        ctx.program = {"graph": graph, "jitter": jitter, "state": state, "step": one,
                       "batch": pool[0]}
        out["layers"] = ctx.read_layers()
        out["gaps"] = measure.gaps(one, 3, dev) if cuda else []
    # the three steps after the window: on the pool's batches from the
    # fourth on, so that the window's batches that the first three steps
    # did not take are held too, from the state that the window left
    while calls[0] % pool_n != 3 % pool_n:
        one()
    t_after, order = state["step"], [(calls[0] + i) % pool_n for i in range(3)]
    left = {t: {n: {k: v.detach().clone() for k, v in p.items()} for n, p in state[t].items()}
            for t in ("params", "moms")}
    after = follow(net, state, one, coords)
    batches = [(pool[t]["input"], pool[t]["labels"]) for t in range(3)]
    later = [(pool[t]["input"], pool[t]["labels"]) for t in order]
    del state, step, one, pool, params, m
    ctx.release()

    args = (seed, cfg["crop"], cfg["scale"], cfg["mean"])
    ref = train_steps(net, make_weights(net, seed, dev, tr["init"]), batches, *args,
                      coords=coords)
    out["checks"] = check.train_gaps(program, ref)
    start = {t: {n: {k: v.clone() for k, v in p.items()} for n, p in left[t].items()}
             for t in left} if tr.get("controls") else None
    ref = train_steps(net, left["params"], later, *args, coords=coords, moms=left["moms"],
                      t0=t_after)
    out["checks"].update(check.train_gaps(after, ref, prefix="after_"))
    if start is not None:
        # the calibration's control and fault after the window, in the
        # program's place from the same state
        out["controls"] = {}
        for run, kw in (("control", {"precision": "fp8"}), ("half", {"rows": batch // 2})):
            state = {t: {n: {k: v.clone() for k, v in p.items()} for n, p in start[t].items()}
                     for t in start}
            got = train_steps(net, state["params"], later, *args, coords=coords,
                              moms=state["moms"], t0=t_after, **kw)
            out["controls"][run] = check.train_gaps(got, ref, prefix="after_")
    return out


def follow(net, state, one, coords) -> dict:
    """Three steps of the step function `one` on `state`, as the reference
    reads them: each step's loss, each leaf's first gradient as the
    optimizer took it (g + l2 w, from its momentum before and after: m' =
    mu m - eps (g + l2 w)) and its change after the three, their norms
    and, at `coords`, their elements."""
    t0 = state["step"]
    before = {(e.name, k): state["moms"][e.name][k].detach().clone()
              for e in net.weighted for k in ("w", "b")}
    start = {key: state["params"][key[0]][key[1]].detach().clone() for key in before}
    out = {"loss": [], "grad": {}, "change": {}, "grad_at": {}, "change_at": {}}
    for i in range(3):
        out["loss"].append(one()["loss"])
        for (name, k), m in before.items() if i == 0 else ():
            spec = next(e for e in net.weighted if e.name == name)
            spec = spec.wopt if k == "w" else spec.bopt
            g = (spec.momentum(t0) * m - state["moms"][name][k].detach()) / spec.epsilon(t0)
            out["grad"][f"{name}/{k}"] = float(torch.linalg.vector_norm(g))
            out["grad_at"][f"{name}/{k}"] = g.reshape(-1)[coords[f"{name}/{k}"]].cpu().numpy()
    for (name, k), w in start.items():
        delta = state["params"][name][k].detach() - w
        out["change"][f"{name}/{k}"] = float(torch.linalg.vector_norm(delta))
        out["change_at"][f"{name}/{k}"] = delta.reshape(-1)[coords[f"{name}/{k}"]].cpu().numpy()
    out["loss"] = [float(x) for x in out["loss"]]
    return out
