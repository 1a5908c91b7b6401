"""Where AlexNet's train step spends its time on the card (counterpart of
`tools/profile_alexnet.py`, with the categories of `tools/traceparse.py`).

    python -m convnet_tpu_torch.tools.profile_alexnet [--batch 256]
        [--steps 20] [--image-size 224] [--device cuda|cpu] [--seed N]
        [--trace-dir DIR]

Times, on uint8 (B, S + 32, S + 32, 3) batches made on the device from
--seed: the full train step; the eval forward (the loss, center crop);
the forward and backward without the update; the update alone
(`optim.apply_updates`); the input prologue alone; and each conv, FC, max
pool and response-norm edge at its true shape (the activations stored in
the model's dtype), forward and forward + backward. Each response-norm
edge is timed twice, through the kernel's wrapper (`[kernel]`: on a card,
the CUDA kernels) and through its plain PyTorch version (`[plain]`): the
counterpart of the JAX script's two LRN backends. Each row is one JSON
line: "host_ms", the median host milliseconds of a call followed by a
synchronize, and "device_ms", the median of CUDA events around a call
(null on the CPU), after warm-up calls.

Then torch.profiler traces 5 train steps (into --trace-dir, else a
temporary directory) and one JSON line gives the card's time a step by
category of kernel name (`category`: conv for cuDNN's and cuBLAS's
kernels, pool-fwd, pool-bwd, lrn for the response-norm kernels, prologue,
dropout for the dropout and step-draws kernels, copy, elementwise, other)
and the idle share of the window: the part of the time from the card's
first kernel or copy to its last in which none ran. On a card the trace
records the card's activity alone (with the host's operators recorded
too, the slowed host leaves the card idle half of an eager step). On the
CPU the trace holds no device events: the line says "device": "cpu" with
no categories and a null idle share.
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch import optim
from convnet_tpu_torch.bench import CLASSES, RAW_MARGIN, alexnet_graph, train_jitter
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.graph import ET, Graph
from convnet_tpu_torch.ops import KERNEL_NAMES
from convnet_tpu_torch.ops.conv import conv2d, fc
from convnet_tpu_torch.ops.lrn import response_norm_cross_map, response_norm_reference
from convnet_tpu_torch.ops.pool import maxpool2d
from convnet_tpu_torch.trainer import (
    JitterTensors,
    draw_step,
    init_state,
    make_eval_step,
    make_train_step,
    preprocess,
    rng_tensor,
)
from convnet_tpu_torch.utils import card

TRACE_STEPS = 5
#: the category of each of the port's kernels (ops.KERNEL_NAMES)
_OWN = {"lrn_fwd": "lrn", "lrn_bwd": "lrn", "pool_lrn_fwd": "lrn", "pool_lrn_bwd": "lrn",
        "dropout": "dropout", "step_draws": "dropout", "s2d_prologue": "prologue",
        "maxpool_fwd": "pool-fwd", "copy_add": "copy", "crop_window": "copy",
        "relayout": "copy", "crop_deinterleave": "prologue"}
#: Words of cuDNN's and cuBLAS's kernel names (convolutions and GEMMs).
_CONV_WORDS = ("cudnn", "conv", "xmma", "gemm", "gemv", "cutlass", "implicit", "wgrad", "dgrad",
               "fprop", "splitk")
CATEGORIES = ("conv", "pool-fwd", "pool-bwd", "lrn", "prologue", "dropout", "copy",
              "elementwise", "other")


def category(name: str) -> str:
    """The category of a device event by its name (a kernel, or a Memcpy or
    Memset): `tools/traceparse.py`'s categories mapped to CUDA kernels."""
    for kernel, pattern in KERNEL_NAMES.items():
        if re.search(pattern, name):
            return _OWN[kernel]
    n = name.lower()
    if "max_pool" in n or "maxpool" in n:
        return "pool-bwd" if "backward" in n else "pool-fwd"
    if any(w in n for w in _CONV_WORDS):
        return "conv"
    if "memcpy" in n or "memset" in n or "copy" in n or "nchw" in n or "nhwc" in n:
        return "copy"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def timed(name: str, fn: Callable[[], object], device: torch.device, batch: int,
          iters: int) -> Dict:
    """One row: fn's host ms (with a synchronize) and device ms (CUDA events)."""
    host = card.host_ms(fn, device, iters=iters)
    dev = card.cuda_ms(fn, iters=iters) if device.type == "cuda" else None
    return {"name": name, "host_ms": host, "device_ms": dev, "images_per_sec": batch / host * 1e3,
            "batch": batch}


def edge_rows(graph: Graph, params, batch: int, device: torch.device, iters: int,
              gen: torch.Generator) -> List[Dict]:
    """Each conv, FC, max pool and response-norm edge at its true shape,
    forward and forward + backward; the response norms through the
    kernel's wrapper and through the plain version."""
    cdt = torch.bfloat16 if graph.compute_dtype == "bfloat16" else None
    adt = torch.bfloat16 if graph.activation_dtype == "bfloat16" else torch.float32
    size = graph.shapes["input"][0]
    acts = {"input": torch.rand((batch, size, size, 3), dtype=torch.float32, device=device,
                                generator=gen)}
    rows = []

    def both(label, op, *inputs):
        """Rows of op's forward and forward + backward; returns the output."""
        y = op(*inputs)
        leaves = [t.detach().requires_grad_() for t in inputs]
        ones = torch.ones_like(y)

        def fwd_bwd():
            return torch.autograd.grad(op(*leaves), leaves, ones)

        with torch.no_grad():
            rows.append(timed(f"{label} fwd", lambda: op(*inputs), device, batch, iters))
        rows.append(timed(f"{label} fwd+bwd", fwd_bwd, device, batch, iters))
        return y.detach()

    for name in graph.topo_layer_order():
        layer = graph.layer(name)
        if layer.is_input:
            continue
        for e in graph.incoming(name):
            x = acts[e.source]
            if e.edge_type == ET.CONV:
                y = both(e.name, lambda x, w, e=e: conv2d(x, w, e.stride, e.padding, cdt,
                                                         e.num_groups),
                         x, params[e.name]["w"])
            elif e.edge_type == ET.FC:
                y = both(e.name, lambda x, w: fc(x, w, cdt), x, params[e.name]["w"])
                y = y[:, None, None, :]
            elif e.edge_type == ET.MAXPOOL:
                y = both(e.name, lambda x, e=e: maxpool2d(x, e.kernel_size, e.stride, e.padding),
                         x)
            elif e.edge_type == ET.RESPONSE_NORM:
                conf = (e.add_scale, e.pow_scale, e.frac_of_filters_response_norm,
                        e.response_norm_blocked)
                y = both(f"{e.name} [kernel]",
                         lambda x, conf=conf: response_norm_cross_map(x, *conf), x)
                both(f"{e.name} [plain]", lambda x, conf=conf: response_norm_reference(x, *conf),
                     x)
            else:
                continue
            y = torch.relu(y) if layer.activation else y
            acts[name] = y.to(adt)
    return rows


def trace_steps(step, state, data, device: torch.device, trace_dir: Path) -> Dict:
    """TRACE_STEPS train steps under torch.profiler: the card's ms a step by
    category and the idle share of the window. On a card it records the
    card's activity alone: recording every host operator as well slows the
    host enough to leave the card idle half of an eager step."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    card.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        for _ in range(TRACE_STEPS):
            step(state, data)
        card.synchronize(device)
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "train_steps.pt.trace.json"
    prof.export_chrome_trace(str(path))
    return trace_categories(json.loads(path.read_text()).get("traceEvents", []), TRACE_STEPS)


def trace_categories(events: List[Dict], steps: int) -> Dict:
    """From a Chrome trace's events: {"device_ms_per_step": {category: ms},
    "device_busy_ms_per_step", "window_ms", "idle_share"} over the window
    from the first device event's start to the last one's end (kernels,
    copies and memsets); busy is the union of their intervals."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)), ev.get("name", ""))
                   for ev in events
                   if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in ev)
    if not spans:
        return {"device_ms_per_step": {}, "device_busy_ms_per_step": None, "window_ms": None,
                "idle_share": None}
    by_cat = dict.fromkeys(CATEGORIES, 0.0)
    busy, reach = 0.0, spans[0][0]
    for t0, t1, name in spans:
        by_cat[category(name)] += (t1 - t0) / 1e3 / steps
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    window = reach - spans[0][0]
    return {"device_ms_per_step": by_cat, "device_busy_ms_per_step": busy / 1e3 / steps,
            "window_ms": window / 1e3, "idle_share": 1.0 - busy / window if window > 0 else None}


def profile(device: torch.device, batch: int = 256, steps: int = 20, image_size: int = 224,
            seed: int = 0, trace_dir: Optional[str] = None, out=print) -> Dict:
    """Every row and the trace's categories, each passed to `out` as a
    JSON line; returns {"rows": [...], "trace": {...}}."""
    facts = card.device_facts(device)
    graph = alexnet_graph(image_size)
    jitter = train_jitter(image_size)
    raw = image_size + RAW_MARGIN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = {
        "input": torch.randint(0, 256, (batch, raw, raw, 3), dtype=torch.uint8, device=device,
                               generator=gen),
        "labels": torch.randint(0, CLASSES, (batch,), dtype=torch.int32, device=device,
                                generator=gen),
    }
    state = init_state(graph, seed=seed, device=device)
    train = make_train_step(graph, jitter)
    spec, mean, std = jitter["input"]
    eval_step = make_eval_step(graph, {"input": (JitterSpec(image_size, scale=spec.scale), mean,
                                                 std)})
    consts = JitterTensors(jitter)
    rng = rng_tensor(state, device)
    params = {n: {k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for n, p in state["params"].items()}
    leaves = [v for p in params.values() for v in p.values()]

    def fwd_bwd():
        keys, crops = draw_step(graph, jitter, data, rng)
        proc = preprocess(graph, jitter, data, crops, consts)
        loss, _ = model_lib.loss_fn(graph, params, proc, train=True, dropout_keys=keys)
        return torch.autograd.grad(loss, leaves)

    grads_flat = fwd_bwd()
    grads, it = {}, iter(grads_flat)
    for n, p in params.items():
        grads[n] = {k: next(it) for k in p}
    upd_params = {n: {k: v.detach().clone() for k, v in p.items()} for n, p in params.items()}
    moms = optim.init_momentum(upd_params)
    crops = draw_step(graph, jitter, data, rng)[1]

    rows = [
        timed("train step", lambda: train(state, data), device, batch, steps),
        timed("eval forward (loss)", lambda: eval_step(state["params"], data), device, batch,
              steps),
        timed("forward + backward (no update)", fwd_bwd, device, batch, steps),
        timed("update (apply_updates)",
              lambda: optim.apply_updates(graph, upd_params, moms, grads, step=100), device,
              batch, steps),
        timed("prologue", lambda: preprocess(graph, jitter, data, crops, consts), device, batch,
              steps),
    ]
    for r in rows:
        out(json.dumps({**r, **facts}))
    del grads, grads_flat, upd_params, moms
    for r in edge_rows(graph, state["params"], batch, device, steps, gen):
        rows.append(r)
        out(json.dumps({**r, **facts}))
    with tempfile.TemporaryDirectory() as tmp:
        trace = trace_steps(train, state, data, device, Path(trace_dir or tmp))
    trace = {"trace_steps": TRACE_STEPS, "batch": batch, **trace, **facts}
    out(json.dumps(trace))
    return {"rows": rows, "trace": trace}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=20, help="timed calls a row")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-dir", default=None, help="keep the Chrome trace of the 5 steps here")
    add_device_argument(p)
    a = p.parse_args(argv)
    profile(resolve_device(a.device), a.batch, a.steps, a.image_size, a.seed, a.trace_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
