"""Gradient checker CLI (counterpart of `convnet_tpu/cli/grad_check.py`).

Finite differences against the analytic gradient, per weighted edge: the
analytic side is autograd through the port's forward (the kernels' own
backward Functions included, so on a card an LRN runs through `lrn_fwd`
and `lrn_bwd`); the numeric side perturbs a random subset of each
parameter's elements in place and evaluates the loss twice each.
The loss is the model's (`model.loss_fn`): the output layers' losses,
each times its `loss_weight`, summed.

Usage:
    python -m convnet_tpu_torch.cli.grad_check MODEL.pbtxt [--batch-size 8]
        [--samples 20] [--x64] [--tol 2e-3] [--tol-edge SRC:DST=TOL]
        [--device cuda|cpu]

--x64 checks in float64 on the CPU, whatever --device says. The LRN's math
is f32 in both packages even then (its plain version casts to f32, as the
JAX package's XLA form does), so a model with an LRN edge is checked there
at f32's resolution, as the JAX CLI checks it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from convnet_tpu_torch import config
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.graph import LOSS, build_graph


def synth_batch(graph, batch_size, rng, device="cpu", dtype=torch.float32):
    """Random inputs and targets matching the graph's data fields, drawn
    from `rng` (np.random.RandomState) in the JAX CLI's order; float
    fields are drawn in f32 and take `dtype`."""
    batch = {}
    for l in graph.input_layers:
        h, w, c = graph.shapes[l.name]
        x = rng.randn(batch_size, h, w, c).astype(np.float32)
        batch[l.data_field] = torch.as_tensor(x, device=device).to(dtype)
    for l in graph.output_layers:
        if l.data_field in batch:
            continue  # autoencoder-style: the target aliases an input stream
        k = graph.shapes[l.name][2]
        if l.loss_function == LOSS.CROSS_ENTROPY_MULTINOMIAL:
            batch[l.data_field] = torch.as_tensor(rng.randint(0, k, batch_size), device=device)
        else:
            y = rng.rand(batch_size, k).astype(np.float32)
            batch[l.data_field] = torch.as_tensor(y, device=device).to(dtype)
    return batch


def check_graph(
    graph,
    batch_size=8,
    samples=20,
    eps=1e-3,
    tol=2e-3,
    seed=0,
    log=print,
    use_x64=False,
    tol_edges=None,
    device="cuda",
):
    """Returns (num_failures, max_rel_err). The relative error is
    cuda-convnet's: |analytic - numeric| / max(1, |analytic| + |numeric|).

    device: where to check, the card unless the caller asks for the CPU;
    a CUDA device that is not there raises RuntimeError, as the CLI's
    --device does (never a quiet fall back to the CPU).

    use_x64: check in float64 on the CPU. f32 central differences carry
    cancellation noise of about loss * 1e-7 / eps, which drowns the signal
    for large-loss models (e.g. squared-error reconstruction)."""
    device = torch.device("cpu") if use_x64 else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"check_graph: no CUDA device is available for device={str(device)!r}; "
                           "pass device='cpu' to check on the CPU")
    dtype = torch.float64 if use_x64 else torch.float32
    tol_edges = tol_edges or {}
    rng = np.random.RandomState(seed)
    params = model_lib.init_params(graph, seed=seed, device=device, dtype=dtype)
    batch = synth_batch(graph, batch_size, rng, device, dtype)

    def loss_of():
        with torch.no_grad():
            return float(model_lib.loss_fn(graph, params, batch, train=False)[0])

    # edges and leaves in sorted order, the order the JAX CLI draws its samples in
    keys = [(name, k) for name in sorted(params) for k in sorted(params[name])]
    with torch.enable_grad():
        leaves = [params[name][k].requires_grad_(True) for name, k in keys]
        loss = model_lib.loss_fn(graph, params, batch, train=False)[0]
        grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)

    failures = 0
    max_rel = 0.0
    for (edge_name, leaf_name), g in zip(keys, grads):
        flat = params[edge_name][leaf_name].view(-1)
        g_flat = g.reshape(-1).cpu().numpy()
        idxs = rng.choice(flat.numel(), size=min(samples, flat.numel()), replace=False)
        worst = 0.0
        for i in idxs:
            orig = flat[i].item()
            flat[i] = orig + eps
            lp = loss_of()
            flat[i] = orig - eps
            lm = loss_of()
            flat[i] = orig
            numeric = (lp - lm) / (2 * eps)
            analytic = float(g_flat[i])
            rel = abs(analytic - numeric) / max(1.0, abs(analytic) + abs(numeric))
            worst = max(worst, rel)
        max_rel = max(max_rel, worst)
        edge_tol = tol_edges.get(edge_name, tol)
        status = "OK " if worst <= edge_tol else "FAIL"
        if worst > edge_tol:
            failures += 1
        log(f"{status} {edge_name:>30s}.{leaf_name}  max_rel_err {worst:.2e}")
    return failures, max_rel


def build_argparser():
    p = argparse.ArgumentParser(prog="convnet_torch_grad_check", description=__doc__)
    p.add_argument("model", help="model .pbtxt")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--samples", type=int, default=20)
    p.add_argument(
        "--eps",
        type=float,
        default=None,
        help="finite-difference step (default: 1e-7 with --x64 where "
        "truncation dominates, else 1e-3 to stay above f32 cancellation)",
    )
    p.add_argument(
        "--tol",
        type=float,
        default=2e-3,
        help=(
            "max relative error per edge (default 2e-3 — use --x64 so "
            "finite differences aren't cancellation-limited); loosen a "
            "specific edge with --tol-edge when a ReLU/maxpool kink "
            "sits within eps of a sampled weight"
        ),
    )
    p.add_argument(
        "--tol-edge",
        action="append",
        default=[],
        metavar="SRC:DST=TOL",
        help="per-edge tolerance override, repeatable "
        "(e.g. --tol-edge conv1:pool1=1e-2)",
    )
    p.add_argument("--image-size", type=int, default=None, help="override input size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--x64",
        action="store_true",
        help="check in float64 on the CPU: required for large-loss models where "
        "f32 finite differences are cancellation-limited",
    )
    p.add_argument(
        "--strict",
        action="store_true",
        help="fail on pbtxt fields unknown to the schema instead of "
        "parsing leniently with a warning",
    )
    add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.strict:
        config.set_strict(True)
    # float64 lives on the CPU, as the JAX CLI forces it there
    device = torch.device("cpu") if args.x64 else resolve_device(args.device)
    tol_edges = {}
    for spec in args.tol_edge:
        name, _, val = spec.partition("=")
        if not val:
            raise SystemExit(f"--tol-edge expects SRC:DST=TOL, got {spec!r}")
        tol_edges[name] = float(val)
    if args.eps is None:
        args.eps = 1e-7 if args.x64 else 1e-3
    model = config.read_model(args.model)
    sizes = {}
    if args.image_size:
        for lp in model.layer:
            if lp.is_input:
                sizes[lp.name] = args.image_size
    graph = build_graph(model, sizes)
    failures, max_rel = check_graph(
        graph,
        batch_size=args.batch_size,
        samples=args.samples,
        eps=args.eps,
        tol=args.tol,
        seed=args.seed,
        use_x64=args.x64,
        tol_edges=tol_edges,
        device=device,
    )
    print(f"grad check: {failures} failures, max rel err {max_rel:.2e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
