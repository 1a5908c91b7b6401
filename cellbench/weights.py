"""The cell's inputs, made from its seed: weights, train batches and
serving requests. Both sides, the port and the reference, are given the
same ones.

Weights are made on the device by one torch.Generator seeded by --seed:
every weight of every edge from one standard normal draw in f32, each
edge's slice scaled by its rule, and each bias filled with the edge's
init_bias. Rules (a traffic mix's "init"): "pbtxt" scales by the edge's
init_wt (DENSE_GAUSSIAN, the model file's own start of training); "he"
by sqrt(2 / fan_in), so that activations keep their size through the
ReLUs and the outputs depend on the image, as a trained net's do."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def make_weights(net, seed: int, device, rule: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """{edge: {"w", "b"}} f32 tensors on `device`, each of its own storage,
    for a reference's `Net` (`cellbench/reference/__init__.py`)."""
    shapes = net.param_shapes()
    sizes = [math.prod(shapes[e.name]["w"]) for e in net.weighted]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, dtype=torch.float32, device=device)
    out = {}
    for e, part in zip(net.weighted, torch.split(flat, sizes)):
        if rule == "pbtxt":
            if e.init != "DENSE_GAUSSIAN":
                raise ValueError(f"edge {e.name}: rule pbtxt takes DENSE_GAUSSIAN, not {e.init}")
            scale = e.init_wt
        elif rule == "he":
            scale = math.sqrt(2.0 / net.fan_in(e))
        else:
            raise ValueError(f"weight rule {rule!r}: pbtxt or he")
        out[e.name] = {
            "w": (part * scale).view(shapes[e.name]["w"]),
            "b": torch.full(shapes[e.name]["b"], e.init_bias, dtype=torch.float32, device=device),
        }
    return out


def make_batches(seed: int, count: int, batch: int, raw: int, channels: int, classes: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """`count` distinct train batches on `device`: uint8 (batch, raw, raw,
    channels) images and int32 labels, from a generator seeded by seed + 1
    (apart from the weights' stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    images = torch.randint(0, 256, (count, batch, raw, raw, channels), dtype=torch.uint8,
                           generator=gen, device=device)
    labels = torch.randint(0, classes, (count, batch), dtype=torch.int32, generator=gen,
                           device=device)
    return [{"input": images[i], "labels": labels[i]} for i in range(count)]


def make_requests(seed: int, count: int, batch: int, raw: int, channels: int) -> List[np.ndarray]:
    """`count` distinct serving requests on the host: uint8 (batch, raw,
    raw, channels) arrays."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (count, batch, raw, raw, channels), dtype=np.uint8)
    return [pool[i] for i in range(count)]
