"""Headline benchmark of the port: AlexNet train images/s on one card
(counterpart of the repo's `bench.py`).

Runs the full train step (the input prologue on the device, the forward,
the backward and the per-edge SGD update) of full-width AlexNet
(`examples/imagenet/alexnet.pbtxt`, its `parallel {}` cleared to 1x1) on
uint8 256x256 batches and prints one JSON line, last:

    {"metric": "alexnet_train_images_per_sec_per_chip[_rawcache]",
     "value": img/s, "unit": "images/sec", "mfu": ..., "device": ...,
     "power_limit_w": ..., "batch": B, "steps": n, "steps_per_launch": k,
     "data": "synthetic" | "rawcache", "final_loss": x}

`mfu` is img/s x 3 x `conv_flops_per_image` (a train step is about three
forwards' conv and FC FLOPs) over the card's dense bf16 peak
(`utils/card.py`): 989e12 FLOP/s on an H100 SXM, so 145,195 img/s would
be 1.0 at 224. A card whose peak is not known, and the CPU, get null.

    python -m convnet_tpu_torch.bench [--batch B] [--steps N]
        [--steps-per-launch K] [--data synthetic|rawcache]
        [--image-size S] [--device cuda|cpu] [--seed N] [--cache-dir DIR]

The flags take the place of the JAX script's environment variables:
BENCH_BATCH is --batch, BENCH_STEPS --steps, BENCH_UNROLL
--steps-per-launch, BENCH_DATA --data and BENCH_IMAGE_SIZE --image-size.
The JAX script's outer runner (chip-claim deadlines, retries and a ledger
of the last good value) has no counterpart: a failed run fails.

--steps counts timed launches, after 3 warm-up launches; a launch is k
train steps (`make_train_step(unroll=k)`: on a card, k replays of the
step's CUDA graph). The timed window is the host clock from the first
timed launch to the read of the last loss on the host, which must be
finite.

Data: `synthetic` makes one batch (k batches stacked at k > 1) on the
run's device from a torch.Generator seeded by --seed, once, as the JAX
script's `make_data` does. `rawcache` writes max(3 x batch, 3072) random
rows with `write_raw_cache` under --cache-dir (default: a temporary
directory, deleted after the run), reads them through a DataHandler
(random picks from a staged window, `randomize_gpu`, prefetch depth 3),
and stages each next batch on the device while the current step runs; it
takes one step a launch.

The run's device is the card unless --device cpu is given; with no card
it exits before measuring anything. A CPU run prints "device": "cpu" and
"mfu": null.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from convnet_tpu_torch import config
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.data.native import write_raw_cache
from convnet_tpu_torch.graph import ET, Graph, build_graph
from convnet_tpu_torch.trainer import device_batch, init_state, make_train_step
from convnet_tpu_torch.utils import card

METRIC = "alexnet_train_images_per_sec_per_chip"
ALEXNET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "imagenet", "alexnet.pbtxt")
# the sweep's winner on the card (tools/sweep.py; PERF.md §5): batch 4096
# at one step a launch, 43,284 img/s on an H100 80GB HBM3 at 700 W (4
# steps a launch: 43,124; batch 2048: 41,945; 128: 17,068)
DEFAULT_BATCH = 4096
DEFAULT_STEPS_PER_LAUNCH = 1
WARMUP_LAUNCHES = 3
#: a raw image's side over the crop's, as in ImageNet's 256 -> 224
RAW_MARGIN = 32
MEAN = 0.45
CLASSES = 1000


def conv_flops_per_image(graph: Graph) -> int:
    """The forward's FLOPs an image (2 x MACs) of the conv, LOCAL, FC and
    CONV_ONETOONE edges: the count of the JAX script's function."""
    total = 0
    for e in graph.edges:
        h, w, c = graph.shapes[e.dest]
        sh, sw, sc = graph.shapes[e.source]
        if e.edge_type in (ET.CONV, ET.LOCAL):
            total += 2 * h * w * c * e.kernel_size * e.kernel_size * sc
        elif e.edge_type == ET.FC:
            total += 2 * sh * sw * sc * c
        elif e.edge_type == ET.CONV_ONETOONE:
            total += 2 * h * w * sc * c
    return total


def alexnet_graph(image_size: int = 224, dtype: Optional[str] = None) -> Graph:
    """Full-width AlexNet on one device at a crop of image_size; dtype
    "bfloat16" or "float32" sets the compute and activation dtypes (None
    keeps the pbtxt's, bf16)."""
    model = config.read_model(ALEXNET)
    model.parallel.data = 1
    model.parallel.model = 1
    if dtype is not None:
        model.compute_dtype = dtype
        model.activation_dtype = "bfloat16" if dtype == "bfloat16" else ""
    return build_graph(model, {"input": image_size})


def train_jitter(image_size: int):
    """The train prologue: crop image_size from the raw image, random
    translations and flips, scale 1/255, mean 0.45."""
    spec = JitterSpec(image_size=image_size, can_translate=True, can_flip=True, scale=1 / 255)
    return {"input": (spec, np.full((3,), MEAN, np.float32), None)}


def random_batch(lead: tuple, raw: int, device: torch.device,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """uint8 (*lead, raw, raw, 3) images and int32 (*lead,) labels, made
    on `device` from `gen`."""
    return {
        "input": torch.randint(0, 256, (*lead, raw, raw, 3), dtype=torch.uint8, device=device,
                               generator=gen),
        "labels": torch.randint(0, CLASSES, lead, dtype=torch.int32, device=device,
                                generator=gen),
    }


def rawcache_handler(directory: str, batch: int, raw: int, device: torch.device,
                     gen: torch.Generator) -> DataHandler:
    """max(3 x batch, 3072) random rows written as a raw cache under
    `directory`, read by a DataHandler that picks rows at random from a
    staged window (randomize_gpu) with prefetch depth 3."""
    rows = random_batch((max(3 * batch, 3072),), raw, device, gen)
    images, labels = os.path.join(directory, "images.cache"), os.path.join(directory, "labels.cache")
    write_raw_cache(images, rows["input"].cpu().numpy())
    write_raw_cache(labels, rows["labels"].cpu().numpy())
    del rows
    return DataHandler(config.parse_dataset_config(f"""
        name: "bench_rawcache" batch_size: {batch} pipeline_loads: true prefetch_depth: 3
        randomize_gpu: true
        data_config {{ layer_name: "input" data_type: RAW_CACHE file_pattern: "{images}" }}
        data_config {{ layer_name: "labels" data_type: RAW_CACHE file_pattern: "{labels}" }}
    """))


def last_loss(metrics: Dict[str, torch.Tensor]) -> float:
    """The last step's loss, read to the host (k steps a launch give (k,))."""
    return float(metrics["loss"].reshape(-1)[-1])


def measure(graph: Graph, batch: int, steps: int, steps_per_launch: int, data: str,
            device: torch.device, seed: int, cache_dir: Optional[str] = None) -> Dict:
    """Train `graph` for WARMUP_LAUNCHES, then `steps` timed launches of
    steps_per_launch steps; returns {"images_per_sec", "seconds",
    "final_loss", "max_memory_allocated" (bytes; None off a card)}."""
    if data not in ("synthetic", "rawcache"):
        raise ValueError(f"data {data!r}: synthetic or rawcache")
    if steps_per_launch > 1 and data != "synthetic":
        raise ValueError("steps_per_launch > 1 takes only synthetic data")
    if steps < 1 or steps_per_launch < 1:
        raise ValueError(f"steps {steps} and steps_per_launch {steps_per_launch} must be >= 1")
    size = graph.shapes[graph.input_layers[0].name][0]
    raw = size + RAW_MARGIN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launch = make_train_step(graph, train_jitter(size), unroll=steps_per_launch)
    state = init_state(graph, seed=seed, device=device)
    with tempfile.TemporaryDirectory(dir=cache_dir) as tmp:
        handler = None
        if data == "rawcache":
            handler = rawcache_handler(tmp, batch, raw, device, gen)
            nxt = device_batch(handler.get_batch(), device)
        else:
            lead = (batch,) if steps_per_launch == 1 else (steps_per_launch, batch)
            nxt = random_batch(lead, raw, device, gen)
        try:
            for _ in range(WARMUP_LAUNCHES):
                metrics = launch(state, nxt)
            last_loss(metrics)
            t0 = time.perf_counter()
            for i in range(steps):
                metrics = launch(state, nxt)
                if handler is not None and i + 1 < steps:
                    # gathered and copied while the step runs on the device
                    nxt = device_batch(handler.get_batch(), device)
            final_loss = last_loss(metrics)
            seconds = time.perf_counter() - t0
        finally:
            if handler is not None:
                handler.close()
    if not np.isfinite(final_loss):
        raise FloatingPointError(f"the last loss is {final_loss}")
    return {
        "images_per_sec": batch * steps * steps_per_launch / seconds,
        "seconds": seconds,
        "final_loss": final_loss,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }


def main(batch: int = DEFAULT_BATCH, steps: int = 20,
         steps_per_launch: int = DEFAULT_STEPS_PER_LAUNCH, data: str = "synthetic",
         image_size: int = 224, device: str = "cuda", seed: int = 0,
         cache_dir: Optional[str] = None) -> Dict:
    """Measure, print the JSON line and return it as a dict."""
    dev = resolve_device(device)
    graph = alexnet_graph(image_size)
    got = measure(graph, batch, steps, steps_per_launch, data, dev, seed, cache_dir)
    ips = got["images_per_sec"]
    line = {
        "metric": METRIC + ("_rawcache" if data == "rawcache" else ""),
        "value": ips,
        "unit": "images/sec",
        "mfu": card.mfu(ips, 3 * conv_flops_per_image(graph), dev),
        **card.device_facts(dev),
        "batch": batch,
        "steps": steps,
        "steps_per_launch": steps_per_launch,
        "data": data,
        "final_loss": got["final_loss"],
    }
    print(json.dumps(line), flush=True)
    return line


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    p.add_argument("--steps", type=int, default=20, help="timed launches")
    p.add_argument("--steps-per-launch", type=int, default=DEFAULT_STEPS_PER_LAUNCH)
    p.add_argument("--data", choices=("synthetic", "rawcache"), default="synthetic")
    p.add_argument("--image-size", type=int, default=224, help="the crop (224: full AlexNet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=None,
                   help="where --data rawcache writes its rows (a temporary directory in it)")
    add_device_argument(p)
    a = p.parse_args(argv)
    main(a.batch, a.steps, a.steps_per_launch, a.data, a.image_size, a.device, a.seed,
         a.cache_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
