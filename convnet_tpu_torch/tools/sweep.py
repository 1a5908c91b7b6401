"""The bench's AlexNet train step over batch x dtype x steps a launch
(counterpart of `tools/tpu_sweep.py`): the sweep that picks
`convnet_tpu_torch.bench`'s default batch and steps a launch on the card.
Prints one JSON line per variant:

    python -m convnet_tpu_torch.tools.sweep [--batches 128,256,512]
        [--dtypes bfloat16,float32] [--steps-per-launch 1,4] [--steps 20]
        [--image-size 224] [--device cuda|cpu] [--seed N]

Each variant is `bench.measure` on synthetic data (3 warm-up launches,
then --steps timed launches, ending on a loss read), with the model's
compute and activation dtypes set as the JAX sweep sets them: bf16 both,
or f32 compute and the pbtxt's default activations. A line holds
ms_per_step, images_per_sec, mfu (against the card's bf16 peak; null for
float32, whose convs run in f32 with TF32 off, and off a card) and, on a
card, torch.cuda.max_memory_allocated in bytes. A variant that runs out of
the card's memory prints its error and the sweep goes on.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
from typing import Dict

import torch

from convnet_tpu_torch.bench import alexnet_graph, conv_flops_per_image, measure
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.utils import card


def time_variant(batch: int, dtype: str, steps_per_launch: int, steps: int,
                 device: torch.device, image_size: int = 224, seed: int = 0) -> Dict:
    graph = alexnet_graph(image_size, dtype)
    got = measure(graph, batch, steps, steps_per_launch, "synthetic", device, seed)
    ips = got["images_per_sec"]
    return {
        "batch": batch,
        "dtype": dtype,
        "steps_per_launch": steps_per_launch,
        "ms_per_step": got["seconds"] / (steps * steps_per_launch) * 1e3,
        "images_per_sec": ips,
        "mfu": (card.mfu(ips, 3 * conv_flops_per_image(graph), device)
                if dtype == "bfloat16" else None),
        "max_memory_allocated": got["max_memory_allocated"],
        "final_loss": got["final_loss"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", default="128,256,512,1024,2048,4096")
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--steps-per-launch", default="1,4")
    p.add_argument("--steps", type=int, default=20, help="timed launches a variant")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    facts = card.device_facts(dev)
    variants = itertools.product([int(b) for b in a.batches.split(",")], a.dtypes.split(","),
                                 [int(k) for k in a.steps_per_launch.split(",")])
    for batch, dtype, k in variants:
        try:
            line = time_variant(batch, dtype, k, a.steps, dev, a.image_size, a.seed)
        except torch.OutOfMemoryError as e:
            line = {"batch": batch, "dtype": dtype, "steps_per_launch": k,
                    "error": str(e).splitlines()[0][:160]}
        print(json.dumps({**line, **facts}), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
