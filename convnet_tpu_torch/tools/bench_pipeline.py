"""Secondary benchmarks of the port: the input prologue's MB/s, the
CIFAR-10 train step's time and AlexNet's inference images/s (counterparts
of `tools/bench_pipeline.py` and of `tools/r5_chip5.py`'s
`bench_alexnet_inference`). Prints one JSON line per metric, each with the
device's name and power limit:

    python -m convnet_tpu_torch.tools.bench_pipeline [--device cuda|cpu]
        [--seed N] [--steps N] [--aug-batch B] [--cifar-batch B]
        [--infer-batches 1024,256] [--image-size S]

- `aug_pipeline_throughput` (MB/s of uint8 input): `jitter_s2d`, the
  prologue the port's train step runs on AlexNet's input (random crops
  and flips, scale 1/255, mean 0.45, into conv1's space-to-depth form; on
  a card the `s2d_prologue` kernel). The JAX script timed `jitter_batch`,
  its general crop; the port's `jitter_batch` is plain torch ops that the
  train step takes only for inputs the prologue cannot feed, so it is not
  what a train step spends. The crops and flips are drawn before the
  timed window, one set a call (`sample_crop_flip` from (seed, call)), as
  the JAX script folds the call's index into its key.
- `cifar10_train_step_time` (ms, and images_per_sec): the train step of
  `models.cifar10()` in f32, as its pbtxt has it, on f32 (B, 32, 32, 3)
  inputs and int labels, no jitter.
- `alexnet_infer_images_per_sec_per_chip` (and ms_per_batch): the eval
  forward of full-width AlexNet (`trainer.make_forward` with the center
  crop, scale 1/255, mean 0.45; bf16) with `init_params` weights, on a
  uint8 batch already on the device, under torch.inference_mode.

Every timed window is the host clock from the first timed call to a value
read to the host after the last. Random inputs come from a torch.Generator
on the run's device seeded by --seed. The run's device is the card unless
--device cpu is given; with no card it exits before measuring anything. A
CPU run's lines say "device": "cpu".
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from convnet_tpu_torch import models
from convnet_tpu_torch.bench import MEAN, RAW_MARGIN, alexnet_graph, train_jitter
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.data.jitter import JitterSpec, sample_crop_flip
from convnet_tpu_torch.model import init_params
from convnet_tpu_torch.ops.s2d_relayout import jitter_s2d, prologue_plan
from convnet_tpu_torch.trainer import init_state, make_forward, make_train_step
from convnet_tpu_torch.utils import card

WARMUP = 3


def bench_aug(device: torch.device, batch: int = 256, crop: int = 224, steps: int = 30,
              seed: int = 0) -> Dict:
    """MB/s of uint8 (batch, crop + 32, crop + 32, 3) input through
    AlexNet's train prologue, `jitter_s2d`."""
    raw = crop + RAW_MARGIN
    edge = prologue_plan(alexnet_graph(crop), "input")
    spec = train_jitter(crop)["input"][0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randint(0, 256, (batch, raw, raw, 3), dtype=torch.uint8, device=device, generator=gen)
    mean = torch.full((3,), MEAN, dtype=torch.float32, device=device)
    draws = [
        sample_crop_flip(torch.tensor([seed, i], dtype=torch.int64, device=device), "input",
                         batch, raw, raw, crop, spec.can_translate, spec.can_flip)
        for i in range(steps + 1)
    ]

    def run(i):
        return jitter_s2d(x, *draws[i], crop=crop, kernel=edge.kernel_size, stride=edge.stride,
                          scale=spec.scale, mean=mean).x

    float(run(steps).reshape(-1)[-1])
    t0 = time.perf_counter()
    for i in range(steps):
        out = run(i)
    float(out.reshape(-1)[-1])
    dt = time.perf_counter() - t0
    return {"metric": "aug_pipeline_throughput", "value": batch * raw * raw * 3 * steps / 1e6 / dt,
            "unit": "MB/s", "batch": batch, "steps": steps, **card.device_facts(device)}


def bench_cifar_step(device: torch.device, batch: int = 256, steps: int = 30,
                     seed: int = 0) -> Dict:
    """ms a train step of the CIFAR-10 net (f32), after WARMUP steps."""
    graph = models.cifar10()
    step = make_train_step(graph)
    state = init_state(graph, seed=seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = {
        "input": torch.rand((batch, 32, 32, 3), dtype=torch.float32, device=device, generator=gen),
        "labels": torch.randint(0, 10, (batch,), dtype=torch.int32, device=device, generator=gen),
    }
    for _ in range(WARMUP):
        m = step(state, data)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, data)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    if loss != loss:
        raise FloatingPointError("the CIFAR-10 step's loss is NaN")
    return {"metric": "cifar10_train_step_time", "value": dt / steps * 1e3, "unit": "ms",
            "images_per_sec": batch * steps / dt, "batch": batch, "steps": steps,
            "final_loss": loss, **card.device_facts(device)}


def bench_alexnet_inference(device: torch.device, batch: int, steps: int = 30,
                            image_size: int = 224, seed: int = 0) -> Dict:
    """images/s of AlexNet's eval forward on a uint8 batch on the device,
    after one warm-up call."""
    graph = alexnet_graph(image_size)
    raw = image_size + RAW_MARGIN
    jitter = {"input": (JitterSpec(image_size=image_size, scale=1 / 255),
                        train_jitter(image_size)["input"][1], None)}
    fwd = make_forward(graph, ["output"], jitter)
    params = init_params(graph, seed=seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = {"input": torch.randint(0, 256, (batch, raw, raw, 3), dtype=torch.uint8,
                                   device=device, generator=gen)}
    with torch.inference_mode():
        float(fwd(params, data)["output"].sum())
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fwd(params, data)
        total = float(out["output"].sum())
        dt = time.perf_counter() - t0
    if total != total:
        raise FloatingPointError("AlexNet's outputs hold a NaN")
    return {"metric": "alexnet_infer_images_per_sec_per_chip", "value": batch * steps / dt,
            "unit": "images/sec", "ms_per_batch": dt / steps * 1e3, "batch": batch,
            "steps": steps, **card.device_facts(device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=30, help="timed calls of each metric")
    p.add_argument("--aug-batch", type=int, default=256)
    p.add_argument("--cifar-batch", type=int, default=256)
    p.add_argument("--infer-batches", default="1024,256")
    p.add_argument("--image-size", type=int, default=224, help="AlexNet's crop")
    add_device_argument(p)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    for batch in (int(b) for b in a.infer_batches.split(",")):
        print(json.dumps(bench_alexnet_inference(dev, batch, a.steps, a.image_size, a.seed)),
              flush=True)
    print(json.dumps(bench_aug(dev, a.aug_batch, a.image_size, a.steps, a.seed)), flush=True)
    print(json.dumps(bench_cifar_step(dev, a.cifar_batch, a.steps, a.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
