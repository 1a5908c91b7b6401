"""Serving numbers on the card: host<->card transfer rates, the
Predictor's latency at small batches and the extract CLI's rows/s
(counterpart of `tools/r3_chip4.py` sections 1-3 and `tools/r3_chip2.py`
sections 2a-2b). Prints one JSON line per measurement:

    python -m convnet_tpu_torch.tools.serving_probe [--device cuda|cpu]
        [--seed N] [--calls 30] [--batches 1,64]
        [--model examples/imagenet/alexnet.pbtxt] [--rows 2048]
        [--out-dir DIR]

1. `transfer_mb_per_s`: host -> device of uint8 (1, 224, 224, 3) (150
   KB), uint8 (64, 224, 224, 3) (9.6 MB), f32 (64, 224, 224, 3) (38.5 MB)
   and uint8 (1024, 256, 256, 3) (201 MB), each from a pageable numpy
   array and landed by a read of one element, 5 calls after one; then
   device -> host of an f32 (1024, 4096) tensor (16 MB).
2. `predictor_latency_ms` at each of --batches: `make_predictor`'s
   Predictor (the model's own dtypes, params from the port's seeded init,
   the eval prologue: center crop from crop + 32, scale 1/255, mean 0.45,
   uint8 wire), --calls calls after one. "wire": `Predictor.__call__`,
   numpy in and numpy out. "device": the Predictor's forward on a uint8
   batch already on the device, ending on its outputs read to the host
   (the JAX script's `pred._compiled` calls). Each line: the mean ms a
   call ("value", the JAX script's figure), the median and the slowest
   call, and images/s at the mean. On a card the "device" line also
   splits the call: `enqueue_ms`, the median host time from a call's
   start until its forward has been enqueued, in the same timed calls
   (the rest of a call waits for the card and reads the outputs back),
   and `forward_device_ms`, the card's time for the forward with the
   host's launches hidden behind a spin (`utils/card.py device_ms`,
   --calls forwards a spin): which of the two sets the latency.
3. `extract_rows_per_s`: --rows random uint8 crop x crop x 3 rows
   written with `write_raw_cache`, a RAW_CACHE data pbtxt (batch 256,
   pipeline_loads, scale 1/255), a checkpoint of the init params
   (`checkpoint.save`), and the extract CLI with `--layers fc7 --timing`
   twice: "cold", in a fresh Python process (`python -m
   convnet_tpu_torch.cli.extract`), and "warm", called in this process
   after the cold run. "value" is rows over the sum of the CLI's
   `--timing` phases (gather, dispatch, readback, write: the extraction
   loop, set-up apart); each line also holds the phases in seconds, the
   wall clock of the run (`wall_s`: for the cold run from the process's
   start to its exit), rows over it, and `setup_s`, the wall clock
   outside the phases (the checkpoint's load, the graph, the
   DataHandler; for the cold run also the interpreter, the imports and
   the card's context).

Every time but `forward_device_ms` is the host clock; each timed call
of sections 1 and 2, but the enqueue, ends on a value read to the host.
The model's `parallel {}` is cleared to one device. Inputs come from
numpy's generator seeded by --seed. The run's device is the card unless
--device cpu is given; with no card it exits before measuring anything. A
line holds the device's name and power limit ("device": "cpu" off a
card). --out-dir keeps the raw cache, the checkpoint and the extracted
features there (default: a temporary directory, deleted after the run).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from convnet_tpu_torch import checkpoint, config
from convnet_tpu_torch.bench import ALEXNET, MEAN, RAW_MARGIN
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.cli import extract as extract_cli
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.data.native import write_raw_cache
from convnet_tpu_torch.graph import Graph, build_graph
from convnet_tpu_torch.model import init_params
from convnet_tpu_torch.predictor import Predictor
from convnet_tpu_torch.utils import card

TRANSFER_CALLS = 5
#: the host -> device arrays of section 1: (dtype, shape)
H2D = ((np.uint8, (1, 224, 224, 3)), (np.uint8, (64, 224, 224, 3)),
       (np.float32, (64, 224, 224, 3)), (np.uint8, (1024, 256, 256, 3)))
D2H = (np.float32, (1024, 4096))
EXTRACT_BATCH = 256
EXTRACT_LAYER = "fc7"
_PHASE = re.compile(r"^\s+(gather|dispatch|readback|write)\s+([0-9.]+) s$")


def read_graph(model_path: str) -> Graph:
    """The model's graph on one device (its `parallel {}` cleared)."""
    model = config.read_model(model_path)
    model.parallel.data = 1
    model.parallel.model = 1
    return build_graph(model)


def crop_size(graph: Graph) -> int:
    (layer,) = graph.input_layers
    return graph.shapes[layer.name][0]


def make_predictor(graph: Graph, params: Dict, batch: int, device) -> Predictor:
    """The probe's Predictor: the eval prologue (center crop from crop +
    RAW_MARGIN, scale 1/255, mean MEAN) on uint8 requests of `batch` rows."""
    crop = crop_size(graph)
    jitter = {"input": (JitterSpec(image_size=crop, scale=1 / 255),
                        np.full((3,), MEAN, np.float32), None)}
    return Predictor(graph, params, batch_size=batch, jitter=jitter, raw_size=crop + RAW_MARGIN,
                     input_dtype=np.uint8, device=device)


def _host_ms(fn: Callable[[], object], calls: int) -> List[float]:
    """Host milliseconds of each of `calls` calls of fn, after one."""
    fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def transfers(device: torch.device, seed: int = 0, calls: int = TRANSFER_CALLS) -> List[Dict]:
    rng = np.random.default_rng(seed)
    facts = card.device_facts(device)
    lines = []

    def line(direction, arr, ms):
        return {"metric": "transfer_mb_per_s", "direction": direction,
                "dtype": arr.dtype.name, "shape": list(arr.shape), "bytes": arr.nbytes,
                "value": arr.nbytes / ms / 1e3, "unit": "MB/s", "ms": ms, "calls": calls,
                **facts}

    for dtype, shape in H2D:
        arr = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
               else rng.standard_normal(shape, dtype=np.float32))
        # a read of one element lands the copy (on the card: waits for it)
        ms = statistics.mean(_host_ms(
            lambda: torch.from_numpy(arr).to(device, copy=True).reshape(-1)[-1].item(), calls))
        lines.append(line("h2d", arr, ms))
        del arr
    dtype, shape = D2H
    big = torch.zeros(shape, dtype=torch.float32, device=device)
    card.synchronize(device)
    ms = statistics.mean(_host_ms(lambda: big.to("cpu", copy=True).numpy(), calls))
    lines.append(line("d2h", np.empty(shape, dtype), ms))
    return lines


def predictor_latency(device: torch.device, graph: Graph, params: Dict, batches: Sequence[int],
                      calls: int = 30, seed: int = 0) -> List[Dict]:
    rng = np.random.default_rng(seed)
    facts = card.device_facts(device)
    raw = crop_size(graph) + RAW_MARGIN
    lines = []
    for batch in batches:
        pred = make_predictor(graph, params, batch, device)
        x = rng.integers(0, 256, (batch, raw, raw, 3), dtype=np.uint8)
        on_device = {"input": torch.from_numpy(x).to(device)}

        enqueued = []  # host ms of each "device" call until its forward was enqueued

        def resident():
            with torch.inference_mode():
                t0 = time.perf_counter()
                out = pred._forward(pred.params, on_device)
                enqueued.append((time.perf_counter() - t0) * 1e3)
                return {k: v.float().cpu().numpy() for k, v in out.items()}

        for mode, fn in (("wire", lambda: pred({"input": x})), ("device", resident)):
            times = _host_ms(fn, calls)
            mean = statistics.mean(times)
            lines.append({"metric": "predictor_latency_ms", "mode": mode, "batch": batch,
                          "value": mean, "unit": "ms", "median_ms": statistics.median(times),
                          "max_ms": max(times), "images_per_sec": batch / mean * 1e3,
                          "calls": calls, **facts})
        if device.type == "cuda":
            with torch.inference_mode():
                forward_ms = card.device_ms(lambda: pred._forward(pred.params, on_device),
                                            k=calls)
            lines[-1].update(enqueue_ms=statistics.median(enqueued[1:]),
                             forward_device_ms=forward_ms)
        del pred, on_device
    return lines


def _package_parent() -> str:
    """The directory that holds convnet_tpu_torch (for a fresh process's
    PYTHONPATH)."""
    return str(Path(__file__).resolve().parents[2])


def extract_runs(device: torch.device, model_path: str, graph: Graph, params: Dict, rows: int,
                 out_dir: str, seed: int = 0) -> List[Dict]:
    """The extract CLI over `rows` random rows, cold (a fresh process) and
    then warm (in this process); its inputs and features stay in out_dir
    (img.cache, data.pbtxt, the checkpoint, feats.h5)."""
    crop = crop_size(graph)
    rng = np.random.default_rng(seed)
    cache = os.path.join(out_dir, "img.cache")
    write_raw_cache(cache, rng.integers(0, 256, (rows, crop, crop, 3), dtype=np.uint8))
    data_pbtxt = os.path.join(out_dir, "data.pbtxt")
    with open(data_pbtxt, "w") as f:
        f.write(f"""name: "extract_bench"
batch_size: {EXTRACT_BATCH}
pipeline_loads: true
data_config {{
  layer_name: "input"
  data_type: RAW_CACHE
  file_pattern: "{cache}"
  image_size: {crop}
  num_colors: 3
  scale: 0.00392156862
}}
""")
    host_params = {e: {k: v.float().cpu().numpy() for k, v in p.items()}
                   for e, p in params.items()}
    ckpt = checkpoint.save(out_dir, graph.name, host_params, None, 0)
    argv = [model_path, data_pbtxt, "--checkpoint", ckpt, "--output",
            os.path.join(out_dir, "feats.h5"), "--layers", EXTRACT_LAYER, "--timing",
            "--device", str(device)]
    facts = card.device_facts(device)
    lines = []
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        if run == "cold":
            proc = subprocess.run(
                [sys.executable, "-m", "convnet_tpu_torch.cli.extract", *argv],
                env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                    filter(None, (_package_parent(), os.environ.get("PYTHONPATH"))))),
                capture_output=True, text=True)
            rc, said = proc.returncode, proc.stdout + proc.stderr
        else:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = extract_cli.main(argv)
            said = out.getvalue()
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"the extract CLI ({run}) exited {rc}: {said[-3000:]}")
        phases = {m.group(1): float(m.group(2)) for m in map(_PHASE.match, said.splitlines())
                  if m}
        looped = sum(phases.values())
        lines.append({"metric": "extract_rows_per_s", "run": run, "value": rows / looped,
                      "unit": "rows/s", "rows": rows, "layer": EXTRACT_LAYER,
                      "batch": EXTRACT_BATCH, "phases_s": phases, "wall_s": seconds,
                      "wall_rows_per_s": rows / seconds, "setup_s": seconds - looped, **facts})
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calls", type=int, default=30, help="timed Predictor calls a line")
    p.add_argument("--batches", default="1,64", help="the Predictor's batch sizes")
    p.add_argument("--model", default=ALEXNET, help="model .pbtxt (default: full-width AlexNet)")
    p.add_argument("--rows", type=int, default=2048, help="rows the extract CLI runs over")
    p.add_argument("--out-dir", default=None,
                   help="keep the extract's raw cache, checkpoint and features here")
    add_device_argument(p)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    for line in transfers(dev, a.seed):
        print(json.dumps(line), flush=True)
    graph = read_graph(a.model)
    params = init_params(graph, seed=a.seed, device=dev)
    for line in predictor_latency(dev, graph, params, [int(b) for b in a.batches.split(",")],
                                  a.calls, a.seed):
        print(json.dumps(line), flush=True)
    with contextlib.ExitStack() as stack:
        out_dir = a.out_dir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(out_dir, exist_ok=True)
        for line in extract_runs(dev, a.model, graph, params, a.rows, out_dir, a.seed):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
