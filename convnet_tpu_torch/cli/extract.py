"""Feature-extraction CLI (counterpart of `convnet_tpu/cli/extract.py`).

Loads a model pbtxt and a checkpoint, runs the forward over a dataset (no
jitter: center crop) and streams the chosen layers' activations into an
HDF5 file, every row once.

Usage:
    python -m convnet_tpu_torch.cli.extract MODEL.pbtxt DATA.pbtxt \
        --checkpoint CKPT.h5 --output OUT.h5 --layers fc7 [fc6 ...] \
        [--device cuda|cpu]
    torchrun --nproc-per-node N -m convnet_tpu_torch.cli.extract ...

Under torchrun the ranks form the model's `parallel {}` mesh (clamped to
the world with a warning), the batch is rounded up to a multiple of its
data axis, each rank computes its rows, and rank 0 gathers them and
writes them in order.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch import config
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch.cli import add_device_argument, init_distributed, resolve_device
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.data.datawriter import DataWriter
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.parallel.mesh import (
    batch_rows,
    mesh_for_graph,
    param_shardings,
    shard_params,
)
from convnet_tpu_torch.trainer import device_batch, make_forward


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="convnet_torch_extract", description=__doc__)
    p.add_argument("model", help="model .pbtxt")
    p.add_argument("data", help="DatasetConfig .pbtxt to extract over")
    p.add_argument("--checkpoint", required=True, help="HDF5 checkpoint")
    p.add_argument(
        "--config",
        default=None,
        help="FeatureExtractorConfig .pbtxt supplying output/layers/batch size",
    )
    p.add_argument("--output", default=None, help="output HDF5 file")
    p.add_argument("--layers", nargs="+", default=None, help="layer names to dump")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument(
        "--strict",
        action="store_true",
        help="fail on pbtxt fields unknown to the schema instead of "
        "parsing leniently with a warning",
    )
    p.add_argument(
        "--timing",
        action="store_true",
        help="print a per-phase wall-time breakdown (gather / dispatch "
        "/ device readback / HDF5 write) at the end",
    )
    add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.strict:
        config.set_strict(True)
    device = resolve_device(args.device)
    joined = init_distributed(device, None)
    try:
        return _extract(args, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _extract(args, device) -> int:
    if args.config:
        fe = config.read_feature_extractor_config(args.config)
        args.output = args.output or fe.output_file
        args.layers = args.layers or list(fe.layer)
        args.batch_size = args.batch_size or fe.batch_size
    if not args.output or not args.layers:
        raise SystemExit("--output and --layers are required (directly or via --config)")
    model = config.read_model(args.model)
    data_cfg = config.read_dataset_config(args.data)
    sizes = {c.layer_name: c.image_size for c in data_cfg.data_config if c.image_size}
    graph = build_graph(model, sizes)
    for name in args.layers:
        graph.layer(name)  # raises KeyError for unknown layers
    mesh = mesh_for_graph(graph)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    # batch size priority: the flag, then the data config's own, then the
    # model's, padded up to a multiple of the mesh's data axis (iter_epoch
    # pads the last batch anyway, so every row is still extracted once)
    bs = (
        args.batch_size
        or (data_cfg.batch_size if data_cfg.HasField("batch_size") else 0)
        or model.batch_size
    )
    if mesh is not None and bs % mesh.data:
        bs += mesh.data - bs % mesh.data
        say(f"batch size rounded up to {bs} (multiple of mesh data axis {mesh.data})")
    data = DataHandler(data_cfg, batch_size=bs, randomize=False)
    for line in data.backend_log():
        say(line)
    rows = batch_rows(mesh, bs)
    try:
        params, _, step = ckpt.load(args.checkpoint, expected_shapes=model_lib.param_shapes(graph))
        params = model_lib.params_from_numpy(params, device)
        if mesh is not None:
            params = shard_params(params, param_shardings(graph, mesh.model), mesh)
        say(f"loaded {args.checkpoint} (step {step})")
        fwd = make_forward(graph, args.layers, data.jitter_specs(), mesh)
        dims = {name: int(np.prod(graph.shapes[name])) for name in args.layers}
        t = {"gather": 0.0, "dispatch": 0.0, "readback": 0.0, "write": 0.0}
        done = 0

        def all_rows(x):
            """The data group's rows of x in order (this rank's without a mesh)."""
            if mesh is None or mesh.data == 1:
                return x
            parts = [torch.empty_like(x) for _ in range(mesh.data)]
            dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
            return torch.cat(parts)

        with DataWriter(args.output, dims) if lead else contextlib.nullcontext() as writer:
            # Every row once: iter_epoch pads the last batch, whose padded
            # rows are trimmed before writing. Double-buffered: batch i+1's
            # copy in, forward and copy out are queued on the device before
            # the host waits for batch i's activations and writes them.
            pending = None

            def drain(pending):
                nonlocal done
                host, ready, valid = pending
                t0 = time.perf_counter()
                if ready is not None:
                    ready.synchronize()
                t["readback"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                if lead:
                    writer.append({name: host[name][:valid].float().numpy()
                                   for name in args.layers})
                t["write"] += time.perf_counter() - t0
                done += valid
                if done % (50 * data.batch_size) < data.batch_size:
                    say(f"extracted {done}/{data.num_rows} rows")

            it = data.iter_epoch()
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                t["gather"] += time.perf_counter() - t0
                if item is None:
                    break
                batch, valid = item
                t0 = time.perf_counter()
                with torch.inference_mode():
                    out = fwd(params, device_batch({k: v[rows] for k, v in batch.items()}, device))
                    # to pinned host memory without blocking; the event
                    # marks when the copies are done
                    host = {name: all_rows(out[name]).to("cpu", non_blocking=True)
                            for name in args.layers}
                ready = None
                if device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record()
                t["dispatch"] += time.perf_counter() - t0
                if pending is not None:
                    drain(pending)
                pending = (host, ready, valid)
            if pending is not None:
                drain(pending)
    finally:
        data.close()
    if args.timing:
        width = max(len(k) for k in t)
        for k, v in t.items():
            say(f"  {k:{width}s} {v:12.6f} s")
    say(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
