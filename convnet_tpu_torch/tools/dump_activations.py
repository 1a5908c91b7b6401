"""Dump every layer's activations for a fixed input to HDF5 (counterpart
of `tools/dump_activations.py`): a model, a checkpoint (or the port's
seeded init) and seeded synthetic inputs, drawn as the JAX tool draws
them, so the two dumps of one checkpoint can be compared.

Usage:
    python -m convnet_tpu_torch.tools.dump_activations MODEL.pbtxt OUT.h5 \
        [--checkpoint C.h5] [--batch-size 4] [--seed 0] [--image-size N] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch import config, hdf5
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.cli.grad_check import synth_batch
from convnet_tpu_torch.graph import build_graph


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model")
    p.add_argument("output")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=None)
    add_device_argument(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    model = config.read_model(args.model)
    sizes = {lp.name: args.image_size for lp in model.layer if lp.is_input} if args.image_size else {}
    graph = build_graph(model, sizes)
    if args.checkpoint:
        arrays, _, _ = ckpt.load(args.checkpoint, expected_shapes=model_lib.param_shapes(graph))
        params = model_lib.params_from_numpy(arrays, device)
    else:
        params = model_lib.init_params(graph, seed=args.seed, device=device)
    batch = synth_batch(graph, args.batch_size, np.random.RandomState(args.seed), device=device)
    with torch.inference_mode():
        acts = model_lib.apply_fn(graph, params, batch)
    with hdf5.File(args.output, "w") as f:
        f.attrs["model"] = graph.name
        f.attrs["seed"] = args.seed
        for name, arr in acts.items():
            f.create_dataset(name.replace("/", "_"), data=arr.float().cpu().numpy())
        for lname in [l.name for l in graph.input_layers]:
            field = graph.layer(lname).data_field
            f.create_dataset(f"input_{lname}", data=batch[field].cpu().numpy())
    print(f"wrote {args.output}: {len(acts)} activation tensors")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
