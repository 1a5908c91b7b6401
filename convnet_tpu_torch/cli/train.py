"""Train CLI (counterpart of `convnet_tpu/cli/train.py`).

Usage:
    python -m convnet_tpu_torch.cli.train MODEL.pbtxt TRAIN_DATA.pbtxt \
        [VAL_DATA.pbtxt] [--output-dir DIR] [--max-iter N] [--batch-size N] \
        [--steps-per-launch K] [--device cuda|cpu]
    torchrun --nproc-per-node N -m convnet_tpu_torch.cli.train ... \
        [--data-parallel D] [--model-parallel M] [--backend nccl|gloo]

Builds the graph from the model pbtxt (input sizes from the data config),
resumes from the newest checkpoint in the output dir if there is one, runs
the train loop and, when the model sets checkpoint_after, saves a
checkpoint at the end. Under torchrun the ranks form the model's `parallel
{}` mesh (clamped to the world with a warning); rank 0 logs and writes the
checkpoints.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from convnet_tpu_torch import config
from convnet_tpu_torch.cli import (
    add_backend_argument,
    add_device_argument,
    init_distributed,
    resolve_device,
)
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.trainer import Trainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="convnet_torch_train", description=__doc__)
    p.add_argument("model", help="model .pbtxt")
    p.add_argument("train_data", help="training DatasetConfig .pbtxt")
    p.add_argument("val_data", nargs="?", default=None, help="validation DatasetConfig .pbtxt")
    p.add_argument("--output-dir", default=None, help="checkpoint/output directory")
    p.add_argument("--max-iter", type=int, default=None, help="override model max_iter")
    p.add_argument("--batch-size", type=int, default=None, help="override batch size")
    p.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace of steps 5-15 here",
    )
    p.add_argument(
        "--data-parallel",
        type=int,
        default=None,
        help="override Model.parallel.data (batch-sharding ways; a mesh larger "
        "than the world of ranks is clamped with a warning)",
    )
    p.add_argument(
        "--model-parallel",
        type=int,
        default=None,
        help="override Model.parallel.model (unit- and channel-sharding ways; "
        "clamped likewise)",
    )
    p.add_argument(
        "--steps-per-launch",
        type=int,
        default=1,
        help="train steps per launch: on a card, k replays of the step's CUDA "
        "graph over k batches staged together (default 1: eager steps; a mesh "
        "on cards needs the nccl backend for k > 1)",
    )
    p.add_argument(
        "--strict",
        action="store_true",
        help="fail on pbtxt fields unknown to the schema instead of "
        "parsing leniently with a warning",
    )
    add_device_argument(p)
    add_backend_argument(p)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.strict:
        config.set_strict(True)
    device = resolve_device(args.device)
    joined = init_distributed(device, args.backend)
    try:
        return _train(args, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, device) -> int:
    model = config.read_model(args.model)
    if args.batch_size:
        model.batch_size = args.batch_size
    if args.data_parallel is not None:
        model.parallel.data = args.data_parallel
    if args.model_parallel is not None:
        model.parallel.model = args.model_parallel
    train_cfg = config.read_dataset_config(args.train_data)
    train_data = DataHandler(train_cfg, batch_size=model.batch_size, seed=model.seed)
    val_data = None
    if args.val_data:
        val_cfg = config.read_dataset_config(args.val_data)
        val_data = DataHandler(val_cfg, batch_size=model.batch_size, randomize=False)
    try:
        graph = build_graph(model, train_data.input_image_sizes())
        trainer = Trainer(
            graph,
            train_data,
            val_data,
            checkpoint_dir=args.output_dir,
            model_proto=model,
            steps_per_launch=args.steps_per_launch,
            device=device,
        )
        trainer.train(max_iter=args.max_iter, profile_dir=args.profile_dir)
        if graph.checkpoint_after:
            trainer.save()
    finally:
        train_data.close()
        if val_data:
            val_data.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
