"""Command-line entry points of the port (counterparts of
`convnet_tpu/cli/`): `train` takes a model pbtxt and train / val data
pbtxts, `extract` writes chosen layers' activations to HDF5, `grad_check`
finite-differences every weighted edge. Each takes the JAX CLI's arguments
plus `--device` (default "cuda"), and fails where no card is found unless
it is given `--device cpu`.
"""

from __future__ import annotations

import argparse

import torch


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        default="cuda",
        help='torch device to run on (default "cuda"; "cpu" to run on the CPU)',
    )


def resolve_device(name: str) -> torch.device:
    """The device the CLI runs on. A CUDA device that is not there is an
    error, never a quiet fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    return dev
