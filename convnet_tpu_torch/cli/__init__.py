"""Command-line entry points of the port (counterparts of
`convnet_tpu/cli/`): `train` takes a model pbtxt and train / val data
pbtxts, `extract` writes chosen layers' activations to HDF5, `grad_check`
finite-differences every weighted edge. Each takes the JAX CLI's arguments
plus `--device` (default "cuda"), and fails where no card is found unless
it is given `--device cpu`.

`train` and `extract` run over a mesh of ranks when launched by torchrun
(`torchrun --nproc-per-node N -m convnet_tpu_torch.cli.train ...`): each
process joins the process group that torchrun's environment describes
(`init_distributed`), NCCL between cards, gloo on the CPU; the train
CLI's `--backend gloo` lets ranks share a card.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist


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


def add_backend_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend",
        choices=("nccl", "gloo"),
        default=None,
        help="the process group's backend under torchrun (default: nccl for "
        "--device cuda, one card a rank; gloo for --device cpu, or to let "
        "ranks share a card)",
    )


def init_distributed(device: torch.device, backend: Optional[str]) -> bool:
    """Join the process group of torchrun's environment (WORLD_SIZE > 1:
    RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) and make this rank's
    card the current one. Returns whether it initialized a group (the
    caller then destroys it); a group that is already up is used as it is,
    and a world of one needs none."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return False
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device_id = None
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise SystemExit(f"local rank {local}: NCCL needs one card a rank and this host "
                             f"has {cards}; pass --backend gloo to let ranks share a card")
        torch.cuda.set_device(local % cards)
        device_id = torch.device("cuda", local % cards) if backend == "nccl" else None
    elif backend == "nccl":
        raise SystemExit("--backend nccl needs --device cuda")
    dist.init_process_group(backend, device_id=device_id)
    return True

