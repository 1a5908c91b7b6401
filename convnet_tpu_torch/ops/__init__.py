"""Ops of the port: NHWC tensors in and out, as in `convnet_tpu.ops`.

Importing this package first calls the CPU's vector math functions once
on one thread (`warm_cpu_math`). In some PyTorch builds (seen in
2.13.0+cpu with MKL 2024.2) the first `torch.sqrt` of a process, when it
is large enough to be split over OpenMP threads (2048 elements a thread),
now and then returns some threads' chunks with about 11 good bits (3e-4
relative); every later call is exact. The plain versions of the kernels
(the LRN chain among them) take sqrt, exp, log and tanh from that library,
and every module that computes with them imports this package first.
"""

from typing import Dict

import torch


def warm_cpu_math() -> None:
    """First use of sqrt, exp, log and tanh on the CPU on one thread: a
    tensor far below the size at which a unary op is split over threads."""
    one = torch.ones(8, dtype=torch.float32)
    for fn in (torch.sqrt, torch.exp, torch.log, torch.tanh):
        fn(one)


warm_cpu_math()


#: Each wrapper's CUDA kernels by their names on the card (csrc/), as a
#: profiler's trace shows them: a pattern for re.search. `copy_add` is the
#: chip probes' add (ops/copy_add.py), and `crop_window`, `relayout` and
#: `crop_deinterleave` the gather probes' kernels (ops/gather.py), on no
#: model's path.
KERNEL_NAMES = {
    "lrn_fwd": r"\blrn_fwd_(regs|generic)\b", "lrn_bwd": r"\blrn_bwd_kernel\b",
    "dropout": r"\bdropout_kernel\b", "step_draws": r"\bstep_draws_kernel\b",
    "s2d_prologue": r"\bs2d_prologue_kernel\b", "maxpool_fwd": r"\bmaxpool_fwd_kernel\b",
    "pool_lrn_fwd": r"\bpool_lrn_fwd_(fast|generic)\b",
    "pool_lrn_bwd": r"\bpool_lrn_bwd_(fast|generic)\b",
    "copy_add": r"\bcopy_add_kernel\b",
    "crop_window": r"\bcrop_window_kernel\b", "relayout": r"\brelayout_(run|tile)_kernel\b",
    "crop_deinterleave": r"\bcrop_deinterleave_kernel\b",
}


def launch_counts() -> Dict[str, int]:
    """Every CUDA kernel's launches in this process so far, by name: each
    wrapper counts where it launches its kernel (replays of a captured CUDA
    graph launch again without the wrappers, and are not counted here)."""
    from convnet_tpu_torch.ops import (copy_add, dropout, fused_pool_lrn, gather, lrn, pool,
                                       s2d_relayout)

    return {"lrn_fwd": lrn.LAUNCHES, "lrn_bwd": lrn.BWD_LAUNCHES, "dropout": dropout.LAUNCHES,
            "step_draws": dropout.DRAW_LAUNCHES, "s2d_prologue": s2d_relayout.LAUNCHES,
            "maxpool_fwd": pool.LAUNCHES, "pool_lrn_fwd": fused_pool_lrn.LAUNCHES,
            "pool_lrn_bwd": fused_pool_lrn.BWD_LAUNCHES, "copy_add": copy_add.LAUNCHES,
            "crop_window": gather.CROP_WINDOW_LAUNCHES, "relayout": gather.RELAYOUT_LAUNCHES,
            "crop_deinterleave": gather.CROP_DEINTERLEAVE_LAUNCHES}
