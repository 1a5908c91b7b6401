"""Ops of the port: NHWC tensors in and out, as in `convnet_tpu.ops`."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every CUDA kernel's launches in this process so far, by name: each
    wrapper counts where it launches its kernel (replays of a captured CUDA
    graph launch again without the wrappers, and are not counted here)."""
    from convnet_tpu_torch.ops import dropout, fused_pool_lrn, lrn, pool, s2d_relayout

    return {"lrn_fwd": lrn.LAUNCHES, "lrn_bwd": lrn.BWD_LAUNCHES, "dropout": dropout.LAUNCHES,
            "step_draws": dropout.DRAW_LAUNCHES, "s2d_prologue": s2d_relayout.LAUNCHES,
            "maxpool_fwd": pool.LAUNCHES, "pool_lrn_fwd": fused_pool_lrn.LAUNCHES,
            "pool_lrn_bwd": fused_pool_lrn.BWD_LAUNCHES}
