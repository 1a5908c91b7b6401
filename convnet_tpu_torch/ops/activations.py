"""Layer nonlinearities (counterpart of `convnet_tpu/ops/activations.py`).
Softmax runs over the channel (last) axis in the tensor's dtype; output
layers reach it in f32. The gradients are autograd's, which already
differentiate ReLU (masked by y > 0, so 0 at the kink), sigmoid and tanh
through their outputs, as the reference's custom VJPs do
(activations.py:25-77)."""

from __future__ import annotations

import torch

from convnet_tpu_torch.graph import ACT


def apply_activation(x: torch.Tensor, activation: int) -> torch.Tensor:
    if activation == ACT.LINEAR:
        return x
    if activation == ACT.LOGISTIC:
        return torch.sigmoid(x)
    if activation == ACT.RECTIFIED_LINEAR:
        return torch.relu(x)
    if activation == ACT.SOFTMAX:
        return torch.softmax(x, dim=-1)
    if activation == ACT.TANH:
        return torch.tanh(x)
    raise ValueError(f"unknown activation {activation}")
