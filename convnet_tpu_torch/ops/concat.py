"""The concatenating join: a layer fed by CONCAT edges holds its sources'
channels side by side, in the model file's edge order. One ATen call on
the card and the CPU alike; autograd's backward hands each source a view
of the joined gradient."""

from __future__ import annotations

from typing import Sequence

import torch


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B, H, W, C_i) NHWC tensors -> (B, H, W, sum C_i), contiguous."""
    return torch.cat(list(xs), dim=3)
