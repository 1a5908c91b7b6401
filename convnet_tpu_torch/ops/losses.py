"""Output-layer losses and error counts (counterpart of
`convnet_tpu/ops/losses.py`).

Losses take pre-activation logits in their stable log-softmax and
softplus forms and return the SUM over the batch; the model divides by
the batch size. Autograd gives the reference's derivatives (e.g. softmax
cross entropy: probs - target).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convnet_tpu_torch.graph import LOSS


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (B, K); labels: (B,) int class ids -> scalar sum of CE."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).sum()


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits: (B, K); targets in [0, 1] -> scalar sum of per-unit BCE."""
    # log(sigmoid(x)) = -softplus(-x); log(1 - sigmoid(x)) = -softplus(x)
    return (targets * F.softplus(-logits) + (1.0 - targets) * F.softplus(logits)).sum()


def squared_error(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """0.5 * sum of squared differences."""
    return 0.5 * ((pred - targets) ** 2).sum()


def compute_loss(loss_function: int, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if loss_function == LOSS.CROSS_ENTROPY_MULTINOMIAL:
        return softmax_cross_entropy(logits, target)
    if loss_function == LOSS.CROSS_ENTROPY_BINARY:
        return binary_cross_entropy(logits, target)
    if loss_function == LOSS.SQUARED_ERROR:
        return squared_error(logits, target)
    raise ValueError(f"unsupported loss function {loss_function}")


def classification_errors(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Number of top-1 mistakes in the batch (int64 device scalar)."""
    return (logits.argmax(-1) != labels.long()).sum()
