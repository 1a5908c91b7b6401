"""The numbers that decide `correct`, each held to its cell's limit
(`cellbench/limits/<cell>.json`).

Train, three steps of the timed state against the reference's: the
first three, from the seed's weights, and, under names that begin with
"after_", the three after the window, from the state that it left:
- `loss_gap`: the largest of the three steps' |loss - reference| over
  |reference|;
- `grad_gap`: over the leaves, the largest |norm - reference's norm| of
  the first gradient as the optimizer takes it (g + l2 w), over the larger
  of that leaf's reference norm and the median leaf's;
- `change_gap`: the same of the parameters' change after the three steps.
- `grad_err:<leaf>`, `change_err:<leaf>`: each leaf's norm of the
  difference between the program's and the reference's first gradient
  (change), over the reference's norm, on a sample of the leaf's elements
  drawn from the seed (`coordinates`). The norms' gaps are blind to an
  error that turns a vector without changing its length, such as a
  lower precision's; each leaf has a limit of its own, since rounding
  alone turns the gradient of a leaf whose gradient is a small remainder
  of large sums (conv1's) far more than that of the output layer's.
A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone: it is left out of the norms' gaps, and
its element errors read 0 (`leaves_left_out` counts such leaves).

Serve: `logit_gap`, over the images of the requests compared, the
largest root mean square over the classes of the gap between the served
and the reference's log-probabilities, each image's gaps less their mean
(the logits' gap, whatever their common shift). `prob_gap`, the largest
|probability - reference's|, is read beside it by the calibration.
Probabilities under 1e-30 count as 1e-30."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import numpy as np
import torch

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's is left out.
NOUGHT = 1e-3
#: The least probability whose log is compared.
FLOOR = 1e-30
#: Elements of a leaf whose gradient and change are compared one by one.
SAMPLE = 1 << 16


def coordinates(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf: flat indices}: every element of a leaf of SAMPLE or fewer,
    else SAMPLE drawn (with repeats) from a generator seeded by seed + 3."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    out = {}
    for leaf, shape in shapes.items():
        n = int(np.prod(shape))
        out[leaf] = (torch.arange(n, device=device) if n <= SAMPLE else
                     torch.randint(0, n, (SAMPLE,), generator=gen, device=device))
    return out


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves: Iterable[str]) -> float:
    leaves = list(leaves)
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves)


def train_gaps(prog: Dict, ref: Dict, prefix: str = "") -> Dict[str, float]:
    """{"loss_gap", "grad_gap", "change_gap", "leaves_left_out",
    "grad_err:<leaf>", "change_err:<leaf>"}, each name after `prefix`, of
    the program's three steps against the reference's."""
    median = statistics.median(ref["grad"].values())
    leaves = [k for k, v in ref["grad"].items() if v >= NOUGHT * median]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    out = {"loss_gap": loss, "grad_gap": _worst(prog["grad"], ref["grad"], leaves),
           "change_gap": _worst(prog["change"], ref["change"], leaves),
           "leaves_left_out": float(len(ref["grad"]) - len(leaves))}
    for name in ("grad", "change"):
        p, r = prog[f"{name}_at"], ref[f"{name}_at"]
        for k in ref["grad"]:
            err = np.linalg.norm(p[k] - r[k]) / np.linalg.norm(r[k]) if k in leaves else 0.0
            out[f"{name}_err:{k}"] = float(err)
    return {prefix + k: v for k, v in out.items()}


def prob_gap(answers, reference) -> float:
    """The largest |p - reference| over the answers; answers: (key, (B,
    K) probabilities) pairs; reference: {key: (B, K) probabilities}. A
    non-finite answer reads infinite."""
    worst = 0.0
    for key, p in answers:
        p = np.asarray(p, np.float64).reshape(reference[key].shape)
        if not np.all(np.isfinite(p)):
            return float("inf")
        worst = max(worst, float(np.max(np.abs(p - reference[key]))))
    return worst


def logit_gap(answers, reference) -> float:
    """The largest, over the answers' images, root mean square over the
    classes of the centred gap of log-probabilities; answers and reference
    as for prob_gap. A non-finite answer reads infinite."""
    worst = 0.0
    for key, p in answers:
        q = reference[key]
        p = np.asarray(p, np.float64).reshape(q.shape)
        if not np.all(np.isfinite(p)):
            return float("inf")
        d = np.log(np.maximum(p, FLOOR)) - np.log(np.maximum(q, FLOOR))
        d -= d.mean(axis=1, keepdims=True)
        worst = max(worst, float(np.sqrt((d * d).mean(axis=1)).max()))
    return worst
