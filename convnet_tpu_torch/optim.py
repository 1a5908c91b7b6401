"""Per-edge SGD with momentum, L2 decay and LR/momentum schedules
(counterpart of `convnet_tpu/optim.py`), one hyperparameter set per edge
for weights and biases separately:

    eps(t) = schedule(base_epsilon, t)
    mom(t) = initial + (final - initial) * min(1, t / transition)
    inc   <- mom(t) * inc - eps(t) * (grad + l2_decay * w)
    w     <- w + inc

plus the gradient clip, the max-norm constraint on the last axis and
`start_optimization_after`. Not `torch.optim.SGD`, whose momentum update
has another form. The step counter is a host int, so the schedules are
computed on the host, in float32 as the reference computes them on the
device; the update runs in place on the device tensors, under no_grad.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from convnet_tpu_torch.graph import DECAY, Graph, OptimSpec

Params = Dict[str, Dict[str, torch.Tensor]]

_f32 = np.float32


def epsilon_at(spec: OptimSpec, t: int) -> float:
    ts, base, tt = _f32(spec.epsilon_decay_timescale), _f32(spec.base_epsilon), _f32(t)
    if spec.epsilon_decay == DECAY.NONE:
        return float(base)
    if spec.epsilon_decay == DECAY.INVERSE_T:
        return float(base / (_f32(1.0) + tt / ts))
    if spec.epsilon_decay == DECAY.EXPONENTIAL:
        return float(base * np.power(_f32(0.5), tt / ts))
    if spec.epsilon_decay == DECAY.LINEAR:
        return float(base * np.maximum(_f32(0.0), _f32(1.0) - tt / ts))
    raise ValueError(f"unknown epsilon decay {spec.epsilon_decay}")


def momentum_at(spec: OptimSpec, t: int) -> float:
    frac = np.minimum(_f32(1.0), _f32(t) / _f32(spec.momentum_transition_timescale))
    span = _f32(spec.final_momentum - spec.initial_momentum)
    return float(_f32(spec.initial_momentum) + span * frac)


def init_momentum(params: Params) -> Params:
    return {
        name: {k: torch.zeros_like(v) for k, v in p.items()}
        for name, p in params.items()
    }


def _update_leaf(spec: OptimSpec, w: torch.Tensor, m: torch.Tensor, g: torch.Tensor, t: int):
    """One update of w and its momentum m, in place."""
    if t < spec.start_optimization_after:
        return  # frozen: w and m stay as they are
    g = g + spec.l2_decay * w
    if spec.gradient_clip > 0.0:
        norm = torch.sqrt((g * g).sum())
        g = g * torch.clamp(spec.gradient_clip / (norm + 1e-12), max=1.0)
    inc = momentum_at(spec, t) * m - epsilon_at(spec, t) * g
    new_w = w + inc
    if spec.weight_norm_limit > 0.0 and w.dim() >= 2:
        # max-norm on each output unit's incoming weights (last axis: units)
        axes = tuple(range(w.dim() - 1))
        norms = torch.sqrt((new_w * new_w).sum(dim=axes, keepdim=True))
        new_w = new_w * torch.clamp(spec.weight_norm_limit / (norms + 1e-12), max=1.0)
    w.copy_(new_w)
    m.copy_(inc)


@torch.no_grad()
def apply_updates(graph: Graph, params: Params, moms: Params, grads: Params, step: int) -> None:
    """One SGD step over every weighted edge, in place on params and moms."""
    for e in graph.weighted_edges:
        p, m, g = params[e.name], moms[e.name], grads[e.name]
        _update_leaf(e.weight_optimizer, p["w"], m["w"], g["w"], step)
        _update_leaf(e.bias_optimizer, p["b"], m["b"], g["b"], step)
