"""Per-edge SGD with momentum, L2 decay and LR/momentum schedules
(counterpart of `convnet_tpu/optim.py`), one hyperparameter set per edge
for weights and biases separately:

    eps(t) = schedule(base_epsilon, t)
    mom(t) = initial + (final - initial) * min(1, t / transition)
    inc   <- mom(t) * inc - eps(t) * (grad + l2_decay * w)
    w     <- w + inc

plus the gradient clip, the max-norm constraint on the last axis and
`start_optimization_after`. Not `torch.optim.SGD`, whose momentum update
has another form. The schedules are computed on the host, in float32 as
the reference computes them on the device; the update runs in place on
the device tensors, under no_grad. An eager step passes the step counter
as a host int. A CUDA graph of the step, which replays every host value it
captured, reads the step's values from a device tensor instead
(`schedule`: eps, momentum and whether the leaf updates, one row a leaf),
filled before each replay; the f32 arithmetic is the same, so are the
results. An eager step updates the leaves that share l2, eps and
momentum, and take no clip, norm limit or shard, together: one launch of
each operation for all of them (`_update_group`), the same roundings in
the same order, so the same bits as one leaf at a time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from convnet_tpu_torch import ops  # noqa: F401  (its import warms the CPU's vector math)
from convnet_tpu_torch.graph import DECAY, Graph, OptimSpec
from convnet_tpu_torch.utils.timers import span

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


def _leaves(graph: Graph):
    """(edge, "w" or "b", its OptimSpec) for every leaf, in schedule-row order."""
    for e in graph.weighted_edges:
        yield e, "w", e.weight_optimizer
        yield e, "b", e.bias_optimizer


def schedule(graph: Graph, t: int) -> np.ndarray:
    """(leaves, 3) f32: eps(t), mom(t) and 1 if the leaf updates at step t
    (0 before its start_optimization_after), one row a leaf."""
    return np.array(
        [(epsilon_at(spec, t), momentum_at(spec, t), float(t >= spec.start_optimization_after))
         for _, _, spec in _leaves(graph)],
        dtype=np.float32,
    ).reshape(-1, 3)


def _update_leaf(spec: OptimSpec, w: torch.Tensor, m: torch.Tensor, g: torch.Tensor, eps, mom,
                 active=True, group=None):
    """One update of w and its momentum m, in place. eps, mom: host floats,
    or 0-d f32 device tensors; active: a host bool, or a 0-d device tensor
    (1: update, 0: keep w and m); group: the process group over which w is
    sharded (the clip's norm is the whole leaf's), or None."""
    if active is False:
        return  # frozen: w and m stay as they are
    g = g + spec.l2_decay * w
    if spec.gradient_clip > 0.0:
        sq = (g * g).sum()
        if group is not None:
            dist.all_reduce(sq, group=group)
        norm = torch.sqrt(sq)
        g = g * torch.clamp(spec.gradient_clip / (norm + 1e-12), max=1.0)
    inc = mom * m - eps * g
    new_w = w + inc
    if spec.weight_norm_limit > 0.0 and w.dim() >= 2:
        # max-norm on each output unit's incoming weights (last axis: units)
        axes = tuple(range(w.dim() - 1))
        norms = torch.sqrt((new_w * new_w).sum(dim=axes, keepdim=True))
        new_w = new_w * torch.clamp(spec.weight_norm_limit / (norms + 1e-12), max=1.0)
    if isinstance(active, torch.Tensor):
        on = active > 0
        new_w, inc = torch.where(on, new_w, w), torch.where(on, inc, m)
    w.copy_(new_w)
    m.copy_(inc)


def _update_group(l2: float, eps: float, mom: float, ws, ms, gs) -> None:
    """`_update_leaf` of many active, unclipped, unconstrained and unsharded
    leaves that share l2, eps and mom (host floats), in place: the same
    roundings in the same order (l2 w, + g, x eps; mom m, - that; w +), a
    launch of each for all the leaves instead of one a leaf, and one
    temporary a leaf."""
    t = torch._foreach_mul(ws, l2)
    torch._foreach_add_(t, gs)
    torch._foreach_mul_(t, eps)
    torch._foreach_mul_(ms, mom)
    torch._foreach_sub_(ms, t)
    torch._foreach_add_(ws, ms)


@torch.no_grad()
def apply_updates(graph: Graph, params: Params, moms: Params, grads: Params,
                  step: Optional[int] = None, hyper: Optional[torch.Tensor] = None,
                  sharded: Optional[Dict[Tuple[str, str], object]] = None) -> None:
    """One SGD step over every weighted edge, in place on params and moms,
    at host step `step`, or with the schedule's values read from `hyper`
    (`schedule`'s rows, on the device). sharded: {(edge, leaf): process
    group} of the leaves that hold a shard of the parameter (a mesh's
    model axis)."""
    sharded = sharded or {}
    if (step is None) == (hyper is None):
        raise ValueError("apply_updates takes the step or its schedule tensor, not both")
    with span("optim.update"):
        groups: Dict[Tuple[float, float, float], list] = {}
        for row, (e, k, spec) in enumerate(_leaves(graph)):
            p, m, g = params[e.name][k], moms[e.name][k], grads[e.name][k]
            if hyper is None:
                eps, mom = epsilon_at(spec, step), momentum_at(spec, step)
                active = step >= spec.start_optimization_after
                group = sharded.get((e.name, k))
                if (active and group is None and spec.gradient_clip <= 0.0
                        and spec.weight_norm_limit <= 0.0):
                    groups.setdefault((spec.l2_decay, eps, mom), []).append((p, m, g))
                else:
                    _update_leaf(spec, p, m, g, eps, mom, active, group)
            else:
                # a leaf that never freezes needs no select
                active = hyper[row, 2] if spec.start_optimization_after > 0 else True
                _update_leaf(spec, p, m, g, hyper[row, 0], hyper[row, 1], active,
                             sharded.get((e.name, k)))
        for (l2, eps, mom), leaves in groups.items():
            _update_group(l2, eps, mom, *map(list, zip(*leaves)))
