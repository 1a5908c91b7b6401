"""The eval forward of the port: input prologue + model (counterpart of
`convnet_tpu/trainer.py` `_preprocess`'s eval branch and `make_forward`).
The train step is not ported yet."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from convnet_tpu.graph import Graph
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch.data.jitter import JitterSpec, center_offsets, jitter_batch
from convnet_tpu_torch.ops.s2d_relayout import jitter_s2d, prologue_plan

#: {data_field: (JitterSpec, mean, std)}, mean/std numpy arrays or None.
JitterMap = Dict[str, Tuple[JitterSpec, Optional[np.ndarray], Optional[np.ndarray]]]


def _as_tensor(v, device):
    return None if v is None else torch.as_tensor(np.array(v, np.float32), device=device)


def preprocess(graph: Graph, jitter: Optional[JitterMap], batch: Dict[str, torch.Tensor]):
    """Eval prologue for image inputs. A uint8 batch whose input layer
    feeds a conv that `prologue_plan` accepts, with a scalar or
    per-channel mean/std, goes through the one-pass space-to-depth
    prologue (center crop); other inputs get `jitter_batch`'s center crop.
    With no jitter map, uint8 inputs are widened to f32."""
    if not jitter:
        return {k: v.float() if v.dtype == torch.uint8 else v for k, v in batch.items()}
    out = dict(batch)
    for field, (spec, mean, std) in jitter.items():
        x = out[field]
        dev = x.device
        if x.dim() == 4 and x.dtype == torch.uint8 and np.ndim(mean) <= 1 and np.ndim(std) <= 1:
            layer = next((l for l in graph.input_layers if l.data_field == field), None)
            edge = prologue_plan(graph, layer.name) if layer is not None else None
            if edge is not None:
                b, h, w, c = x.shape
                cy, cx = center_offsets(h, w, spec.image_size)
                per_channel = [
                    None if v is None else _as_tensor(np.broadcast_to(v, (c,)), dev)
                    for v in (mean, std)
                ]
                out[field] = jitter_s2d(
                    x,
                    torch.full((b,), cy, dtype=torch.int32, device=dev),
                    torch.full((b,), cx, dtype=torch.int32, device=dev),
                    None,
                    crop=spec.image_size,
                    kernel=edge.kernel_size,
                    stride=edge.stride,
                    scale=spec.scale,
                    mean=per_channel[0],
                    std=per_channel[1],
                )
                continue
        out[field] = jitter_batch(x, spec, _as_tensor(mean, dev), _as_tensor(std, dev))
    return out


def make_forward(graph: Graph, layers: List[str], jitter: Optional[JitterMap] = None):
    """(params, batch) -> {layer: activation} for feature extraction and
    serving; the batch holds raw (uint8 or float) NHWC tensors."""

    def fwd(params, batch):
        return model_lib.apply_fn(
            graph, params, preprocess(graph, jitter, batch), return_layers=layers
        )

    return fwd
