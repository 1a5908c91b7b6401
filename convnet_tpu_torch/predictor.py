"""Fixed-batch inference: the serving side of the port (counterpart of
`convnet_tpu/predictor.py`).

PyTorch runs eagerly, so there is no ahead-of-time compile; the first
request builds the CUDA kernels if the checkout has no built library yet.
Requests arrive as numpy arrays; each input field is staged through one
pinned host buffer per field and copied to the device asynchronously.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch.graph import Graph
from convnet_tpu_torch.model import param_shapes
from convnet_tpu_torch.trainer import JitterMap, make_forward

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


class Predictor:
    """Fixed-batch forward pass over chosen layers.

    With a jitter map the forward runs the model's eval prologue -- center
    crop from `raw_size` (default: the crop size itself) plus scale/mean/
    std -- so clients ship raw pre-crop images. `input_dtype=np.uint8` is
    the uint8 wire format (4x less host->device traffic): with a jitter
    map the crop runs on uint8 and the affine on the device; without one
    the bytes are widened to f32 on the device as they are. Fields outside
    the jitter map always travel as f32.

    params: {edge: {"w", "b"}} tensors or numpy arrays, in the JAX
    package's layouts (see model.params_from_numpy). Outputs come back as
    numpy arrays; bf16 layers are widened to f32."""

    def __init__(
        self,
        graph: Graph,
        params: Dict,
        layers: Optional[List[str]] = None,
        batch_size: int = 128,
        jitter: Optional[JitterMap] = None,
        raw_size: Optional[int] = None,
        input_dtype=np.float32,
        device="cuda",
    ):
        self.graph = graph
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.layers = layers or [l.name for l in graph.output_layers]
        for name in self.layers:
            graph.layer(name)  # validate early
        if raw_size is not None:
            if jitter is None:
                raise ValueError("raw_size needs a jitter map (it defines the crop)")
            crop = max(spec.image_size for spec, _, _ in jitter.values())
            if raw_size < crop:
                raise ValueError(f"raw_size {raw_size} < crop size {crop}")
        self._input_dtype = np.dtype(input_dtype)
        if self._input_dtype not in _TORCH_DTYPES:
            raise TypeError(f"input_dtype must be uint8 or float32, got {self._input_dtype}")
        self.params = {
            name: {
                k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32)))
                .to(self.device, torch.float32)
                for k, v in p.items()
            }
            for name, p in params.items()
        }
        self._forward = make_forward(graph, self.layers, jitter)
        jittered = frozenset(jitter or ())
        # only image fields of the jitter map take input_dtype; with no
        # jitter map at all it applies to every field
        self._wire_dtype = {
            l.data_field: (
                self._input_dtype if (not jitter or l.data_field in jittered)
                else np.dtype(np.float32)
            )
            for l in graph.input_layers
        }
        self._staging = {}
        pin = self.device.type == "cuda"
        for l in graph.input_layers:
            h, w, c = graph.shapes[l.name]
            if jitter and l.data_field in jitter:
                h = w = raw_size or jitter[l.data_field][0].image_size
            self._staging[l.data_field] = torch.empty(
                (batch_size, h, w, c),
                dtype=_TORCH_DTYPES[self._wire_dtype[l.data_field]],
                pin_memory=pin,
            )

    @classmethod
    def from_checkpoint(
        cls,
        graph: Graph,
        path: str,
        layers=None,
        batch_size: int = 128,
        jitter=None,
        raw_size=None,
        input_dtype=np.float32,
        device="cuda",
    ) -> "Predictor":
        """A Predictor over the params of a checkpoint file (any layout
        `checkpoint.load` accepts, weights coerced to the graph's shapes)."""
        params, _, _ = ckpt.load(path, expected_shapes=param_shapes(graph))
        return cls(graph, params, layers, batch_size, jitter, raw_size, input_dtype, device)

    def _stage(self, k: str, v, n: int) -> torch.Tensor:
        want = self._wire_dtype[k]
        v = np.asarray(v)
        if want == np.uint8 and v.dtype != np.uint8:
            # a cast to uint8 silently wraps out-of-range values (300 -> 44,
            # -1.0 -> 255): fail loudly on floats or wide integers
            if np.issubdtype(v.dtype, np.floating) or (v.size and (v.min() < 0 or v.max() > 255)):
                raise TypeError(
                    f"input {k!r}: this Predictor takes uint8 inputs but got "
                    f"{v.dtype} with values outside 0..255; pass raw 0..255 "
                    "images (or build the Predictor with input_dtype=float32)"
                )
        buf = self._staging[k]
        if v.shape[1:] != tuple(buf.shape[1:]):
            raise ValueError(f"input {k!r}: shape {v.shape[1:]} != {tuple(buf.shape[1:])}")
        buf[:n].copy_(torch.from_numpy(np.ascontiguousarray(v, want)))
        if n < self.batch_size:
            # pad by repeating the last row; outputs are trimmed to n
            buf[n:].copy_(buf[n - 1 : n].expand(self.batch_size - n, *buf.shape[1:]))
        return buf.to(self.device, non_blocking=True)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Run one batch of up to batch_size rows."""
        n = next(iter(batch.values())).shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch of {n} exceeds batch_size {self.batch_size}")
        if n == 0:
            raise ValueError("empty batch")
        missing = set(self._staging) - set(batch)
        if missing:
            raise ValueError(f"batch lacks input fields {sorted(missing)}")
        staged = {k: self._stage(k, batch[k], n) for k in self._staging}
        with torch.inference_mode():
            out = self._forward(self.params, staged)
            # device -> host waits for the forward, so the staging buffers
            # are free again when this returns
            return {
                k: (v[:n].float() if v.dtype == torch.bfloat16 else v[:n]).cpu().numpy()
                for k, v in out.items()
            }

    def predict_labels(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Top-1 class ids from the output layer of the largest
        `loss_weight` (the first of those on ties): a model's main head,
        not an auxiliary one."""
        outputs = self.graph.output_layers
        out_layer = max(outputs, key=lambda l: l.loss_weight).name
        acts = self(batch)[out_layer]
        return np.argmax(acts.reshape(acts.shape[0], -1), axis=-1)
