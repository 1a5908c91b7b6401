"""A plain reference for a model whose layers join, kept as test data: the
tiny root's configuration "tinyjoin" names it ("reference": "join"), and
the tiny root puts it beside the shared `net` as
`cellbench/reference/join.py`.

It writes out the shared `net`'s edges, and makes each layer the sum of
its incoming edges, as the toolkit joins them (TorontoDeepLearning/
convnet), then its activation and dropout. Layers run in the port's
topological order: passes over the model file's layers, each taking, in
file order, those whose every source is done (so that a dropout mask is
keyed by the layer number that the port keys it by), and a layer's edges
are summed in file order. The loss, the SGD update and the control's
rounding are `net`'s."""

from __future__ import annotations

from typing import Dict, List

import torch

from cellbench.reference import draws, net as base
from cellbench.reference.textproto import parse

exact_f32 = base.exact_f32
train_steps = base.train_steps
_one = base._one


class Net(base.Net):
    """The network of one model file whose layers may join."""

    def __init__(self, text: str, crop: int):
        msg = parse(text)
        self.compute_dtype = _one(msg, "compute_dtype", "float32")
        self.activation_dtype = _one(msg, "activation_dtype", "float32")
        self.layers: Dict[str, base.Layer] = {}
        for m in msg.get("layer", []):
            act = _one(m, "activation", "LINEAR")
            if act not in base._ACTIVATIONS:
                raise ValueError(f"the reference has no activation {act}")
            name = _one(m, "name", "")
            self.layers[name] = base.Layer(
                name, int(_one(m, "num_channels", 1)), act,
                bool(_one(m, "is_input", False)), bool(_one(m, "is_output", False)),
                float(_one(m, "dropprob", 0.0)), _one(m, "data_field", "") or name)
        edges = []
        for m in msg.get("edge", []):
            kind = _one(m, "edge_type", "")
            if kind not in base._EDGES:
                raise ValueError(f"the reference has no edge type {kind}")
            if int(_one(m, "num_groups", 1)) != 1 \
                    or _one(m, "response_norm_blocked", False) \
                    or not _one(m, "shared_bias", True):
                raise ValueError("the reference has no grouped, blocked or unshared edges")
            src, dst = _one(m, "source", ""), _one(m, "dest", "")
            edges.append(base.Edge(
                _one(m, "name", "") or f"{src}:{dst}", src, dst, kind,
                int(_one(m, "kernel_size", 0)), int(_one(m, "stride", 1)),
                int(_one(m, "padding", 0)),
                _one(m, "initialization", "DENSE_GAUSSIAN"),
                float(_one(m, "init_wt", 0.01)), float(_one(m, "init_bias", 0.0)),
                float(_one(m, "add_scale", 0.0)), float(_one(m, "pow_scale", 0.75)),
                float(_one(m, "frac_of_filters_response_norm", 0.25)),
                base.Optim.read(_one(m, "weight_optimizer", {})),
                base.Optim.read(_one(m, "bias_optimizer", {}))))
        self.incoming: Dict[str, List[base.Edge]] = {
            n: [e for e in edges if e.dest == n] for n in self.layers}
        self.shapes = {l.name: (crop, crop, l.channels) for l in self.layers.values()
                       if l.is_input}
        self.order: List[str] = list(self.shapes)
        grew = True
        while grew:
            grew = False
            for l in self.layers.values():
                inc = self.incoming[l.name]
                if l.name in self.shapes or not inc or any(e.source not in self.shapes
                                                           for e in inc):
                    continue
                shapes = {self._out_shape(e) for e in inc}
                if len(shapes) != 1 or next(iter(shapes))[2] != l.channels:
                    raise ValueError(f"layer {l.name}: {l.channels} channels, edges give "
                                     f"{sorted(shapes)}")
                self.shapes[l.name] = shapes.pop()
                self.order.append(l.name)
                grew = True
        if len(self.order) != len(self.layers) or len(edges) != sum(
                len(v) for v in self.incoming.values()):
            raise ValueError("the model has a cycle, or a layer or edge that no input reaches")
        self.edges = [e for n in self.order for e in self.incoming[n]]
        self.outputs = [l for l in self.layers.values() if l.is_output]
        if len(self.outputs) != 1 or self.outputs[0].activation != "SOFTMAX":
            raise ValueError("the reference takes one SOFTMAX output layer")
        self.output = self.outputs[0]
        self.input = next(l for l in self.layers.values() if l.is_input)
        #: non-input layer number, as dropout masks are keyed
        self.layer_number = {n: i for i, n in enumerate(n for n in self.order
                                                         if not self.layers[n].is_input)}

    def _out_shape(self, e: base.Edge):
        h, w, c = self.shapes[e.source]
        if e.kind == "FC":
            return (1, 1, self.layers[e.dest].channels)
        if e.kind == "RESPONSE_NORM":
            return (h, w, c)
        oc = c if e.kind == "MAXPOOL" else self.layers[e.dest].channels
        return (base.out_size(h, e.kernel, e.stride, e.padding),
                base.out_size(w, e.kernel, e.stride, e.padding), oc)

    def forward(self, params, x: torch.Tensor, *, train: bool = False, seed: int = 0,
                step: int = 0, precision: str = "float32") -> torch.Tensor:
        """NCHW f32 input -> the output layer's pre-activation (B, K), f32,
        each layer the sum of its incoming edges. train: apply dropout with
        the masks of (seed, step)."""
        acts = {self.input.name: x}
        for name in self.order:
            l = self.layers[name]
            if l.is_input:
                continue
            z = sum(self._edge(e, acts[e.source], params.get(e.name), precision)
                    for e in self.incoming[name])
            if l.is_output:
                return z.reshape(z.shape[0], -1)
            if l.activation == "RECTIFIED_LINEAR":
                z = torch.relu(z)
            if train and l.dropprob > 0:
                key = draws.layer_key(seed, step, self.layer_number[l.name])
                nhwc = (z.shape[0], z.shape[2], z.shape[3], z.shape[1])
                keep = draws.keep_mask(z.numel(), key, l.dropprob, z.device)
                keep = keep.view(nhwc).permute(0, 3, 1, 2)
                zero = torch.zeros((), device=z.device)
                z = torch.where(keep, z * (1.0 / (1.0 - l.dropprob)), zero)
            acts[l.name] = z
        raise ValueError("no edge reaches the output layer")
