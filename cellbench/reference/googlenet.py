"""The plain reference of GoogLeNet (Inception v1; Szegedy et al., "Going
Deeper with Convolutions", arXiv:1409.4842) as its model file writes it
(`examples/imagenet/port/googlenet.pbtxt`, the configuration `googlenet`):
plain PyTorch, float32, TF32 off, none of the port's code.

It reads the model's text itself (`textproto`) and writes out each layer
from the file: its incoming edges summed, or, where they are CONCAT edges,
their sources side by side along the channels in the file's edge order;
then its activation, then in training its dropout. The edges are the
shared `net`'s (CONV, FC, MAXPOOL, RESPONSE_NORM, the bf16 rounding of a
max pool's input included), and two more:

- CONCAT carries its source unchanged into the joined layer;
- AVGPOOL averages each whole k x k window at stride s (a model file with
  padding or a window that hangs off the input is refused: the paper's
  heads have none).

Layers run in the port's topological order: passes over the file's
layers, each taking, in file order, those whose every source is done, so
that a dropout mask is keyed by the layer number that the port keys it by.

The loss (`train_steps`) is the paper's (Section 5): over the output
layers, each SOFTMAX, the sum of loss_weight x cross entropy (0.3 on the
two auxiliary heads, 1 on the main one), the batch's mean. `Net.output` is
the main head, the output of the largest weight.

Departures from the paper, each also the port's: conv1 takes padding 2
where the paper's 3 would give 113 under the toolkit's ceil rule; the LRN,
the initialization and the optimizer are BVLC Caffe's `bvlc_googlenet`
(the paper gives none); the learning rate schedule is the toolkit's
exponential decay. Departures in the computation alone: a step's gradient
is the sum, over blocks of ROWS images, of each block's share of the
batch's loss, so that a batch of 2048 fits the card in float32; each
block's crops and dropout masks are its rows of the whole batch's draws.
The fp8 control's scales are a block's tensors' (`net._fp8`), not the
whole batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cellbench.reference import draws, net as base
from cellbench.reference.textproto import parse

exact_f32 = base.exact_f32
_one = base._one

#: Images a block of a train step: the gradient is summed over blocks.
ROWS = 128
_EDGES = ("CONV", "FC", "MAXPOOL", "RESPONSE_NORM", "CONCAT", "AVGPOOL")
_ACTIVATIONS = ("LINEAR", "RECTIFIED_LINEAR", "SOFTMAX")


@dataclass(frozen=True)
class Layer:
    name: str
    channels: int
    activation: str
    is_input: bool
    is_output: bool
    dropprob: float
    field: str
    loss_weight: float


class Net(base.Net):
    """The network of one model file whose layers join by sums or by
    concatenation, with one or more SOFTMAX output layers."""

    def __init__(self, text: str, crop: int):
        msg = parse(text)
        self.compute_dtype = _one(msg, "compute_dtype", "float32")
        self.activation_dtype = _one(msg, "activation_dtype", "float32")
        self.layers: Dict[str, Layer] = {}
        for m in msg.get("layer", []):
            act = _one(m, "activation", "LINEAR")
            if act not in _ACTIVATIONS:
                raise ValueError(f"the reference has no activation {act}")
            name = _one(m, "name", "")
            weight = float(_one(m, "loss_weight", 1.0))
            if not weight > 0:
                raise ValueError(f"layer {name}: loss_weight {weight} is not positive")
            self.layers[name] = Layer(
                name, int(_one(m, "num_channels", 1)), act, bool(_one(m, "is_input", False)),
                bool(_one(m, "is_output", False)), float(_one(m, "dropprob", 0.0)),
                _one(m, "data_field", "") or name, weight)
        edges = []
        for m in msg.get("edge", []):
            kind = _one(m, "edge_type", "")
            if kind not in _EDGES:
                raise ValueError(f"the reference has no edge type {kind}")
            if int(_one(m, "num_groups", 1)) != 1 or _one(m, "response_norm_blocked", False) \
                    or not _one(m, "shared_bias", True):
                raise ValueError("the reference has no grouped, blocked or unshared edges")
            src, dst = _one(m, "source", ""), _one(m, "dest", "")
            edges.append(base.Edge(
                _one(m, "name", "") or f"{src}:{dst}", src, dst, kind,
                int(_one(m, "kernel_size", 0)), int(_one(m, "stride", 1)),
                int(_one(m, "padding", 0)), _one(m, "initialization", "DENSE_GAUSSIAN"),
                float(_one(m, "init_wt", 0.01)), float(_one(m, "init_bias", 0.0)),
                float(_one(m, "add_scale", 0.0)), float(_one(m, "pow_scale", 0.75)),
                float(_one(m, "frac_of_filters_response_norm", 0.25)),
                base.Optim.read(_one(m, "weight_optimizer", {})),
                base.Optim.read(_one(m, "bias_optimizer", {}))))
        self.incoming: Dict[str, List[base.Edge]] = {
            n: [e for e in edges if e.dest == n] for n in self.layers}
        self.shapes: Dict[str, Tuple[int, int, int]] = {
            l.name: (crop, crop, l.channels) for l in self.layers.values() if l.is_input}
        self.order: List[str] = list(self.shapes)
        grew = True
        while grew:
            grew = False
            for l in self.layers.values():
                inc = self.incoming[l.name]
                if l.name in self.shapes or not inc or any(e.source not in self.shapes
                                                           for e in inc):
                    continue
                self.shapes[l.name] = self._layer_shape(l, inc)
                self.order.append(l.name)
                grew = True
        if len(self.order) != len(self.layers) or len(edges) != sum(
                len(v) for v in self.incoming.values()):
            raise ValueError("the model has a cycle, or a layer or edge that no input reaches")
        self.edges = [e for n in self.order for e in self.incoming[n]]
        self.outputs = [l for l in self.layers.values() if l.is_output]
        if not self.outputs or any(l.activation != "SOFTMAX" for l in self.outputs):
            raise ValueError("the reference takes SOFTMAX output layers")
        self.output = max(self.outputs, key=lambda l: l.loss_weight)
        self.input = next(l for l in self.layers.values() if l.is_input)
        #: non-input layer number, as dropout masks are keyed
        self.layer_number = {n: i for i, n in enumerate(n for n in self.order
                                                         if not self.layers[n].is_input)}

    def _layer_shape(self, l: Layer, inc: List[base.Edge]) -> Tuple[int, int, int]:
        """(H, W, C) of layer l from its incoming edges, or ValueError."""
        if any(e.kind == "CONCAT" for e in inc):
            if any(e.kind != "CONCAT" for e in inc):
                raise ValueError(f"layer {l.name}: CONCAT mixed with other edge kinds")
            spatial = {self.shapes[e.source][:2] for e in inc}
            channels = sum(self.shapes[e.source][2] for e in inc)
            if len(spatial) != 1 or channels != l.channels:
                raise ValueError(f"layer {l.name}: {l.channels} channels, concatenation gives "
                                 f"{sorted(spatial)} x {channels}")
            return (*spatial.pop(), channels)
        shapes = set()
        for e in inc:
            h, w, c = self.shapes[e.source]
            if e.kind == "FC":
                shapes.add((1, 1, l.channels))
            elif e.kind == "RESPONSE_NORM":
                shapes.add((h, w, c))
            elif e.kind == "AVGPOOL":
                k, s = e.kernel, e.stride
                if e.padding or h < k or w < k or (h - k) % s or (w - k) % s:
                    raise ValueError(f"edge {e.name}: a partial average-pool window")
                shapes.add(((h - k) // s + 1, (w - k) // s + 1, c))
            else:
                oc = c if e.kind == "MAXPOOL" else l.channels
                shapes.add((base.out_size(h, e.kernel, e.stride, e.padding),
                            base.out_size(w, e.kernel, e.stride, e.padding), oc))
        if len(shapes) != 1 or next(iter(shapes))[2] != l.channels:
            raise ValueError(f"layer {l.name}: {l.channels} channels, edges give "
                             f"{sorted(shapes)}")
        return shapes.pop()

    def _edge(self, e: base.Edge, x: torch.Tensor, p, precision: str) -> torch.Tensor:
        if e.kind == "CONCAT":
            return x
        if e.kind == "AVGPOOL":
            return F.avg_pool2d(x, e.kernel, e.stride)
        return super()._edge(e, x, p, precision)

    def heads(self, params, x: torch.Tensor, *, train: bool = False, seed: int = 0,
              step: int = 0, precision: str = "float32",
              block: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        """NCHW f32 input -> {output layer: its pre-activation (B, K)}, f32.
        train: apply dropout with the masks of (seed, step); block (start,
        total): x holds rows start.. of a batch of total, whose masks' rows
        these take (the whole of x where None)."""
        acts = {self.input.name: x}
        out = {}
        start, total = block if block is not None else (0, x.shape[0])
        for name in self.order:
            l = self.layers[name]
            if l.is_input:
                continue
            zs = [self._edge(e, acts[e.source], params.get(e.name), precision)
                  for e in self.incoming[name]]
            z = torch.cat(zs, dim=1) if self.incoming[name][0].kind == "CONCAT" else sum(zs)
            if l.is_output:
                out[name] = z.reshape(z.shape[0], -1)
                continue
            if l.activation == "RECTIFIED_LINEAR":
                z = torch.relu(z)
            if train and l.dropprob > 0:
                key = draws.layer_key(seed, step, self.layer_number[l.name])
                b, c, h, w = z.shape
                keep = draws.keep_mask(total * h * w * c, key, l.dropprob, z.device)
                keep = keep.view(total, h, w, c)[start:start + b].permute(0, 3, 1, 2)
                zero = torch.zeros((), device=z.device)
                z = torch.where(keep, z * (1.0 / (1.0 - l.dropprob)), zero)
            acts[name] = z
        return out

    def forward(self, params, x: torch.Tensor, *, train: bool = False, seed: int = 0,
                step: int = 0, precision: str = "float32") -> torch.Tensor:
        """NCHW f32 input -> the main head's pre-activation (B, K), f32."""
        return self.heads(params, x, train=train, seed=seed, step=step,
                          precision=precision)[self.output.name]


def train_steps(net: Net, params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                seed: int, crop: int, scale: float, mean: float, steps: int = 3,
                precision: str = "float32", rows: Optional[int] = None,
                coords: Optional[Dict[str, torch.Tensor]] = None,
                moms=None, t0: int = 0) -> Dict:
    """`steps` SGD steps from `params` and `moms` (both updated in place;
    zero momenta where None), step t0 + i on batches[i] = (uint8 images,
    int labels) with the draws of (seed, t0 + i); the loss of a step is
    the sum over the output layers of loss_weight x cross entropy, the
    batch's mean, and its gradient the sum over blocks of ROWS images.
    rows: use only the first rows of each batch (a fault). Returns what
    `cellbench/reference/__init__.py` lists."""
    start = {n: {k: v.detach().clone() for k, v in p.items()} for n, p in params.items()}
    if moms is None:
        moms = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in params.items()}
    leaves = [(e, k) for e in net.weighted for k in ("w", "b")]
    out = {"loss": [], "grad": {}, "change": {}, "grad_at": {}, "change_at": {}}
    with exact_f32():
        for i in range(steps):
            t = t0 + i
            images, labels = batches[i]
            if rows is not None:
                images, labels = images[:rows], labels[:rows]
            b = images.shape[0]
            oy, ox, flips = draws.crops(seed, t, net.input.field, b, images.shape[1], crop,
                                        images.device)
            for e, k in leaves:
                params[e.name][k].requires_grad_(True)
            grads, loss = None, 0.0
            for r in range(0, b, ROWS):
                s = slice(r, min(r + ROWS, b))
                x = net.prologue(images[s], crop, scale, mean, (oy[s], ox[s], flips[s]))
                heads = net.heads(params, x, train=True, seed=seed, step=t,
                                  precision=precision, block=(r, b))
                part = sum(net.layers[h].loss_weight
                           * F.cross_entropy(z, labels[s].long(), reduction="sum")
                           for h, z in heads.items()) / b
                got = torch.autograd.grad(part, [params[e.name][k] for e, k in leaves])
                grads = list(got) if grads is None else [a + g for a, g in zip(grads, got)]
                loss += float(part.detach())
            out["loss"].append(loss)
            with torch.no_grad():
                for (e, k), g in zip(leaves, grads):
                    w, m = params[e.name][k], moms[e.name][k]
                    spec = e.wopt if k == "w" else e.bopt
                    g = g + spec.l2_decay * w
                    if i == 0:
                        leaf = f"{e.name}/{k}"
                        out["grad"][leaf] = float(torch.linalg.vector_norm(g))
                        if coords is not None:
                            out["grad_at"][leaf] = g.reshape(-1)[coords[leaf]].cpu().numpy()
                    m.mul_(spec.momentum(t)).sub_(spec.epsilon(t) * g)
                    w.add_(m)
    for e, k in leaves:
        leaf = f"{e.name}/{k}"
        params[e.name][k].requires_grad_(False)
        delta = params[e.name][k] - start[e.name][k]
        out["change"][leaf] = float(torch.linalg.vector_norm(delta))
        if coords is not None:
            out["change_at"][leaf] = delta.reshape(-1)[coords[leaf]].cpu().numpy()
    return out
