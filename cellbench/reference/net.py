"""The plain reference: a model file's network written out in plain
PyTorch, float32, with TF32 off, and none of the port's code.

It reads the model's text itself (`textproto`) and follows the model
file's meaning as the toolkit defines it (TorontoDeepLearning/convnet):

- layers are NHWC (B, H, W, C) to the outside; an FC layer is (B, 1, 1, C);
- a CONV, LOCAL or MAXPOOL edge has out = 1 + ceil((in + 2p - k) / s),
  capped so that the last window still overlaps the input, the window
  that hangs off the high side completed with zeros (conv, local) or
  -inf (max pool);
- weights: CONV (k, k, Cin, Cout), LOCAL (oh, ow, Cin*k*k, Cout) with the
  patch in (Cin, kh, kw) order, FC (H*W*C, units) over the input
  flattened in (H, W, C) order; biases (Cout,);
- RESPONSE_NORM: y_i = x_i (1 + (add_scale / n) sum_{j in [i - n//2,
  i + (n-1)//2]} x_j^2)^(-pow_scale) over channels, n = max(1,
  round(frac * C));
- a layer applies its activation, then in training its dropout (inverted:
  kept units times 1 / (1 - p)), the mask of non-input layer number i
  drawn as the port draws it (`draws`);
- a SOFTMAX output layer's loss is the batch's mean cross entropy;
- SGD per edge and leaf: inc = mom(t) inc - eps(t) (g + l2 w); w += inc.

Where the model file stores activations in bfloat16, a max pool's input
is rounded to bfloat16 (the gradient passes through unrounded), so that
a window whose two largest values are equal there sends the gradient to
the first of them, as it does where the activations are stored: float32
alone would send it to whichever is larger by a rounding.

`precision="fp8"` computes the same network with the operands of every
convolution, local and fully connected product rounded to float8 e4m3
with a scale a tensor (and, in training, their gradients to e5m2): the
precision below the model's bfloat16, the control that the check must
refuse. `precision="bf16"` rounds the same operands and gradients to
bfloat16 instead: the model's own precision, a witness of how far
rounding alone moves each number.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cellbench.reference import draws
from cellbench.reference.textproto import parse

Params = Dict[str, Dict[str, torch.Tensor]]

_OPTIM_DEFAULTS = {
    "base_epsilon": 0.01, "epsilon_decay": "NONE", "epsilon_decay_timescale": 1,
    "initial_momentum": 0.0, "final_momentum": 0.0, "momentum_transition_timescale": 1,
    "l2_decay": 0.0, "weight_norm_limit": 0.0, "gradient_clip": 0.0,
    "start_optimization_after": 0,
}
_WEIGHTED = ("CONV", "LOCAL", "FC")
_EDGES = _WEIGHTED + ("MAXPOOL", "RESPONSE_NORM")
_ACTIVATIONS = ("LINEAR", "RECTIFIED_LINEAR", "SOFTMAX")


def _one(msg, key, default):
    vals = msg.get(key)
    return vals[-1] if vals else default


@dataclass(frozen=True)
class Optim:
    base_epsilon: float
    epsilon_decay: str
    epsilon_decay_timescale: int
    initial_momentum: float
    final_momentum: float
    momentum_transition_timescale: int
    l2_decay: float

    @staticmethod
    def read(msg) -> "Optim":
        v = {k: _one(msg, k, d) for k, d in _OPTIM_DEFAULTS.items()}
        for k in ("weight_norm_limit", "gradient_clip", "start_optimization_after"):
            if v.pop(k):
                raise ValueError(f"the reference has no {k}")
        v["epsilon_decay_timescale"] = max(1, int(v["epsilon_decay_timescale"]))
        v["momentum_transition_timescale"] = max(1, int(v["momentum_transition_timescale"]))
        return Optim(**v)

    def epsilon(self, t: int) -> float:
        f = torch.tensor
        base, ts, tt = f(self.base_epsilon), f(float(self.epsilon_decay_timescale)), f(float(t))
        if self.epsilon_decay == "NONE":
            return float(base)
        if self.epsilon_decay == "EXPONENTIAL":
            return float(base * torch.pow(f(0.5), tt / ts))
        if self.epsilon_decay == "INVERSE_T":
            return float(base / (1.0 + tt / ts))
        if self.epsilon_decay == "LINEAR":
            return float(base * torch.clamp(1.0 - tt / ts, min=0.0))
        raise ValueError(f"epsilon decay {self.epsilon_decay}")

    def momentum(self, t: int) -> float:
        frac = min(1.0, t / self.momentum_transition_timescale)
        return float(torch.tensor(self.initial_momentum)
                     + torch.tensor(self.final_momentum - self.initial_momentum) * frac)


@dataclass(frozen=True)
class Layer:
    name: str
    channels: int
    activation: str
    is_input: bool
    is_output: bool
    dropprob: float
    field: str


@dataclass(frozen=True)
class Edge:
    name: str
    source: str
    dest: str
    kind: str
    kernel: int
    stride: int
    padding: int
    init: str
    init_wt: float
    init_bias: float
    add_scale: float
    pow_scale: float
    frac: float
    wopt: Optim = field(repr=False)
    bopt: Optim = field(repr=False)


def out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    """The toolkit's output size: ceil, with the last window overlapping."""
    n = 1 + math.ceil((size + 2 * padding - kernel) / stride)
    return min(n, 1 + (size + 2 * padding - 1) // stride)


def pads(size: int, kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    """(low, high) padding that fits exactly out_size windows."""
    hi = (out_size(size, kernel, stride, padding) - 1) * stride + kernel - size - padding
    return padding, max(hi, 0)


class _Round(torch.autograd.Function):
    """x rounded to float8 e4m3 under a scale from its largest magnitude;
    its gradient rounded to e5m2 the same way."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class _Bf16(torch.autograd.Function):
    """x rounded to bfloat16 and back; the gradient passes unrounded."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Bf16Both(torch.autograd.Function):
    """x rounded to bfloat16 and back; its gradient the same."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


#: the products' operand rounding of each lower precision
_ROUND = {"fp8": _Round.apply, "bf16": _Bf16Both.apply}


class Net:
    """The network of one model file, its shapes at a crop, its parameters'
    shapes, its forward, its loss and its SGD update."""

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
            self.layers[name] = Layer(name, int(_one(m, "num_channels", 1)), act,
                                      bool(_one(m, "is_input", False)),
                                      bool(_one(m, "is_output", False)),
                                      float(_one(m, "dropprob", 0.0)),
                                      _one(m, "data_field", "") or name)
        self.edges: List[Edge] = []
        for m in msg.get("edge", []):
            kind = _one(m, "edge_type", "")
            if kind not in _EDGES:
                raise ValueError(f"the reference has no edge type {kind}")
            if int(_one(m, "num_groups", 1)) != 1 or _one(m, "response_norm_blocked", False) \
                    or not _one(m, "shared_bias", True):
                raise ValueError("the reference has no grouped, blocked or unshared edges")
            src, dst = _one(m, "source", ""), _one(m, "dest", "")
            self.edges.append(Edge(
                _one(m, "name", "") or f"{src}:{dst}", src, dst, kind,
                int(_one(m, "kernel_size", 0)), int(_one(m, "stride", 1)),
                int(_one(m, "padding", 0)), _one(m, "initialization", "DENSE_GAUSSIAN"),
                float(_one(m, "init_wt", 0.01)), float(_one(m, "init_bias", 0.0)),
                float(_one(m, "add_scale", 0.0)), float(_one(m, "pow_scale", 0.75)),
                float(_one(m, "frac_of_filters_response_norm", 0.25)),
                Optim.read(_one(m, "weight_optimizer", {})),
                Optim.read(_one(m, "bias_optimizer", {}))))
        self.shapes: Dict[str, Tuple[int, int, int]] = {}
        self.order: List[str] = []
        for l in self.layers.values():
            if l.is_input:
                self.shapes[l.name] = (crop, crop, l.channels)
                self.order.append(l.name)
        for e in self.edges:
            if e.source not in self.shapes or e.dest in self.shapes:
                raise ValueError(f"edge {e.name} is out of order or joins a second input")
            h, w, c = self.shapes[e.source]
            dst = self.layers[e.dest]
            if e.kind == "FC":
                shape = (1, 1, dst.channels)
            elif e.kind == "RESPONSE_NORM":
                shape = (h, w, c)
            else:
                oc = c if e.kind == "MAXPOOL" else dst.channels
                shape = (out_size(h, e.kernel, e.stride, e.padding),
                         out_size(w, e.kernel, e.stride, e.padding), oc)
            if shape[2] != dst.channels:
                raise ValueError(f"layer {dst.name}: {dst.channels} channels, edge gives {shape}")
            self.shapes[e.dest] = shape
            self.order.append(e.dest)
        self.outputs = [l for l in self.layers.values() if l.is_output]
        if len(self.outputs) != 1 or self.outputs[0].activation != "SOFTMAX":
            raise ValueError("the reference takes one SOFTMAX output layer")
        self.output = self.outputs[0]
        self.input = next(l for l in self.layers.values() if l.is_input)
        #: non-input layer number, as dropout masks are keyed
        self.layer_number = {n: i for i, n in enumerate(n for n in self.order
                                                         if not self.layers[n].is_input)}

    # -- sizes -----------------------------------------------------------

    @property
    def weighted(self) -> List[Edge]:
        return [e for e in self.edges if e.kind in _WEIGHTED]

    def param_shapes(self) -> Dict[str, Dict[str, Tuple[int, ...]]]:
        out = {}
        for e in self.weighted:
            h, w, c = self.shapes[e.source]
            oh, ow, oc = self.shapes[e.dest]
            if e.kind == "CONV":
                ws = (e.kernel, e.kernel, c, oc)
            elif e.kind == "LOCAL":
                ws = (oh, ow, c * e.kernel * e.kernel, oc)
            else:
                ws = (h * w * c, oc)
            out[e.name] = {"w": ws, "b": (oc,)}
        return out

    def fan_in(self, e: Edge) -> int:
        """Inputs that one output unit of a weighted edge sums."""
        h, w, c = self.shapes[e.source]
        return h * w * c if e.kind == "FC" else e.kernel * e.kernel * c

    def edge_flops(self, e: Edge) -> int:
        """An image's forward FLOPs (2 x multiply-adds) of a weighted edge."""
        oh, ow, oc = self.shapes[e.dest]
        return 2 * oh * ow * oc * self.fan_in(e) if e.kind in _WEIGHTED else 0

    def flops_per_image(self) -> int:
        """An image's forward FLOPs over the conv, local and FC edges."""
        return sum(self.edge_flops(e) for e in self.edges)

    # -- the forward -----------------------------------------------------

    def prologue(self, images: torch.Tensor, crop: int, scale: float, mean: float,
                 offsets=None) -> torch.Tensor:
        """uint8 (B, H, W, C) -> f32 NCHW crops, x * scale - mean; offsets:
        (oy, ox, flips) of a train step, else the centre crop."""
        b, h, w, _ = images.shape
        if offsets is None:
            cy = (h - crop) // 2
            x = images[:, cy:cy + crop, (w - crop) // 2:(w - crop) // 2 + crop]
        else:
            x = draws.crop_images(images, crop, *offsets)
        x = x.float() * torch.tensor(scale, dtype=torch.float32) - torch.tensor(
            mean, dtype=torch.float32)
        return x.permute(0, 3, 1, 2)

    def _edge(self, e: Edge, x: torch.Tensor, p, precision: str) -> torch.Tensor:
        h, w, c = self.shapes[e.source]
        q = _ROUND.get(precision, lambda t: t)
        if e.kind == "FC":
            flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            y = q(flat) @ q(p["w"]) + p["b"]
            return y[:, :, None, None]
        if e.kind == "RESPONSE_NORM":
            n = max(1, int(round(e.frac * c)))
            sq = F.pad(x * x, (0, 0, 0, 0, n // 2, (n - 1) // 2))
            s = sum(sq[:, k:k + c] for k in range(n))
            return x * torch.pow(1.0 + (e.add_scale / n) * s, -e.pow_scale)
        ph, pw = pads(h, e.kernel, e.stride, e.padding), pads(w, e.kernel, e.stride, e.padding)
        if e.kind == "MAXPOOL":
            if self.activation_dtype == "bfloat16":
                x = _Bf16.apply(x)
            x = F.pad(x, (*pw, *ph), value=float("-inf"))
            return F.max_pool2d(x, e.kernel, e.stride)
        x = F.pad(q(x), (*pw, *ph))
        wt = q(p["w"])
        if e.kind == "CONV":
            y = F.conv2d(x, wt.permute(3, 2, 0, 1), stride=e.stride)
        else:
            oh, ow, kkc, oc = wt.shape
            patches = F.unfold(x, e.kernel, stride=e.stride)  # (B, C*k*k, L), C slowest
            y = torch.einsum("bkl,lko->bol", patches, wt.reshape(oh * ow, kkc, oc))
            y = y.reshape(x.shape[0], oc, oh, ow)
        return y + p["b"][None, :, None, None]

    def forward(self, params: Params, x: torch.Tensor, *, train: bool = False,
                seed: int = 0, step: int = 0, precision: str = "float32") -> torch.Tensor:
        """NCHW f32 input -> the output layer's pre-activation (B, K), f32.
        train: apply dropout with the masks of (seed, step)."""
        acts = {self.input.name: x}
        for e in self.edges:
            z = self._edge(e, acts[e.source], params.get(e.name), precision)
            l = self.layers[e.dest]
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

    def probabilities(self, params: Params, x: torch.Tensor, precision: str = "float32"):
        """The output layer's softmax, (B, K), f32."""
        return torch.softmax(self.forward(params, x, precision=precision), dim=-1)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for products and convolutions, as float32 means."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def train_steps(net: Net, params: Params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                seed: int, crop: int, scale: float, mean: float, steps: int = 3,
                precision: str = "float32", rows: Optional[int] = None,
                coords: Optional[Dict[str, torch.Tensor]] = None,
                moms: Optional[Params] = None, t0: int = 0) -> Dict:
    """`steps` SGD steps from `params` (updated in place, f32) and `moms`
    (updated in place; zero where None), from step t0: step t0 + i on
    batches[i] = (uint8 images, int labels) with the draws of (seed, t0 +
    i). rows: use only the first rows of each batch (a fault: part of the
    batch left out). Returns {"loss": [each step's], "grad": {leaf: norm of
    the first step's g + l2 w}, "change": {leaf: norm of the parameters'
    change after the steps}}, leaves named "edge/w"; with coords ({leaf:
    flat indices}), also "grad_at" and "change_at": those elements of the
    two, as numpy arrays."""
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
            offsets = draws.crops(seed, t, net.input.field, images.shape[0], images.shape[1],
                                  crop, images.device)
            x = net.prologue(images, crop, scale, mean, offsets)
            for e, k in leaves:
                params[e.name][k].requires_grad_(True)
            logits = net.forward(params, x, train=True, seed=seed, step=t, precision=precision)
            loss = F.cross_entropy(logits, labels.long())
            grads = torch.autograd.grad(loss, [params[e.name][k] for e, k in leaves])
            out["loss"].append(float(loss.detach()))
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
