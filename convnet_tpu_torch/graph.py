"""Immutable graph IR compiled from a config.Model proto: the port's
copy of `convnet_tpu/graph.py`, over the port's own schema
(`convnet_tpu_torch.proto`).

Reference counterpart: `ConvNet::BuildNet` (src/convnet.cc [U]) builds a
mutable C++ object DAG of Layer / Edge instances and topo-sorts the
fprop order. Here the proto compiles into *frozen specs* — pure data —
that the model builder (convnet_tpu_torch.model) runs eagerly. The specs
are plain dataclasses, hashable and comparable; enum fields are the
proto's ints, the same numbers in both packages.

Shape convention: NHWC. Every layer's state is (batch, H, W, C); FC
destinations are (batch, 1, 1, units). The reference uses a flattened
cuda-convnet layout — only the *values* are parity targets, not memory
layout (SURVEY.md §7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Tuple

from convnet_tpu_torch import proto as pb

# Enum aliases (ints, stable across the proto).
ACT = pb.Layer.Activation
LOSS = pb.Layer.LossFunction
ET = pb.Edge.EdgeType
INIT = pb.Edge.Initialization
DECAY = pb.Optimizer.Decay

#: Edge types that carry trainable parameters
#: (reference: EdgeWithWeight subclasses [U]).
WEIGHTED_EDGE_TYPES = (ET.FC, ET.CONV, ET.LOCAL, ET.CONV_ONETOONE)


@dataclass(frozen=True)
class OptimSpec:
    """Per-edge SGD hyperparameters (reference: Optimizer proto +
    EdgeWithWeight::UpdateWeights, src/edge_with_weight.cc [U])."""

    base_epsilon: float = 0.01
    epsilon_decay: int = DECAY.NONE
    epsilon_decay_timescale: int = 1
    initial_momentum: float = 0.0
    final_momentum: float = 0.0
    momentum_transition_timescale: int = 1
    l2_decay: float = 0.0
    weight_norm_limit: float = 0.0
    gradient_clip: float = 0.0
    start_optimization_after: int = 0

    @staticmethod
    def from_proto(p: pb.Optimizer) -> "OptimSpec":
        return OptimSpec(
            base_epsilon=p.base_epsilon,
            epsilon_decay=p.epsilon_decay,
            epsilon_decay_timescale=max(1, p.epsilon_decay_timescale),
            initial_momentum=p.initial_momentum,
            final_momentum=p.final_momentum,
            momentum_transition_timescale=max(1, p.momentum_transition_timescale),
            l2_decay=p.l2_decay,
            weight_norm_limit=p.weight_norm_limit,
            gradient_clip=p.gradient_clip,
            start_optimization_after=p.start_optimization_after,
        )


@dataclass(frozen=True)
class LayerSpec:
    """Node of the DAG (reference: class Layer, src/layer.{cc,h} [U])."""

    name: str
    num_channels: int = 1
    activation: int = ACT.LINEAR
    is_input: bool = False
    is_output: bool = False
    dropprob: float = 0.0
    loss_function: int = LOSS.NONE
    data_field: str = ""
    gpu_id: int = 0
    image_size: int = 0
    #: an output layer's weight in the summed loss (the port's schema)
    loss_weight: float = 1.0

    @cached_property
    def span_name(self) -> str:
        """The layer's span in a profiler trace (`utils.timers.span`)."""
        return f"model.layer.{self.name}"

    @staticmethod
    def from_proto(p: pb.Layer) -> "LayerSpec":
        loss = p.loss_function
        if p.is_output and loss == LOSS.NONE:
            # The reference's output layers derive the loss from the
            # activation (softmax -> multinomial CE, logistic -> binary CE).
            if p.activation == ACT.SOFTMAX:
                loss = LOSS.CROSS_ENTROPY_MULTINOMIAL
            elif p.activation == ACT.LOGISTIC:
                loss = LOSS.CROSS_ENTROPY_BINARY
            else:
                loss = LOSS.SQUARED_ERROR
        if not 0.0 <= p.dropprob < 1.0:
            raise ValueError(
                f"layer {p.name!r}: dropprob must be in [0, 1), got "
                f"{p.dropprob} (1.0 would drop everything; the inverted-"
                "dropout scale 1/(1-p) diverges)"
            )
        if not p.loss_weight > 0.0:
            raise ValueError(f"layer {p.name!r}: loss_weight must be positive, got {p.loss_weight}")
        return LayerSpec(
            name=p.name,
            num_channels=p.num_channels,
            activation=p.activation,
            is_input=p.is_input,
            is_output=p.is_output,
            dropprob=p.dropprob,
            loss_function=loss,
            data_field=p.data_field or p.name,
            gpu_id=p.gpu_id,
            image_size=p.image_size,
            loss_weight=p.loss_weight,
        )


@dataclass(frozen=True)
class EdgeSpec:
    """Connection between two layers (reference: class Edge + subclasses,
    src/edge.{cc,h} and per-type files [U])."""

    source: str
    dest: str
    edge_type: int
    name: str = ""
    kernel_size: int = 0
    stride: int = 1
    padding: int = 0
    initialization: int = INIT.DENSE_GAUSSIAN
    init_wt: float = 0.01
    init_bias: float = 0.0
    weight_optimizer: OptimSpec = field(default_factory=OptimSpec)
    bias_optimizer: OptimSpec = field(default_factory=OptimSpec)
    add_scale: float = 0.0
    pow_scale: float = 0.75
    frac_of_filters_response_norm: float = 0.25
    response_norm_blocked: bool = False
    sample_factor: int = 1
    shared_bias: bool = True
    pretrained_model: str = ""
    pretrained_edge_name: str = ""
    gpu_id: int = 0
    num_groups: int = 1

    @property
    def has_weights(self) -> bool:
        return self.edge_type in WEIGHTED_EDGE_TYPES

    @cached_property
    def span_name(self) -> str:
        """The edge's span in a profiler trace (`utils.timers.span`):
        model.edge.<EDGE_TYPE>.<name>."""
        return f"model.edge.{ET.Name(self.edge_type)}.{self.name}"

    @staticmethod
    def from_proto(p: pb.Edge) -> "EdgeSpec":
        if p.num_groups < 1:
            raise ValueError(
                f"edge {p.source}->{p.dest}: num_groups must be >= 1, got "
                f"{p.num_groups}"
            )
        if p.num_groups > 1 and p.edge_type != ET.CONV:
            raise ValueError(
                f"edge {p.source}->{p.dest}: num_groups is only supported on "
                f"CONV edges (grouped convolution), got num_groups="
                f"{p.num_groups} on edge_type {p.edge_type}"
            )
        if p.edge_type in (ET.CONV, ET.LOCAL, ET.MAXPOOL, ET.AVGPOOL):
            if p.stride < 1:
                raise ValueError(
                    f"edge {p.source}->{p.dest}: stride must be >= 1, got "
                    f"{p.stride} (the proto default is 1 — remove the field "
                    "or set a positive value)"
                )
            if p.kernel_size < 1:
                raise ValueError(
                    f"edge {p.source}->{p.dest}: kernel_size must be >= 1, "
                    f"got {p.kernel_size}"
                )
            if p.padding < 0:
                raise ValueError(
                    f"edge {p.source}->{p.dest}: padding must be >= 0, got "
                    f"{p.padding}"
                )
        return EdgeSpec(
            source=p.source,
            dest=p.dest,
            edge_type=p.edge_type,
            name=p.name or f"{p.source}:{p.dest}",
            kernel_size=p.kernel_size,
            stride=p.stride,
            padding=p.padding,
            initialization=p.initialization,
            init_wt=p.init_wt,
            init_bias=p.init_bias,
            weight_optimizer=OptimSpec.from_proto(p.weight_optimizer),
            bias_optimizer=OptimSpec.from_proto(p.bias_optimizer),
            add_scale=p.add_scale,
            pow_scale=p.pow_scale,
            frac_of_filters_response_norm=p.frac_of_filters_response_norm,
            response_norm_blocked=p.response_norm_blocked,
            sample_factor=max(1, p.sample_factor),
            shared_bias=p.shared_bias,
            pretrained_model=p.pretrained_model,
            pretrained_edge_name=p.pretrained_edge_name,
            gpu_id=p.gpu_id,
            num_groups=p.num_groups,
        )


def conv_out_size(in_size: int, kernel: int, stride: int, padding: int) -> int:
    """Output spatial size, cuda-convnet convention (ceil): the last window
    may hang off the padded input and is completed with implicit padding.

    out = 1 + ceil((in + 2*pad - kernel) / stride)

    Matches AlexNet conv1: in=224, k=11, s=4, p=0 -> 55, and overlapping
    pooling: in=55, k=3, s=2 -> 27. (Reference: module-count logic in the
    cuda-convnet conv kernels, cudamat/cudamat_conv*.cu [U].)
    """
    if kernel <= 0:
        raise ValueError(f"kernel_size must be positive, got {kernel}")
    span = in_size + 2 * padding - kernel
    if span < 0:
        raise ValueError(
            f"kernel {kernel} larger than padded input {in_size + 2 * padding}"
        )
    out = 1 + math.ceil(span / stride)
    # cap: the last (possibly partial) window must still overlap the
    # symmetric-padded input — without this, stride > span configs
    # produce a window made entirely of implicit padding
    return min(out, 1 + (in_size + 2 * padding - 1) // stride)


@dataclass(frozen=True)
class Graph:
    """Validated, topo-ordered model graph with inferred shapes.

    `shapes[name] = (H, W, C)` per layer (batch dim excluded).
    """

    name: str
    layers: Tuple[LayerSpec, ...]
    edges: Tuple[EdgeSpec, ...]  # in topological fprop order
    shapes: Dict[str, Tuple[int, int, int]]
    seed: int = 42
    batch_size: int = 128
    max_iter: int = 1000
    display_after: int = 100
    validate_after: int = 0
    validate_batches: int = 0
    checkpoint_after: int = 0
    checkpoint_dir: str = ""
    compute_dtype: str = "float32"
    activation_dtype: str = ""
    parallel_data: int = 1
    parallel_model: int = 1
    remat: bool = False

    # --- lookups -----------------------------------------------------------

    def layer(self, name: str) -> LayerSpec:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def edge(self, name: str) -> EdgeSpec:
        for e in self.edges:
            if e.name == name:
                return e
        raise KeyError(name)

    @property
    def input_layers(self) -> List[LayerSpec]:
        return [l for l in self.layers if l.is_input]

    @property
    def output_layers(self) -> List[LayerSpec]:
        return [l for l in self.layers if l.is_output]

    @property
    def weighted_edges(self) -> List[EdgeSpec]:
        return [e for e in self.edges if e.has_weights]

    def incoming(self, layer_name: str) -> List[EdgeSpec]:
        return [e for e in self.edges if e.dest == layer_name]

    def topo_layer_order(self) -> List[str]:
        """Layer names in fprop order (inputs first)."""
        order = [l.name for l in self.layers if l.is_input]
        for e in self.edges:
            if e.dest not in order:
                order.append(e.dest)
        return order

    @property
    def _key(self):
        """Identity: everything that changes the computation (hash and eq
        derive from the same tuple, so two graphs differing only in
        precision, remat or sharding are never equal)."""
        return (
            self.layers,
            self.edges,
            tuple(sorted(self.shapes.items())),
            self.compute_dtype,
            self.activation_dtype,
            self.parallel_data,
            self.parallel_model,
            self.remat,
        )

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, Graph) and self._key == other._key


def _edge_out_shape(
    e: EdgeSpec, src_shape: Tuple[int, int, int], dest_layer: LayerSpec
) -> Tuple[int, int, int]:
    """Shape rule per edge type (reference: per-edge SetImageSize [U])."""
    h, w, c = src_shape
    t = e.edge_type
    if t == ET.FC:
        return (1, 1, dest_layer.num_channels)
    if t in (ET.CONV, ET.LOCAL, ET.MAXPOOL):
        if t == ET.CONV and e.num_groups > 1:
            if c % e.num_groups or dest_layer.num_channels % e.num_groups:
                raise ValueError(
                    f"grouped conv edge {e.name}: num_groups={e.num_groups} "
                    f"must divide both input channels ({c}) and output "
                    f"channels ({dest_layer.num_channels})"
                )
        oh = conv_out_size(h, e.kernel_size, e.stride, e.padding)
        ow = conv_out_size(w, e.kernel_size, e.stride, e.padding)
        oc = c if t == ET.MAXPOOL else dest_layer.num_channels
        return (oh, ow, oc)
    if t in (ET.RESPONSE_NORM, ET.CONCAT):
        return (h, w, c)
    if t == ET.AVGPOOL:
        # whole windows only: no rule for a window that takes padding or
        # hangs off the input is guessed
        k, s = e.kernel_size, e.stride
        if e.padding or h < k or w < k or (h - k) % s or (w - k) % s:
            raise ValueError(
                f"avgpool edge {e.name}: {k}x{k} windows at stride {s}, padding "
                f"{e.padding} do not tile {h}x{w} whole (a partial window is refused)"
            )
        return ((h - k) // s + 1, (w - k) // s + 1, c)
    if t == ET.CONV_ONETOONE:
        return (h, w, dest_layer.num_channels)
    if t == ET.RGBTOYUV:
        if c != 3:
            raise ValueError(f"rgb_to_yuv edge {e.name}: source has {c} channels")
        return (h, w, 3)
    if t == ET.UPSAMPLE:
        return (h * e.sample_factor, w * e.sample_factor, c)
    if t == ET.DOWNSAMPLE:
        if h % e.sample_factor or w % e.sample_factor:
            raise ValueError(
                f"downsample edge {e.name}: {h}x{w} not divisible by {e.sample_factor}"
            )
        return (h // e.sample_factor, w // e.sample_factor, c)
    raise ValueError(f"unknown edge type {t}")


def _sum_shape(
    l: LayerSpec, inc: List[EdgeSpec], shapes: Dict[str, Tuple[int, int, int]]
) -> Tuple[int, int, int]:
    """Shape of a layer that sums its incoming edges' outputs: theirs, one
    for all."""
    out_shapes = {_edge_out_shape(e, shapes[e.source], l) for e in inc}
    if len(out_shapes) != 1:
        raise ValueError(f"layer {l.name}: incoming edges disagree on shape: {out_shapes}")
    (shape,) = out_shapes
    if shape[2] != l.num_channels:
        raise ValueError(
            f"layer {l.name}: num_channels={l.num_channels} but edges "
            f"produce {shape[2]} channels"
        )
    return shape


def _concat_shape(
    l: LayerSpec, inc: List[EdgeSpec], shapes: Dict[str, Tuple[int, int, int]]
) -> Tuple[int, int, int]:
    """Shape of a layer joined by CONCAT edges: its sources' channels side
    by side, in the model file's edge order, over their common H and W."""
    if any(e.edge_type != ET.CONCAT for e in inc):
        kinds = sorted({ET.Name(e.edge_type) for e in inc})
        raise ValueError(f"layer {l.name}: CONCAT edges mixed with other edge kinds {kinds}")
    spatial = {shapes[e.source][:2] for e in inc}
    if len(spatial) != 1:
        raise ValueError(f"layer {l.name}: concatenated sources disagree on H, W: {spatial}")
    channels = sum(shapes[e.source][2] for e in inc)
    if channels != l.num_channels:
        raise ValueError(
            f"layer {l.name}: num_channels={l.num_channels} but its CONCAT edges bring "
            f"{channels} channels"
        )
    (hw,) = spatial
    return (*hw, channels)


def build_graph(
    model: pb.Model, input_image_sizes: Optional[Dict[str, int]] = None
) -> Graph:
    """Compile a config.Model proto into a validated Graph.

    `input_image_sizes` optionally overrides/supplies the spatial size of
    input layers (the reference gets it from the DataHandler at
    AllocateMemory time [U]); Layer.image_size in the pbtxt also works.
    Input layers with no spatial hint default to 1x1 (pure vector input).
    """
    input_image_sizes = dict(input_image_sizes or {})

    layers = tuple(LayerSpec.from_proto(lp) for lp in model.layer)
    by_name = {l.name: l for l in layers}
    if len(by_name) != len(layers):
        raise ValueError("duplicate layer names in model")

    raw_edges = [EdgeSpec.from_proto(ep) for ep in model.edge]
    for e in raw_edges:
        if e.source not in by_name:
            raise ValueError(f"edge {e.name}: unknown source layer {e.source!r}")
        if e.dest not in by_name:
            raise ValueError(f"edge {e.name}: unknown dest layer {e.dest!r}")
        if by_name[e.dest].is_input:
            raise ValueError(f"edge {e.name}: dest {e.dest!r} is an input layer")
    names = [e.name for e in raw_edges]
    if len(set(names)) != len(names):
        raise ValueError("duplicate edge names in model")

    # Kahn topo sort over layers; order edges by when their dest is ready.
    ready = {l.name for l in layers if l.is_input}
    if not ready:
        raise ValueError("model has no input layer")
    pending = list(raw_edges)
    ordered: List[EdgeSpec] = []
    # shape inference runs alongside the sort
    shapes: Dict[str, Tuple[int, int, int]] = {}
    for l in layers:
        if l.is_input:
            size = input_image_sizes.get(l.name, l.image_size) or 1
            shapes[l.name] = (size, size, l.num_channels)

    while pending:
        progressed = False
        for l in layers:
            if l.name in ready:
                continue
            inc = [e for e in pending if e.dest == l.name]
            if not inc:
                continue
            if all(e.source in ready for e in inc):
                if any(e.edge_type == ET.CONCAT for e in inc):
                    shapes[l.name] = _concat_shape(l, inc, shapes)
                else:
                    shapes[l.name] = _sum_shape(l, inc, shapes)
                ready.add(l.name)
                for e in inc:
                    ordered.append(e)
                    pending.remove(e)
                progressed = True
        if not progressed:
            stuck = sorted({e.dest for e in pending})
            raise ValueError(f"model graph has a cycle or unreachable layers: {stuck}")

    unreached = [l.name for l in layers if l.name not in ready]
    if unreached:
        raise ValueError(f"layers not reachable from inputs: {unreached}")
    if not any(l.is_output for l in layers):
        raise ValueError("model has no output layer")

    par = model.parallel
    # Reference pbtxts encode a model split via per-layer/edge gpu_id pins
    # (src/multigpu_convnet.cc [U]). The rebuild's native form is the mesh
    # `parallel {}` block; when gpu_ids are present without one, derive
    # parallel.model from the number of distinct devices so those configs
    # don't silently run single-device.
    gpu_ids = {l.gpu_id for l in layers} | {e.gpu_id for e in raw_edges}
    if len(gpu_ids) > 1 and not model.HasField("parallel"):
        derived = len(gpu_ids)
        print(
            f"build_graph: model pins layers to {derived} distinct gpu_ids but "
            f"has no parallel {{}} block; deriving parallel.model = {derived} "
            f"(set parallel {{ model: 1 }} explicitly to force single-device)"
        )
        par.model = derived
    return Graph(
        name=model.name,
        layers=layers,
        edges=tuple(ordered),
        shapes=shapes,
        seed=model.seed,
        batch_size=model.batch_size,
        max_iter=model.max_iter,
        display_after=model.display_after,
        validate_after=model.validate_after,
        validate_batches=model.validate_batches,
        checkpoint_after=model.checkpoint_after,
        checkpoint_dir=model.checkpoint_dir,
        compute_dtype=model.compute_dtype,
        activation_dtype=model.activation_dtype,
        parallel_data=max(1, par.data),
        parallel_model=max(1, par.model),
        remat=model.remat,
    )
