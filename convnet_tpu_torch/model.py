"""The model: Graph IR -> the forward and the loss (counterpart of
`convnet_tpu/model.py`).

Params are `{edge_name: {"w": tensor, "b": tensor}}` for weighted edges,
f32 (float64 for the gradient check's --x64), in the JAX package's
layouts (HWIO conv weights, (H*W*C, units) FC weights, (Cin, Cout)
CONV_ONETOONE weights, (out_h, out_w, k*k*Cin, Cout) LOCAL weights), so a
JAX params tree maps over unchanged (`params_from_numpy`).
Activations are NHWC; FC outputs are (B, 1, 1, units).
A layer sums its incoming edges' outputs, or, where they are CONCAT
edges, holds their sources side by side along the channels (one
`ops.concat.concat_channels` under all the edges' spans); an AVGPOOL edge
takes ATen's average pool over whole windows.

The forward keeps the reference's fusion plan and cast points:
- a conv whose ReLU output feeds only a response-norm edge leaves its bias
  to the LRN kernel, which adds it in f32 (model.py:287-303) -- always on
  here, as on the TPU, since the port always has its kernel;
- the ReLU of an LRN's source layer runs inside the LRN (model.py:377-385);
- under CONVNET_POOL_LRN_FUSED=1 a train step's LRN layer whose one
  consumer is a max pool is not materialized: the pool edge runs
  `lrn_maxpool[_bias]` over the LRN's source, with the reference's
  all-ties pool gradient (model.py:268-365);
- edges compute in compute_dtype (bf16 outputs), a bias is cast to the
  output's dtype before its add (model.py:176), layers are stored in the
  activation dtype (model.py:433) and output pre-activations are promoted
  to f32 (model.py:404-409).
With `remat` set, a train forward wraps each weighted edge in
torch.utils.checkpoint, which recomputes its output in the backward
(model.py:386-395).

Under a mesh (`parallel/mesh.py`) the batch holds this rank's rows. An edge
whose weights the model axis shards computes its slice of the output
channels or columns from its local weights, reading its input through
`copy_to_model` and handing its output to `gather_from_model`, so the LRN,
pools, dropout and losses see full channels, as XLA's gathers give the JAX
package. A grouped conv takes the input channels of the groups its
filters lie in. A bias deferred into an LRN is gathered beside the conv's
output. Dropout draws the bits of the rank's rows of the global batch.
The LRN -> max pool fusion is off under any mesh, as in the JAX package
(model.py:275). PyTorch runs eagerly, so activations that only the fused LRN would have
replaced (dead code that XLA drops) are never computed. In training,
autograd differentiates the same forward: the LRN and dropout through
their kernels' autograd Functions, the rest through ATen's and cuDNN's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from convnet_tpu_torch import checkpoint
from convnet_tpu_torch.graph import ACT, ET, INIT, LOSS, EdgeSpec, Graph
from convnet_tpu_torch.ops import losses as losses_ops
from convnet_tpu_torch.ops.activations import apply_activation
from convnet_tpu_torch.ops.concat import concat_channels
from convnet_tpu_torch.ops.conv import S2DInput, conv2d, conv_onetoone, fc
from convnet_tpu_torch.ops.dropout import dropout
from convnet_tpu_torch.ops.fused_pool_lrn import (
    fusion_applicable,
    lrn_maxpool_bias,
    pool_lrn_fusion_wanted,
)
from convnet_tpu_torch.ops.lrn import (
    response_norm_cross_map,
    response_norm_cross_map_bias,
)
from convnet_tpu_torch.ops.local import local_conv2d, local_weight_shape
from convnet_tpu_torch.ops.pool import avgpool2d, maxpool2d
from convnet_tpu_torch.ops.resample import downsample, rgb_to_yuv, upsample
from convnet_tpu_torch.parallel.mesh import (
    Mesh,
    copy_to_model,
    edge_is_sharded,
    gather_from_model,
)
from convnet_tpu_torch.utils.timers import span

Params = Dict[str, Dict[str, torch.Tensor]]

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _weight_shape(graph: Graph, e: EdgeSpec) -> Tuple[int, ...]:
    src_h, src_w, src_c = graph.shapes[e.source]
    dst_h, dst_w, dst_c = graph.shapes[e.dest]
    if e.edge_type == ET.FC:
        return (src_h * src_w * src_c, dst_c)
    if e.edge_type == ET.CONV:
        return (e.kernel_size, e.kernel_size, src_c // e.num_groups, dst_c)
    if e.edge_type == ET.CONV_ONETOONE:
        return (src_c, dst_c)
    if e.edge_type == ET.LOCAL:
        return local_weight_shape(dst_h, dst_w, e.kernel_size, src_c, dst_c)
    raise ValueError(f"edge {e.name} has no weights")


def _bias_shape(graph: Graph, e: EdgeSpec) -> Tuple[int, ...]:
    dst_h, dst_w, dst_c = graph.shapes[e.dest]
    if e.edge_type in (ET.CONV, ET.LOCAL) and not e.shared_bias:
        return (dst_h, dst_w, dst_c)
    return (dst_c,)


def param_shapes(graph: Graph) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{edge: {"w": shape, "b": shape}} for every weighted edge."""
    return {
        e.name: {"w": _weight_shape(graph, e), "b": _bias_shape(graph, e)}
        for e in graph.weighted_edges
    }


def _init_weight(rng: np.random.Generator, e: EdgeSpec, shape) -> np.ndarray:
    kind, scale = e.initialization, e.init_wt
    # every layout contracts all but the last dim; for LOCAL that counts the
    # out_h*out_w sites too, as the JAX package does (model.py:461-463)
    fan_in = int(np.prod(shape[:-1]))
    if kind == INIT.CONSTANT:
        return np.full(shape, scale, np.float32)
    if kind == INIT.DENSE_GAUSSIAN:
        return scale * rng.standard_normal(shape, np.float32)
    if kind == INIT.DENSE_GAUSSIAN_SQRT_FAN_IN:
        return (scale / math.sqrt(fan_in)) * rng.standard_normal(shape, np.float32)
    if kind == INIT.DENSE_UNIFORM:
        return rng.uniform(-scale, scale, shape).astype(np.float32)
    if kind == INIT.DENSE_UNIFORM_SQRT_FAN_IN:
        lim = scale / math.sqrt(fan_in)
        return rng.uniform(-lim, lim, shape).astype(np.float32)
    if kind == INIT.SPARSE_GAUSSIAN:
        # ~sqrt(fan_in) nonzero inputs per unit (Martens-style)
        w = scale * rng.standard_normal(shape, np.float32)
        return np.where(rng.random(shape) < 1.0 / math.sqrt(fan_in), w, 0.0).astype(np.float32)
    raise ValueError(f"unknown initialization {kind}")


def init_params(
    graph: Graph, seed: Optional[int] = None, device="cpu", dtype=torch.float32
) -> Params:
    """Initialise every weighted edge with its pbtxt init mode, from numpy
    Generators seeded by (seed, edge index); a PRETRAINED edge loads its
    weights and bias from its checkpoint (`pretrained_model`, the edge
    `pretrained_edge_name` or its own name). The draws are not the JAX
    package's (threefry); parity tests share params via params_from_numpy.
    The values are drawn in f32 and then take `dtype` (float64 for the
    gradient check's --x64, as the JAX package casts its f32 draws)."""
    root = graph.seed if seed is None else seed
    arrays = {}
    for i, e in enumerate(graph.weighted_edges):
        if e.initialization == INIT.PRETRAINED:
            if not e.pretrained_model:
                raise ValueError(f"edge {e.name}: PRETRAINED init without pretrained_model")
            arrays[e.name] = checkpoint.load_edge(
                e.pretrained_model,
                e.pretrained_edge_name or e.name,
                expected_shape=_weight_shape(graph, e),
            )
            continue
        rng = np.random.default_rng((root, i))
        arrays[e.name] = {
            "w": _init_weight(rng, e, _weight_shape(graph, e)),
            "b": np.full(_bias_shape(graph, e), e.init_bias, np.float32),
        }
    return params_from_numpy(arrays, device, dtype)


def params_from_numpy(params, device="cpu", dtype=torch.float32) -> Params:
    """{edge: {"w", "b"}} arrays (a JAX params tree, or numpy) -> the
    port's tensors of `dtype` (f32, or float64), same layouts and values."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return {
        name: {
            k: torch.as_tensor(np.array(v, np_dtype), device=device).to(dtype)
            for k, v in p.items()
        }
        for name, p in params.items()
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _bias_deferral_plan(graph: Graph) -> Dict[str, str]:
    """layer -> the conv edge whose bias the layer's single response-norm
    consumer adds in its kernel (convnet_tpu/model.py:287-303; a conv with
    per-position biases keeps its own add)."""
    plan = {}
    for name in graph.topo_layer_order():
        l = graph.layer(name)
        inc = graph.incoming(name)
        cons = [e for e in graph.edges if e.source == name]
        if (
            not l.is_input
            and not l.is_output
            and l.activation == ACT.RECTIFIED_LINEAR
            and l.dropprob == 0.0
            and len(inc) == 1
            and inc[0].edge_type == ET.CONV
            and inc[0].shared_bias
            and len(cons) == 1
            and cons[0].edge_type == ET.RESPONSE_NORM
        ):
            plan[name] = inc[0].name
    return plan


def _lrn_deferrable(l, inc, consumers, want) -> bool:
    """Whether LRN layer l can be left to its pool consumer's lrn_maxpool
    (convnet_tpu/model.py:312-326): LINEAR, no dropout, not an output, fed
    by one response-norm edge and read by one max pool only, and not
    asked for by the caller (want: the requested layers, None for all)."""
    return (
        len(inc) == 1
        and inc[0].edge_type == ET.RESPONSE_NORM
        and l.activation == ACT.LINEAR
        and l.dropprob == 0.0
        and not l.is_output
        and len(consumers) == 1
        and consumers[0].edge_type == ET.MAXPOOL
        and want is not None
        and l.name not in want
    )


def _edge_fprop(e: EdgeSpec, p, x, cdt, fuse_relu=False, defer_bias=False, bias=None):
    t = e.edge_type
    if t == ET.FC:
        z = fc(x, p["w"], compute_dtype=cdt)
        z = z + p["b"].to(z.dtype)
        return z[:, None, None, :]
    if t == ET.CONV:
        z = conv2d(x, p["w"], e.stride, e.padding, compute_dtype=cdt, groups=e.num_groups)
        if defer_bias:
            return z  # the consuming response-norm kernel adds the bias
        return z + p["b"].to(z.dtype)
    if t == ET.MAXPOOL:
        return maxpool2d(x, e.kernel_size, e.stride, e.padding)
    if t == ET.AVGPOOL:
        return avgpool2d(x, e.kernel_size, e.stride)  # whole windows (graph.py)
    if t == ET.RESPONSE_NORM:
        args = (
            e.add_scale,
            e.pow_scale,
            e.frac_of_filters_response_norm,
            e.response_norm_blocked,
            fuse_relu,
        )
        if bias is not None:
            return response_norm_cross_map_bias(x, bias, *args)
        return response_norm_cross_map(x, *args)
    if t == ET.CONV_ONETOONE:
        z = conv_onetoone(x, p["w"], compute_dtype=cdt)
        return z + p["b"].to(z.dtype)
    if t == ET.LOCAL:
        z = local_conv2d(x, p["w"], e.stride, e.padding, e.kernel_size, compute_dtype=cdt)
        return z + p["b"].to(z.dtype)
    if t == ET.UPSAMPLE:
        return upsample(x, e.sample_factor)
    if t == ET.DOWNSAMPLE:
        return downsample(x, e.sample_factor)
    if t == ET.RGBTOYUV:
        return rgb_to_yuv(x)
    raise ValueError(f"edge {e.name}: unknown edge type {t}")


def _model_input(e: EdgeSpec, x, mesh: Mesh):
    """A model-sharded edge's input on this rank, and the edge as the rank
    computes it. The input's gradient is summed over the model group
    (copy_to_model): the rank's output slice gives only its share. A
    grouped conv's filters on this rank lie in g/n whole groups (n | g) or
    within one group (g | n): the rank reads those groups' input channels
    and runs a conv of that many groups."""
    if not isinstance(x, S2DInput):  # the prologue's input has no gradient
        x = copy_to_model(x, mesh)
    g, n = e.num_groups, mesh.model
    if g == 1:
        return x, e
    cin = x.shape[3]
    if g % n == 0:
        lo, width, groups = mesh.m * cin // n, cin // n, g // n
    else:
        group = mesh.m * g // n
        lo, width, groups = group * cin // g, cin // g, 1
    return x.narrow(3, lo, width), dataclasses.replace(e, num_groups=groups)


def apply_fn(
    graph: Graph,
    params: Params,
    batch: Dict[str, torch.Tensor],
    return_layers: Optional[List[str]] = None,
    *,
    train: bool = False,
    dropout_keys: Optional[Dict[int, torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, torch.Tensor]:
    """Fprop. `batch` maps each input layer's data_field to a (B, H, W, C)
    tensor or an S2DInput. Returns {layer: activation} for `return_layers`
    (default: all layers) plus "<name>:preact" (B, units) f32 for every
    output layer. train=True applies each layer's dropout after its
    activation, the mask keyed by the layer's index among the non-input
    layers (model.py:306, 426-432): dropout_keys {index: int64 (2,) key
    tensor}, as a train step derives them on the device
    (`dropout_layers`). mesh: the rank's mesh (None on one device); params
    then hold this rank's shards and batch its rows."""
    cdt = torch.bfloat16 if graph.compute_dtype == "bfloat16" else None
    adt = torch.bfloat16 if graph.activation_dtype == "bfloat16" else None
    store_dt = adt if adt is not None else (torch.float32 if cdt is not None else None)
    want = set(return_layers) if return_layers is not None else None
    acts: Dict[str, torch.Tensor] = {}
    preacts: Dict[str, torch.Tensor] = {}  # pre-ReLU values the LRN fuses over
    out: Dict[str, torch.Tensor] = {}

    for l in graph.input_layers:
        if l.data_field not in batch:
            raise ValueError(
                f"input layer {l.name!r} expects data field {l.data_field!r} "
                f"but the batch has {sorted(batch)}"
            )
        x = batch[l.data_field]
        if not isinstance(x, S2DInput) and x.dim() != 4:
            raise ValueError(f"input {l.name}: expected NHWC, got shape {tuple(x.shape)}")
        acts[l.name] = x

    defer_bias = _bias_deferral_plan(graph)
    pending_bias: Dict[str, torch.Tensor] = {}
    fuse_pool_lrn = train and pool_lrn_fusion_wanted() and mesh is None
    # LRN layer -> (its edge, the edge's input, whether the ReLU is fused)
    deferred_lrn: Dict[str, Tuple[EdgeSpec, torch.Tensor, bool]] = {}
    drop_i = -1  # the layer counter the dropout masks are keyed by
    for name in graph.topo_layer_order():
        l = graph.layer(name)
        if not l.is_input:
            drop_i += 1  # a deferred LRN layer counts too (model.py:332)
            inc = graph.incoming(name)
            consumers = [e2 for e2 in graph.edges if e2.source == name]
            if fuse_pool_lrn and _lrn_deferrable(l, inc, consumers, want):
                e = inc[0]
                frelu = e.source in preacts
                x_src = preacts[e.source] if frelu else acts[e.source]
                if fusion_applicable(x_src.shape, consumers[0].padding):
                    deferred_lrn[name] = (e, x_src, frelu)
                    continue
            z = None
            if inc[0].edge_type == ET.CONCAT:  # then every edge of inc is (graph.py)
                with contextlib.ExitStack() as spans:
                    for e in inc:
                        spans.enter_context(span(e.span_name))
                    z = concat_channels([acts[e.source] for e in inc])
            for e in inc if z is None else ():
                with span(e.span_name):
                    if e.source in deferred_lrn:
                        le, x_src, frelu = deferred_lrn[e.source]
                        contrib = lrn_maxpool_bias(
                            x_src,
                            pending_bias.get(le.source),
                            le.add_scale,
                            le.pow_scale,
                            le.frac_of_filters_response_norm,
                            le.response_norm_blocked,
                            e.kernel_size,
                            e.stride,
                            e.padding,
                            frelu,
                        )
                        z = contrib if z is None else z + contrib
                        continue
                    p = params.get(e.name)
                    if p is None and e.has_weights:
                        raise ValueError(
                            f"no parameters for edge {e.name!r}; params provide {sorted(params)}"
                        )
                    fuse = e.edge_type == ET.RESPONSE_NORM and e.source in preacts
                    x_in = preacts[e.source] if fuse else acts[e.source]
                    dbias = defer_bias.get(name) == e.name
                    sharded = edge_is_sharded(graph, mesh, e.name)
                    e_run = e
                    if sharded:
                        x_in, e_run = _model_input(e, x_in, mesh)
                    if graph.remat and train and e.has_weights:
                        # recompute the edge's output in the backward instead of
                        # keeping it (Model.remat; model.py:386-395)
                        contrib = torch.utils.checkpoint.checkpoint(
                            _edge_fprop, e_run, p, x_in, cdt, defer_bias=dbias,
                            use_reentrant=False, preserve_rng_state=False,
                        )
                    else:
                        contrib = _edge_fprop(
                            e_run, p, x_in, cdt,
                            fuse_relu=fuse,
                            defer_bias=dbias,
                            bias=pending_bias.get(e.source) if fuse else None,
                        )
                    if sharded:
                        contrib = gather_from_model(contrib, mesh)
                    if dbias:
                        pending_bias[name] = gather_from_model(p["b"], mesh) if sharded else p["b"]
                    z = contrib if z is None else z + contrib
            with span(l.span_name):
                if l.is_output:
                    z = z.to(torch.promote_types(z.dtype, torch.float32))
                    out[f"{name}:preact"] = z.reshape(z.shape[0], -1)
                relu_fusable = (
                    l.activation == ACT.RECTIFIED_LINEAR and not l.is_output and l.dropprob == 0.0
                )
                if relu_fusable and any(e2.edge_type == ET.RESPONSE_NORM for e2 in consumers):
                    preacts[name] = z
                # the activation is materialized only if a consumer or the caller
                # reads it: a response-norm consumer of a ReLU layer reads preacts
                readers = [
                    e2 for e2 in consumers
                    if not (relu_fusable and e2.edge_type == ET.RESPONSE_NORM)
                ]
                if readers or want is None or name in want:
                    if name in pending_bias:
                        z = z + pending_bias[name].to(z.dtype)
                    a = apply_activation(z, l.activation)
                    if train and l.dropprob > 0.0:
                        if dropout_keys is None:
                            raise ValueError("train=True with dropout needs dropout_keys")
                        # the bits of the rank's rows of the global batch
                        offset = mesh.d * a.numel() if mesh is not None else 0
                        a = dropout(a, l.dropprob, dropout_keys[drop_i], offset)
                    acts[name] = a.to(store_dt) if store_dt is not None else a
        if (want is None or name in want) and name in acts:
            out[name] = acts[name]
    return out


def dropout_layers(graph: Graph) -> List[int]:
    """The indices (among the non-input layers, in topological order) of
    the layers that apply dropout in training: the layer numbers their
    masks are keyed by."""
    layers = [graph.layer(n) for n in graph.topo_layer_order()]
    return [i for i, l in enumerate(x for x in layers if not x.is_input) if l.dropprob > 0.0]


def loss_fn(
    graph: Graph,
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    train: bool = True,
    dropout_keys: Optional[Dict[int, torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
):
    """Mean loss over the batch and metrics (device tensors): "loss", the
    output layers' losses summed, each times its `loss_weight`, and
    "<output>/errors" for each cross-entropy output. Targets live in
    `batch` under each output layer's data_field. Under a mesh, over this
    rank's rows."""
    outs = apply_fn(graph, params, batch, return_layers=[], train=train,
                    dropout_keys=dropout_keys, mesh=mesh)
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    batch_size = None
    outputs = graph.output_layers
    for l in outputs:
        # an output layer's loss and errors, and after the last one the
        # batch mean, are its layer's work in a trace (the backward's nodes
        # credit to the layer that made them)
        with span(l.span_name):
            logits = outs[f"{l.name}:preact"]
            batch_size = logits.shape[0]
            if l.data_field not in batch:
                raise ValueError(
                    f"output layer {l.name!r} expects target field {l.data_field!r} "
                    f"but the batch has {sorted(batch)}"
                )
            target = batch[l.data_field]
            if l.loss_function == LOSS.CROSS_ENTROPY_MULTINOMIAL:
                target = target.reshape(-1)
            else:
                target = target.reshape(target.shape[0], -1)
            loss_l = losses_ops.compute_loss(l.loss_function, logits, target)
            if l.loss_weight != 1.0:
                loss_l = loss_l * l.loss_weight
            total = total + loss_l
            if l.loss_function == LOSS.CROSS_ENTROPY_MULTINOMIAL:
                metrics[f"{l.name}/errors"] = losses_ops.classification_errors(logits, target)
            if l is outputs[-1]:
                loss = total / batch_size
    metrics["loss"] = loss
    return loss, metrics
