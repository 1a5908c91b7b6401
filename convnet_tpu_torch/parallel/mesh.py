"""The mesh of ranks and the sharding rules (counterpart of
`convnet_tpu/parallel/mesh.py`).

The JAX package declares shardings over a device mesh and lets XLA insert
the collectives. Here the mesh is a grid of processes in a
`torch.distributed` process group (NCCL between cards, gloo on the CPU or
for ranks that share one card), and every collective is written out:

- axis "data": each rank takes its rows of the global batch (`batch_rows`);
  parameters are replicated along it, and a train step all-reduces the
  gradients over the rank's data group (the ranks with the same model
  coordinate);
- axis "model": the large FC, LOCAL, CONV and CONV_ONETOONE edges keep
  1/n of their output units or channels on each rank of a model group (the
  ranks with the same data coordinate), by the JAX package's rules
  (`param_shardings`). Such an edge reads its input through
  `copy_to_model` and hands its output slice to `gather_from_model`, so
  every other op sees full channels, as XLA's gathers give the JAX package.

Rank r sits at (d, m) = divmod(r, model), as `make_mesh` reshapes its
device list. The only collectives are `dist.all_reduce` and
`dist.all_gather` (list form): gloo and NCCL both have them, for CPU and
CUDA tensors.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from convnet_tpu_torch.graph import ET, Graph

#: Only FC weight matrices with at least this many output units get
#: model-sharded; smaller ones are replicated.
MIN_MODEL_SHARD_UNITS = 512

#: CONV / CONV_ONETOONE / LOCAL edges with at least this many output
#: channels shard those channels over the model axis.
MIN_MODEL_SHARD_CONV_CHANNELS = 64

#: {edge: {"w": sharded axis or None, "b": sharded axis or None}}
Shardings = Dict[str, Dict[str, Optional[int]]]


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid over the ranks of the default process group:
    this rank's coordinates (d, m), and the groups it all-reduces and
    gathers over."""

    data: int
    model: int
    d: int
    m: int
    #: the ranks with this rank's m: the gradient all-reduce's group
    data_group: Any
    #: the ranks with this rank's d: the channel gathers' group
    model_group: Any
    backend: str

    @property
    def rank(self) -> int:
        return self.d * self.model + self.m


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A data x model mesh over the initialized default process group,
    which must hold exactly data * model ranks. Every rank must call it,
    in the same order as its other group creations."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    world = dist.get_world_size()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the world has {world}")
    d, m = divmod(dist.get_rank(), model)
    data_group = model_group = None
    for mm in range(model):
        g = dist.new_group([dd * model + mm for dd in range(data)])
        if mm == m:
            data_group = g
    for dd in range(data):
        g = dist.new_group([dd * model + mm for mm in range(model)])
        if dd == d:
            model_group = g
    backend = str(dist.get_backend())
    # a group's communicator is set up at its first collective: do that here,
    # so no train step's first collective waits for it (a CUDA graph capture
    # cannot hold that set-up)
    dev = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    for g in (data_group, model_group):
        dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return Mesh(data, model, d, m, data_group, model_group, backend)


def mesh_shape_for_graph(graph: Graph, world: int) -> Tuple[int, int]:
    """The (data, model) shape of the model's `parallel {}` block, clamped
    to `world` ranks (data halved first, then model) with the JAX
    package's warning."""
    data, model = graph.parallel_data, graph.parallel_model
    while data * model > world and data > 1:
        data //= 2
    while data * model > world and model > 1:
        model //= 2
    if (data, model) != (graph.parallel_data, graph.parallel_model):
        warnings.warn(
            f"model requests a {graph.parallel_data}x{graph.parallel_model} "
            f"mesh but only {world} device(s) are available — "
            f"clamped to {data}x{model}",
            stacklevel=3,
        )
    return data, model


def mesh_for_graph(graph: Graph) -> Optional[Mesh]:
    """The mesh of the model's `parallel {}` block over the default process
    group (clamped to its size); None for 1x1 in a world of one. A world
    larger than the mesh is a launch error (`make_mesh` raises)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    data, model = mesh_shape_for_graph(graph, world)
    if data * model == 1 and world == 1:
        return None
    return make_mesh(data, model)


def batch_rows(mesh: Optional[Mesh], b: int) -> slice:
    """This rank's rows of a global batch of b (all of them without a
    mesh): the data axis splits the batch into equal contiguous parts."""
    if mesh is None:
        return slice(0, b)
    if b % mesh.data:
        raise ValueError(f"batch of {b} rows does not split over the mesh's data axis "
                         f"({mesh.data} ways)")
    n = b // mesh.data
    return slice(mesh.d * n, (mesh.d + 1) * n)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _edge_pspec(graph: Graph, edge_name: str, leaf: str, n_model: int = 1) -> Optional[int]:
    """The axis of the edge's leaf ("w" or "b") that the model axis shards,
    or None when the leaf is replicated: the JAX package's `_edge_pspec`,
    with the position of "model" in its PartitionSpec as the axis."""
    e = graph.edge(edge_name)
    dst_c = graph.shapes[e.dest][2]
    if n_model > 1 and dst_c % n_model:
        return None  # the output dimension does not divide the model axis
    if e.edge_type == ET.FC and dst_c >= MIN_MODEL_SHARD_UNITS:
        return 1 if leaf == "w" else 0  # columns
    if e.edge_type == ET.LOCAL and dst_c >= MIN_MODEL_SHARD_CONV_CHANNELS:
        # the untied weight's output channels, and the per-site bias's
        if leaf == "w":
            return 3
        return 2 if not e.shared_bias else 0
    if e.edge_type == ET.CONV and dst_c >= MIN_MODEL_SHARD_CONV_CHANNELS:
        # output channels, only where the contiguous split keeps to the
        # groups' boundaries (n | g or g | n)
        g = e.num_groups
        if g > 1 and (n_model % g) and (g % n_model):
            return None
        if leaf == "w":
            return 3
        return 0 if e.shared_bias else 2
    if e.edge_type == ET.CONV_ONETOONE and dst_c >= MIN_MODEL_SHARD_CONV_CHANNELS:
        return 1 if leaf == "w" else 0
    return None


def param_shardings(graph: Graph, n_model: int) -> Shardings:
    """The sharded axis of every leaf of the params tree at a model axis of
    n_model ways (None: replicated)."""
    return {
        e.name: {k: _edge_pspec(graph, e.name, k, n_model) for k in ("w", "b")}
        for e in graph.weighted_edges
    }


def state_shardings(graph: Graph, n_model: int) -> Dict[str, Shardings]:
    """The shardings of a train state's params and momenta (the step and
    seed are host values, the same on every rank)."""
    ps = param_shardings(graph, n_model)
    return {"params": ps, "moms": ps}


def edge_is_sharded(graph: Graph, mesh: Optional[Mesh], edge_name: str) -> bool:
    """Whether the edge computes only this rank's slice of its output
    channels or columns."""
    return mesh is not None and mesh.model > 1 and _edge_pspec(
        graph, edge_name, "w", mesh.model) is not None


def _local(v: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    if axis is None or mesh.model == 1:
        return v
    return v.chunk(mesh.model, dim=axis)[mesh.m].contiguous()


def shard_params(tree, shardings: Shardings, mesh: Optional[Mesh]):
    """Full {edge: {"w", "b"}} tensors -> this rank's tensors: its slice of
    each sharded leaf, the whole of each replicated one."""
    if mesh is None:
        return tree
    return {n: {k: _local(v, shardings[n][k], mesh) for k, v in p.items()}
            for n, p in tree.items()}


def gather_params(tree, shardings: Shardings, mesh: Optional[Mesh]) -> Dict[str, Dict[str, np.ndarray]]:
    """This rank's {edge: {"w", "b"}} tensors -> the full tree as f32 numpy
    arrays (the checkpoint's layout). Every rank of the model group must
    call it: a sharded leaf is all-gathered over that group."""
    out = {}
    for n, p in tree.items():
        out[n] = {}
        for k, v in p.items():
            axis = shardings[n][k] if mesh is not None else None
            if axis is not None and mesh.model > 1:
                v = _all_gather_cat(v.detach().contiguous(), axis, mesh.model_group, mesh.model)
            out[n][k] = v.detach().float().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _all_gather_cat(x: torch.Tensor, axis: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


class _GatherFromModel(torch.autograd.Function):
    """Forward: all-gather the last axis over the model group. Backward:
    this rank's slice of the gradient. Everything after the gather is
    computed alike on every rank of the group, so the gradient there is
    the same on each and needs no sum (a summing backward, as
    torch.distributed.nn's all_gather has, would scale the sharded
    weights' gradients by the group's size)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather_cat(x.contiguous(), x.dim() - 1, mesh.model_group, mesh.model)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g.chunk(mesh.model, dim=g.dim() - 1)[mesh.m].contiguous(), None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of the gradient over the
    model group: each rank's sharded edge gives only its output slice's
    share of the gradient of its input."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the last axis -> the model group's full axis."""
    return _GatherFromModel.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x unchanged; its gradient summed over the model group."""
    return _CopyToModel.apply(x, mesh)


def all_reduce_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors' sums over `group`, in their order: one all-reduce a
    dtype, over one flat buffer that holds every tensor of that dtype (the
    sums are views of it)."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out
