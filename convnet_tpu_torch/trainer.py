"""Training and eval: the input prologue, the train and eval steps, several
steps per launch, and the step loop (counterpart of
`convnet_tpu/trainer.py`), on one device or over a mesh of ranks.

A train step runs the jitter prologue, the forward, `torch.autograd`'s
backward and the per-edge SGD update, eagerly; the update is in place.
Its randomness comes from the device: the state's int64 tensor (seed,
step) on the device feeds `step_draws`, which derives each dropout layer's
key (seed, step, layer) and each input field's crop origins and flips
(seed, step, crc32(field)) in one launch, and the step advances it. So a
run started again from the same state replays the same stream, and the
draws do not depend on how the steps are launched. They are not the JAX
package's (threefry).

`make_train_step(unroll=k)` runs k steps a launch over k batches stacked
on a leading axis, with metrics of shape (k,), as the JAX package's
`lax.scan` does. On the CPU a launch is a loop of eager steps. On a card
one step is captured as a CUDA graph over static input buffers, after
warm-up steps on a copy of the state; a launch copies each batch into
those buffers and replays the graph once a step, with the optimizer's
schedule for that step copied in from pinned memory, and reads nothing
back. The k steps give what k single steps give. A step that cannot be
captured raises, naming the operation that broke the capture.

`Trainer` writes a checkpoint every `checkpoint_after` steps and resumes
from the newest one in its checkpoint directory (`checkpoint.py`, the JAX
package's HDF5 layout). With steps_per_launch k, display, validation and
checkpoints fire at the first launch boundary at or past each multiple.
`Trainer.train(profile_dir=...)` traces the reference's window of steps
with torch.profiler; the step's stages, edges and layers, its update and
the Trainer's host stages show in the trace as named spans
(`utils/timers.py`).

Under a mesh (`parallel/mesh.py`; the Trainer takes the model's `parallel
{}` block over the default process group, as the JAX Trainer does) every
rank reads the same batches and keeps its rows of each (`batch_rows`); it
draws the crops of those rows and the dropout bits of their elements, so
the ranks together draw what one device draws. The model-sharded edges'
collectives run inside the forward and backward (`model.apply_fn`). A
train step then all-reduces the gradients over the rank's data group, and
the loss (averaged) and error counts (summed) with them, in one flat
buffer a dtype: the loss is divided by the data axis before the backward,
so the sum is the global batch's mean gradient. Checkpoints hold the full
parameters in the single-device layout: every rank gathers, rank 0 writes,
and a resume shards what it loads, so a checkpoint moves between meshes.
Rank 0 logs.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch.config import model_to_text
from convnet_tpu_torch.graph import Graph
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch import optim
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.data.jitter import JitterSpec, center_offsets, crop_draw, jitter_batch
from convnet_tpu_torch.ops import launch_counts
from convnet_tpu_torch.ops.dropout import step_draws
from convnet_tpu_torch.ops.s2d_relayout import jitter_s2d, prologue_plan
from convnet_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    batch_rows,
    gather_params,
    mesh_for_graph,
    param_shardings,
    shard_params,
    state_shardings,
)
from convnet_tpu_torch.utils.timers import Timer, span, start_trace, stop_trace

#: {data_field: (JitterSpec, mean, std)}, mean/std numpy arrays or None.
JitterMap = Dict[str, Tuple[JitterSpec, Optional[np.ndarray], Optional[np.ndarray]]]
#: {"params", "moms", "step": host int, "seed": host int}, and once a step
#: has run, "rng": the int64 (seed, step) tensor on the device with
#: "rng_step", the host step it holds.
TrainState = Dict[str, Any]
#: A train step's random draws: ({dropout layer index: key}, {field: crop}).
Draws = Tuple[Dict[int, torch.Tensor], Dict[str, tuple]]
#: Warm-up steps (on a copy of the state) before a step is captured: the
#: first runs build the kernels and settle cuDNN's and cuBLAS's choices.
CAPTURE_WARMUP = 3


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`. To a card it goes through pinned memory
    without blocking: a copy from pageable memory would make the host wait
    for all the work queued before it."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_batch(host_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host arrays as tensors on `device`, copied without blocking."""
    return {k: _to_device(torch.from_numpy(np.ascontiguousarray(v)), device)
            for k, v in host_batch.items()}


def init_state(graph: Graph, seed: Optional[int] = None, device="cpu",
               mesh: Optional[Mesh] = None) -> TrainState:
    """Params from the pbtxt's init modes, zero momenta, step 0; under a
    mesh, this rank's shards of them."""
    seed = graph.seed if seed is None else seed
    params = model_lib.init_params(graph, seed, device)
    if mesh is not None:
        params = shard_params(params, param_shardings(graph, mesh.model), mesh)
    return {"params": params, "moms": optim.init_momentum(params), "step": 0, "seed": seed}


def rng_tensor(state: TrainState, device) -> torch.Tensor:
    """The state's int64 (seed, step) tensor on `device`, made on first use
    and written again (in place) when the host step moved without it, as a
    resume does."""
    device = torch.device(device)
    rng = state.get("rng")
    if rng is None or rng.device != device:
        rng = state["rng"] = torch.zeros(2, dtype=torch.int64, device=device)
        state["rng_step"] = None
    if state.get("rng_step") != state["step"]:
        host = torch.tensor([state["seed"], state["step"]], dtype=torch.int64)
        rng.copy_(host.pin_memory() if device.type == "cuda" else host, non_blocking=True)
        state["rng_step"] = state["step"]
    return rng


class JitterTensors:
    """Each field's mean and std as f32 tensors on a device, made once per
    device (per-channel (C,) for the space-to-depth prologue, as given for
    jitter_batch): a step that copied them every call would wait for the
    card, and a CUDA graph would replay a copy from freed host memory."""

    def __init__(self, jitter: Optional[JitterMap]):
        self._jitter = jitter or {}
        self._cache: Dict[tuple, tuple] = {}

    def get(self, field: str, device, channels: Optional[int] = None):
        key = (field, str(device), channels)
        if key not in self._cache:
            _, mean, std = self._jitter[field]

            def tensor(v):
                if v is None:
                    return None
                if channels is not None:
                    v = np.broadcast_to(v, (channels,))
                return _to_device(torch.from_numpy(np.array(v, np.float32)), device)

            self._cache[key] = (tensor(mean), tensor(std))
        return self._cache[key]


def draw_step(graph: Graph, jitter: Optional[JitterMap], batch: Dict[str, torch.Tensor],
              rng: torch.Tensor, mesh: Optional[Mesh] = None) -> Draws:
    """One train step's draws from rng = (seed, step) on the batch's device:
    the dropout layers' keys and each jittered field's crop origins and
    flips (under a mesh, those of the rank's rows of the global batch). One
    `step_draws` launch takes the keys and the first field, one more each
    further field."""
    words = [(i, 0) for i in model_lib.dropout_layers(graph)]
    fields = []
    for field, (spec, _, _) in (jitter or {}).items():
        b, h, w = batch[field].shape[:3]
        row0 = mesh.d * b if mesh is not None else 0
        d = crop_draw(field, b, h, w, spec.image_size, spec.can_translate, spec.can_flip, row0)
        if d is not None:
            fields.append((field, d))
    if not words and not fields:
        return {}, {}
    first = fields[0][1] if fields else None
    keys, crop = step_draws(rng, words, first)
    crops = {fields[0][0]: crop} if fields else {}
    for field, d in fields[1:]:
        crops[field] = step_draws(rng, (), d)[1]
    return {i: keys[j] for j, (i, _) in enumerate(words)}, crops


def preprocess(
    graph: Graph,
    jitter: Optional[JitterMap],
    batch: Dict[str, torch.Tensor],
    crops: Optional[Dict[str, tuple]] = None,
    consts: Optional[JitterTensors] = None,
):
    """The jitter prologue for image inputs. A uint8 batch whose input
    layer feeds a conv that `prologue_plan` accepts, with a scalar or
    per-channel mean/std, goes through the one-pass space-to-depth
    prologue; other inputs through `jitter_batch`. crops: {field: (oy, ox,
    flips)} of a train step (`draw_step`); a field without one takes the
    eval center crop. consts: the mean/std tensors (made here when not
    given). With no jitter map, uint8 inputs are widened to f32."""
    if not jitter:
        return {k: v.float() if v.dtype == torch.uint8 else v for k, v in batch.items()}
    consts = consts or JitterTensors(jitter)
    crops = crops or {}
    out = dict(batch)
    for field, (spec, mean, std) in jitter.items():
        x = out[field]
        dev = x.device
        crop = crops.get(field)
        if x.dim() == 4 and x.dtype == torch.uint8 and np.ndim(mean) <= 1 and np.ndim(std) <= 1:
            layer = next((l for l in graph.input_layers if l.data_field == field), None)
            edge = prologue_plan(graph, layer.name) if layer is not None else None
            if edge is not None:
                b, h, w, c = x.shape
                if crop is not None:
                    oy, ox, flips = crop
                else:
                    cy, cx = center_offsets(h, w, spec.image_size)
                    oy = torch.full((b,), cy, dtype=torch.int32, device=dev)
                    ox = torch.full((b,), cx, dtype=torch.int32, device=dev)
                    flips = None
                mean_t, std_t = consts.get(field, dev, c)
                out[field] = jitter_s2d(
                    x, oy, ox, flips,
                    crop=spec.image_size,
                    kernel=edge.kernel_size,
                    stride=edge.stride,
                    scale=spec.scale,
                    mean=mean_t,
                    std=std_t,
                )
                continue
        mean_t, std_t = consts.get(field, dev)
        out[field] = jitter_batch(x, spec, mean_t, std_t, crop=crop)
    return out


def make_forward(graph: Graph, layers: List[str], jitter: Optional[JitterMap] = None,
                 mesh: Optional[Mesh] = None):
    """(params, batch) -> {layer: activation} for feature extraction and
    serving; the batch holds raw (uint8 or float) NHWC tensors. Under a
    mesh: this rank's params and rows, and the activations of those rows."""
    consts = JitterTensors(jitter)

    def fwd(params, batch):
        return model_lib.apply_fn(
            graph, params, preprocess(graph, jitter, batch, consts=consts), return_layers=layers,
            mesh=mesh,
        )

    return fwd


def _reduce_over_data(grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor],
                      mesh: Mesh):
    """Sum the gradients (of the loss already divided by the data axis) and
    the metrics over the rank's data group, one all-reduce a dtype: "loss"
    comes back as the global batch's mean, the error counts as sums."""
    with span("parallel.reduce"):
        names = list(metrics)
        packed = torch.stack([metrics[k].float() / mesh.data if k == "loss" else metrics[k].float()
                              for k in names])
        *grads, packed = all_reduce_sum([*grads, packed], mesh.data_group)
        return grads, {k: v.to(metrics[k].dtype) for k, v in zip(names, packed)}


def _step_core(graph: Graph, jitter: Optional[JitterMap], mesh: Optional[Mesh] = None):
    """(params, moms, rng, batch, step | hyper) -> metrics: one train step
    that draws from and then advances rng, with the optimizer's schedule
    at host step `step` or read from the device tensor `hyper`; under a
    mesh, on this rank's shards and rows, with the gradients and metrics
    reduced over its data group."""
    consts = JitterTensors(jitter)
    sharded = _sharded_leaves(graph, mesh)

    def core(params, moms, rng, batch, step=None, hyper=None):
        keys = [(name, k) for name in params for k in params[name]]
        # a caller's inference_mode or no_grad would leave nothing to differentiate
        with torch.inference_mode(False), torch.enable_grad():
            for name, k in keys:
                params[name][k].requires_grad_(True)
            with span("trainer.draws"):
                dropout_keys, crops = draw_step(graph, jitter, batch, rng, mesh)
            core.draws = (dropout_keys, crops)
            with span("trainer.prologue"):
                proc = preprocess(graph, jitter, batch, crops, consts)
            with span("model.forward"):
                loss, metrics = model_lib.loss_fn(graph, params, proc, train=True,
                                                  dropout_keys=dropout_keys, mesh=mesh)
                if mesh is not None:
                    loss = loss / mesh.data
            # on a card the backward runs on the autograd engine's device
            # thread, while this one waits inside the span
            with span("model.backward"):
                flat = torch.autograd.grad(loss, [params[name][k] for name, k in keys])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            flat, metrics = _reduce_over_data(list(flat), metrics, mesh)
        grads: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in params}
        for (name, k), g in zip(keys, flat):
            grads[name][k] = g
        optim.apply_updates(graph, params, moms, grads, step=step, hyper=hyper,
                            sharded=sharded)
        rng[1:].add_(1)
        return metrics

    return core


def _sharded_leaves(graph: Graph, mesh: Optional[Mesh]):
    """{(edge, leaf): the model group} of the leaves the model axis shards
    (a clipped gradient's norm is summed over that group)."""
    if mesh is None or mesh.model == 1:
        return {}
    ps = param_shardings(graph, mesh.model)
    return {(n, k): mesh.model_group for n, p in ps.items() for k, ax in p.items() if ax is not None}


def _state_device(state: TrainState) -> torch.device:
    return next(iter(next(iter(state["params"].values())).values())).device


class _StepGraph:
    """One train step captured as a CUDA graph, over the state's own
    parameter, momentum and (seed, step) tensors, static input buffers and
    a static schedule tensor. `launches` holds the kernels' launches that
    the capture recorded: each replay makes them again, though the
    wrappers' counters, which count where the wrapper runs, do not move."""

    def __init__(self, graph: Graph, core, state: TrainState, row: Dict[str, torch.Tensor]):
        dev = _state_device(state)
        self.graph = graph
        self.rng = rng_tensor(state, dev)
        self.tensors = self._tensors(state)
        # row may be a device tensor or a view of pinned host memory
        self.static = {f: torch.empty_like(v, device=dev).copy_(v, non_blocking=True)
                       for f, v in row.items()}
        self.hyper = _to_device(torch.from_numpy(optim.schedule(graph, state["step"])), dev)
        scratch = {t: {n: {k: v.clone() for k, v in p.items()} for n, p in state[t].items()}
                   for t in ("params", "moms")}
        scratch_rng = self.rng.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARMUP):
                    core(scratch["params"], scratch["moms"], scratch_rng, self.static,
                         hyper=self.hyper)
        except RuntimeError as e:
            raise RuntimeError(f"the train step waits for the card and cannot be captured: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch, scratch_rng
        before = launch_counts()
        self.cuda_graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.cuda_graph):
                self.metrics = core(state["params"], state["moms"], self.rng, self.static,
                                    hyper=self.hyper)
        except Exception as e:
            raise RuntimeError(f"the train step could not be captured as a CUDA graph: {e}") from e
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.draws = core.draws  # the graph's own tensors: each replay rewrites them
        self.replays = 0

    @staticmethod
    def _tensors(state: TrainState) -> List[torch.Tensor]:
        return [v for t in ("params", "moms") for p in state[t].values() for v in p.values()]

    def holds(self, state: TrainState) -> bool:
        """Whether the graph was captured over this state's tensors."""
        return rng_tensor(state, self.rng.device) is self.rng and all(
            a is b for a, b in zip(self._tensors(state), self.tensors)
        )

    def run(self, state: TrainState, batches: Dict[str, torch.Tensor], n: int):
        """n replays, each after copying its batch (from the device or from
        pinned memory) and its schedule row into the static buffers."""
        t0 = state["step"]
        sched = torch.from_numpy(np.stack([optim.schedule(self.graph, t0 + i) for i in range(n)]))
        sched = sched.pin_memory()
        rows = []
        for i in range(n):
            with span("trainer.replay"):
                for f, buf in self.static.items():
                    buf.copy_(batches[f][i], non_blocking=True)
                self.hyper.copy_(sched[i], non_blocking=True)
                self.cuda_graph.replay()
                rows.append({k: v.clone() for k, v in self.metrics.items()})
        self.replays += n
        state["step"] = state["rng_step"] = t0 + n
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class TrainSteps:
    """The eager train step of one graph and jitter map and, on a card, its
    CUDA graph (captured at the first launch of several steps, and again
    if the state's tensors change). Under a mesh, the step of this rank."""

    def __init__(self, graph: Graph, jitter: Optional[JitterMap] = None,
                 mesh: Optional[Mesh] = None):
        self.graph = graph
        self.mesh = mesh
        self._core = _step_core(graph, jitter, mesh)
        self.captured: Optional[_StepGraph] = None
        #: the last step's draws, (dropout keys, crops): device tensors
        #: that the next step may overwrite
        self.last_draws: Draws = ({}, {})

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One eager step: state["step"] advances by one; the metrics
        ("loss", "<output>/errors") stay device tensors."""
        with span("trainer.step"):
            step = state["step"]
            metrics = self._core(state["params"], state["moms"],
                                 rng_tensor(state, _state_device(state)), batch, step=step)
            state["step"] = state["rng_step"] = step + 1
            self.last_draws = self._core.draws
            return metrics

    def launch(self, state: TrainState, batches: Dict[str, torch.Tensor], n: int):
        """n steps over batches stacked on a leading axis of n; metrics of
        shape (n,). On a card the batches may lie in pinned host memory:
        each replay copies its batch from there."""
        for f, v in batches.items():
            if v.shape[0] != n:
                raise ValueError(f"launch of {n} steps: batch {f!r} has leading axis {v.shape[0]}")
        if _state_device(state).type != "cuda":
            rows = [self.step(state, {f: v[i] for f, v in batches.items()}) for i in range(n)]
            return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        if self.mesh is not None and self.mesh.backend != "nccl":
            raise ValueError(
                f"{n} steps a launch replay the step as a CUDA graph, which cannot hold the "
                f"{self.mesh.backend} backend's collectives: run the mesh over nccl, or one "
                "step a launch")
        if self.captured is None or not self.captured.holds(state):
            self.captured = None  # the old graph's memory goes back first
            with span("trainer.capture"):
                self.captured = _StepGraph(self.graph, self._core, state,
                                           {f: v[0] for f, v in batches.items()})
        metrics = self.captured.run(state, batches, n)
        self.last_draws = self.captured.draws
        return metrics


def make_train_step(graph: Graph, jitter: Optional[JitterMap] = None, unroll: int = 1,
                    mesh: Optional[Mesh] = None):
    """unroll 1: (state, batch) -> metrics, one eager step that updates
    state["params"] and state["moms"] in place and advances state["step"]
    by one. unroll k > 1: (state, batches) -> metrics, k steps over batches
    stacked on a leading axis of k, metrics of shape (k,): a loop of eager
    steps on the CPU, k replays of the step's CUDA graph on a card (under a
    mesh, over nccl only). The metrics stay device tensors until the caller
    reads them. Under a mesh the state holds this rank's shards (`init_state`
    with the mesh) and a batch this rank's rows (`batch_rows`); the metrics
    are the global batch's."""
    if unroll < 1:
        raise ValueError(f"unroll {unroll} < 1")
    steps = TrainSteps(graph, jitter, mesh)
    if unroll == 1:
        return steps.step

    def launch(state: TrainState, batches: Dict[str, torch.Tensor]):
        return steps.launch(state, batches, unroll)

    return launch


def make_eval_step(graph: Graph, jitter: Optional[JitterMap] = None,
                   mesh: Optional[Mesh] = None):
    """(params, batch) -> metrics; center crop, no dropout. Under a mesh:
    this rank's params and rows, and the global batch's metrics."""
    consts = JitterTensors(jitter)

    def eval_fn(params, batch):
        with torch.no_grad():
            _, metrics = model_lib.loss_fn(
                graph, params, preprocess(graph, jitter, batch, consts=consts), train=False,
                mesh=mesh,
            )
            if mesh is not None:
                metrics = _reduce_over_data([], metrics, mesh)[1]
        return metrics

    return eval_fn


class Trainer:
    """Owns the state, the data handlers and the step loop: display every
    `display_after` steps, validation every `validate_after`, a checkpoint
    every `checkpoint_after` (`save`), the train log
    `<checkpoint_dir>/<model>_train_log.txt` when a checkpoint directory
    is set. At construction it resumes from the newest checkpoint of the
    model in the checkpoint directory, if there is one, and logs which
    reader each stream took where its type has two.

    steps_per_launch k > 1: each launch runs k steps over k batches staged
    together (a CUDA graph replayed k times on a card); display, validation
    and checkpoints fire at the first launch boundary at or past each
    multiple, as in the JAX package. `timers` time the host's stages:
    get_batch, stack (k > 1: into cached pinned buffers), pin (k = 1),
    copy (k = 1: enqueueing the copy to the device) and launch (enqueueing
    the steps, and at k > 1 each step's copy out of the pinned buffers),
    each also the span `trainer.<stage>` in a profiler trace. The display
    line ends with the window's data wait: the first four's seconds as a
    share of the window's.

    jitter: {field: (JitterSpec, mean, std)} to use instead of the data
    handlers' `jitter_specs()` (for example a mean given without an HDF5
    mean file). model_proto: the model's message; when given, `save`
    rewrites `<checkpoint_dir>/<model>.pbtxt` with the checkpoint's
    timestamp recorded.

    mesh: the ranks' mesh (`make_mesh`); by default the model's `parallel
    {}` block over the default process group (`mesh_for_graph`: clamped to
    the world with a warning, None in a world of one). Every rank builds
    the same data handlers (the same seed, so the same shuffle) and keeps
    its rows of each batch."""

    def __init__(
        self,
        graph: Graph,
        train_data: DataHandler,
        val_data: Optional[DataHandler] = None,
        checkpoint_dir: Optional[str] = None,
        log_fn=print,
        model_proto=None,
        steps_per_launch: int = 1,
        device="cuda",
        jitter: Optional[JitterMap] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.graph = graph
        self.mesh = mesh if mesh is not None else mesh_for_graph(graph)
        if self.mesh is not None and train_data.batch_size % self.mesh.data:
            raise ValueError(
                f"batch_size {train_data.batch_size} not divisible by the "
                f"mesh's data axis ({self.mesh.data} ways)"
            )
        self._shardings = state_shardings(graph, self.mesh.model if self.mesh else 1)
        self.model_proto = model_proto
        self.train_data = train_data
        self.val_data = val_data
        self.device = torch.device(device)
        self.checkpoint_dir = checkpoint_dir or graph.checkpoint_dir or "."
        self._log_fn = log_fn
        self._log_path = None
        if checkpoint_dir or graph.checkpoint_dir:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            self._log_path = os.path.join(self.checkpoint_dir, f"{graph.name}_train_log.txt")
        need = {l.data_field for l in graph.input_layers} | {
            l.data_field for l in graph.output_layers
        }
        have = set(train_data.streams)
        if not need <= have:
            raise ValueError(
                f"data config provides streams {sorted(have)} but the model needs fields "
                f"{sorted(need)} (missing: {sorted(need - have)})"
            )
        train_jitter = jitter if jitter is not None else train_data.jitter_specs()
        eval_jitter = jitter if jitter is not None else (
            val_data.jitter_specs() if val_data is not None else train_jitter
        )
        self.steps_per_launch = max(1, int(steps_per_launch))
        self.steps = TrainSteps(graph, train_jitter, self.mesh)
        self._eval_step = make_eval_step(graph, eval_jitter, self.mesh)
        self.timers = {k: Timer(f"trainer.{k}") for k in ("get_batch", "stack", "pin", "copy",
                                                          "launch")}
        # k > 1 on a card: two sets of pinned staging buffers a launch size,
        # taken in turn, each reused once the launch's copies out of it ran
        self._pinned: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._pinned_done: Dict[Tuple[int, int], torch.cuda.Event] = {}
        self._turn = 0
        self._staged_key: Optional[Tuple[int, int]] = None
        self.state = init_state(graph, device=self.device, mesh=self.mesh)
        for which, data in (("train", train_data), ("val", val_data)):
            for line in data.backend_log() if data is not None else ():
                self.log(f"{which} data: {line}")
        self._resume()

    def _launch_fn(self, n: int) -> Callable:
        if n == 1:
            return self.steps.step
        return lambda state, batches: self.steps.launch(state, batches, n)

    def log(self, msg: str):
        """Rank 0's message to log_fn and the train log (the other ranks'
        are dropped)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        self._log_fn(msg)
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(msg + "\n")

    # -- checkpointing ------------------------------------------------------

    def _resume(self):
        """Every rank loads the full checkpoint and keeps its shards of it."""
        path = ckpt.latest(self.checkpoint_dir, self.graph.name)
        if not path:
            return
        params, moms, step = ckpt.load(path, expected_shapes=model_lib.param_shapes(self.graph))
        expect = {e.name for e in self.graph.weighted_edges}
        if set(params) != expect:
            raise ValueError(f"checkpoint {path} edges {sorted(params)} != model {sorted(expect)}")
        for t, tree in (("params", params), ("moms", moms)):
            if tree is not None:
                self.state[t] = shard_params(model_lib.params_from_numpy(tree, self.device),
                                             self._shardings[t], self.mesh)
        self.state["step"] = step
        self.log(f"resumed from {path} at step {step}")

    def save(self) -> Optional[str]:
        """Write the params, momenta and step as a checkpoint (f32, on the
        host, the full parameters) and return its path; with a model_proto,
        also rewrite `<model>.pbtxt` beside it with the checkpoint's
        timestamp. Under a mesh every rank must call it: each gathers the
        sharded leaves, rank 0 writes (the others return None), and all
        wait until the file is there."""
        host = {t: gather_params(self.state[t], self._shardings[t], self.mesh)
                for t in ("params", "moms")}
        if self.mesh is not None and self.mesh.rank != 0:
            dist.barrier()
            return None
        path = ckpt.save(self.checkpoint_dir, self.graph.name, host["params"], host["moms"],
                         step=self.state["step"])
        if self.model_proto is not None:
            # the tag is the file name without the model prefix, not a split
            # on "_": a collision-suffixed name ("<ts>_1.h5") keeps "<ts>_1",
            # so checkpoint_path(dir, name, tag) still resolves to this file
            ts = os.path.basename(path).removeprefix(f"{self.graph.name}_").removesuffix(".h5")
            self.model_proto.timestamp = ts
            self.model_proto.timestamp_history.append(ts)
            with open(os.path.join(self.checkpoint_dir, f"{self.graph.name}.pbtxt"), "w") as f:
                f.write(model_to_text(self.model_proto))
        self.log(f"checkpoint -> {path}")
        if self.mesh is not None:
            dist.barrier()
        return path

    # -- loops --------------------------------------------------------------

    def _rows(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's rows of a global batch (all of them on one device)."""
        if self.mesh is None:
            return host_batch
        return {k: v[batch_rows(self.mesh, len(v))] for k, v in host_batch.items()}

    def device_batch(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A DataHandler batch (under a mesh, this rank's rows of it) as
        tensors on the Trainer's device."""
        return device_batch(self._rows(host_batch), self.device)

    def _stage(self, n: int) -> Dict[str, torch.Tensor]:
        """Fetch n batches (this rank's rows of each) as one launch's input:
        a plain batch for n = 1 (on the device), stacked on a leading axis
        else (on a card, in pinned buffers that the launch copies from, step
        by step)."""
        t = self.timers
        self._staged_key = None
        with t["get_batch"]:
            hosts = [self._rows(self.train_data.get_batch()) for _ in range(n)]
        if self.device.type != "cuda":
            with t["stack"]:
                if n == 1:
                    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hosts[0].items()}
                return {k: torch.from_numpy(np.stack([h[k] for h in hosts])) for k in hosts[0]}
        if n == 1:
            with t["pin"]:
                pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                          for k, v in hosts[0].items()}
            with t["copy"]:
                return {k: v.to(self.device, non_blocking=True) for k, v in pinned.items()}
        self._turn ^= 1
        key = (n, self._turn)
        if key not in self._pinned:
            self._pinned[key] = {
                k: torch.empty((n, *v.shape), dtype=torch.from_numpy(v[:0]).dtype, pin_memory=True)
                for k, v in hosts[0].items()
            }
        bufs = self._pinned[key]
        if key in self._pinned_done:
            self._pinned_done[key].synchronize()  # the copies out of this set have run
        with t["stack"]:
            for k, buf in bufs.items():
                rows = buf.numpy()
                for i, h in enumerate(hosts):
                    np.copyto(rows[i], h[k])
        self._staged_key = key
        return bufs

    def _staging_s(self) -> float:
        """The host's seconds so far in staging batches (the get_batch,
        stack, pin and copy timers)."""
        return sum(self.timers[k].total for k in ("get_batch", "stack", "pin", "copy"))

    def train(self, max_iter: Optional[int] = None, profile_dir: Optional[str] = None):
        """The step loop up to `max_iter` steps (default: the pbtxt's).
        profile_dir: trace about ten steps past the first steps' warm-up
        with torch.profiler into this directory, as a TensorBoard-readable
        Chrome trace (the reference's window, `convnet_tpu/trainer.py:444-524`,
        which starts at the first launch boundary at or past step start +
        max(5, k) and spans ceil(10 / k) launches); a run that ends inside
        the window writes what it traced, one that ends before it says so."""
        g = self.graph
        total = max_iter if max_iter is not None else g.max_iter
        k = self.steps_per_launch
        it = self.state["step"]
        p_start = it + max(5, k)
        p_stop = p_start + k * -(-10 // k)
        prof = None
        cuda = self.device.type == "cuda"
        window: List[Dict[str, torch.Tensor]] = []
        t0, staged0 = time.time(), self._staging_s()
        next_batch = self._stage(min(k, total - it)) if it < total else None
        while it < total:
            if profile_dir is not None:
                if prof is None and p_start <= it < p_stop:
                    prof = start_trace(profile_dir, cuda)
                elif prof is not None and it >= p_stop:
                    stop_trace(prof, cuda)
                    prof = None
                    self.log(f"profile trace -> {profile_dir}")
            n = min(k, total - it)
            with self.timers["launch"]:
                metrics = self._launch_fn(n)(self.state, next_batch)
            if self._staged_key is not None:
                # the launch has queued its copies out of the pinned set
                done = self._pinned_done[self._staged_key] = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            prev, it = it, it + n
            # stage the next launch's batches while this one runs on the device
            if it < total:
                next_batch = self._stage(min(k, total - it))
            window.append(metrics)
            if g.display_after and it // g.display_after > prev // g.display_after:
                loss = torch.cat([m["loss"].float().reshape(-1) for m in window]).mean().item()
                errs = sum(
                    torch.cat([m[key].reshape(-1) for m in window]).sum().item()
                    for key in window[0] if key.endswith("/errors")
                )
                seen = sum(m["loss"].numel() for m in window) * self.train_data.batch_size
                dt = time.time() - t0
                ips = seen / dt if dt > 0 else 0.0
                wait = (self._staging_s() - staged0) / dt if dt > 0 else 0.0
                self.log(
                    f"step {it} loss {loss:.4f} train_err {errs / max(1, seen):.4f} "
                    f"({ips:.1f} img/s) data wait {100 * wait:.1f}%"
                )
                window = []
                t0, staged0 = time.time(), self._staging_s()
            if (
                g.validate_after
                and self.val_data
                and it // g.validate_after > prev // g.validate_after
            ):
                verr, vloss = self.validate()
                self.log(f"step {it} VALIDATION loss {vloss:.4f} err {verr:.4f}")
                t0, staged0 = time.time(), self._staging_s()
            if g.checkpoint_after and it // g.checkpoint_after > prev // g.checkpoint_after:
                self.save()
                t0, staged0 = time.time(), self._staging_s()
        if prof is not None:
            stop_trace(prof, cuda)
            self.log(f"profile trace -> {profile_dir} (truncated at end of run)")
        elif profile_dir is not None and it < p_start:
            self.log(
                f"WARNING: profile_dir given but the run ended at step {it} "
                f"before the trace window (starts at step {p_start}); no "
                "trace was captured"
            )
        return self.state

    def validate(self, num_batches: Optional[int] = None) -> Tuple[float, float]:
        """(error rate, mean loss) over num_batches validation batches
        (default: validate_batches, else the whole set); under a mesh each
        rank evaluates its rows and the eval step sums over the data group."""
        if self.val_data is None:
            raise ValueError("validate() needs val_data")
        n = num_batches or self.graph.validate_batches or self.val_data.num_batches
        n = max(1, min(n, self.val_data.num_batches))
        bs = self.val_data.batch_size
        tot_err = tot_loss = seen = 0.0
        for _ in range(n):
            m = self._eval_step(self.state["params"], self.device_batch(self.val_data.get_batch()))
            tot_loss += float(m["loss"]) * bs
            tot_err += sum(float(m[k]) for k in m if k.endswith("/errors"))
            seen += bs
        return tot_err / seen, tot_loss / seen
