"""Training and eval on one device: the input prologue, the train and eval
steps, and the step loop (counterpart of `convnet_tpu/trainer.py`).

A train step runs the jitter prologue, the forward, `torch.autograd`'s
backward and the per-edge SGD update, eagerly; the update is in place.
Randomness is keyed by (seed, step): each input field's crop generator by
(seed, step, crc32(field)) and each dropout mask by (seed, step, layer),
so a run started again from the same state replays the same stream. The
draws are not the JAX package's (threefry).

`Trainer` writes a checkpoint every `checkpoint_after` steps and resumes
from the newest one in its checkpoint directory (`checkpoint.py`, the JAX
package's HDF5 layout). `Trainer.train(profile_dir=...)` traces the
reference's window of steps with torch.profiler. Not ported yet, and
raising NotImplementedError rather than skipped: several steps per launch.
"""

from __future__ import annotations

import os
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch.config import model_to_text
from convnet_tpu_torch.graph import Graph
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch import optim
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.data.jitter import (
    JitterSpec,
    center_offsets,
    jitter_batch,
    sample_crop_flip,
)
from convnet_tpu_torch.ops.dropout import derive_key
from convnet_tpu_torch.ops.s2d_relayout import jitter_s2d, prologue_plan

#: {data_field: (JitterSpec, mean, std)}, mean/std numpy arrays or None.
JitterMap = Dict[str, Tuple[JitterSpec, Optional[np.ndarray], Optional[np.ndarray]]]
#: {"params", "moms", "step": host int, "seed": host int}
TrainState = Dict[str, Any]


def _as_tensor(v, device):
    """A numpy mean or std as an f32 tensor on `device`. To a card it goes
    through pinned memory: a copy from pageable memory would make the
    host wait for all the work queued before it, every step."""
    if v is None:
        return None
    t = torch.from_numpy(np.array(v, np.float32))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def device_batch(host_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host arrays as tensors on `device`. To a card they go through
    pinned memory without blocking, so the copy does not wait for the work
    in flight."""
    device = torch.device(device)
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def init_state(graph: Graph, seed: Optional[int] = None, device="cpu") -> TrainState:
    """Params from the pbtxt's init modes, zero momenta, step 0."""
    seed = graph.seed if seed is None else seed
    params = model_lib.init_params(graph, seed, device)
    return {"params": params, "moms": optim.init_momentum(params), "step": 0, "seed": seed}


def field_generator(seed: int, step: int, field: str, device) -> torch.Generator:
    """The crop/flip generator of one input field at one step, on
    `device`, seeded from (seed, step, crc32(field)); crc32 rather than
    hash() so every process draws the same stream."""
    k0, k1 = derive_key(seed, step, step >> 32, zlib.crc32(field.encode()), 1)
    gen = torch.Generator(device=device)
    gen.manual_seed((k1 << 32) | k0)
    return gen


def preprocess(
    graph: Graph,
    jitter: Optional[JitterMap],
    batch: Dict[str, torch.Tensor],
    train: bool = False,
    rng: Optional[Tuple[int, int]] = None,
):
    """The jitter prologue for image inputs. A uint8 batch whose input
    layer feeds a conv that `prologue_plan` accepts, with a scalar or
    per-channel mean/std, goes through the one-pass space-to-depth
    prologue; other inputs through `jitter_batch`. Eval takes the center
    crop; train (rng = (seed, step)) draws per-image crop origins and
    flips from each field's `field_generator`. With no jitter map, uint8
    inputs are widened to f32."""
    if not jitter:
        return {k: v.float() if v.dtype == torch.uint8 else v for k, v in batch.items()}
    out = dict(batch)
    for field, (spec, mean, std) in jitter.items():
        x = out[field]
        dev = x.device
        gen = None
        if train and (spec.can_translate or spec.can_flip):
            if rng is None:
                raise ValueError("train jitter needs rng = (seed, step)")
            gen = field_generator(*rng, field, dev)
        if x.dim() == 4 and x.dtype == torch.uint8 and np.ndim(mean) <= 1 and np.ndim(std) <= 1:
            layer = next((l for l in graph.input_layers if l.data_field == field), None)
            edge = prologue_plan(graph, layer.name) if layer is not None else None
            if edge is not None:
                b, h, w, c = x.shape
                oy = ox = flips = None
                if gen is not None:
                    oy, ox, flips = sample_crop_flip(
                        gen, b, h, w, spec.image_size, spec.can_translate, spec.can_flip
                    )
                if oy is None:
                    cy, cx = center_offsets(h, w, spec.image_size)
                    oy = torch.full((b,), cy, dtype=torch.int32, device=dev)
                    ox = torch.full((b,), cx, dtype=torch.int32, device=dev)
                per_channel = [
                    None if v is None else _as_tensor(np.broadcast_to(v, (c,)), dev)
                    for v in (mean, std)
                ]
                out[field] = jitter_s2d(
                    x, oy, ox, flips,
                    crop=spec.image_size,
                    kernel=edge.kernel_size,
                    stride=edge.stride,
                    scale=spec.scale,
                    mean=per_channel[0],
                    std=per_channel[1],
                )
                continue
        out[field] = jitter_batch(
            x, spec, _as_tensor(mean, dev), _as_tensor(std, dev), train=gen is not None, gen=gen
        )
    return out


def make_forward(graph: Graph, layers: List[str], jitter: Optional[JitterMap] = None):
    """(params, batch) -> {layer: activation} for feature extraction and
    serving; the batch holds raw (uint8 or float) NHWC tensors."""

    def fwd(params, batch):
        return model_lib.apply_fn(
            graph, params, preprocess(graph, jitter, batch), return_layers=layers
        )

    return fwd


def make_train_step(graph: Graph, jitter: Optional[JitterMap] = None, unroll: int = 1):
    """(state, batch) -> metrics. One step: the train prologue, forward,
    backward, and `optim.apply_updates`, which updates state["params"]
    and state["moms"] in place; state["step"] advances by one. The
    metrics ("loss", "<output>/errors") stay device tensors until the
    caller reads them."""
    if unroll != 1:
        raise NotImplementedError("several steps per launch (unroll > 1) are not ported yet")

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        seed, step = state["seed"], state["step"]
        params = state["params"]
        keys = [(name, k) for name in params for k in params[name]]
        # a caller's inference_mode or no_grad would leave nothing to differentiate
        with torch.inference_mode(False), torch.enable_grad():
            for name, k in keys:
                params[name][k].requires_grad_(True)
            proc = preprocess(graph, jitter, batch, train=True, rng=(seed, step))
            loss, metrics = model_lib.loss_fn(
                graph, params, proc, train=True, dropout_seed=(seed, step)
            )
            flat = torch.autograd.grad(loss, [params[name][k] for name, k in keys])
        grads: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in params}
        for (name, k), g in zip(keys, flat):
            grads[name][k] = g
        optim.apply_updates(graph, params, state["moms"], grads, step)
        state["step"] = step + 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_eval_step(graph: Graph, jitter: Optional[JitterMap] = None):
    """(params, batch) -> metrics; center crop, no dropout."""

    def eval_fn(params, batch):
        with torch.no_grad():
            _, metrics = model_lib.loss_fn(
                graph, params, preprocess(graph, jitter, batch), train=False
            )
        return metrics

    return eval_fn


def _clamp_parallel(graph: Graph) -> None:
    """The port runs on one device: a `parallel {}` block asking for more
    is clamped, with the warning `parallel/mesh.py:59-82` gives."""
    data, model = graph.parallel_data, graph.parallel_model
    if data * model > 1:
        warnings.warn(
            f"model requests a {data}x{model} mesh but the port runs on one device — "
            "clamped to 1x1",
            stacklevel=3,
        )


class Trainer:
    """Owns the state, the data handlers and the step loop: display every
    `display_after` steps, validation every `validate_after`, a checkpoint
    every `checkpoint_after` (`save`), the train log
    `<checkpoint_dir>/<model>_train_log.txt` when a checkpoint directory
    is set. At construction it resumes from the newest checkpoint of the
    model in the checkpoint directory, if there is one.

    jitter: {field: (JitterSpec, mean, std)} to use instead of the data
    handlers' `jitter_specs()` (for example a mean given without an HDF5
    mean file). model_proto: the model's message; when given, `save`
    rewrites `<checkpoint_dir>/<model>.pbtxt` with the checkpoint's
    timestamp recorded."""

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
    ):
        if steps_per_launch != 1:
            raise NotImplementedError("steps_per_launch > 1 is not ported yet")
        _clamp_parallel(graph)
        self.graph = graph
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
        self._train_step = make_train_step(graph, train_jitter)
        self._eval_step = make_eval_step(graph, eval_jitter)
        self.state = init_state(graph, device=self.device)
        self._resume()

    def log(self, msg: str):
        self._log_fn(msg)
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(msg + "\n")

    # -- checkpointing ------------------------------------------------------

    def _resume(self):
        path = ckpt.latest(self.checkpoint_dir, self.graph.name)
        if not path:
            return
        shapes = {
            name: {"w": tuple(p["w"].shape), "b": tuple(p["b"].shape)}
            for name, p in self.state["params"].items()
        }
        params, moms, step = ckpt.load(path, expected_shapes=shapes)
        expect = {e.name for e in self.graph.weighted_edges}
        if set(params) != expect:
            raise ValueError(f"checkpoint {path} edges {sorted(params)} != model {sorted(expect)}")
        self.state["params"] = model_lib.params_from_numpy(params, self.device)
        if moms is not None:
            self.state["moms"] = model_lib.params_from_numpy(moms, self.device)
        self.state["step"] = step
        self.log(f"resumed from {path} at step {step}")

    def save(self) -> str:
        """Write the params, momenta and step as a checkpoint (f32, on the
        host) and return its path; with a model_proto, also rewrite
        `<model>.pbtxt` beside it with the checkpoint's timestamp."""
        def host(tree):
            return {n: {k: v.detach().float().cpu().numpy() for k, v in p.items()}
                    for n, p in tree.items()}

        path = ckpt.save(self.checkpoint_dir, self.graph.name, host(self.state["params"]),
                         host(self.state["moms"]), step=self.state["step"])
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
        return path

    # -- loops --------------------------------------------------------------

    def device_batch(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A DataHandler batch as tensors on the Trainer's device."""
        return device_batch(host_batch, self.device)

    def train(self, max_iter: Optional[int] = None, profile_dir: Optional[str] = None):
        """The step loop up to `max_iter` steps (default: the pbtxt's).
        profile_dir: trace steps start+5 to start+15 (past the first
        steps' warm-up) with torch.profiler into this directory, as a
        TensorBoard-readable Chrome trace (the reference's window,
        `convnet_tpu/trainer.py:444-524`); a run that ends inside the
        window writes what it traced, one that ends before it says so."""
        g = self.graph
        total = max_iter if max_iter is not None else g.max_iter
        it = self.state["step"]
        p_start, p_stop = it + 5, it + 15
        prof = None
        window: List[Dict[str, torch.Tensor]] = []
        t0 = time.time()
        next_batch = self.device_batch(self.train_data.get_batch()) if it < total else None
        while it < total:
            if profile_dir is not None:
                if prof is None and p_start <= it < p_stop:
                    prof = self._start_trace(profile_dir)
                elif prof is not None and it >= p_stop:
                    self._stop_trace(prof)
                    prof = None
                    self.log(f"profile trace -> {profile_dir}")
            metrics = self._train_step(self.state, next_batch)
            prev, it = it, it + 1
            # stage the next batch while this step runs on the device
            if it < total:
                next_batch = self.device_batch(self.train_data.get_batch())
            window.append(metrics)
            if g.display_after and it // g.display_after > prev // g.display_after:
                loss = torch.stack([m["loss"].float() for m in window]).mean().item()
                errs = sum(
                    torch.stack([m[k] for m in window]).sum().item()
                    for k in window[0] if k.endswith("/errors")
                )
                seen = len(window) * self.train_data.batch_size
                dt = time.time() - t0
                ips = seen / dt if dt > 0 else 0.0
                self.log(
                    f"step {it} loss {loss:.4f} train_err {errs / max(1, seen):.4f} "
                    f"({ips:.1f} img/s)"
                )
                window = []
                t0 = time.time()
            if (
                g.validate_after
                and self.val_data
                and it // g.validate_after > prev // g.validate_after
            ):
                verr, vloss = self.validate()
                self.log(f"step {it} VALIDATION loss {vloss:.4f} err {verr:.4f}")
                t0 = time.time()
            if g.checkpoint_after and it // g.checkpoint_after > prev // g.checkpoint_after:
                self.save()
                t0 = time.time()
        if prof is not None:
            self._stop_trace(prof)
            self.log(f"profile trace -> {profile_dir} (truncated at end of run)")
        elif profile_dir is not None and it < p_start:
            self.log(
                f"WARNING: profile_dir given but the run ended at step {it} "
                f"before the trace window (starts at step {p_start}); no "
                "trace was captured"
            )
        return self.state

    def _start_trace(self, profile_dir: str):
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
        prof.start()
        return prof

    def _stop_trace(self, prof) -> None:
        """End the trace once the traced steps' device work is done, and
        write it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()

    def validate(self, num_batches: Optional[int] = None) -> Tuple[float, float]:
        """(error rate, mean loss) over num_batches validation batches
        (default: validate_batches, else the whole set)."""
        if self.val_data is None:
            raise ValueError("validate() needs val_data")
        n = num_batches or self.graph.validate_batches or self.val_data.num_batches
        n = max(1, min(n, self.val_data.num_batches))
        bs = self.val_data.batch_size
        tot_err = tot_loss = seen = 0.0
        for _ in range(n):
            m = self._eval_step(
                self.state["params"], self.device_batch(self.val_data.get_batch())
            )
            tot_loss += float(m["loss"]) * bs
            tot_err += sum(float(m[k]) for k in m if k.endswith("/errors"))
            seen += bs
        return tot_err / seen, tot_loss / seen
