"""Rank processes of the port's parallel tests (tests/test_torch_port_parallel.py):
not a test file itself.

`spawn` starts a world of ranks on the CPU: one process a rank, started
with the "spawn" method, joined in a gloo process group through a file
under the test's temporary directory (a TCP port could collide between
pytest-xdist workers). Each rank runs one of the functions below and
puts what it returns on a queue, which `spawn` reads back in rank
order. The ranks import only the port, numpy and torch: the JAX
reference runs in the test's own process.
"""

from __future__ import annotations

import hashlib
import queue
import time
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: A world that is not done within this many seconds is a failure.
WORLD_TIMEOUT_S = 240


def _entry(rank: int, world: int, init: str, results, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results.put((rank, result))


def spawn(fn: Callable, world: int, directory: Path, *args) -> List[Any]:
    """fn(*args) on each rank of a gloo world of `world` ranks; the ranks'
    results in rank order. A rank that raises fails the call."""
    directory.mkdir(parents=True, exist_ok=True)
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(_entry, args=(world, f"file://{directory}/init", results, fn, args),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    got: Dict[int, Any] = {}
    try:
        # drain the queue before joining: a rank exits once its result is read
        while len(got) < world:
            try:
                rank, result = results.get(timeout=1)
                got[rank] = result
            except queue.Empty:
                ctx.join(timeout=0)  # raises as soon as a rank has failed
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ranks ran past {WORLD_TIMEOUT_S} s")
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ranks ran past {WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------


def digest(tree) -> str:
    """sha256 of a nested dict of numpy arrays, in key order."""
    h = hashlib.sha256()

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                h.update(k.encode())
                walk(node[k])
        else:
            h.update(np.ascontiguousarray(node).tobytes())

    walk(tree)
    return h.hexdigest()


def _graph(model_text: str, sizes: Dict[str, int]):
    from convnet_tpu_torch import config
    from convnet_tpu_torch.graph import build_graph

    return build_graph(config.parse_model(model_text), sizes)


def jitter_map(jitter):
    """(image_size, can_translate, can_flip, scale, mean) -> a JitterMap of
    the field "input", or None."""
    if jitter is None:
        return None
    from convnet_tpu_torch.data.jitter import JitterSpec

    size, translate, flip, scale, mean = jitter
    return {"input": (JitterSpec(image_size=size, can_translate=translate, can_flip=flip,
                                 scale=scale), mean, None)}


def run_jobs(jobs: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """{name: run_meshes(**job)} for every job."""
    return {name: run_meshes(**job) for name, job in jobs.items()}


def run_meshes(model_text: str, sizes: Dict[str, int], meshes, seed: int, batches, jitter,
               layers) -> Dict[tuple, Dict[str, Any]]:
    """For each mesh shape (data, model): from the full params of the
    port's init_params at `seed`, one
    train step a batch of `batches` (global numpy batches; the rank keeps
    its rows), then the sharded forward of `layers` and the eval step on
    the first batch. Returns, by shape: the gathered params and momenta
    (rank 0; a digest of them on every rank), each step's metrics and
    crops, the forward's rows, the eval metrics and the local shape of
    every leaf."""
    from convnet_tpu_torch import model as model_lib
    from convnet_tpu_torch import optim
    from convnet_tpu_torch.parallel.mesh import (
        batch_rows,
        gather_params,
        make_mesh,
        param_shardings,
        shard_params,
    )
    from convnet_tpu_torch.trainer import make_eval_step, make_forward, make_train_step

    graph = _graph(model_text, sizes)
    jmap = jitter_map(jitter)
    out = {}
    for shape in meshes:
        mesh = make_mesh(*shape)
        specs = param_shardings(graph, mesh.model)
        local = shard_params(model_lib.init_params(graph, seed), specs, mesh)
        state = {"params": local, "moms": optim.init_momentum(local), "step": 0, "seed": 0}
        step = make_train_step(graph, jmap, mesh=mesh)
        metrics, crops = [], []
        for batch in batches:
            rows = batch_rows(mesh, len(batch["labels"]))
            m = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
            metrics.append({k: v.item() for k, v in m.items()})
            crops.append({f: tuple(None if t is None else t.numpy() for t in c)
                          for f, c in step.__self__.last_draws[1].items()})
        rows = batch_rows(mesh, len(batches[0]["labels"]))
        first = {k: torch.from_numpy(v[rows]) for k, v in batches[0].items()}
        with torch.no_grad():
            fwd = make_forward(graph, layers, jmap, mesh)(local, first)
        ev = make_eval_step(graph, jmap, mesh)(state["params"], first)
        gathered = {t: gather_params(state[t], specs, mesh) for t in ("params", "moms")}
        out[shape] = {
            # the full trees from rank 0, a digest of them from every rank
            "params": gathered["params"] if dist.get_rank() == 0 else None,
            "moms": gathered["moms"] if dist.get_rank() == 0 else None,
            "digest": digest(gathered),
            "metrics": metrics,
            "crops": crops,
            "fwd": {k: v.float().numpy() for k, v in fwd.items() if k in layers},
            "eval": {k: v.item() for k, v in ev.items()},
            "local_shapes": {n: {k: tuple(v.shape) for k, v in p.items()}
                             for n, p in state["params"].items()},
            "coords": (mesh.d, mesh.m),
        }
    return out


def run_trainer(model_text: str, sizes: Dict[str, int], data_text: str, directory: str,
                steps: int, resume_dir: str) -> Dict[str, Any]:
    """On a 2x2 mesh: a Trainer whose batch does not split over the data
    axis must raise; a Trainer trains `steps` steps over DUMMY data and
    saves into `directory`; a Trainer on `resume_dir` (holding a
    single-device checkpoint) resumes from it. Returns the error message,
    the saved path (rank 0), and both Trainers' gathered params."""
    from convnet_tpu_torch import config
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.parallel.mesh import gather_params, make_mesh, param_shardings
    from convnet_tpu_torch.trainer import Trainer

    graph = _graph(model_text, sizes)
    mesh = make_mesh(2, 2)
    specs = param_shardings(graph, mesh.model)
    cfg = config.parse_dataset_config(data_text)
    odd = DataHandler(cfg, batch_size=7)
    try:
        Trainer(graph, odd, device="cpu", mesh=mesh)
        error = None
    except ValueError as e:
        error = str(e)
    odd.close()
    data = DataHandler(cfg)
    lines: List[str] = []
    tr = Trainer(graph, data, checkpoint_dir=directory, log_fn=lines.append, device="cpu",
                 mesh=mesh)
    tr.train(max_iter=steps)
    path = tr.save()
    trained = gather_params(tr.state["params"], specs, mesh)
    data.close()
    data = DataHandler(cfg)
    resumed = Trainer(graph, data, checkpoint_dir=resume_dir, log_fn=lines.append, device="cpu",
                      mesh=mesh)
    data.close()
    return {"error": error, "path": path, "trained": trained, "step": tr.state["step"],
            "resumed": gather_params(resumed.state["params"], specs, mesh),
            "resumed_step": resumed.state["step"], "lines": lines}


def run_cli(train_argv: List[str], extract_argv: List[str], checkpoint_dir: str,
            model_name: str) -> Dict[str, Any]:
    """The train CLI and then the extract CLI in this rank's process, in the
    world the rank has joined; the extract's "CKPT" argument stands for
    the newest checkpoint that the train CLI wrote."""
    from convnet_tpu_torch import checkpoint
    from convnet_tpu_torch.cli import extract, train

    rc = train.main(train_argv)
    path = checkpoint.latest(checkpoint_dir, model_name)
    return {"train": rc,
            "extract": extract.main([path if a == "CKPT" else a for a in extract_argv])}

