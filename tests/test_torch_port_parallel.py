"""The port's multi-device path (convnet_tpu_torch/parallel) on the CPU:
against the port's own single-device path and against the JAX package's
mesh (tests/test_parallel.py's 8 virtual CPU devices).

The port's ranks are processes in a gloo world (tests/torch_port_ranks.py),
spawned once a world and each running several checks; the JAX reference
and the port's single-device runs are computed here, in the test process.
The comparisons with the JAX package's mesh are in
tests/test_torch_port_parallel_jax.py, a world of their own, so that
pytest-xdist runs the two files side by side.
Tolerance: f32 at rtol 1e-4, atol 1e-5, tests/test_parallel.py's bar: a
sharded step differs from one device's only in the order of its sums (the
gradient all-reduce, column blocks of a product).

Models: TRAIN_NET (test_torch_port_train.py: uint8 input through the
space-to-depth prologue, conv2's 128 channels sharded at model 2 and 4 with
its bias deferred into rnorm2) and alexnet_2tower at f32 and 67 px, as
tests/test_parallel.py sizes AlexNet, whose grouped convs split at
(n, g) = (2, 2) and (4, 2). Against the port's one device: with random
crops, flips and dropout. Against JAX: with neither (their random draws
differ), as the other parity tests do.
"""

import glob
import os
import warnings
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)
import torch_port_ranks as ranks

from convnet_tpu import checkpoint as jax_ckpt
from convnet_tpu import config as jax_config
from convnet_tpu import trainer as jax_trainer
from convnet_tpu.graph import build_graph as jax_build_graph
from convnet_tpu.parallel import mesh as jax_mesh
from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch import optim as pt_optim
from convnet_tpu_torch.cli import extract, train
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.ops import dropout as pt_drop
from convnet_tpu_torch.parallel import mesh as pt_mesh
from convnet_tpu_torch.trainer import Trainer, make_eval_step, make_forward, make_train_step

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-5
MESHES = [(4, 1), (2, 2), (1, 4)]
MODELS = sorted(p for p in (REPO / "examples").glob("*/*.pbtxt") if "_data" not in p.name
                and "dummy" not in p.name)

RAW, CROP, BATCH = 48, 43, 128
MEAN = np.full((3,), 0.45, np.float32)
OPT = (" weight_optimizer { base_epsilon: 0.05 initial_momentum: 0.9 final_momentum: 0.9 "
       "l2_decay: 0.0005 } bias_optimizer { base_epsilon: 0.1 initial_momentum: 0.9 "
       "final_momentum: 0.9 }")
# test_torch_port_train.py's TRAIN_NET in f32
TRAIN_NET = """
name: "tiny_alexnet_train"
seed: 3
batch_size: 128
layer { name: "input" is_input: true num_channels: 3 image_size: 43 }
layer { name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 16 }
layer { name: "pool1" num_channels: 16 }
layer { name: "conv2" num_channels: 128 activation: RECTIFIED_LINEAR }
layer { name: "rnorm2" num_channels: 128 }
layer { name: "pool2" num_channels: 128 }
layer { name: "fc" num_channels: 32 activation: RECTIFIED_LINEAR dropprob: DROP }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 11 stride: 4 padding: 0
       initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.05 OPT }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
       add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.3125 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool1" dest: "conv2" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.1 OPT }
edge { source: "conv2" dest: "rnorm2" edge_type: RESPONSE_NORM
       add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.0390625 }
edge { source: "rnorm2" dest: "pool2" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool2" dest: "fc" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05
       init_bias: 0.1 OPT }
edge { source: "fc" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05 OPT }
""".replace("OPT", OPT)
TOWERS_SIZE, TOWERS_RAW, TOWERS_BATCH = 67, 72, 16


def _towers_text(dropprob=None) -> str:
    m = pt_config.read_model(str(REPO / "examples/imagenet/alexnet_2tower.pbtxt"))
    m.ClearField("compute_dtype")  # f32: bf16 rounding would hide a sharding bug
    m.ClearField("activation_dtype")
    m.parallel.data = m.parallel.model = 1
    if dropprob is not None:
        for l in m.layer:
            if l.dropprob:
                l.dropprob = dropprob
    return pt_config.model_to_text(m)


def _batches(n, b, raw, classes, seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        x = [rng.integers(0, 256, (b, raw, raw, 3), dtype=np.uint8) for _ in range(n)]
    else:
        x = [rng.random((b, raw, raw, 3), dtype=np.float32) for _ in range(n)]
    return [{"input": xi, "labels": rng.integers(0, classes, b).astype(np.int32)} for xi in x]




def _clip_conv2(text: str) -> str:
    """conv2's weights (sharded at model 2 and 4) with a gradient clip that
    binds: its norm is the whole leaf's, summed over the model group."""
    at = text.index("weight_optimizer {", text.index('dest: "conv2"'))
    return text[:at] + "weight_optimizer { gradient_clip: 0.01" + text[at + 18:]


#: name -> the ranks' job: a model, its input sizes, two global batches
#: and a jitter (None: the raw float input, no crops, and no dropout)
JOBS = {
    "train_net": dict(model_text=_clip_conv2(TRAIN_NET.replace("DROP", "0.5")), sizes={},
                      batches=_batches(2, BATCH, RAW, 10, 0, np.uint8),
                      jitter=(CROP, True, True, 1 / 255, MEAN), layers=["fc", "pool2"]),
    "train_net_plain": dict(model_text=TRAIN_NET.replace("DROP", "0.0"), sizes={},
                            batches=_batches(2, BATCH, CROP, 10, 1, np.float32), jitter=None,
                            layers=["fc"]),
    "towers": dict(model_text=_towers_text(), sizes={"input": TOWERS_SIZE},
                   batches=_batches(2, TOWERS_BATCH, TOWERS_RAW, 1000, 2, np.uint8),
                   jitter=(TOWERS_SIZE, True, True, 1 / 255, MEAN), layers=["fc7", "pool5"]),
    "towers_plain": dict(model_text=_towers_text(0.0), sizes={"input": TOWERS_SIZE},
                         batches=_batches(2, TOWERS_BATCH, TOWERS_SIZE, 1000, 3, np.float32),
                         jitter=None, layers=["fc7"]),
}
SEED = 0  # the port's init_params seed, in the ranks and here


def _graph(job):
    return pt_build_graph(pt_config.parse_model(JOBS[job]["model_text"]), JOBS[job]["sizes"])


def _assert_trees_close(got, want, what):
    for n, p in want.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[n][k], v, rtol=RTOL, atol=ATOL, err_msg=f"{what} {n}/{k}")


def spawn_jobs(names, directory):
    """The jobs `names` on meshes 4x1, 2x2 and 1x4 in one world of 4 ranks:
    [rank] -> {job: {mesh: results}}."""
    jobs = {name: dict(JOBS[name], meshes=MESHES, seed=SEED) for name in names}
    return ranks.spawn(ranks.run_jobs, 4, directory, jobs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_jobs(["train_net", "towers"], tmp_path_factory.mktemp("world"))


@pytest.fixture(scope="module")
def single():
    """The port's single-device steps, forward and eval of the jobs with
    random draws."""
    out = {}
    for name in ("train_net", "towers"):
        job = JOBS[name]
        g = _graph(name)
        jmap = ranks.jitter_map(job["jitter"])
        params = pt_model.init_params(g, SEED)
        state = {"params": params, "moms": pt_optim.init_momentum(params), "step": 0, "seed": 0}
        step = make_train_step(g, jmap)
        metrics, crops = [], []
        for batch in job["batches"]:
            m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            metrics.append({k: v.item() for k, v in m.items()})
            crops.append({f: tuple(None if t is None else t.numpy() for t in c)
                          for f, c in step.__self__.last_draws[1].items()})
        first = {k: torch.from_numpy(v) for k, v in job["batches"][0].items()}
        with torch.no_grad():
            fwd = make_forward(g, job["layers"], jmap)(state["params"], first)
        ev = make_eval_step(g, jmap)(state["params"], first)
        out[name] = {
            "params": {n: {k: v.detach().numpy() for k, v in p.items()}
                       for n, p in state["params"].items()},
            "moms": {n: {k: v.numpy() for k, v in p.items()} for n, p in state["moms"].items()},
            "metrics": metrics, "crops": crops,
            "fwd": {k: v.float().numpy() for k, v in fwd.items() if k in job["layers"]},
            "eval": {k: v.item() for k, v in ev.items()},
        }
    return out


# ---------------------------------------------------------------------------
# The sharding rules and the mesh's shape, against the JAX package
# ---------------------------------------------------------------------------


def _example_graphs(path: Path):
    jm, pm = jax_config.read_model(str(path)), pt_config.read_model(str(path))
    sizes = {l.name: 67 for l in jm.layer if l.is_input} if "imagenet" in str(path) else None
    return jax_build_graph(jm, sizes), pt_build_graph(pm, sizes)


def _jax_axis(spec):
    return next((i for i, a in enumerate(tuple(spec)) if a == "model"), None)


@pytest.mark.parametrize("path", MODELS, ids=lambda p: p.stem)
def test_sharding_rules_equal_jax(path):
    jg, pg = _example_graphs(path)
    for n in (1, 2, 4, 8):
        got = pt_mesh.param_shardings(pg, n)
        for e in jg.weighted_edges:
            for leaf in ("w", "b"):
                want = _jax_axis(jax_mesh._edge_pspec(jg, e.name, leaf, n))
                assert got[e.name][leaf] == want, (path.stem, n, e.name, leaf)
        assert pt_mesh.state_shardings(pg, n) == {"params": got, "moms": got}


@pytest.mark.parametrize("world_size", [1, 2, 4, 8])
def test_mesh_shape_and_warning_equal_jax(world_size):
    for name in ("alexnet", "alexnet_2tower"):
        jg, pg = _example_graphs(REPO / f"examples/imagenet/{name}.pbtxt")
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jm = jax_mesh.mesh_for_graph(jg, devices=jax.devices()[:world_size])
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            shape = pt_mesh.mesh_shape_for_graph(pg, world_size)
        want = (1, 1) if jm is None else (jm.shape["data"], jm.shape["model"])
        assert shape == want, (name, world_size)
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    # no process group: a world of one, and the JAX package's clamp
    with pytest.warns(UserWarning, match="4x2 mesh but only 1 device"):
        assert pt_mesh.mesh_for_graph(pg) is None


def test_make_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(RuntimeError, match="process group"):
        pt_mesh.make_mesh(2, 1)
    assert pt_mesh.batch_rows(None, 8) == slice(0, 8)


# ---------------------------------------------------------------------------
# Sharded steps, forward and eval in a world of 4 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("job", ["train_net", "towers"])
def test_sharded_steps_equal_single_device(world, single, job, mesh):
    """Two steps with random crops, flips and dropout: every rank holds
    the same replicas, its leaves are 1/n of the sharded ones, its crops
    are its rows' of one device's, and the gathered params and momenta and
    the metrics are one device's."""
    g = _graph(job)
    want = single[job]
    got = world[0][job][mesh]
    specs = pt_mesh.param_shardings(g, mesh[1])
    shapes = pt_model.param_shapes(g)
    for r, out in enumerate(world):
        res = out[job][mesh]
        d, m = divmod(r, mesh[1])
        assert res["coords"] == (d, m)
        assert res["digest"] == got["digest"], (job, mesh, r)
        for n, p in shapes.items():
            for k, full in p.items():
                local = list(full)
                if specs[n][k] is not None:
                    local[specs[n][k]] //= mesh[1]
                assert res["local_shapes"][n][k] == tuple(local), (n, k)
        b = len(JOBS[job]["batches"][0]["labels"]) // mesh[0]
        for step_crops, want_crops in zip(res["crops"], want["crops"]):
            for a, w in zip(step_crops["input"], want_crops["input"]):
                np.testing.assert_array_equal(a, w[d * b:(d + 1) * b])
    for a, w in zip(got["metrics"], want["metrics"]):
        assert a["output/errors"] == w["output/errors"]
        np.testing.assert_allclose(a["loss"], w["loss"], rtol=RTOL)
    _assert_trees_close(got["params"], want["params"], "params")
    _assert_trees_close(got["moms"], want["moms"], "moms")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("job", ["train_net", "towers"])
def test_sharded_forward_and_eval_equal_single_device(world, single, job, mesh):
    want = single[job]
    b = len(JOBS[job]["batches"][0]["labels"]) // mesh[0]
    for r, out in enumerate(world):
        res = out[job][mesh]
        d = r // mesh[1]
        for layer, w in want["fwd"].items():
            np.testing.assert_allclose(res["fwd"][layer], w[d * b:(d + 1) * b], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{job} {mesh} rank {r} {layer}")
        assert res["eval"]["output/errors"] == want["eval"]["output/errors"]
        np.testing.assert_allclose(res["eval"]["loss"], want["eval"]["loss"], rtol=RTOL)


# ---------------------------------------------------------------------------
# The draws of a rank's rows, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [2, 4])
def test_step_draws_of_a_ranks_rows_are_the_global_draws_rows(data):
    from convnet_tpu_torch.data.jitter import crop_draw

    rng = torch.tensor([11, 5], dtype=torch.int64)
    whole = pt_drop.step_draws(rng, [(3, 0)], crop_draw("input", BATCH, RAW, RAW, CROP, True,
                                                        True))
    b = BATCH // data
    for d in range(data):
        keys, crops = pt_drop.step_draws(
            rng, [(3, 0)], crop_draw("input", b, RAW, RAW, CROP, True, True, d * b))
        assert torch.equal(keys, whole[0])
        for a, w in zip(crops, whole[1]):
            assert torch.equal(a, w[d * b:(d + 1) * b])
    with pytest.raises(ValueError, match="crop rows"):
        pt_drop.step_draws(rng, (), crop_draw("input", 4, RAW, RAW, CROP, True, True, -4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_offset_through_autograd_draws_the_global_mask(dtype):
    """A rank's rows through dropout(..., offset) give, forward and
    backward, the rows of the whole batch through dropout(...)."""
    b, f, data = 8, 12, 4
    gen = np.random.default_rng(4)
    x = torch.from_numpy(gen.standard_normal((b, f), np.float32)).to(dtype)
    g = torch.from_numpy(gen.standard_normal((b, f), np.float32)).to(dtype)
    key = torch.tensor(pt_drop.dropout_key(7, 3, 2), dtype=torch.int64)
    xw = x.clone().requires_grad_()
    yw = pt_drop.dropout(xw, 0.5, key)
    (dw,) = torch.autograd.grad(yw, xw, g)
    rows = b // data
    for d in range(data):
        xr = x[d * rows:(d + 1) * rows].clone().requires_grad_()
        yr = pt_drop.dropout(xr, 0.5, key, offset=d * rows * f)
        (dr,) = torch.autograd.grad(yr, xr, g[d * rows:(d + 1) * rows])
        assert torch.equal(yr, yw[d * rows:(d + 1) * rows].detach())
        assert torch.equal(dr, dw[d * rows:(d + 1) * rows])
    with pytest.raises(ValueError, match="multiple of 4"):
        pt_drop.dropout(x, 0.5, key, offset=6)


# ---------------------------------------------------------------------------
# The Trainer on a 2x2 mesh, and its checkpoints
# ---------------------------------------------------------------------------

DATA = """
name: "dummy"
batch_size: 128
randomize_cpu: true
pipeline_loads: false
data_config { layer_name: "input" data_type: DUMMY raw_image_size: 48 image_size: 43
              can_translate: true can_flip: true scale: 0.0039215686 dummy_size: 384 }
data_config { layer_name: "labels" data_type: DUMMY dummy_size: 384 dummy_num_classes: 10 }
"""
TRAINER_STEPS = 3


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    """A single-device checkpoint to resume from, then the 2x2 world."""
    g = _graph("train_net")
    resume = tmp_path_factory.mktemp("resume")
    data = DataHandler(pt_config.parse_dataset_config(DATA))
    tr = Trainer(g, data, checkpoint_dir=str(resume), log_fn=lambda _: None, device="cpu")
    tr.train(max_iter=2)
    single_path = tr.save()
    data.close()
    out = tmp_path_factory.mktemp("mesh_ckpt")
    results = ranks.spawn(ranks.run_trainer, 4, tmp_path_factory.mktemp("trainer_world"),
                          JOBS["train_net"]["model_text"], {}, DATA, str(out), TRAINER_STEPS,
                          str(resume))
    return results, single_path


def test_trainer_on_a_mesh_trains_as_one_device(trainer_world):
    """An indivisible batch raises; the 2x2 Trainer's steps over DUMMY data
    (crops, flips, dropout) equal one device's Trainer's; rank 0 alone
    logs and writes; its checkpoint holds the full params."""
    results, _ = trainer_world
    assert "not divisible by the mesh's data axis (2 ways)" in results[0]["error"]
    g = _graph("train_net")
    data = DataHandler(pt_config.parse_dataset_config(DATA))
    lines = []
    tr = Trainer(g, data, log_fn=lines.append, device="cpu")
    tr.train(max_iter=TRAINER_STEPS)
    data.close()
    want = {n: {k: v.detach().numpy() for k, v in p.items()} for n, p in tr.state["params"].items()}
    _assert_trees_close(results[0]["trained"], want, "trainer")
    assert results[0]["path"] and all(r["path"] is None for r in results[1:])
    assert all(r["lines"] == [] for r in results[1:]) and results[0]["lines"]
    assert all(r["step"] == TRAINER_STEPS for r in results)


def test_mesh_checkpoint_loads_in_both_packages(trainer_world, tmp_path):
    results, _ = trainer_world
    path = results[0]["path"]
    jparams, _, jstep = jax_ckpt.load(path)
    assert jstep == TRAINER_STEPS
    _assert_trees_close(jax.tree.map(np.asarray, jparams), results[0]["trained"], "jax load")
    g = _graph("train_net")
    data = DataHandler(pt_config.parse_dataset_config(DATA))
    tr = Trainer(g, data, checkpoint_dir=os.path.dirname(path), log_fn=lambda _: None,
                 device="cpu")
    data.close()
    assert tr.state["step"] == TRAINER_STEPS
    for n, p in tr.state["params"].items():
        for k, v in p.items():
            np.testing.assert_array_equal(v.numpy(), results[0]["trained"][n][k])


def test_single_device_checkpoint_resumes_on_the_mesh(trainer_world):
    results, single_path = trainer_world
    params, _, step = ckpt.load(single_path)
    for r in results:
        assert r["resumed_step"] == step == 2
        for n, p in params.items():
            for k, v in p.items():
                np.testing.assert_array_equal(r["resumed"][n][k], v)


# ---------------------------------------------------------------------------
# The CLIs in a world of 2 ranks
# ---------------------------------------------------------------------------

CLI_NET = """
name: "mesh_cli"
seed: 5
batch_size: 16
max_iter: 4
display_after: 2
checkpoint_after: 4
parallel { data: 2 model: 1 }
layer { name: "input" is_input: true num_channels: 1 image_size: 28 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "pool1" num_channels: 8 }
layer { name: "fc1" num_channels: 512 activation: RECTIFIED_LINEAR dropprob: 0.5 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 5 stride: 1 padding: 2
       initialization: DENSE_GAUSSIAN init_wt: 0.1 }
edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 2 stride: 2 }
edge { source: "pool1" dest: "fc1" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN
       init_wt: 1.0 }
edge { source: "fc1" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN
       init_wt: 1.0 }
"""


def test_train_and_extract_clis_on_two_ranks(tmp_path):
    """The train CLI with its mesh overridden to 1x2 (fc1's columns split),
    then the extract CLI on the model's own 2x1 (rows split, the batch of 5
    rounded up to 6), in one world of 2 ranks: one checkpoint and one log,
    rank 0's, the checkpoint's params one device's, and the extracted rows
    one device's extract."""
    model = tmp_path / "mesh_cli.pbtxt"
    model.write_text(CLI_NET)
    dtrain = str(REPO / "examples/mnist/mnist_dummy_train.pbtxt")
    dval = str(REPO / "examples/mnist/mnist_dummy_val.pbtxt")
    cpu = ["--device", "cpu"]
    runs = {}
    for name, mesh_args in (("mesh", ["--data-parallel", "1", "--model-parallel", "2"]),
                            ("single", [])):
        out = tmp_path / name
        train_argv = [str(model), dtrain, "--output-dir", str(out), *mesh_args, *cpu]
        runs[name] = out
        if name == "single":
            with pytest.warns(UserWarning, match="2x1 mesh but only 1 device"):
                assert train.main(train_argv) == 0
            continue
        argv_x = [str(model), dval, "--checkpoint", "CKPT", "--output", str(tmp_path / "x.h5"),
                  "--layers", "fc1", "--batch-size", "5", *cpu]
        rcs = ranks.spawn(ranks.run_cli, 2, tmp_path / "world", train_argv, argv_x, str(out),
                          "mesh_cli")
        assert rcs == [{"train": 0, "extract": 0}] * 2
    # one checkpoint at checkpoint_after, one at the end, as on one device
    ckpts = {n: sorted(glob.glob(str(out / "*.h5"))) for n, out in runs.items()}
    assert len(ckpts["mesh"]) == len(ckpts["single"]) == 2
    got, want = ckpt.load(ckpts["mesh"][-1])[0], ckpt.load(ckpts["single"][-1])[0]
    _assert_trees_close(got, want, "cli checkpoint")
    log = (runs["mesh"] / "mesh_cli_train_log.txt").read_text().splitlines()
    assert [l.split()[1] for l in log if l.startswith("step")] == ["2", "4"]
    single_x = tmp_path / "single_x.h5"
    with pytest.warns(UserWarning, match="2x1 mesh"):
        assert extract.main([str(model), dval, "--checkpoint", ckpts["mesh"][-1], "--output",
                             str(single_x), "--layers", "fc1", "--batch-size", "5", "--device",
                             "cpu"]) == 0
    with h5py.File(tmp_path / "x.h5") as f, h5py.File(single_x) as w:
        assert f["fc1"].shape == w["fc1"].shape == (1024, 512)
        np.testing.assert_allclose(f["fc1"][...], w["fc1"][...], rtol=RTOL, atol=ATOL)
