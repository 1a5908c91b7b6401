"""The port's HDF5 checkpoints (convnet_tpu_torch.checkpoint), PRETRAINED
init, Trainer save and resume, and Predictor.from_checkpoint, against the
JAX package's, on the CPU.

Both packages write and read the layout of docs/checkpoint_format.md, so a
file written by either loads in the other: the parity tests write with one
package and read with the other, and the layout variants are read by both
and must load array-equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import checkpoint as jax_ckpt
from convnet_tpu import config
from convnet_tpu import model as jax_model
from convnet_tpu.graph import build_graph
from convnet_tpu.predictor import Predictor as JaxPredictor
from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch import trainer as pt_trainer
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.predictor import Predictor

REPO = Path(__file__).resolve().parent.parent
DIGITS = REPO / "examples" / "digits"

# A narrow f32 net: convs with HWIO filters (one with an unshared bias), a
# max pool and an FC edge, so every weight layout the format pins is used.
NET = """
name: "narrow"
seed: 5
layer { name: "input" is_input: true num_channels: 3 image_size: 12 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "pool1" num_channels: 8 }
layer { name: "conv2" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.1 }
edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool1" dest: "conv2" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       shared_bias: false initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.05 }
edge { source: "conv2" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
"""
BATCH = 16


def _graphs(text=NET):
    """(JAX graph, port graph) of one pbtxt, each through its own reader."""
    return build_graph(config.parse_model(text)), pt_build_graph(pt_config.parse_model(text))


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((BATCH, 12, 12, 3)).astype(np.float32)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            np.testing.assert_array_equal(np.asarray(got[name][k]), np.asarray(want[name][k]))


def _moms(params, scale):
    return {n: {k: np.asarray(v, np.float32) * scale for k, v in p.items()}
            for n, p in params.items()}


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """JAX's save writes, the port's load reads: the same arrays, and the
    port's Predictor over them gives the JAX Predictor's f32 logits at 1e-4."""
    jg, g = _graphs()
    jparams = jax_model.init_params(jg, seed=1)
    path = jax_ckpt.save(str(tmp_path), "narrow", jparams, _moms(jparams, 0.5), step=9)
    params, moms, step = ckpt.load(path, expected_shapes=pt_model.param_shapes(g))
    assert step == 9
    _assert_trees_equal(params, {n: {k: np.asarray(v) for k, v in p.items()}
                                 for n, p in jparams.items()})
    _assert_trees_equal(moms, _moms(jparams, 0.5))
    x = _images()
    want = JaxPredictor(jg, jparams, batch_size=BATCH)({"input": x})
    got = Predictor.from_checkpoint(g, path, batch_size=BATCH, device="cpu")({"input": x})
    np.testing.assert_allclose(got["output:preact"], np.asarray(want["output:preact"]),
                               rtol=1e-4, atol=1e-4)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's save writes, JAX's load reads: the same arrays, and the
    JAX Predictor over them gives the port Predictor's f32 logits at 1e-4."""
    jg, g = _graphs()
    params = pt_model.init_params(g, seed=2)
    host = _host(params)
    path = ckpt.save(str(tmp_path), "narrow", host, _moms(host, 0.25), step=11)
    jparams, jmoms, step = jax_ckpt.load(path, expected_shapes=jax_model.param_shapes(jg))
    assert step == 11
    _assert_trees_equal(jparams, host)
    _assert_trees_equal(jmoms, _moms(host, 0.25))
    with h5py.File(path, "r") as f:
        assert f.attrs["model_name"] == "narrow" and f.attrs["step"] == 11
        assert set(f) == set(host) and set(f["input:conv1"]) == {"w", "b", "w_mom", "b_mom"}
    x = _images(1)
    want = Predictor(g, params, batch_size=BATCH, device="cpu")({"input": x})
    got = JaxPredictor.from_checkpoint(jg, path, batch_size=BATCH)({"input": x})
    np.testing.assert_allclose(np.asarray(got["output:preact"]), want["output:preact"],
                               rtol=1e-4, atol=1e-4)


def _two_edges():
    return {
        "a:b": {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(3, np.float32)},
        "b:c": {"w": np.full((3, 4), 0.5, np.float32), "b": np.arange(4, dtype=np.float32)},
    }


SHAPES = {"a:b": {"w": (2, 3), "b": (3,)}, "b:c": {"w": (3, 4), "b": (4,)}}
CONV_W = np.random.RandomState(0).randn(5, 5, 3, 16).astype(np.float32)  # HWIO


def _write_variant(path, variant):
    """The layout variants of tests/test_checkpoint.py, written with h5py.
    Returns the expected_shapes to load them with."""
    params = _two_edges()
    with h5py.File(path, "w") as f:
        if variant == "aliased_group":
            f.attrs["step"] = 7
            for name, p in params.items():
                g = f.create_group(name)
                g.create_dataset("weight", data=p["w"])
                g.create_dataset("bias", data=p["b"])
                g.create_dataset("weight_mom", data=p["w"] * 0.1)
                g.create_dataset("bias_mom", data=p["b"] * 0.1)
        elif variant == "flat_datasets":
            f.attrs["step"] = 3
            for name, p in params.items():
                f.create_dataset(name, data=p["w"])
                f.create_dataset(name + "_bias", data=p["b"])
                f.create_dataset(name + "_mom", data=p["w"] * 0.2)
        elif variant == "transposed_fc":
            for name, p in params.items():
                g = f.create_group(name)
                g.create_dataset("w", data=p["w"].T)
                g.create_dataset("b", data=p["b"])
        elif variant == "flattened_conv":
            g = f.create_group("input:conv1")
            g.create_dataset("w", data=CONV_W.transpose(3, 0, 1, 2).reshape(16, -1))
            g.create_dataset("b", data=np.zeros(16, np.float32))
            g = f.create_group("conv1:conv2")
            g.create_dataset("w", data=CONV_W.reshape(-1, 16))  # (k*k*in, out)
            return {"input:conv1": {"w": (5, 5, 3, 16), "b": (16,)},
                    "conv1:conv2": {"w": (5, 5, 3, 16), "b": (16,)}}
        elif variant == "missing_bias":
            f.create_dataset("a:b", data=np.ones((2, 3), np.float32))
            g = f.create_group("b:c")
            g.create_dataset("w", data=params["b:c"]["w"])
        elif variant == "incompatible_shape":
            g = f.create_group("a:b")
            g.create_dataset("w", data=np.ones((7, 9), np.float32))
            g.create_dataset("b", data=np.zeros(3, np.float32))
    return SHAPES


@pytest.mark.parametrize("variant", ["aliased_group", "flat_datasets", "transposed_fc",
                                     "flattened_conv", "missing_bias", "incompatible_shape"])
def test_layout_variants_load_as_in_jax(tmp_path, variant):
    """docs/checkpoint_format.md's variants: the port's load and load_edge
    give JAX's arrays (or raise as it does)."""
    path = str(tmp_path / f"{variant}.h5")
    shapes = _write_variant(path, variant)
    if variant == "incompatible_shape":
        with pytest.raises(ValueError, match="incompatible"):
            jax_ckpt.load(path, expected_shapes=shapes)
        with pytest.raises(ValueError, match="incompatible"):
            ckpt.load(path, expected_shapes=shapes)
        return
    jparams, jmoms, jstep = jax_ckpt.load(path, expected_shapes=shapes)
    params, moms, step = ckpt.load(path, expected_shapes=shapes)
    assert step == jstep
    _assert_trees_equal(params, jparams)
    assert (moms is None) == (jmoms is None)
    if moms is not None:
        _assert_trees_equal(moms, jmoms)
    for edge, shape in shapes.items():
        _assert_trees_equal({edge: ckpt.load_edge(path, edge, shape["w"])},
                            {edge: jax_ckpt.load_edge(path, edge, shape["w"])})
    if variant == "flattened_conv":
        np.testing.assert_array_equal(params["input:conv1"]["w"], CONV_W)
        np.testing.assert_array_equal(params["conv1:conv2"]["w"], CONV_W)
    if variant == "missing_bias":
        np.testing.assert_array_equal(params["a:b"]["b"], np.zeros(3, np.float32))


def test_round_trip_and_latest(tmp_path):
    params = _two_edges()
    moms = _moms(params, 0.1)
    path = ckpt.save(str(tmp_path), "m", params, moms, step=42, timestamp="20260101000000")
    assert path == ckpt.checkpoint_path(str(tmp_path), "m", "20260101000000")
    got, got_moms, step = ckpt.load(path)
    assert step == 42
    _assert_trees_equal(got, params)
    _assert_trees_equal(got_moms, moms)
    newer = ckpt.save(str(tmp_path), "m", params, timestamp="20260102000000")
    ckpt.save(str(tmp_path), "other", params, timestamp="20260103000000")
    assert ckpt.latest(str(tmp_path), "m") == newer == jax_ckpt.latest(str(tmp_path), "m")
    assert ckpt.load(newer)[1] is None
    assert ckpt.latest(str(tmp_path), "missing") is None
    assert ckpt.latest(str(tmp_path / "nonexistent"), "m") is None
    with pytest.raises(KeyError, match="x:y"):
        ckpt.load_edge(path, "x:y")


DONOR_NET = """
name: "recv"
layer {{ name: "input" is_input: true num_channels: 6 }}
layer {{ name: "output" is_output: true num_channels: 3 activation: SOFTMAX }}
edge {{ source: "input" dest: "output" edge_type: FC
       initialization: PRETRAINED {source} }}
"""


@pytest.mark.parametrize("writer,edge_name", [("jax", ""), ("port", ""), ("jax", "donor:edge")])
def test_pretrained_init_equals_the_donor(tmp_path, writer, edge_name):
    """A PRETRAINED edge takes its weights from the donor checkpoint, under
    its own name or `pretrained_edge_name`, whichever package wrote it; the
    JAX package's init reads the same arrays."""
    donor = {
        "w": np.random.RandomState(0).randn(6, 3).astype(np.float32),
        "b": np.arange(3, dtype=np.float32),
    }
    save = jax_ckpt.save if writer == "jax" else ckpt.save
    path = save(str(tmp_path), "donor", {edge_name or "input:output": donor},
                timestamp="20260101000000")
    source = f'pretrained_model: "{path}"'
    if edge_name:
        source += f' pretrained_edge_name: "{edge_name}"'
    jg, g = _graphs(DONOR_NET.format(source=source))
    params = pt_model.init_params(g)
    _assert_trees_equal(_host({"e": params["input:output"]}), {"e": donor})
    jparams = jax_model.init_params(jg)
    np.testing.assert_array_equal(np.asarray(jparams["input:output"]["w"]), donor["w"])


def test_pretrained_init_needs_a_model():
    _, g = _graphs(DONOR_NET.format(source=""))
    with pytest.raises(ValueError, match="pretrained_model"):
        pt_model.init_params(g)


def _digits_graphs(extra=""):
    text = (DIGITS / "digits.pbtxt").read_text()
    text = text.replace("max_iter: 800", "max_iter: 6").replace("checkpoint_after: 800",
                                                                "checkpoint_after: 4")
    text = text.replace("display_after: 200", "display_after: 2") + extra
    return (build_graph(config.parse_model(text), {"input": 8}),
            pt_build_graph(pt_config.parse_model(text), {"input": 8}),
            pt_config.parse_model(text))


DUMMY_DIGITS = """
name: "dummy_digits" batch_size: 64
data_config { layer_name: "input" data_type: DUMMY raw_image_size: 8 image_size: 8 num_colors: 1
              dummy_size: 256 }
data_config { layer_name: "labels" data_type: DUMMY dummy_size: 256 dummy_num_classes: 10 }
"""


def _host(tree):
    return {n: {k: v.detach().numpy() for k, v in p.items()} for n, p in tree.items()}


def _clone(tree):
    return {n: {k: v.detach().clone() for k, v in p.items()} for n, p in tree.items()}


def test_trainer_saves_at_checkpoint_after_and_resumes(tmp_path):
    """The port's Trainer writes a checkpoint at its `checkpoint_after`
    cadence and the pbtxt beside it; a second Trainer on that directory
    resumes at the saved step with the saved params and momenta, which the
    JAX package's load reads alike."""
    _, g, model = _digits_graphs()
    data = DataHandler(pt_config.parse_dataset_config(DUMMY_DIGITS))
    lines = []
    tr = pt_trainer.Trainer(g, data, checkpoint_dir=str(tmp_path), log_fn=lines.append,
                            model_proto=model, device="cpu")
    tr.train(max_iter=5)
    saved = [l.split()[-1] for l in lines if l.startswith("checkpoint -> ")]
    assert len(saved) == 1 and ckpt.latest(str(tmp_path), "digits") == saved[0]
    want_params, want_moms = _clone(tr.state["params"]), _clone(tr.state["moms"])
    params, moms, step = ckpt.load(saved[0])
    assert step == 4
    tag = os.path.basename(saved[0]).removeprefix("digits_").removesuffix(".h5")
    written = pt_config.read_model(str(tmp_path / "digits.pbtxt"))
    assert written.timestamp == tag and list(written.timestamp_history) == [tag]
    assert ckpt.checkpoint_path(str(tmp_path), "digits", tag) == saved[0]
    jparams, jmoms, jstep = jax_ckpt.load(saved[0])
    assert jstep == 4
    _assert_trees_equal(jparams, params)
    _assert_trees_equal(jmoms, moms)

    # the state at step 4: train a fresh Trainer to 4 on the same data
    data4 = DataHandler(pt_config.parse_dataset_config(DUMMY_DIGITS))
    at4 = pt_trainer.Trainer(g, data4, checkpoint_dir=str(tmp_path / "fresh"), log_fn=lines.append,
                             device="cpu")
    at4.train(max_iter=4)
    _assert_trees_equal(params, _host(at4.state["params"]))
    _assert_trees_equal(moms, _host(at4.state["moms"]))
    resumed = pt_trainer.Trainer(g, data, checkpoint_dir=str(tmp_path), log_fn=lines.append,
                                 device="cpu")
    assert resumed.state["step"] == 4 and any("resumed from" in l for l in lines)
    for name in want_params:
        for k in ("w", "b"):
            assert torch.equal(resumed.state["params"][name][k], at4.state["params"][name][k])
            assert torch.equal(resumed.state["moms"][name][k], at4.state["moms"][name][k])
    assert not all(torch.equal(want_params[n]["w"], resumed.state["params"][n]["w"])
                   for n in want_params)  # the first Trainer went on to step 5
    resumed.train(max_iter=6)
    assert resumed.state["step"] == 6
    data.close()
    data4.close()


def test_trainer_save_names_collide_and_resolve(tmp_path, monkeypatch):
    """Two saves in one second: the second file takes a `_1` suffix, the
    pbtxt's tag keeps it, and the tag resolves to that file."""
    _, g, model = _digits_graphs()
    monkeypatch.setattr(ckpt, "_timestamp", lambda: "20260101000000")
    data = DataHandler(pt_config.parse_dataset_config(DUMMY_DIGITS))
    tr = pt_trainer.Trainer(g, data, checkpoint_dir=str(tmp_path), log_fn=lambda _: None,
                            model_proto=model, device="cpu")
    first, second = tr.save(), tr.save()
    assert first.endswith("digits_20260101000000.h5")
    assert second.endswith("digits_20260101000000_1.h5")
    written = pt_config.read_model(str(tmp_path / "digits.pbtxt"))
    assert written.timestamp == "20260101000000_1"
    assert list(written.timestamp_history) == ["20260101000000", "20260101000000_1"]
    assert ckpt.checkpoint_path(str(tmp_path), "digits", written.timestamp) == second
    data.close()


def test_resume_refuses_another_models_edges(tmp_path):
    _, g, _ = _digits_graphs()
    ckpt.save(str(tmp_path), "digits", _two_edges(), timestamp="20260101000000")
    data = DataHandler(pt_config.parse_dataset_config(DUMMY_DIGITS))
    with pytest.raises(ValueError, match="edges"):
        pt_trainer.Trainer(g, data, checkpoint_dir=str(tmp_path), device="cpu")
    data.close()


def test_released_digits_checkpoint_classifies_through_the_port():
    """The shipped examples/digits/digits_pretrained.h5 through the port's
    Predictor.from_checkpoint on the held-out rows of
    tests/test_checkpoint.py: error < 0.05, the JAX Predictor's labels."""
    from sklearn.datasets import load_digits

    jg, g, _ = _digits_graphs()
    d = load_digits()
    images = (d.images * (255.0 / 16.0)).astype(np.uint8)[..., None]
    held_out = np.random.RandomState(0).permutation(len(images))[1500:]
    x = images[held_out].astype(np.float32) * (1.0 / 255.0)
    path = str(DIGITS / "digits_pretrained.h5")
    port = Predictor.from_checkpoint(g, path, batch_size=128, device="cpu")
    ref = JaxPredictor.from_checkpoint(jg, path, batch_size=128)
    got = np.concatenate([port.predict_labels({"input": x[i: i + 128]})
                          for i in range(0, len(x), 128)])
    want = np.concatenate([ref.predict_labels({"input": x[i: i + 128]})
                           for i in range(0, len(x), 128)])
    err = float(np.mean(got != d.target[held_out]))
    assert err < 0.05, f"released digits net error {err:.3f}"
    np.testing.assert_array_equal(got, want)


def test_checkpoint_module_imports_without_h5py(tmp_path):
    """The port reads and writes HDF5 itself (convnet_tpu_torch/hdf5.py):
    with h5py blocked, the checkpoint module and its entry points import,
    and a checkpoint saves and loads array-equal."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "import convnet_tpu_torch.checkpoint as c, convnet_tpu_torch.trainer\n"
        "import convnet_tpu_torch.predictor, convnet_tpu_torch.model\n"
        "p = {'input:fc': {'w': np.arange(6, dtype=np.float32).reshape(2, 3),\n"
        "                  'b': np.ones(3, np.float32)}}\n"
        f"path = c.save({str(tmp_path)!r}, 'm', p, p, step=3)\n"
        "got, moms, step = c.load(path)\n"
        "assert step == 3 and np.array_equal(got['input:fc']['w'], p['input:fc']['w'])\n"
        "assert np.array_equal(moms['input:fc']['b'], p['input:fc']['b'])\n"
        "try:\n"
        "    c.load('x.h5')\n"
        "except FileNotFoundError:\n"
        "    print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
