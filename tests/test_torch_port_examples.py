"""The example models and data templates that chip_smoke.py phase 8h runs on
the card, against the JAX package on the CPU.

- examples/mnist/mnist_lenet.pbtxt and examples/cifar10/cifar10_local.pbtxt
  at their own widths, f32, batch 8: three train steps of the port and of
  the JAX package from the same numpy params on the same uint8 batches.
  Both parsed models have every `dropprob` set to 0, since the two
  packages draw their dropout masks from different generators (Philox
  against threefry). The loss and the params agree within rtol/atol 1e-4
  (BASELINE.json's bar), each leaf's update within 1e-3 of its largest
  plus one f32 ulp of the leaf's largest element: cifar10_local's conv2,
  local3 and local4 weights move by 270 to 570 ulps in three steps at
  its learning rates, so the two packages' weights, each rounded to f32,
  differ by half an ulp (1.8e-3 of the update) while each stands 4.5e-3 to
  5e-3 of the update from a float64 run of the port, at the same distance.
  mnist_lenet's conv1 has one input channel: the JAX package computes it
  by im2col and the port by cuDNN's (here ATen's) conv. Both compute the
  same function, so the bar is the same.
- examples/imagenet/imagenet_train_data.pbtxt and imagenet_val_data.pbtxt,
  their paths pointed at 8 JPEGs written by PIL, labels and a full-pixel
  mean file written by the port's hdf5.py: each package's DataHandler
  gives array-equal uint8 batches at raw 256 and labels, and the same
  jitter specs and mean. The JAX package reads the JPEGs with its own
  native/dataloader.cc built with g++ -ljpeg (as in
  tests/test_torch_port_streams.py), so the port's decoder is held to
  libjpeg.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)
from test_torch_port_streams import JAX_LOADER_SOURCE
from test_torch_port_train import _assert_updates_close, _np, _port_state

from convnet_tpu import config
from convnet_tpu import trainer as jax_trainer
from convnet_tpu.data import native as jax_native
from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler
from convnet_tpu.data.jitter import JitterSpec as JaxJitterSpec
from convnet_tpu.graph import build_graph
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import hdf5
from convnet_tpu_torch import trainer as pt_trainer
from convnet_tpu_torch.data import jitter as pt_jitter
from convnet_tpu_torch.data import native as pt_native
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.tools.compute_mean import mean_std

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
MODELS = {"mnist_lenet": EXAMPLES / "mnist" / "mnist_lenet.pbtxt",
          "cifar10_local": EXAMPLES / "cifar10" / "cifar10_local.pbtxt"}
BATCH, STEPS = 8, 3
JPEGS, RAW = 8, 256


def _graphs_without_dropout(path):
    """(JAX graph, port graph) of a model, each read by its own package,
    with every layer's dropprob set to 0."""
    jm, pm = config.read_model(str(path)), pt_config.read_model(str(path))
    for m in (jm, pm):
        for layer in m.layer:
            layer.dropprob = 0.0
    return build_graph(jm), pt_build_graph(pm)


@pytest.mark.parametrize("name", MODELS)
def test_example_model_train_steps_match_jax(name):
    jg, g = _graphs_without_dropout(MODELS[name])
    size, _, colors = g.shapes["input"]
    jstate = jax_trainer.init_state(jg, seed=0)
    p0 = jax.tree.map(np.asarray, jstate["params"])
    pstate = _port_state(p0)
    jstep = jax_trainer.make_train_step(
        jg, {"input": (JaxJitterSpec(image_size=size, scale=1 / 255), None, None)})
    pstep = pt_trainer.make_train_step(
        g, {"input": (pt_jitter.JitterSpec(image_size=size, scale=1 / 255), None, None)})
    rng = np.random.default_rng(21)
    for _ in range(STEPS):
        batch = {"input": rng.integers(0, 256, (BATCH, size, size, colors), dtype=np.uint8),
                 "labels": rng.integers(0, 10, (BATCH,), dtype=np.int32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    assert pstate["step"] == STEPS and int(jstate["step"]) == STEPS
    for e in g.weighted_edges:
        for k in ("w", "b"):
            np.testing.assert_allclose(_np(pstate["params"][e.name][k]),
                                       np.asarray(jstate["params"][e.name][k]),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{e.name}/{k}")
    _assert_updates_close(g, p0, jstate["params"], pstate["params"], 1e-3, ulps=1)


# ---------------------------------------------------------------------------
# The ImageNet data templates over a JPEG list
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_libjpeg_loader(monkeypatch):
    """The JAX package's native module loads its own native/dataloader.cc,
    built with g++ -ljpeg; skips where that build fails."""
    try:
        pt_native.library(JAX_LOADER_SOURCE, ("-ljpeg",))
    except RuntimeError as e:
        pytest.skip(f"g++ cannot build the JAX package's libjpeg loader here: {e}")
    path = pt_native._library_path(JAX_LOADER_SOURCE, ("-ljpeg",))
    monkeypatch.setattr(jax_native, "_LIB_PATHS", [str(path)])
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available()


@pytest.fixture
def jpeg_list(tmp_path):
    """JPEGS JPEG files of several sizes and both orientations (PIL,
    quality 90), their list, int32 labels, and the full-pixel mean and std
    of the rows the port's loader decodes at raw 256, the last two written
    by hdf5.py as compute_mean writes them. Returns the list's, the
    labels' and the mean file's paths."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(25)
    files = []
    for i in range(JPEGS):
        w, h = (500, 375) if i % 2 else (300 + 17 * i, 420 - 9 * i)
        coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
        field = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
        grain = rng.integers(-12, 13, (h, w, 3))
        files.append(tmp_path / f"photo{i}.jpg")
        Image.fromarray(np.clip(field + grain, 0, 255).astype(np.uint8)).save(files[-1], quality=90)
    listfile = tmp_path / "list.txt"
    listfile.write_text("\n".join(str(p) for p in files) + "\n")
    loader = pt_native.NativeImageLoader([str(p) for p in files], RAW, 3, threads=2)
    try:
        rows = loader.load(np.arange(JPEGS))
    finally:
        loader.close()
    mean, std = mean_std(rows, per_channel=False, chunk=4)
    with hdf5.File(tmp_path / "mean.h5", "w") as f:
        f.create_dataset("mean", data=mean.astype(np.float32))
        f.create_dataset("std", data=std.astype(np.float32))
    with hdf5.File(tmp_path / "labels.h5", "w") as f:
        f.create_dataset("labels", data=rng.integers(0, 1000, JPEGS).astype(np.int32))
    return {"list": listfile, "labels": tmp_path / "labels.h5", "mean": tmp_path / "mean.h5"}


@pytest.mark.parametrize("which", ["train", "val"])
def test_imagenet_templates_read_as_in_jax(jpeg_list, jax_libjpeg_loader, which):
    text = (EXAMPLES / "imagenet" / f"imagenet_{which}_data.pbtxt").read_text()
    for old, new in ((f"/data/imagenet/{which}_list.txt", jpeg_list["list"]),
                     (f"/data/imagenet/{which}_labels.h5", jpeg_list["labels"]),
                     ("/data/imagenet/mean.h5", jpeg_list["mean"])):
        assert old in text
        text = text.replace(old, str(new))
    ours = DataHandler(pt_config.parse_dataset_config(text), batch_size=JPEGS // 2,
                       randomize=False)
    ref = JaxDataHandler(config.parse_dataset_config(text), batch_size=JPEGS // 2,
                         randomize=False)
    try:
        assert ours.backends() == {"input": "native"}
        assert ref.streams["input"]._native is not None
        for _ in range(2):
            got, want = ours.get_batch(), ref.get_batch()
            assert got["input"].shape == (JPEGS // 2, RAW, RAW, 3)
            assert got["input"].dtype == np.uint8 and got["input"].std() > 1
            np.testing.assert_array_equal(got["input"], want["input"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
        (spec, mean, std), (jspec, jmean, jstd) = ours.jitter_specs()["input"], \
            ref.jitter_specs()["input"]
    finally:
        ours.close()
        ref.close()
    train = which == "train"
    assert (spec.image_size, spec.can_translate, spec.can_flip) == (224, train, train)
    for field in ("image_size", "can_translate", "can_flip", "scale", "normalize"):
        assert getattr(spec, field) == getattr(jspec, field), field
    assert mean.shape == (RAW, RAW, 3) and std is None and jstd is None
    np.testing.assert_array_equal(mean, jmean)
    with hdf5.File(jpeg_list["mean"]) as f:
        np.testing.assert_array_equal(mean, f["mean"][...])
