"""End-to-end convergence on the CPU through the port alone (counterpart of
tests/test_convergence.py, with its models, data sizes and bars): HDF5
shards written by the port's own HDF5 module, a per-channel mean and std
from the port's compute_mean, the port's DataHandler and Trainer, and the
validation error.

The synthetic task's crops translate but do not flip. A horizontal flip
maps the bar of class 1 (36 degrees) onto class 4's (144) and class 2's
onto class 3's, so under flips those four classes are pairwise the same
images and the validation error has a floor near 0.2, the bar itself:
the JAX test passes at its seeds, where the port's draws (Philox, not
threefry) gave 0.203. Without flips and dropout, from
one init, the two packages' Trainers end at the same validation error
(test_synthetic_task_trains_as_the_jax_trainer)."""

import os

import numpy as np
import pytest

from convnet_tpu_torch import config, hdf5
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.tools import compute_mean, make_synth_dataset, train_digits_release
from convnet_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYNTH_MODEL = """
name: "synth"
seed: 5
batch_size: 64
max_iter: 400
display_after: 100
layer { name: "input" is_input: true num_channels: 3 }
layer { name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "pool1" num_channels: 16 }
layer { name: "rnorm1" num_channels: 16 }
layer { name: "conv2" num_channels: 32 activation: RECTIFIED_LINEAR }
layer { name: "pool2" num_channels: 32 }
layer { name: "fc1" num_channels: 64 activation: RECTIFIED_LINEAR dropprob: 0.25 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 5 stride: 1 padding: 2
       initialization: DENSE_GAUSSIAN init_wt: 0.05
       weight_optimizer { base_epsilon: 0.02 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
       bias_optimizer { base_epsilon: 0.04 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool1" dest: "rnorm1" edge_type: RESPONSE_NORM
       add_scale: 0.0001 pow_scale: 0.75 frac_of_filters_response_norm: 0.25 }
edge { source: "rnorm1" dest: "conv2" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.05
       weight_optimizer { base_epsilon: 0.02 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
       bias_optimizer { base_epsilon: 0.04 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "conv2" dest: "pool2" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool2" dest: "fc1" edge_type: FC
       initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0
       weight_optimizer { base_epsilon: 0.02 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.001 }
       bias_optimizer { base_epsilon: 0.04 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "fc1" dest: "output" edge_type: FC
       initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0
       weight_optimizer { base_epsilon: 0.02 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.001 }
       bias_optimizer { base_epsilon: 0.04 epsilon_decay: INVERSE_T epsilon_decay_timescale: 250 initial_momentum: 0.9 final_momentum: 0.9 } }
"""

DIGITS_MODEL = """
name: "digits"
seed: 3
batch_size: 64
max_iter: 400
display_after: 200
layer { name: "input" is_input: true num_channels: 1 image_size: 8 }
layer { name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "pool1" num_channels: 16 }
layer { name: "fc1" num_channels: 64 activation: RECTIFIED_LINEAR dropprob: 0.2 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.1
       weight_optimizer { base_epsilon: 0.05 epsilon_decay: INVERSE_T epsilon_decay_timescale: 300 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
       bias_optimizer { base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 2 stride: 2 }
edge { source: "pool1" dest: "fc1" edge_type: FC
       initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0
       weight_optimizer { base_epsilon: 0.05 epsilon_decay: INVERSE_T epsilon_decay_timescale: 300 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.001 }
       bias_optimizer { base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "fc1" dest: "output" edge_type: FC
       initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0
       weight_optimizer { base_epsilon: 0.05 epsilon_decay: INVERSE_T epsilon_decay_timescale: 300 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.001 }
       bias_optimizer { base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 } }
"""


def train_and_validate(model_text, train_cfg, val_cfg, out_dir):
    """(validation error, loss) after the model's max_iter steps on the CPU."""
    train = DataHandler(config.parse_dataset_config(train_cfg), seed=0)
    val = DataHandler(config.parse_dataset_config(val_cfg), randomize=False)
    try:
        graph = build_graph(config.parse_model(model_text), train.input_image_sizes())
        tr = Trainer(graph, train, val, checkpoint_dir=out_dir, log_fn=lambda *_: None,
                     device="cpu")
        tr.train()
        return tr.validate()
    finally:
        train.close()
        val.close()


def synth_shards(tmp_path):
    """The synthetic task's 2048/512 rows at 24 px as HDF5, with the train
    rows' per-channel mean and std; returns data_cfg(split, randomize):
    crops of 22, translated (not flipped), normalized by the mean file."""
    for name, rows, seed in [("train", 2048, 0), ("val", 512, 1)]:
        data, labels = make_synth_dataset.generate(rows, 24, seed)
        with hdf5.File(str(tmp_path / f"{name}.h5"), "w") as f:
            f.create_dataset("data", data=data)
            f.create_dataset("labels", data=labels)
    assert compute_mean.main([str(tmp_path / "train.h5"), str(tmp_path / "mean.h5"),
                              "--per-channel"]) == 0

    def data_cfg(split, randomize):
        return f"""
            name: "{split}"
            batch_size: 64
            randomize_cpu: {randomize}
            pipeline_loads: true
            data_config {{ layer_name: "input" data_type: HDF5
                          file_pattern: "{tmp_path / (split + '.h5')}"
                          dataset_name: "data" image_size: 22 raw_image_size: 24
                          num_colors: 3 can_translate: true
                          mean_file: "{tmp_path / 'mean.h5'}" normalize: true }}
            data_config {{ layer_name: "labels" data_type: HDF5
                          file_pattern: "{tmp_path / (split + '.h5')}"
                          dataset_name: "labels" }}
            """

    return data_cfg


def test_synthetic_task_converges(tmp_path):
    data_cfg = synth_shards(tmp_path)
    err, loss = train_and_validate(SYNTH_MODEL, data_cfg("train", "true"),
                                   data_cfg("val", "false"), str(tmp_path / "out"))
    assert err < 0.20, f"validation error {err:.3f} (loss {loss:.3f}) — failed to learn"


def test_synthetic_task_trains_as_the_jax_trainer(tmp_path):
    """The synthetic task with the center crop and no dropout (no random
    draws), both Trainers from the JAX package's init, over the same files:
    the same validation error within a row of 512 and loss within 1e-2."""
    from convnet_tpu import config as jax_config
    from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler
    from convnet_tpu.graph import build_graph as jax_build_graph
    from convnet_tpu.trainer import Trainer as JaxTrainer
    from convnet_tpu_torch import model as model_lib
    from convnet_tpu_torch import optim

    cfg = synth_shards(tmp_path)

    def data_cfg(split, randomize):
        return cfg(split, randomize).replace("can_translate: true", "")

    model = SYNTH_MODEL.replace("dropprob: 0.25", "dropprob: 0.0")
    train = JaxDataHandler(jax_config.parse_dataset_config(data_cfg("train", "true")), seed=0)
    val = JaxDataHandler(jax_config.parse_dataset_config(data_cfg("val", "false")),
                         randomize=False)
    try:
        graph = jax_build_graph(jax_config.parse_model(model), train.input_image_sizes())
        tr = JaxTrainer(graph, train, val, checkpoint_dir=str(tmp_path / "jax"),
                        log_fn=lambda *_: None)
        init = {k: {n: np.asarray(v) for n, v in p.items()} for k, p in tr.state["params"].items()}
        tr.train()
        want_err, want_loss = tr.validate()
    finally:
        train.close()
        val.close()

    train = DataHandler(config.parse_dataset_config(data_cfg("train", "true")), seed=0)
    val = DataHandler(config.parse_dataset_config(data_cfg("val", "false")), randomize=False)
    try:
        graph = build_graph(config.parse_model(model), train.input_image_sizes())
        tr = Trainer(graph, train, val, checkpoint_dir=str(tmp_path / "port"),
                     log_fn=lambda *_: None, device="cpu")
        tr.state["params"] = model_lib.params_from_numpy(init)
        tr.state["moms"] = optim.init_momentum(tr.state["params"])
        tr.train()
        err, loss = tr.validate()
    finally:
        train.close()
        val.close()
    assert abs(err - want_err) <= 1 / 512 and err < 0.20
    assert loss == pytest.approx(want_loss, rel=1e-2)


def test_real_digits_converge(tmp_path):
    """sklearn's 8x8 handwritten digits (the only real images offline),
    split as the digits tool splits them, through the port's stack."""
    pytest.importorskip("sklearn", reason="the digits are sklearn's")
    paths = train_digits_release.write_shards(str(tmp_path))
    tpl = train_digits_release.DATA_TPL
    err, loss = train_and_validate(
        DIGITS_MODEL, tpl % ("train", "true", paths["train"], paths["train"]),
        tpl % ("val", "false", paths["val"], paths["val"]), str(tmp_path / "out"))
    # real handwritten digits: a tiny convnet gets well under 10% error
    assert err < 0.10, f"digits validation error {err:.3f} (loss {loss:.3f})"
