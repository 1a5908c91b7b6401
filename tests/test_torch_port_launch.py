"""Several train steps per launch, remat and the timers in the port, on the
CPU: `make_train_step(unroll=k)` and `Trainer(steps_per_launch=k)` give
what k single steps give, array-equal (on the CPU a launch is a loop of
eager steps; on a card it replays the step's CUDA graph, which
chip_smoke.py's phase 8c holds to the eager steps), with the JAX
package's cadence of display, validation and checkpoints; remat changes
no f32 result beyond 1e-6."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from convnet_tpu import config
from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler
from convnet_tpu.graph import build_graph as jax_build_graph
from convnet_tpu.trainer import Trainer as JaxTrainer
from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import trainer as pt_trainer
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.utils import timers

# tests/test_train.py's SMALL_NET, with dropout on a hidden FC layer
SMALL_NET = """
name: "smoke"
seed: 3
batch_size: 32
max_iter: 30
display_after: 10
validate_after: 0
checkpoint_after: 0
layer { name: "input" is_input: true num_channels: 1 image_size: 12 }
layer { name: "conv1" num_channels: 4 activation: RECTIFIED_LINEAR }
layer { name: "pool1" num_channels: 4 }
layer { name: "fc2" num_channels: 16 activation: RECTIFIED_LINEAR dropprob: 0.5 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.1
       weight_optimizer { base_epsilon: 0.05 initial_momentum: 0.5 final_momentum: 0.9
                          momentum_transition_timescale: 5 start_optimization_after: 2 }
       bias_optimizer { base_epsilon: 0.1 } }
edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 2 stride: 2 }
edge { source: "pool1" dest: "fc2" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1
       weight_optimizer { base_epsilon: 0.05 initial_momentum: 0.9 final_momentum: 0.9
                          epsilon_decay: INVERSE_T epsilon_decay_timescale: 4 } }
edge { source: "fc2" dest: "output" edge_type: FC
       initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0
       weight_optimizer { base_epsilon: 0.05 initial_momentum: 0.9 final_momentum: 0.9 }
       bias_optimizer { base_epsilon: 0.1 } }
"""

# uint8 14x14 images cropped to 12 with translations and flips
DATA = """
name: "d"
batch_size: 32
randomize_cpu: true
pipeline_loads: {pipeline}
data_config {{ layer_name: "input" data_type: DUMMY raw_image_size: 14 image_size: 12
              num_colors: 1 can_translate: true can_flip: true scale: 0.0039215686
              dummy_size: 256 }}
data_config {{ layer_name: "labels" data_type: DUMMY dummy_size: 256 dummy_num_classes: 10 }}
"""


def _graph(**fields):
    model = pt_config.parse_model(SMALL_NET)
    for k, v in fields.items():
        setattr(model, k, v)
    return build_graph(model, {"input": 12})


def _handler(pipeline="false", randomize=True):
    return DataHandler(pt_config.parse_dataset_config(DATA.format(pipeline=pipeline)),
                       randomize=randomize)


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for name, p in a.items():
        for k, v in p.items():
            assert torch.equal(v, b[name][k]), (name, k)


def test_unroll_equals_single_steps():
    g = _graph()
    data = _handler()
    jitter = data.jitter_specs()
    batches = [pt_trainer.device_batch(data.get_batch(), "cpu") for _ in range(6)]
    data.close()
    single = pt_trainer.make_train_step(g, jitter)
    three = pt_trainer.make_train_step(g, jitter, unroll=3)
    a, b = pt_trainer.init_state(g), pt_trainer.init_state(g)
    losses = [single(a, x)["loss"] for x in batches]
    launched = []
    for lo in (0, 3):
        stacked = {k: torch.stack([x[k] for x in batches[lo:lo + 3]]) for k in batches[0]}
        m = three(b, stacked)
        assert m["loss"].shape == (3,) and m["output/errors"].shape == (3,)
        launched.append(m["loss"])
    assert a["step"] == b["step"] == 6
    assert torch.equal(torch.stack(losses), torch.cat(launched))
    _assert_trees_equal(a["params"], b["params"])
    _assert_trees_equal(a["moms"], b["moms"])
    with pytest.raises(ValueError, match="leading axis"):
        three(b, {k: v[:2] for k, v in stacked.items()})


@pytest.mark.parametrize("pipeline", ["false", "true"])
def test_trainer_steps_per_launch_matches_single(tmp_path, pipeline):
    """13 steps at k = 3 (a tail launch of one) land on k = 1's parameters,
    momenta and step, and display at the first launch boundary at or past
    each multiple of 10."""
    final, logs = {}, {}
    for k in (1, 3):
        lines = []
        tr = pt_trainer.Trainer(_graph(), _handler(pipeline), checkpoint_dir=str(tmp_path / f"k{k}"),
                                log_fn=lines.append, steps_per_launch=k, device="cpu")
        tr.train(max_iter=13)
        tr.train_data.close()
        final[k], logs[k] = tr.state, lines
        assert tr.timers["get_batch"].count == (13 if k == 1 else 5)
    assert final[1]["step"] == final[3]["step"] == 13
    _assert_trees_equal(final[1]["params"], final[3]["params"])
    _assert_trees_equal(final[1]["moms"], final[3]["moms"])
    assert [l.split()[1] for l in logs[1]] == ["10"] and [l.split()[1] for l in logs[3]] == ["12"]


def test_trainer_checkpoint_cadence_under_unroll(tmp_path):
    """checkpoint_after=10 at k = 4 over 24 steps saves at steps 12 and 20,
    as the JAX package does (tests/test_train.py)."""
    tr = pt_trainer.Trainer(_graph(checkpoint_after=10), _handler(), checkpoint_dir=str(tmp_path),
                            log_fn=lambda *_: None, steps_per_launch=4, device="cpu")
    tr.train(max_iter=24)
    tr.train_data.close()
    saved = sorted(ckpt.load(os.path.join(tmp_path, f))[2]
                   for f in os.listdir(tmp_path) if f.endswith(".h5"))
    assert saved == [12, 20]


@pytest.mark.parametrize("k", [1, 4])
def test_logged_steps_equal_jax(k):
    """The steps at which display and validation log are the JAX Trainer's,
    for the same config and launch size."""
    text = SMALL_NET.replace("display_after: 10", "display_after: 5").replace(
        "validate_after: 0", "validate_after: 7")
    steps = {}
    for pkg in ("jax", "port"):
        lines = []
        data_text = DATA.format(pipeline="false")
        if pkg == "jax":
            val = JaxDataHandler(config.parse_dataset_config(data_text), randomize=False)
            tr = JaxTrainer(jax_build_graph(config.parse_model(text), {"input": 12}),
                            JaxDataHandler(config.parse_dataset_config(data_text)), val,
                            log_fn=lines.append, steps_per_launch=k)
        else:
            val = DataHandler(pt_config.parse_dataset_config(data_text), randomize=False)
            tr = pt_trainer.Trainer(build_graph(pt_config.parse_model(text), {"input": 12}),
                                    DataHandler(pt_config.parse_dataset_config(data_text)), val,
                                    log_fn=lines.append, steps_per_launch=k, device="cpu")
        tr.train(max_iter=22)
        tr.train_data.close()
        val.close()
        steps[pkg] = [(l.split()[1], "VALIDATION" in l) for l in lines if l.startswith("step ")]
    assert steps["port"] == steps["jax"]
    assert len(steps["port"]) >= 6


def test_remat_equals_no_remat_in_f32():
    data = _handler()
    jitter = data.jitter_specs()
    batches = [pt_trainer.device_batch(data.get_batch(), "cpu") for _ in range(2)]
    data.close()
    out = {}
    for remat in (False, True):
        g = _graph(remat=remat)
        assert g.remat == remat
        state = pt_trainer.init_state(g)
        step = pt_trainer.make_train_step(g, jitter)
        losses = [step(state, x)["loss"].item() for x in batches]
        out[remat] = (losses, state)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, p in out[False][1]["params"].items():
        for k, v in p.items():
            torch.testing.assert_close(out[True][1]["params"][name][k], v, rtol=1e-6, atol=1e-7)


def test_timer_and_profile_trace(tmp_path):
    t = timers.Timer("trainer.get_batch")
    assert t.mean == 0.0
    with t:
        sum(range(1000))
    dt = t.start().stop()
    assert t.count == 2 and t.total >= dt >= 0.0 and t.mean == t.total / 2
    prof = timers.start_trace(str(tmp_path), cuda=False)
    with t:
        torch.ones(64).sum()
    timers.stop_trace(prof, cuda=False)
    assert t.count == 3
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith(".json") or f.endswith(".json.gz")]
    opener = gzip.open if trace.endswith(".gz") else open
    with opener(os.path.join(tmp_path, trace), "rt") as f:
        assert "trainer.get_batch" in {ev.get("name") for ev in json.load(f)["traceEvents"]}


def test_draws_do_not_depend_on_the_launch():
    """The crops and dropout keys of a step come from (seed, step) alone:
    the device state a launch advances gives step t the draws that a state
    made at step t gives."""
    g = _graph()
    data = _handler()
    jitter = data.jitter_specs()
    batch = pt_trainer.device_batch(data.get_batch(), "cpu")
    data.close()
    steps = pt_trainer.TrainSteps(g, jitter)
    state = pt_trainer.init_state(g)
    for _ in range(3):
        steps.step(state, batch)
    keys, crops = steps.last_draws
    fresh = {"params": state["params"], "moms": state["moms"], "step": 2, "seed": state["seed"]}
    want_keys, want_crops = pt_trainer.draw_step(g, jitter, batch, pt_trainer.rng_tensor(fresh, "cpu"))
    assert keys.keys() == want_keys.keys() == {2}
    assert all(torch.equal(keys[i], want_keys[i]) for i in keys)
    assert all(torch.equal(a, b) for a, b in zip(crops["input"], want_crops["input"]))
    assert state["rng"].tolist() == [state["seed"], 3]
