"""The port's named spans (`convnet_tpu_torch/utils/timers.py`), on the CPU:
an eager train step under torch.profiler holds its stage, edge and layer
spans in order; every backward node links, by its sequence number, to a
forward operator inside an edge or layer span; with no profiler running
no span enters record_function; a profiler changes no parameter; and the
Trainer's `--profile-dir` trace holds its host stages."""

import glob
import gzip
import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from convnet_tpu_torch import config, trainer
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.utils import timers

# conv -> LRN -> max pool -> FC with dropout -> softmax, bf16 as AlexNet
MODEL = """
name: "spans"
seed: 5
batch_size: 8
max_iter: 20
display_after: 10
compute_dtype: "bfloat16"
activation_dtype: "bfloat16"
layer { name: "input" is_input: true num_channels: 3 image_size: 16 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 8 }
layer { name: "pool1" num_channels: 8 }
layer { name: "fc2" num_channels: 16 activation: RECTIFIED_LINEAR dropprob: 0.5 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 5 stride: 2 init_wt: 0.1
       weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
       add_scale: 0.0001 pow_scale: 0.75 frac_of_filters_response_norm: 0.375 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool1" dest: "fc2" edge_type: FC init_wt: 0.1
       weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "fc2" dest: "output" edge_type: FC init_wt: 0.1 }
"""

DATA = """
name: "d"
batch_size: 8
randomize_cpu: true
data_config { layer_name: "input" data_type: DUMMY raw_image_size: 20 image_size: 16
              num_colors: 3 can_translate: true can_flip: true scale: 0.0039215686
              dummy_size: 64 }
data_config { layer_name: "labels" data_type: DUMMY dummy_size: 64 dummy_num_classes: 10 }
"""

EDGES = ["model.edge.CONV.input:conv1", "model.edge.RESPONSE_NORM.conv1:rnorm1",
         "model.edge.MAXPOOL.rnorm1:pool1", "model.edge.FC.pool1:fc2",
         "model.edge.FC.fc2:output"]
EVALUATE = "autograd::engine::evaluate_function: "


def _graph():
    return build_graph(config.parse_model(MODEL), {"input": 16})


def _step_inputs(n=1):
    jitter = {"input": (JitterSpec(16, True, True, scale=1 / 255),
                        np.full((3,), 0.45, np.float32), None)}
    gen = torch.Generator().manual_seed(7)
    batches = [{"input": torch.randint(0, 256, (8, 20, 20, 3), dtype=torch.uint8, generator=gen),
                "labels": torch.randint(0, 10, (8,), dtype=torch.int32, generator=gen)}
               for _ in range(n)]
    return jitter, batches


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [ev for ev in json.load(f)["traceEvents"] if ev.get("ph") == "X"]


def _traced_step(tmp_path):
    """The events of one eager step (after one untraced) under a CPU profiler."""
    g = _graph()
    jitter, (batch,) = _step_inputs()
    state, step = trainer.init_state(g), trainer.make_train_step(g, jitter)
    step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    return _events(prof, tmp_path)


def _spans(events, prefix=""):
    return sorted((ev for ev in events if ev.get("cat") == "user_annotation"
                   and ev["name"].startswith(prefix)), key=lambda ev: ev["ts"])


def _holds(outer, ev):
    return outer["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"]


def test_step_holds_its_stages_in_order(tmp_path):
    events = _traced_step(tmp_path)
    (step,) = _spans(events, "trainer.step")
    spans = [s for s in _spans(events) if s is not step]
    assert all(_holds(step, s) for s in spans)
    stages = [s for s in spans if not s["name"].startswith(("model.edge.", "model.layer."))]
    assert [s["name"] for s in stages] == ["trainer.draws", "trainer.prologue", "model.forward",
                                           "model.backward", "optim.update"]
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(stages, stages[1:]))
    forward = stages[2]
    edges = [s["name"] for s in _spans(events, "model.edge.")]
    assert edges == EDGES and all(_holds(forward, s) for s in _spans(events, "model.edge."))
    layers = [s["name"] for s in _spans(events, "model.layer.")]
    # the output layer's span twice: its activation, then its loss
    assert layers == ["model.layer.conv1", "model.layer.rnorm1", "model.layer.pool1",
                      "model.layer.fc2", "model.layer.output", "model.layer.output"]


def test_backward_nodes_link_to_edge_and_layer_spans(tmp_path):
    """Each backward node's sequence number is that of a forward operator
    inside an edge or layer span (AccumulateGrad carries none)."""
    events = _traced_step(tmp_path)
    evaluates = [ev for ev in events if ev["name"].startswith(EVALUATE)]
    backward = [ev for ev in events if any(_holds(b, ev) and b["tid"] == ev["tid"]
                                           for b in evaluates)]
    owners = _spans(events, "model.edge.") + _spans(events, "model.layer.")
    made = {}
    for ev in sorted(events, key=lambda ev: ev["ts"]):
        seq = ev.get("args", {}).get("Sequence number")
        if ev.get("cat") == "cpu_op" and seq is not None and ev not in backward:
            made[seq] = ev  # the last one made the node
    nodes = [ev for ev in evaluates if not ev["name"].endswith("AccumulateGrad")]
    assert len(nodes) > 20
    for node in nodes:
        fwd = made[node["args"]["Sequence number"]]
        assert any(_holds(s, fwd) for s in owners), (node["name"], fwd["name"])
    linked = {next(s["name"] for s in owners if _holds(s, made[n["args"]["Sequence number"]]))
              for n in nodes}
    assert set(EDGES) <= linked and "model.layer.fc2" in linked  # dropout's backward


def _trainer(tmp_path, log_fn=lambda *_: None):
    data = DataHandler(config.parse_dataset_config(DATA))
    return trainer.Trainer(_graph(), data, checkpoint_dir=str(tmp_path / "checkpoints"),
                           log_fn=log_fn, device="cpu")


def test_no_profiler_enters_no_record_function(tmp_path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(timers._profiler, "record_function", refuse)
    g = _graph()
    jitter, (batch,) = _step_inputs()
    state = trainer.init_state(g)
    trainer.make_train_step(g, jitter)(state, batch)
    assert state["step"] == 1
    tr = _trainer(tmp_path)
    tr.train(max_iter=3)
    tr.train_data.close()
    assert tr.state["step"] == 3 and tr.timers["launch"].count == 3


def test_profiler_leaves_the_state_bit_equal():
    g = _graph()
    jitter, batches = _step_inputs(3)
    out = []
    for traced in (False, True):
        state, step = trainer.init_state(g), trainer.make_train_step(g, jitter)
        with profile(activities=[ProfilerActivity.CPU]) if traced else timers._OFF:
            for b in batches:
                step(state, b)
        out.append(state)
    for t in ("params", "moms"):
        for name, p in out[0][t].items():
            for k, v in p.items():
                assert torch.equal(v, out[1][t][name][k]), (t, name, k)


def test_trainer_profile_dir_trace_holds_host_stages(tmp_path):
    tr = _trainer(tmp_path)
    prof = tmp_path / "prof"
    tr.train(max_iter=20, profile_dir=str(prof))
    tr.train_data.close()
    (path,) = glob.glob(os.path.join(prof, "**", "*.json*"), recursive=True)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"trainer.get_batch", "trainer.stack", "trainer.launch", "trainer.step"} <= names


def test_display_line_ends_with_the_data_wait(tmp_path):
    lines = []
    tr = _trainer(tmp_path, lines.append)
    tr.train(max_iter=10)
    tr.train_data.close()
    (line,) = [l for l in lines if l.startswith("step ")]
    words = line.split()
    assert words[1] == "10" and words[-3:-1] == ["data", "wait"] and words[-1].endswith("%")
    assert 0.0 <= float(words[-1][:-1]) <= 100.0


def test_span_is_shared_when_off_and_a_record_function_when_on():
    assert timers.span("model.edge.CONV.conv1") is timers._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        s = timers.span("model.edge.CONV.conv1")
        assert isinstance(s, torch.autograd.profiler.record_function)
        assert s.name == "model.edge.CONV.conv1"
