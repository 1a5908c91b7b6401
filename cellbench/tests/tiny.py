"""A benchmark root at a tiny size for the CPU tests: a model with every
edge kind of the cells (conv, response norm, max pool, local, FC with
dropout, softmax output), bf16 as the cells, with train and serve mixes
and cells, and a model whose layers join ("tinyjoin") with a reference of
its own (`join.py`), written as a later PR would add them: files and
entries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

MODEL = """
name: "tiny"
compute_dtype: "bfloat16"
activation_dtype: "bfloat16"
parallel { data: 1 model: 1 }
layer { name: "input" is_input: true num_channels: 3 image_size: 16 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 8 }
layer { name: "pool1" num_channels: 8 }
layer { name: "local2" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "fc3" num_channels: 16 activation: RECTIFIED_LINEAR dropprob: 0.5 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 5 stride: 2 padding: 0
  init_wt: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005
                     epsilon_decay: EXPONENTIAL epsilon_decay_timescale: 100000 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
  add_scale: 0.0001 pow_scale: 0.75 frac_of_filters_response_norm: 0.375 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool1" dest: "local2" edge_type: LOCAL kernel_size: 3 stride: 1 padding: 1
  init_wt: 0.1 init_bias: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "local2" dest: "fc3" edge_type: FC init_wt: 0.1 init_bias: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "fc3" dest: "output" edge_type: FC init_wt: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
"""

CONFIG = {"name": "tiny", "source": "https://github.com/TorontoDeepLearning/convnet",
          "reduced": [], "crop": 16, "scale": 1 / 255, "mean": 0.45,
          "model": MODEL.strip().splitlines()}
TRAIN = {"kind": "train", "why": "tiny", "batch": 4, "raw": 20, "pool": 3, "warmup": 1,
         "trace_steps": 2, "init": "pbtxt"}
SERVE = {"kind": "serve", "why": "tiny", "batch": 4, "raw": 20, "pool": 3, "warmup": 1,
         "trace_calls": 2, "sample": 2, "init": "he"}
#: limits at this size, set as the cells' are (`calibrate.set_limits`) from
#: 24 sound seeds on the CPU and 12 seeds of the fp8 control and of half a
#: batch; a batch of 4 leaves the element errors of the leaves before the
#: pool wide (one ReLU or pool flip turns a small leaf)
TRAIN_LIMITS = {
    "after_change_err:fc3:output/b": 0.014,
    "after_change_err:fc3:output/w": 0.0076,
    "after_change_err:input:conv1/b": 0.38,
    "after_change_err:input:conv1/w": 0.44,
    "after_change_err:local2:fc3/b": 0.32,
    "after_change_err:local2:fc3/w": 0.32,
    "after_change_err:pool1:local2/b": 0.33,
    "after_change_err:pool1:local2/w": 0.35,
    "after_change_gap": 0.26,
    "after_grad_err:fc3:output/b": 0.078,
    "after_grad_err:fc3:output/w": 0.018,
    "after_grad_err:local2:fc3/b": 0.014,
    "after_grad_err:local2:fc3/w": 0.028,
    "after_loss_gap": 0.0082,
    "change_err:fc3:output/b": 0.079,
    "change_err:fc3:output/w": 0.02,
    "change_err:input:conv1/b": 0.49,
    "change_err:input:conv1/w": 0.54,
    "change_err:local2:fc3/b": 0.49,
    "change_err:local2:fc3/w": 0.48,
    "change_err:pool1:local2/w": 0.52,
    "change_gap": 0.3,
    "grad_err:fc3:output/b": 0.1,
    "grad_err:fc3:output/w": 0.022,
    "grad_err:input:conv1/b": 0.61,
    "grad_err:input:conv1/w": 0.54,
    "grad_err:local2:fc3/b": 0.6,
    "grad_err:local2:fc3/w": 0.58,
    "grad_err:pool1:local2/w": 0.6,
    "grad_gap": 0.15,
    "loss_gap": 0.0023,
}
SERVE_LIMITS = {"logit_gap": 0.03}

#: tiny's conv1 -> rnorm1 -> pool1, then two convolutions of pool1, 3x3
#: and 1x1, both into join2, which sums them (the toolkit's join), then
#: FC with dropout and the softmax output
JOIN_MODEL = """
name: "tinyjoin"
compute_dtype: "bfloat16"
activation_dtype: "bfloat16"
parallel { data: 1 model: 1 }
layer { name: "input" is_input: true num_channels: 3 image_size: 16 }
layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 8 }
layer { name: "pool1" num_channels: 8 }
layer { name: "join2" num_channels: 8 activation: RECTIFIED_LINEAR }
layer { name: "fc3" num_channels: 16 activation: RECTIFIED_LINEAR dropprob: 0.5 }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 5 stride: 2 padding: 0
  init_wt: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005
                     epsilon_decay: EXPONENTIAL epsilon_decay_timescale: 100000 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
  add_scale: 0.0001 pow_scale: 0.75 frac_of_filters_response_norm: 0.375 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { name: "conv2a" source: "pool1" dest: "join2" edge_type: CONV kernel_size: 3 padding: 1
  init_wt: 0.1 init_bias: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { name: "conv2b" source: "pool1" dest: "join2" edge_type: CONV kernel_size: 1
  init_wt: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "join2" dest: "fc3" edge_type: FC init_wt: 0.1 init_bias: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
edge { source: "fc3" dest: "output" edge_type: FC init_wt: 0.1
  weight_optimizer { base_epsilon: 0.01 initial_momentum: 0.9 final_momentum: 0.9 l2_decay: 0.0005 }
  bias_optimizer { base_epsilon: 0.02 initial_momentum: 0.9 final_momentum: 0.9 } }
"""
JOIN_CONFIG = dict(CONFIG, name="tinyjoin", reference="join",
                   model=JOIN_MODEL.strip().splitlines())
#: limits set as tiny's are, from 24 sound seeds and 12 seeds of the fp8
#: control and of half a batch on the CPU
JOIN_TRAIN_LIMITS = {
    "after_change_err:conv2a/b": 0.47,
    "after_change_err:conv2a/w": 0.43,
    "after_change_err:conv2b/b": 0.47,
    "after_change_err:conv2b/w": 0.46,
    "after_change_err:fc3:output/b": 0.024,
    "after_change_err:fc3:output/w": 0.012,
    "after_change_err:input:conv1/b": 0.49,
    "after_change_err:input:conv1/w": 0.43,
    "after_change_err:join2:fc3/b": 0.4,
    "after_change_err:join2:fc3/w": 0.41,
    "after_change_gap": 0.25,
    "after_grad_err:fc3:output/b": 0.086,
    "after_grad_err:fc3:output/w": 0.02,
    "after_grad_err:join2:fc3/b": 0.017,
    "after_grad_err:join2:fc3/w": 0.028,
    "after_loss_gap": 0.01,
    "change_err:fc3:output/b": 0.052,
    "change_err:fc3:output/w": 0.023,
    "change_gap": 0.51,
    "grad_err:fc3:output/b": 0.066,
    "grad_err:fc3:output/w": 0.017,
    "grad_gap": 0.53,
    "loss_gap": 0.0035,
}
JOIN_SERVE_LIMITS = {"logit_gap": 0.043}


SERVE_METRICS = (("serve.mfu", "%", "higher", "host_clock", "predictor"),
                 ("serve.p95_mfu", "%", "higher", "host_clock", "predictor"),
                 ("predictor.p95_ms", "ms", "lower", "host_clock", "predictor"),
                 ("predictor.host_ms", "ms", "lower", "host_clock", "predictor"),
                 ("model.forward_device_ms", "ms", "lower", "device_trace", "model"),
                 ("device.idle_share.serve", "%", "lower", "device_trace", "device"))


def make_root(tmp: Path, metric_files=()) -> Path:
    """A root whose BENCHMARK.json is the repo's plus the tiny cells
    "tiny.train", "tiny.serve", "tinyjoin.train" and "tinyjoin.serve", with
    the repo's metric readers and reference modules, `join.py` beside them,
    and any `metric_files` ({name: source}) added to cellbench/metrics/."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in (CONFIG, JOIN_CONFIG):
        name = cfg["name"]
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"cellbench/configs/{name}.json", "reduced": [],
                                 "why": name})
        for traffic in ("tiny.train", "tiny.serve"):
            bench["workloads"].append({"name": f"{name}.{traffic.split('.')[1]}",
                                       "config": name, "traffic": traffic, "chips": 1,
                                       "why": name})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "alexnet.train.b1024" in m.get("workloads", ()):
            m["workloads"] += ["tiny.train", "tinyjoin.train"]
    # the serve kind's metrics, which no cell of the repo's reports yet
    serve_cells = ["tiny.serve", "tinyjoin.serve"]
    bench["end_to_end"].append({"name": "serve_images_per_s", "unit": "images/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": serve_cells})
    for name, unit, better, source, layer in SERVE_METRICS:
        bench["per_layer"].append({"name": name, "unit": unit, "better": better, "source": source,
                                   "layer": layer, "moves": "serve_images_per_s",
                                   "workloads": serve_cells})
    data = tmp / "cellbench"
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "reference"):
        shutil.copytree(REPO / "cellbench" / sub, data / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "cellbench" / "tests" / "join.py", data / "reference" / "join.py")
    for name, source in dict(metric_files).items():
        (data / "metrics" / f"{name}.py").write_text(source)
    files = {"configs/tiny.json": CONFIG, "configs/tinyjoin.json": JOIN_CONFIG,
             "traffic/tiny.train.json": TRAIN, "traffic/tiny.serve.json": SERVE,
             "limits/tiny.train.json": TRAIN_LIMITS, "limits/tiny.serve.json": SERVE_LIMITS,
             "limits/tinyjoin.train.json": JOIN_TRAIN_LIMITS,
             "limits/tinyjoin.serve.json": JOIN_SERVE_LIMITS}
    for path, content in files.items():
        (data / path).write_text(json.dumps(content))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
