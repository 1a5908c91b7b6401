"""The port's chip probes on the CPU: the copy kernel's plain version
against the TPU kernel it replaces, and the serving probe end to end.

- `tools/r3_chip2.py`'s `copy_kernel` (read from the file with `ast`: the
  script measures on the chip when it is imported), run through
  `pl.pallas_call` with its BlockSpec forms in interpret mode, is
  array-equal to `copy_add` (on the CPU its plain version, `a + b`) on the
  same bf16 inputs, with whole 1024-column rows and with 128-column blocks.
- `serving_probe` at a small f32 model prints its lines with "device":
  "cpu"; the extract's rows equal a Predictor's on the same rows; and the
  probe's Predictor agrees with the JAX package's Predictor at batch 1 on
  the same params within BASELINE.json's f32 bar (1e-4).
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import config as jax_config
from convnet_tpu.data.jitter import JitterSpec as JaxJitterSpec
from convnet_tpu.graph import build_graph as jax_build_graph
from convnet_tpu.predictor import Predictor as JaxPredictor
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import hdf5, ops
from convnet_tpu_torch.bench import MEAN, RAW_MARGIN
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.data.native import raw_cache_gather_reference
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.model import init_params
from convnet_tpu_torch.predictor import Predictor
from convnet_tpu_torch.ops.copy_add import copy_add, copy_add_reference
from convnet_tpu_torch.tools import copy_probe, serving_probe

REPO = Path(__file__).resolve().parent.parent
COLS = 1024
# an AlexNet-shaped f32 net: uint8 input through a k11/s4 conv1, an LRN, a
# max pool, fc7 and a softmax output
NET = """
name: "probe_net"
seed: 3
layer { name: "input" is_input: true num_channels: 3 image_size: 43 }
layer { name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 16 }
layer { name: "pool1" num_channels: 16 }
layer { name: "fc7" num_channels: 32 activation: RECTIFIED_LINEAR }
layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 11 stride: 4 padding: 0
       initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.05 }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
       add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.3125 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }
edge { source: "pool1" dest: "fc7" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05
       init_bias: 0.1 }
edge { source: "fc7" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05 }
"""


def _tpu_copy_kernel():
    """`copy_kernel` as tools/r3_chip2.py defines it, compiled from its
    source alone."""
    path = REPO / "tools" / "r3_chip2.py"
    (fn,) = [n for n in ast.parse(path.read_text()).body
             if isinstance(n, ast.FunctionDef) and n.name == "copy_kernel"]
    scope = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), scope)
    return scope["copy_kernel"]


# (rows, lanes) blocks of run_copy's forms at a reduced m: whole rows, and
# 128-lane column blocks at two heights
@pytest.mark.parametrize("rows,lanes", [(32, 1024), (16, 128), (48, 128)])
def test_copy_kernel_matches_the_tpu_kernel(rows, lanes):
    m = 96
    rng = np.random.default_rng(7)
    x1, x2 = (rng.standard_normal((m, COLS), dtype=np.float32) * 4 for _ in range(2))
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in (x1, x2))
    ja, jb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (x1, x2))
    for t, j in ((a, ja), (b, jb)):  # the same bf16 inputs on both sides
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    spec = pl.BlockSpec((rows, lanes), lambda i, j: (i, j), memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        _tpu_copy_kernel(),
        grid=(m // rows, COLS // lanes),
        in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, COLS), jnp.bfloat16),
        interpret=True,
    )(ja, jb)
    got = copy_add(a, b, tile_rows=rows // 8, tile_cols=lanes)
    assert got.dtype == torch.bfloat16 and got.shape == (m, COLS)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  copy_add_reference(a, b).float().numpy())


def test_copy_add_checks_its_inputs():
    a = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        copy_add(a.float(), a.float())
    with pytest.raises(ValueError, match="shapes"):
        copy_add(a, a[:3])
    assert [t for _, t in copy_probe.TILINGS] == [(16, 1024), (32, 1024), (16, 128), (32, 128),
                                                    (64, 128), (128, 128)]


def test_copy_probe_on_the_cpu(capsys):
    assert copy_probe.main(["--device", "cpu", "--rows", "64", "--calls", "2"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["jax_block"] for l in lines] == [list(b) for b in copy_probe.JAX_BLOCKS]
    for l in lines:
        assert l["metric"] == "copy_add_gb_per_s" and l["device"] == "cpu"
        assert l["power_limit_w"] is None and l["launches"] == dict.fromkeys(ops.KERNEL_NAMES, 0)
        assert l["ms"] > 0 and l["torch_add_ms"] > 0 and l["bytes"] == 3 * 64 * COLS * 2
        assert l["gb_per_s"] == pytest.approx(l["bytes"] / l["ms"] / 1e6)


def test_serving_probe_on_the_cpu(tmp_path, capsys):
    model = tmp_path / "net.pbtxt"
    model.write_text(NET)
    out = tmp_path / "out"
    assert serving_probe.main(["--device", "cpu", "--model", str(model), "--rows", "16",
                               "--calls", "2", "--batches", "1,3", "--out-dir", str(out)]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert all(l["device"] == "cpu" and l["power_limit_w"] is None for l in lines)
    assert [(l["metric"], l.get("direction")) for l in lines[:5]] == (
        [("transfer_mb_per_s", "h2d")] * 4 + [("transfer_mb_per_s", "d2h")])
    assert [l["bytes"] for l in lines[:5]] == [150528, 9633792, 38535168, 201326592, 16777216]
    assert [(l["metric"], l["mode"], l["batch"]) for l in lines[5:9]] == [
        ("predictor_latency_ms", m, b) for b in (1, 3) for m in ("wire", "device")]
    assert [(l["metric"], l["run"], l["rows"]) for l in lines[9:]] == [
        ("extract_rows_per_s", r, 16) for r in ("cold", "warm")]
    for l in lines[9:]:
        assert set(l["phases_s"]) == {"gather", "dispatch", "readback", "write"}
        assert l["value"] == pytest.approx(16 / sum(l["phases_s"].values()))
        assert l["wall_s"] == pytest.approx(sum(l["phases_s"].values()) + l["setup_s"])
    assert all(l["value"] > 0 for l in lines)

    # the extract's fc7 rows are a Predictor's fc7 of the same rows, under
    # the data pbtxt's eval prologue (scale 1/255, no mean)
    graph = serving_probe.read_graph(str(model))
    rows = raw_cache_gather_reference(str(out / "img.cache"), np.arange(16))
    (ckpt,) = out.glob("probe_net_*.h5")
    pred = Predictor.from_checkpoint(graph, str(ckpt), layers=["fc7"], batch_size=16,
                                     jitter={"input": (JitterSpec(image_size=43,
                                                                  scale=0.00392156862),
                                                       None, None)},
                                     input_dtype=np.uint8, device="cpu")
    with hdf5.File(str(out / "feats.h5")) as f:
        feats = f["fc7"][...]
    want = pred({"input": rows})["fc7"].reshape(16, -1)
    assert feats.shape == (16, 32)
    np.testing.assert_allclose(feats, want, rtol=1e-5, atol=1e-6)


def test_probe_predictor_matches_jax_at_batch_1():
    graph = build_graph(pt_config.parse_model(NET))
    params = init_params(graph, seed=0)
    port = serving_probe.make_predictor(graph, params, 1, "cpu")
    jparams = {e: {k: v.numpy() for k, v in p.items()} for e, p in params.items()}
    crop = 43
    ref = JaxPredictor(jax_build_graph(jax_config.parse_model(NET)), jparams, batch_size=1,
                       raw_size=crop + RAW_MARGIN, input_dtype=np.uint8,
                       jitter={"input": (JaxJitterSpec(image_size=crop, scale=1 / 255),
                                         np.full((3,), MEAN, np.float32), None)})
    x = np.random.default_rng(5).integers(0, 256, (1, crop + RAW_MARGIN, crop + RAW_MARGIN, 3),
                                          dtype=np.uint8)
    got, want = port({"input": x}), ref({"input": x})
    assert set(got) == set(want) == {"output", "output:preact"}
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-4)
