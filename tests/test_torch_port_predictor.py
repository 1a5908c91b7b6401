"""The PyTorch port's serving slice (convnet_tpu_torch.predictor) against
the JAX package's Predictor, on the CPU.

A small AlexNet-shaped net takes the same route as AlexNet does on the
TPU: uint8 input into a k11/s4/p0 conv1, so the space-to-depth prologue
runs; conv -> ReLU -> LRN (bias deferred into it) -> pool twice, with
C=16 (the reference's r2d LRN form) and C=128 (its folded-2D form); then
fc -> softmax. The JAX side is pinned to its TPU serving path (relayout
prologue, bias-fused Pallas LRN, interpret mode) with environment knobs,
and both sides get the same params through params_from_numpy.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import config
from convnet_tpu import model as jax_model
from convnet_tpu.data.jitter import JitterSpec as JaxJitterSpec
from convnet_tpu.graph import build_graph
from convnet_tpu.predictor import Predictor as JaxPredictor
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.ops import lrn as pt_lrn
from convnet_tpu_torch.ops import s2d_relayout as pt_s2d
from convnet_tpu_torch.predictor import Predictor

RAW, CROP, BATCH = 48, 43, 128

NET = """
name: "tiny_alexnet"
seed: 3
compute_dtype: "{dtype}"
activation_dtype: "{adtype}"
layer {{ name: "input" is_input: true num_channels: 3 image_size: {crop} }}
layer {{ name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }}
layer {{ name: "rnorm1" num_channels: 16 }}
layer {{ name: "pool1" num_channels: 16 }}
layer {{ name: "conv2" num_channels: 128 activation: RECTIFIED_LINEAR }}
layer {{ name: "rnorm2" num_channels: 128 }}
layer {{ name: "pool2" num_channels: 128 }}
layer {{ name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }}
edge {{ source: "input" dest: "conv1" edge_type: CONV kernel_size: 11 stride: 4 padding: 0
        initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.05 }}
edge {{ source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
        add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.3125 }}
edge {{ source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }}
edge {{ source: "pool1" dest: "conv2" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
        initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.1 }}
edge {{ source: "conv2" dest: "rnorm2" edge_type: RESPONSE_NORM
        add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.0390625 }}
edge {{ source: "rnorm2" dest: "pool2" edge_type: MAXPOOL kernel_size: 3 stride: 2 }}
edge {{ source: "pool2" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05 }}
"""

MEAN = np.full((3,), 0.45, np.float32)


def _graphs(text):
    """(JAX graph, port graph): one pbtxt through each package's own
    reader and graph IR (their proto classes are distinct types)."""
    return build_graph(config.parse_model(text)), pt_build_graph(pt_config.parse_model(text))


def _graph_pair(dtype):
    adtype = "bfloat16" if dtype == "bfloat16" else ""
    return _graphs(NET.format(dtype=dtype, adtype=adtype, crop=CROP))


def _graph(dtype):
    return _graph_pair(dtype)[1]


def _requests():
    rng = np.random.default_rng(0)
    full = rng.integers(0, 256, (BATCH, RAW, RAW, 3), dtype=np.uint8)
    return full, full[:57]


def _jax_tpu_serving_path(monkeypatch):
    # the TPU's serving path, which the CPU backend leaves off by default
    monkeypatch.setenv("CONVNET_S2D_RELAYOUT", "1")
    monkeypatch.setenv("CONVNET_LRN_BIAS_FUSED", "1")
    monkeypatch.setenv("CONVNET_LRN_BACKEND", "pallas")


def _predictors(dtype, monkeypatch):
    _jax_tpu_serving_path(monkeypatch)
    jg, g = _graph_pair(dtype)
    jparams = jax_model.init_params(jg, seed=0)
    ref = JaxPredictor(
        jg, jparams, batch_size=BATCH, raw_size=RAW, input_dtype=np.uint8,
        jitter={"input": (JaxJitterSpec(image_size=CROP, scale=1 / 255), MEAN, None)},
    )
    port = Predictor(
        g, pt_model.params_from_numpy(jparams), batch_size=BATCH, raw_size=RAW,
        input_dtype=np.uint8, device="cpu",
        jitter={"input": (JitterSpec(image_size=CROP, scale=1 / 255), MEAN, None)},
    )
    return g, ref, port


def _assert_top1(got, want, tol):
    """Top-1 agrees wherever the reference's top-2 margin exceeds the
    logit tolerance (closer calls are not decided at that tolerance)."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * tol
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def test_bf16_slice_matches_jax_predictor(monkeypatch):
    g, ref, port = _predictors("bfloat16", monkeypatch)
    s2d_before, lrn_before = pt_s2d.LAUNCHES, pt_lrn.LAUNCHES
    for req in _requests():
        want = ref({"input": req})
        got = port({"input": req})
        assert set(got) == set(want) == {"output", "output:preact"}
        logits, ref_logits = got["output:preact"], np.asarray(want["output:preact"], np.float32)
        assert logits.shape == ref_logits.shape == (len(req), 10)
        assert logits.dtype == np.float32
        # Both compute in bf16 with f32 accumulation, but cuDNN/oneDNN and
        # XLA sum the convolutions in other orders, so a bf16 output can
        # round the other way (1 ulp = 2^-8 relative) at each of the three
        # bf16-stored layers before the logits. 2e-2 of the largest logit
        # is about five such ulps.
        tol = 2e-2 * np.abs(ref_logits).max()
        np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=tol)
        _assert_top1(logits, ref_logits, tol)
        probs = got["output"]
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=2e-2)  # bf16-stored softmax
        np.testing.assert_allclose(probs, np.asarray(want["output"], np.float32), atol=1e-2)
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert (pt_s2d.LAUNCHES, pt_lrn.LAUNCHES) == (s2d_before, lrn_before)


def test_f32_slice_matches_jax_predictor(monkeypatch):
    """f32 compute: prologue_plan declines, the crop goes through
    jitter_batch and conv1 runs on the cropped image; 1e-4 is
    BASELINE.json's f32 bar."""
    g, ref, port = _predictors("float32", monkeypatch)
    assert pt_s2d.prologue_plan(g, "input") is None
    for req in _requests():
        want = ref({"input": req})
        got = port({"input": req})
        np.testing.assert_allclose(
            got["output:preact"], np.asarray(want["output:preact"]), rtol=1e-4, atol=1e-4
        )
        np.testing.assert_allclose(got["output"], np.asarray(want["output"]), rtol=1e-4, atol=1e-5)


def test_partial_batch_and_labels():
    g = _graph("bfloat16")
    port = Predictor(
        g, pt_model.init_params(g, seed=1), batch_size=BATCH, raw_size=RAW,
        input_dtype=np.uint8, device="cpu",
        jitter={"input": (JitterSpec(image_size=CROP, scale=1 / 255), MEAN, None)},
    )
    full, part = _requests()
    out_full = port({"input": full})["output:preact"]
    out_part = port({"input": part})["output:preact"]
    np.testing.assert_array_equal(out_part, out_full[:57])
    labels = port.predict_labels({"input": part})
    np.testing.assert_array_equal(labels, out_part.argmax(-1))
    with pytest.raises(ValueError, match="exceeds"):
        port({"input": np.concatenate([full, part])})


def test_uint8_wire_rejects_out_of_range():
    g = _graph("bfloat16")
    jit = {"input": (JitterSpec(image_size=CROP, scale=1 / 255), None, None)}
    port = Predictor(g, pt_model.init_params(g), batch_size=4, jitter=jit, raw_size=RAW,
                     input_dtype=np.uint8, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        port({"input": np.random.rand(4, RAW, RAW, 3).astype(np.float32)})
    with pytest.raises(TypeError, match="uint8"):
        port({"input": np.full((4, RAW, RAW, 3), 300, np.int32)})
    ok = port({"input": np.full((4, RAW, RAW, 3), 200, np.int32)})
    assert np.isfinite(ok["output"]).all()
    with pytest.raises(ValueError, match="raw_size"):
        Predictor(g, pt_model.init_params(g), jitter=jit, raw_size=CROP - 1, device="cpu")
    with pytest.raises(ValueError, match="jitter"):
        Predictor(g, pt_model.init_params(g), raw_size=RAW, device="cpu")


@pytest.mark.parametrize(
    "path",
    ["imagenet/alexnet.pbtxt", "imagenet/alexnet_2tower.pbtxt", "cifar10/cifar10_conv.pbtxt",
     "mnist/mnist_lenet.pbtxt"],
)
def test_param_shapes_match_jax(path):
    from pathlib import Path

    path = str(Path(__file__).parent.parent / "examples" / path)
    jg, g = build_graph(config.read_model(path)), pt_build_graph(pt_config.read_model(path))
    assert pt_model.param_shapes(g) == jax_model.param_shapes(jg)


def test_init_modes():
    net = """
    name: "inits" seed: 5
    layer { name: "input" is_input: true num_channels: 64 }
    layer { name: "a" num_channels: 256 }
    layer { name: "b" num_channels: 256 }
    layer { name: "c" num_channels: 256 }
    layer { name: "d" num_channels: 256 }
    layer { name: "e" num_channels: 256 }
    layer { name: "output" is_output: true num_channels: 256 activation: SOFTMAX }
    edge { source: "input" dest: "a" edge_type: FC initialization: CONSTANT init_wt: 0.3 init_bias: 0.7 }
    edge { source: "a" dest: "b" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
    edge { source: "b" dest: "c" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0 }
    edge { source: "c" dest: "d" edge_type: FC initialization: DENSE_UNIFORM init_wt: 0.2 }
    edge { source: "d" dest: "e" edge_type: FC initialization: DENSE_UNIFORM_SQRT_FAN_IN init_wt: 1.0 }
    edge { source: "e" dest: "output" edge_type: FC initialization: SPARSE_GAUSSIAN init_wt: 1.0 }
    """
    g = pt_build_graph(pt_config.parse_model(net))
    p = pt_model.init_params(g)
    w = {e.dest: p[e.name]["w"].numpy() for e in g.weighted_edges}
    assert all(v.dtype == np.float32 for v in w.values())
    assert (w["a"] == np.float32(0.3)).all() and (p["input:a"]["b"].numpy() == np.float32(0.7)).all()
    assert abs(w["b"].std() - 0.1) < 0.01
    assert abs(w["c"].std() - 1 / 16) < 0.005
    assert np.abs(w["d"]).max() <= 0.2 and abs(w["d"].std() - 0.2 / np.sqrt(3)) < 0.01
    assert np.abs(w["e"]).max() <= 1 / 16
    assert abs((w["output"] != 0).mean() - 1 / 16) < 0.01
    again = pt_model.init_params(g)
    assert all(torch.equal(again[k]["w"], p[k]["w"]) for k in p)  # seeded
    other = pt_model.init_params(g, seed=6)
    assert not torch.equal(other["a:b"]["w"], p["a:b"]["w"])


def test_uint8_wire_without_jitter_widens_to_f32():
    """Without a jitter map the uint8 bytes are used as they are, widened to
    f32 on the device: the same outputs as shipping them as floats."""
    g = pt_build_graph(pt_config.parse_model("""
        name: "plain" seed: 2
        layer { name: "input" is_input: true num_channels: 3 image_size: 8 }
        layer { name: "h" num_channels: 4 activation: RECTIFIED_LINEAR }
        layer { name: "output" is_output: true num_channels: 5 activation: SOFTMAX }
        edge { source: "input" dest: "h" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
               initialization: DENSE_GAUSSIAN init_wt: 0.01 }
        edge { source: "h" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.01 }
    """))
    params = pt_model.init_params(g)
    xb = np.random.default_rng(7).integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    p8 = Predictor(g, params, batch_size=4, input_dtype=np.uint8, device="cpu")
    pf = Predictor(g, params, batch_size=4, device="cpu")
    assert p8._staging["input"].dtype == torch.uint8
    np.testing.assert_array_equal(p8({"input": xb})["output"], pf({"input": xb.astype(np.float32)})["output"])
