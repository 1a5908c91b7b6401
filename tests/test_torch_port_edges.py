"""Parity of the port's LOCAL, CONV_ONETOONE, UPSAMPLE, DOWNSAMPLE and
RGBTOYUV edges, of every example model and of LOCAL / CONV_ONETOONE
checkpoints with the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerances:

- the ops in f32, forward and gradients (autograd against jax.vjp): within
  rtol 1e-5 plus 1e-5 of the largest |element|;
- the ops in bf16 (bf16 operands, f32 accumulation, bf16 out): within 2e-2
  of the largest |element|, the bar tests/test_torch_port_ops.py holds the
  bf16 conv to; data movement (upsample) exactly;
- every examples/*/*.pbtxt model, read by each package's reader with
  compute_dtype and activation_dtype cleared to f32, batch 2,
  AlexNet-family inputs at 67 px, JAX's params shared: the output logits
  and every parameter's loss gradient within 1e-4 of their largest
  |element| (BASELINE.json's bar), and `param_shapes` equal; then one
  train step of the model as written (bf16 where it says so) on the port;
- a checkpoint written by either package loads in the other array-equal.
"""

from pathlib import Path

import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import checkpoint as jax_ckpt
from convnet_tpu import config
from convnet_tpu import model as jax_model
from convnet_tpu.cli.grad_check import synth_batch
from convnet_tpu.graph import build_graph
from convnet_tpu.ops import conv as jax_conv
from convnet_tpu.ops import local as jax_local
from convnet_tpu.ops import pool as jax_pool
from convnet_tpu.ops import resample as jax_resample
from convnet_tpu_torch import checkpoint as pt_ckpt
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.ops import conv as pt_conv
from convnet_tpu_torch.ops import local as pt_local
from convnet_tpu_torch.ops import pool as pt_pool
from convnet_tpu_torch.ops import resample as pt_resample
from convnet_tpu_torch.trainer import init_state, make_train_step

REPO = Path(__file__).resolve().parent.parent
MODELS = sorted(p for p in (REPO / "examples").glob("*/*.pbtxt") if "_data" not in p.name
                and "dummy" not in p.name)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-2 * scale)


def _vjp_pair(jax_fn, pt_fn, args, cotangent_seed=0):
    """(JAX out, JAX grads, port out, port grads) for f32 numpy args and a
    random f32 cotangent; the port's gradients by autograd."""
    jout, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in args])
    g = np.random.default_rng(cotangent_seed).standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g, jout.dtype))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    pout = pt_fn(*targs)
    pgrads = torch.autograd.grad(pout, targs, torch.from_numpy(g).to(pout.dtype))
    return jout, jgrads, pout, pgrads


# ---------------------------------------------------------------------------
# The edges' ops
# ---------------------------------------------------------------------------


# stride 1 and 2, pad 0 and 1; (8, 3, 2, 0) has a ceil-mode last window
# hanging one column off the input
@pytest.mark.parametrize("h,k,s,p", [(6, 3, 1, 0), (6, 3, 1, 1), (7, 3, 2, 1), (8, 3, 2, 0),
                                     (5, 2, 2, 0)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_local_conv2d_matches_jax(h, k, s, p, dtype):
    from convnet_tpu_torch.graph import conv_out_size

    rng = np.random.default_rng(11)
    cin, cout = 3, 4
    oh = conv_out_size(h, k, s, p)
    x = rng.standard_normal((2, h, h + 1, cin)).astype(np.float32)
    ow = conv_out_size(h + 1, k, s, p)
    w = rng.standard_normal(pt_local.local_weight_shape(oh, ow, k, cin, cout)).astype(np.float32)
    cdt = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jout, jg, pout, pg = _vjp_pair(
        lambda a, b: jax_local.local_conv2d(a, b, s, p, k, cdt[0]),
        lambda a, b: pt_local.local_conv2d(a, b, s, p, k, cdt[1]),
        (x, w),
    )
    assert tuple(pout.shape) == tuple(jout.shape) == (2, oh, ow, cout)
    assert pout.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert pout.is_contiguous()
    for got, want in zip((pout, *pg), (jout, *jg)):
        _close(got, want, dtype)


def test_local_patches_are_channel_slowest():
    """Each site's patch is ordered (Cin, kh, kw): a hand loop in that
    order, and not in the NHWC patch order (kh, kw, Cin)."""
    rng = np.random.default_rng(12)
    k, cin, cout, h = 3, 2, 3, 5
    x = rng.standard_normal((2, h, h, cin))
    w = rng.standard_normal((h, h, k * k * cin, cout))
    got = pt_local.local_conv2d(torch.from_numpy(x), torch.from_numpy(w), 1, 1, k).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.empty((2, h, h, cout))
    for i in range(h):
        for j in range(h):
            patch = xp[:, i:i + k, j:j + k, :].transpose(0, 3, 1, 2).reshape(2, -1)
            want[:, i, j] = patch @ w[i, j]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_onetoone_matches_jax(dtype):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    w = rng.standard_normal((6, 7)).astype(np.float32)
    cdt = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jout, jg, pout, pg = _vjp_pair(
        lambda a, b: jax_conv.conv_onetoone(a, b, cdt[0]),
        lambda a, b: pt_conv.conv_onetoone(a, b, cdt[1]),
        (x, w),
    )
    assert pout.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    for got, want in zip((pout, *pg), (jout, *jg)):
        _close(got, want, dtype)


# the zero padding counts in the average: pad 1, and a ceil-mode last window
@pytest.mark.parametrize("h,k,s,p", [(8, 2, 2, 0), (6, 3, 2, 1), (7, 3, 2, 0), (9, 3, 3, 0)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_avgpool2d_matches_jax(h, k, s, p, dtype):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, h, h, 5)).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    jout, jg, pout, pg = _vjp_pair(
        lambda a: jax_pool.avgpool2d(a.astype(jnp.bfloat16) if dtype == "bf16" else a, k, s, p),
        lambda a: pt_pool.avgpool2d(a.to(torch.bfloat16) if dtype == "bf16" else a, k, s, p),
        (x,),
    )
    assert tuple(pout.shape) == tuple(jout.shape)
    for got, want in zip((pout, *pg), (jout, *jg)):
        _close(got, want, dtype)


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_and_downsample_match_jax(factor):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jout, jg, pout, pg = _vjp_pair(lambda a: jax_resample.upsample(a, factor),
                                   lambda a: pt_resample.upsample(a, factor), (x,))
    np.testing.assert_array_equal(pout.detach().numpy(), np.asarray(jout))
    _close(pg[0], jg[0], "f32")
    big = rng.standard_normal((2, 3 * factor, 2 * factor, 5)).astype(np.float32)
    jout, jg, pout, pg = _vjp_pair(lambda a: jax_resample.downsample(a, factor),
                                   lambda a: pt_resample.downsample(a, factor), (big,))
    assert tuple(pout.shape) == (2, 3, 2, 5)
    for got, want in zip((pout, *pg), (jout, *jg)):
        _close(got, want, "f32")
    # downsample undoes upsample
    up = pt_resample.upsample(torch.from_numpy(x), factor)
    np.testing.assert_allclose(pt_resample.downsample(up, factor).numpy(), x, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rgb_to_yuv_matches_jax(dtype):
    rng = np.random.default_rng(16)
    x = rng.uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jout, jg, pout, pg = _vjp_pair(lambda a: jax_resample.rgb_to_yuv(a.astype(jdt)),
                                   lambda a: pt_resample.rgb_to_yuv(a.to(tdt)), (x,))
    assert pout.dtype == tdt
    for got, want in zip((pout, *pg), (jout, *jg)):
        _close(got, want, dtype)
    white = pt_resample.rgb_to_yuv(torch.ones((1, 1, 1, 3), dtype=torch.float64))
    assert white.dtype == torch.float64  # math in f32, the result in x's dtype
    np.testing.assert_allclose(white.numpy().ravel(), [1.0, 0.0, 0.0], atol=1e-4)  # as test_ops.py


# ---------------------------------------------------------------------------
# Every example model
# ---------------------------------------------------------------------------


def _example_graphs(path: Path, f32: bool):
    jm, pm = config.read_model(str(path)), pt_config.read_model(str(path))
    if f32:
        for m in (jm, pm):
            m.ClearField("compute_dtype")
            m.ClearField("activation_dtype")
    sizes = {l.name: 67 for l in jm.layer if l.is_input} if "imagenet" in str(path) else None
    return build_graph(jm, sizes), pt_build_graph(pm, sizes)


@pytest.mark.parametrize("path", MODELS, ids=lambda p: p.stem)
def test_example_model_matches_jax(path):
    jg, pg = _example_graphs(path, f32=True)
    assert pt_model.param_shapes(pg) == jax_model.param_shapes(jg)
    # shared params, drawn by the port's numpy init (JAX's threefry draws
    # compile a kernel a shape on the CPU, seconds a model)
    jparams = {n: {k: v.numpy() for k, v in p.items()}
               for n, p in pt_model.init_params(pg, seed=0).items()}
    batch = synth_batch(jg, 2, np.random.RandomState(0))

    def jax_loss(p):
        loss, _ = jax_model.loss_fn(jg, p, batch, train=False)
        return loss

    jgrads = jax.jit(jax.grad(jax_loss))(jparams)
    jout = jax.jit(lambda p: jax_model.apply_fn(jg, p, batch, return_layers=[]))(jparams)

    params = pt_model.params_from_numpy(jparams)
    pbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    keys = [(n, k) for n in params for k in params[n]]
    for n, k in keys:
        params[n][k].requires_grad_(True)
    out = pt_model.apply_fn(pg, params, pbatch, return_layers=[])
    for l in jg.output_layers:
        want = np.asarray(jout[f"{l.name}:preact"])
        np.testing.assert_allclose(_np(out[f"{l.name}:preact"]), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    loss, _ = pt_model.loss_fn(pg, params, pbatch, train=False)
    grads = torch.autograd.grad(loss, [params[n][k] for n, k in keys])
    for (n, k), g in zip(keys, grads):
        want = np.asarray(jgrads[n][k])
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{n}/{k}")

    # one train step of the model as written, on the port
    _, graph = _example_graphs(path, f32=False)
    state = init_state(graph, seed=0)
    p0 = {n: {k: v.clone() for k, v in p.items()} for n, p in state["params"].items()}
    metrics = make_train_step(graph)(state, pbatch)
    assert np.isfinite(metrics["loss"].item()) and state["step"] == 1
    for n, p in state["params"].items():
        for k, v in p.items():
            assert torch.isfinite(v).all() and not torch.equal(v, p0[n][k]), (n, k)


# ---------------------------------------------------------------------------
# LOCAL and CONV_ONETOONE checkpoints
# ---------------------------------------------------------------------------

LOCAL_NET = """
name: "local_net"
seed: 4
layer { name: "input" is_input: true num_channels: 3 image_size: 6 }
layer { name: "local1" num_channels: 4 activation: RECTIFIED_LINEAR }
layer { name: "mix" num_channels: 5 activation: TANH }
layer { name: "output" is_output: true num_channels: 3 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "local1" edge_type: LOCAL kernel_size: 3 stride: 2 padding: 1
       shared_bias: false initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.1 }
edge { source: "local1" dest: "mix" edge_type: CONV_ONETOONE initialization: DENSE_GAUSSIAN init_wt: 0.3 }
edge { source: "mix" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
"""


def _graph_pair(text):
    return build_graph(config.parse_model(text)), pt_build_graph(pt_config.parse_model(text))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cifar10_local_checkpoint_loads_in_the_other_package(writer, tmp_path):
    path = REPO / "examples" / "cifar10" / "cifar10_local.pbtxt"
    jg, pg = build_graph(config.read_model(str(path))), pt_build_graph(pt_config.read_model(str(path)))
    params = {n: {k: v.numpy() for k, v in p.items()}
              for n, p in pt_model.init_params(pg, seed=1).items()}
    moms = jax.tree.map(lambda a: a * 0.5, params)
    save, load = (jax_ckpt, pt_ckpt) if writer == "jax" else (pt_ckpt, jax_ckpt)
    f = save.save(str(tmp_path), "cifar10_local", params, moms, step=7)
    shapes = jax_model.param_shapes(jg) if writer == "port" else pt_model.param_shapes(pg)
    got, got_moms, step = load.load(f, expected_shapes=shapes)
    assert step == 7 and set(got) == set(params)
    for name in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(got[name][k]), np.asarray(params[name][k]))
            np.testing.assert_array_equal(np.asarray(got_moms[name][k]), np.asarray(moms[name][k]))
    assert got["pool2:local3"]["w"].shape == (8, 8, 3 * 3 * 64, 64)


def test_local_and_onetoone_layouts_load_as_in_jax(tmp_path):
    """A LOCAL weight stored flat as (sites * k*k*Cin, Cout) and a
    CONV_ONETOONE weight stored transposed as (Cout, Cin) take the model's
    layout through each package's layout detection alike, with LOCAL's
    unshared (h, w, C) bias."""
    jg, pg = _graph_pair(LOCAL_NET)
    shapes = pt_model.param_shapes(pg)
    assert shapes == jax_model.param_shapes(jg)
    assert shapes["input:local1"] == {"w": (4, 4, 27, 4), "b": (4, 4, 4)}
    assert shapes["local1:mix"] == {"w": (4, 5), "b": (5,)}
    rng = np.random.default_rng(17)
    arrays = {n: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaf.items()}
              for n, leaf in shapes.items()}
    f = tmp_path / "variant.h5"
    with h5py.File(f, "w") as h:
        for n, leaf in arrays.items():
            w = leaf["w"]
            if n == "input:local1":
                w = w.reshape(-1, w.shape[-1])
            elif n == "local1:mix":
                w = w.T
            g = h.create_group(n)
            g.create_dataset("w", data=w)
            g.create_dataset("b", data=leaf["b"])
    got, _, _ = pt_ckpt.load(str(f), expected_shapes=shapes)
    want, _, _ = jax_ckpt.load(str(f), expected_shapes=jax_model.param_shapes(jg))
    for n in arrays:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[n][k], np.asarray(want[n][k]))
            np.testing.assert_array_equal(got[n][k], arrays[n][k])
