"""Parity of the PyTorch port's ops (convnet_tpu_torch.ops) with the JAX
package's, on the CPU.

Inputs come from a numpy seed and go through both functions. On the CPU
the port's kernel wrappers take their plain PyTorch versions, and the JAX
side runs its Pallas kernels in interpret mode, as its own tests do. The
CUDA kernels are compared with the plain versions on the card by
tests/test_torch_port_kernels.py and chip_smoke.py.

Tolerances: f32 to rtol 1e-5 where the op is elementwise math (LRN), to
1e-4 where a contraction sums in another order (conv, fc: BASELINE.json's
bar); bf16 to 1 bf16 ulp (the two differ only where an f32 intermediate
lands within an ulp-rounding of a bf16 boundary); data movement (crop,
space-to-depth, pool) exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import config
from convnet_tpu.data import jitter as jax_jitter
from convnet_tpu.graph import ACT, build_graph
from convnet_tpu.ops import activations as jax_act
from convnet_tpu.ops import conv as jax_conv
from convnet_tpu.ops import lrn as jax_lrn
from convnet_tpu.ops import pool as jax_pool
from convnet_tpu.ops import prologue as jax_prologue
from convnet_tpu.ops import s2d_relayout as jax_s2d
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch.data import jitter as pt_jitter
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.ops import activations as pt_act
from convnet_tpu_torch.ops import conv as pt_conv
from convnet_tpu_torch.ops import lrn as pt_lrn
from convnet_tpu_torch.ops import pool as pt_pool
from convnet_tpu_torch.ops import s2d_relayout as pt_s2d

REPO = Path(__file__).resolve().parent.parent
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _read_graphs(path):
    """(JAX graph, port graph): one pbtxt file through each package's own
    reader and graph IR (their proto classes are distinct types)."""
    return build_graph(config.read_model(path)), pt_build_graph(pt_config.read_model(path))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16_order(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (as int16) -> integers ordered like the values,
    so that adjacent bf16 numbers differ by 1."""
    b = bits.astype(np.int32)
    return np.where(b >= 0, b, -32768 - b)


def _bf16_bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.cpu().contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def assert_bf16_ulps(got, want, ulps: int = 1):
    g = _bf16_order(_bf16_bits(got))
    w = _bf16_order(_bf16_bits(want))
    diff = np.abs(g - w)
    assert diff.max() <= ulps, f"{int(diff.max())} bf16 ulps apart at {np.argmax(diff)}"


# ---------------------------------------------------------------------------
# LRN: the kernel's plain version vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

LRN_FLAGS = [  # (bias, relu, blocked)
    (False, False, False),
    (False, True, False),
    (True, True, False),
    (True, False, False),
    (False, False, True),
    (True, True, True),
]


def _lrn_pair(c, dtype, bias, relu, blocked, frac, beta, add_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((128, 3, 3, c))).astype(np.float32)
    b = (0.5 * rng.standard_normal(c)).astype(np.float32) if bias else None
    xj = jnp.asarray(x, JAX_DT[dtype])
    if bias and blocked and dtype == "bf16":
        # the reference has no fused-bias form for blocked windows: it adds
        # the bias in x's dtype before the LRN (lrn.py:925-951, 1061-1065),
        # a bf16 rounding the port's kernel does not make (it adds in f32
        # for every window). The port's function is the reference's f32
        # function rounded once to bf16, so compare with that.
        want = jax_lrn.response_norm_cross_map_bias(
            xj.astype(jnp.float32), jnp.asarray(b), add_scale, beta, frac, blocked,
            "pallas", relu,
        ).astype(jnp.bfloat16)
    elif bias:
        want = jax_lrn.response_norm_cross_map_bias(
            xj, jnp.asarray(b), add_scale, beta, frac, blocked, "pallas", relu
        )
    else:
        want = jax_lrn.response_norm_cross_map(
            xj, add_scale, beta, frac, blocked, "pallas", relu
        )
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TORCH_DT[dtype])
    bt = None if b is None else torch.from_numpy(b)
    got = pt_lrn.response_norm_cross_map_bias(
        xt, bt, add_scale, beta, frac, blocked, relu
    )
    return got, want


# C=16 at B=128 takes the JAX package's r2d form, C=128 its folded-2D form
@pytest.mark.parametrize("c", [16, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias,relu,blocked", LRN_FLAGS)
def test_lrn_matches_pallas(c, dtype, bias, relu, blocked):
    got, want = _lrn_pair(c, dtype, bias, relu, blocked, frac=5 / c, beta=0.75)
    assert got.dtype == TORCH_DT[dtype] and got.shape == tuple(want.shape)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=0)
    else:
        assert_bf16_ulps(got, want)


@pytest.mark.parametrize(
    "beta,frac,blocked",
    [
        (0.6, 5 / 16, False),  # not a quarter-integer: the pow branch
        (1.25, 5 / 16, False),  # 1/d times d^-1/4: both chain branches
        (0.75, 0.25, True),  # blocked with n dividing C: the reshape branch
    ],
)
def test_lrn_exponents_and_blocks(beta, frac, blocked):
    got, want = _lrn_pair(16, "f32", True, True, blocked, frac=frac, beta=beta)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Input prologue: uint8 -> S2DInput, bit-exact with jitter_s2d
# ---------------------------------------------------------------------------

B, RAW, CROP, KERNEL, STRIDE = 128, 12, 9, 5, 4


@pytest.mark.parametrize(
    "scale,mean,std,flip",
    [
        (1 / 255, [0.4, 0.5, 0.6], None, True),
        (1.0, None, None, False),
        (1 / 255, [0.45, 0.45, 0.45], [0.2, 0.25, 0.3], True),
    ],
)
def test_jitter_s2d_bit_exact(scale, mean, std, flip):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (B, RAW, RAW, 3), dtype=np.uint8)
    oy = rng.integers(0, RAW - CROP + 1, B).astype(np.int32)
    ox = rng.integers(0, RAW - CROP + 1, B).astype(np.int32)
    flips = rng.random(B) < 0.5 if flip else None
    mean = None if mean is None else np.asarray(mean, np.float32)
    std = None if std is None else np.asarray(std, np.float32)
    want = jax_s2d.jitter_s2d(
        jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox),
        None if flips is None else jnp.asarray(flips),
        crop=CROP, kernel=KERNEL, stride=STRIDE, scale=scale, mean=mean, std=std,
        interpret=True,
    )
    got = pt_s2d.jitter_s2d(
        torch.from_numpy(x), torch.from_numpy(oy), torch.from_numpy(ox),
        None if flips is None else torch.from_numpy(flips),
        crop=CROP, kernel=KERNEL, stride=STRIDE, scale=scale,
        mean=None if mean is None else torch.from_numpy(mean),
        std=None if std is None else torch.from_numpy(std),
    )
    assert got.stride == STRIDE and got.x.dtype == torch.bfloat16
    assert got.x.shape == want.x.shape
    np.testing.assert_array_equal(_np(got.x), np.asarray(want.x, np.float32))


def test_s2d_conv_equals_direct_conv():
    """conv2d over the prologue's S2DInput is the strided conv over the
    center-cropped image: the identity the s2d route rests on."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 256, (2, RAW, RAW, 3), dtype=np.uint8))
    w = torch.from_numpy(rng.standard_normal((KERNEL, KERNEL, 3, 6)).astype(np.float32))
    c = (RAW - CROP) // 2
    oy = torch.full((2,), c, dtype=torch.int32)
    s2d = pt_s2d.jitter_s2d(x, oy, oy, None, crop=CROP, kernel=KERNEL, stride=STRIDE, scale=1 / 255)
    crop = pt_jitter.jitter_batch(x, pt_jitter.JitterSpec(image_size=CROP, scale=1 / 255))
    crop = crop.to(torch.bfloat16).float()
    got = pt_conv.conv2d(pt_conv.S2DInput(s2d.x.float(), STRIDE), w, STRIDE, 0)
    want = pt_conv.conv2d(crop, w, STRIDE, 0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("crop,kernel,stride", [(224, 11, 4), (9, 5, 4), (28, 5, 2), (35, 11, 4)])
def test_relayout_geometry(crop, kernel, stride):
    assert pt_s2d.relayout_geometry(crop, kernel, stride) == jax_s2d.relayout_geometry(
        crop, kernel, stride
    )[0]


@pytest.mark.parametrize("path", ["imagenet/alexnet.pbtxt", "cifar10/cifar10_conv.pbtxt",
                                  "mnist/mnist_lenet.pbtxt", "imagenet/alexnet_2tower.pbtxt"])
def test_prologue_plan_matches(path):
    jg, g = _read_graphs(str(REPO / "examples" / path))
    for l in g.input_layers:
        want = jax_prologue.prologue_plan(jg, l.name)
        got = pt_s2d.prologue_plan(g, l.name)
        assert (got and got.name) == (want and want.name)


# ---------------------------------------------------------------------------
# conv, pool, fc, activations, eval crop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "h,k,s,p,cin,cout,groups",
    [
        (8, 3, 1, 1, 3, 5, 1),
        (16, 11, 4, 0, 3, 6, 1),  # the JAX side folds this into space-to-depth
        (9, 3, 2, 0, 2, 2, 1),  # ceil-mode asymmetric padding
        (10, 3, 1, 1, 4, 6, 2),  # grouped
        (7, 5, 1, 2, 16, 8, 1),
    ],
)
def test_conv2d_matches_jax(h, k, s, p, cin, cout, groups):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, h, h, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)
    want = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), s, p, groups=groups)
    got = pt_conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), s, p, groups=groups)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # bf16 compute returns bf16, within a few ulps of the reference
    want16 = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), s, p, jnp.bfloat16, groups)
    got16 = pt_conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), s, p, torch.bfloat16, groups)
    assert got16.dtype == torch.bfloat16
    ref = np.asarray(want16, np.float32)
    np.testing.assert_allclose(_np(got16), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


def test_conv2d_s2d_input_matches_jax():
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((2, 6, 6, 48)).astype(np.float32)
    w = rng.standard_normal((11, 11, 3, 8)).astype(np.float32)
    want = jax_conv.conv2d(jax_conv.S2DInput(jnp.asarray(xs), 4), jnp.asarray(w), 4, 0)
    got = pt_conv.conv2d(pt_conv.S2DInput(torch.from_numpy(xs), 4), torch.from_numpy(w), 4, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        pt_conv.s2d_regroup_weight(torch.from_numpy(w), 4).numpy(),
        np.asarray(jax_conv._s2d_regroup_weight(jnp.asarray(w), 4)),
    )
    with pytest.raises(ValueError, match="stride"):
        pt_conv.conv2d(pt_conv.S2DInput(torch.from_numpy(xs), 2), torch.from_numpy(w), 4, 0)


@pytest.mark.parametrize("h,k,s,p", [(8, 2, 2, 0), (27, 3, 2, 0), (55, 3, 2, 0), (9, 3, 2, 1), (4, 3, 2, 0)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_maxpool_matches_jax(h, k, s, p, dtype):
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, h, h, 4)), JAX_DT[dtype])
    want = jax_pool.maxpool2d(x, k, s, p)
    got = pt_pool.maxpool2d(torch.from_numpy(np.array(x, np.float32)).to(TORCH_DT[dtype]), k, s, p)
    assert got.shape == tuple(want.shape) and got.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_fc_flattens_nhwc():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 3, 3, 8)).astype(np.float32)
    w = rng.standard_normal((72, 5)).astype(np.float32)
    got = pt_conv.fc(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_conv.fc(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x.reshape(4, -1) @ w, rtol=1e-4, atol=1e-5)
    got16 = pt_conv.fc(torch.from_numpy(x), torch.from_numpy(w), torch.bfloat16)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "act", [ACT.LINEAR, ACT.LOGISTIC, ACT.RECTIFIED_LINEAR, ACT.SOFTMAX, ACT.TANH]
)
def test_activations_match_jax(act):
    x = np.random.default_rng(10).standard_normal((4, 1, 1, 7)).astype(np.float32) * 3
    want = jax_act.apply_activation(jnp.asarray(x), act)
    got = pt_act.apply_activation(torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mean_kind", ["none", "channel", "raw", "crop"])
def test_eval_jitter_batch_matches_jax(mean_kind):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (4, 12, 12, 3), dtype=np.uint8)
    spec_j = jax_jitter.JitterSpec(image_size=8, scale=1 / 255)
    spec_t = pt_jitter.JitterSpec(image_size=8, scale=1 / 255)
    shape = {"none": None, "channel": (3,), "raw": (12, 12, 3), "crop": (8, 8, 3)}[mean_kind]
    mean = None if shape is None else rng.random(shape).astype(np.float32)
    std = None if shape is None else (0.5 + rng.random(shape)).astype(np.float32)
    want = jax_jitter.jitter_batch(jnp.asarray(x), spec_j, None, False, mean, std)
    got = pt_jitter.jitter_batch(
        torch.from_numpy(x), spec_t,
        None if mean is None else torch.from_numpy(mean),
        None if std is None else torch.from_numpy(std),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The port imports no JAX and no h5py (the serving and train slices)
# ---------------------------------------------------------------------------


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import convnet_tpu_torch.predictor, convnet_tpu_torch.ops._build\n"
        "import convnet_tpu_torch.trainer, convnet_tpu_torch.optim\n"
        "import convnet_tpu_torch.ops.dropout, convnet_tpu_torch.ops.losses\n"
        "import convnet_tpu_torch.data.datahandler\n"
        "assert 'h5py' not in sys.modules, 'the slices must not import h5py'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    for src in (REPO / "convnet_tpu_torch").rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
