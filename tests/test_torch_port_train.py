"""The PyTorch port's train slice against the JAX package, on the CPU.

The same inputs, made from numpy seeds, go through the JAX function and
its port. The JAX side is pinned to its TPU train path with environment
knobs (relayout prologue, bias-fused Pallas LRN in interpret mode); on the
CPU the port's kernel wrappers run their plain versions. The CUDA kernels
are held against those plain versions on the card by
tests/test_torch_port_kernels.py and chip_smoke.py.

Tolerances, each with its reason:
- f32: 1e-4 (BASELINE.json's bar); the LRN backward rtol 1e-4 with atol
  3e-5, the reference's own bar for its backward kernels
  (tests/test_ops.py:532-536); the optimizer 1e-6 (the same update, the
  schedules computed in f32 as the reference computes them).
- bf16: the reference's bf16 bar for the LRN (rtol 2e-2, atol 2e-2,
  tests/test_ops.py:566). For whole train steps: each parameter's update
  within 6e-2 of its largest update, because a bf16 activation that
  rounds the other way (conv sums run in another order) can move a max
  pool's winner among near-equal bf16 values, which routes that
  window's gradient elsewhere (ROADMAP Queue C, maxpool ties).
- Dropout draws other bits than the JAX package (Philox, not threefry):
  checked by its own properties, and off in the parity runs.
"""

import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import config
from convnet_tpu import model as jax_model
from convnet_tpu import optim as jax_optim
from convnet_tpu import trainer as jax_trainer
from convnet_tpu.data.jitter import JitterSpec as JaxJitterSpec
from convnet_tpu.data.jitter import _onehot_crop_flip
from convnet_tpu.graph import ACT, DECAY, LOSS, build_graph
from convnet_tpu.ops import activations as jax_act
from convnet_tpu.ops import losses as jax_losses
from convnet_tpu.ops import lrn as jax_lrn
from convnet_tpu.ops import s2d_relayout as jax_s2d
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch import optim as pt_optim
from convnet_tpu_torch import trainer as pt_trainer
from convnet_tpu_torch.data import jitter as pt_jitter
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.ops import activations as pt_act
from convnet_tpu_torch.ops import dropout as pt_drop
from convnet_tpu_torch.ops import losses as pt_losses
from convnet_tpu_torch.ops import lrn as pt_lrn
from convnet_tpu_torch.ops import s2d_relayout as pt_s2d

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _graphs(text):
    """(JAX graph, port graph): one pbtxt through each package's own
    reader and graph IR (their proto classes are distinct types)."""
    return build_graph(config.parse_model(text)), pt_build_graph(pt_config.parse_model(text))


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16_ulps(got: torch.Tensor, want) -> int:
    def order(bits):
        b = bits.astype(np.int32)
        return np.where(b >= 0, b, -32768 - b)

    g = got.detach().contiguous().view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    return int(np.abs(order(g) - order(w)).max())


def _jax_tpu_train_path(monkeypatch):
    # the TPU's train path, which the CPU backend leaves off by default
    monkeypatch.setenv("CONVNET_S2D_RELAYOUT", "1")
    monkeypatch.setenv("CONVNET_LRN_BIAS_FUSED", "1")
    monkeypatch.setenv("CONVNET_LRN_BACKEND", "pallas")


# ---------------------------------------------------------------------------
# LRN backward (TPU kernel rows 2, 4 and 6; forwards 1, 3, 5) against jax.vjp
# ---------------------------------------------------------------------------


def _lrn_vjp_pair(form, c, dtype, bias, relu, blocked, monkeypatch, seed=1):
    """(port y, JAX y, port dx, port db, JAX dx, JAX db) for one
    cotangent. B=128 keeps every JAX kernel form eligible (lane-aligned
    batch)."""
    monkeypatch.setenv("CONVNET_LRN_FORM", form)
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((128, 3, 3, c))).astype(np.float32)
    g = rng.standard_normal((128, 3, 3, c)).astype(np.float32)
    b = (0.5 * rng.standard_normal(c)).astype(np.float32)
    frac, add_scale = 5.0 / c, 1.0
    # the bf16 values both sides start from
    xj, gj = jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(g, JAX_DT[dtype])
    x_in = np.array(xj.astype(jnp.float32))
    g_in = np.array(gj.astype(jnp.float32))
    # The reference adds the bias in x's dtype and sums db from the
    # rounded dx where it has no fused-bias kernel (blocked windows, the
    # t-form: lrn.py:925-951, 1104-1111); the port adds it in f32 and sums
    # the f32 dx for every form. In bf16 those cases compare with the
    # reference's f32 function, rounded once.
    f32_ref = dtype == "bf16" and bias and (blocked or form == "t")
    jdt = jnp.float32 if f32_ref else JAX_DT[dtype]
    args = (add_scale, 0.75, frac, blocked, "pallas", relu)
    if bias:
        fn = lambda a, bb: jax_lrn.response_norm_cross_map_bias(a, bb, *args)  # noqa: E731
        want_y, vjp = jax.vjp(fn, jnp.asarray(x_in, jdt), jnp.asarray(b))
        want_dx, want_db = vjp(jnp.asarray(g_in, jdt))
    else:
        fn = lambda a: jax_lrn.response_norm_cross_map(a, *args)  # noqa: E731
        want_y, vjp = jax.vjp(fn, jnp.asarray(x_in, jdt))
        (want_dx,), want_db = vjp(jnp.asarray(g_in, jdt)), None
    want_y, want_dx = want_y.astype(JAX_DT[dtype]), want_dx.astype(JAX_DT[dtype])

    xt = torch.from_numpy(x_in).to(TORCH_DT[dtype]).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if bias else None
    y = pt_lrn.response_norm_cross_map_bias(xt, bt, add_scale, 0.75, frac, blocked, relu)
    grads = torch.autograd.grad(y, [xt] + ([bt] if bias else []),
                                torch.from_numpy(g_in).to(TORCH_DT[dtype]))
    return y, want_y, grads[0], (grads[1] if bias else None), want_dx, want_db


def _check_lrn_grads(dtype, y, want_y, dx, db, want_dx, want_db):
    # the forward at the bars of test_torch_port_ops.py: rtol 1e-5 in f32,
    # 1 bf16 ulp
    if dtype == "f32":
        np.testing.assert_allclose(_np(y), np.asarray(want_y), rtol=1e-5, atol=0)
    else:
        assert _bf16_ulps(y, want_y) <= 1
    assert dx.dtype == TORCH_DT[dtype]
    if dtype == "f32":
        np.testing.assert_allclose(_np(dx), np.asarray(want_dx), rtol=1e-4, atol=3e-5)
    else:
        print(f"worst bf16 ulps of dx: {_bf16_ulps(dx, want_dx)}")
        np.testing.assert_allclose(_np(dx), np.asarray(want_dx, np.float32), rtol=2e-2, atol=2e-2)
    if want_db is not None:
        # db is summed from the f32 dx on both sides, in either dtype
        assert db.dtype == torch.float32
        scale = np.abs(_np(dx)).reshape(-1, dx.shape[-1]).sum(0).max()
        np.testing.assert_allclose(_np(db), np.asarray(want_db), rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.parametrize("form", ["2d", "t", "r2d"])
@pytest.mark.parametrize("c", [96, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias,relu", [(False, False), (False, True), (True, True), (True, False)])
def test_lrn_backward_matches_jax_forms(form, c, dtype, bias, relu, monkeypatch):
    """Rows 2 (folded-2D), 4 (t-form) and 6 (r2d) of the TPU kernel table,
    and the forwards of rows 1, 3 and 5: one port kernel each way against
    each JAX form in interpret mode."""
    _check_lrn_grads(dtype, *_lrn_vjp_pair(form, c, dtype, bias, relu, False, monkeypatch))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [False, True])
def test_lrn_backward_blocked_matches_jax(dtype, bias, monkeypatch):
    _check_lrn_grads(dtype, *_lrn_vjp_pair("2d", 96, dtype, bias, True, True, monkeypatch))


@pytest.mark.parametrize("beta", [0.75, 1.25, 0.6])
def test_neg_pow_pair_matches_jax(beta):
    d = np.linspace(1.0, 40.0, 257, dtype=np.float32)
    pb, dpow = pt_lrn._neg_pow_pair(torch.from_numpy(d), beta)
    want_pb, want_dpow = jax_lrn._neg_pow_pair(jnp.asarray(d), beta)
    # qr^k carries k times the f32 ulp in which the two rsqrt/sqrt may
    # differ: up to 9 * 1.2e-7 for d^-(1.25+1) = qr^9
    np.testing.assert_allclose(pb.numpy(), np.asarray(want_pb), rtol=2e-6)
    np.testing.assert_allclose(dpow.numpy(), np.asarray(want_dpow), rtol=2e-6)
    np.testing.assert_allclose(dpow.numpy(), d.astype(np.float64) ** -(beta + 1), rtol=2e-6)


def test_lrn_bias_gradient_only_through_db():
    """The deferred conv bias reaches params[conv]["b"] once, through the
    LRN's db, and equals the gradient of the unfused chain."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 3, 3, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 3, 3, 16)).astype(np.float32))
    b1 = b.clone().requires_grad_()
    y = pt_lrn.response_norm_cross_map_bias(x, b1, 1.0, 0.75, 5 / 16, False, True)
    (db,) = torch.autograd.grad(y, b1, g)
    b2 = b.clone().requires_grad_()
    y2 = pt_lrn.response_norm_cross_map(torch.relu(x + b2), 1.0, 0.75, 5 / 16)
    (db2,) = torch.autograd.grad(y2, b2, g)
    torch.testing.assert_close(db, db2, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Dropout (TPU kernel row 11): the plain version's properties
# ---------------------------------------------------------------------------


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        # the same code on int64 tensors (the mask) and on Python ints (keys)
        got = pt_drop.philox4x32([torch.tensor(c) for c in ctr], key)
        assert tuple(int(v) for v in got) == want
        assert pt_drop.philox4x32(list(ctr), key) == want


def test_dropout_is_deterministic_in_seed_step_layer():
    x = torch.ones(16, 1, 1, 256)
    a = pt_drop.dropout(x, 0.5, pt_drop.dropout_key(3, 7, 12))
    assert torch.equal(a, pt_drop.dropout(x, 0.5, pt_drop.dropout_key(3, 7, 12)))
    for other in ((4, 7, 12), (3, 8, 12), (3, 7, 13)):
        assert not torch.equal(a, pt_drop.dropout(x, 0.5, pt_drop.dropout_key(*other)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dropout_backward_mask_equals_forward_mask(dtype):
    x = (torch.randn(32, 1, 1, 512) + 3.0).to(TORCH_DT[dtype]).requires_grad_()
    y = pt_drop.dropout(x, 0.5, pt_drop.dropout_key(1, 2, 3))
    g = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx != 0, y != 0)
    scale = torch.tensor(2.0, dtype=TORCH_DT[dtype])
    assert torch.equal(gx, torch.where(y != 0, g * scale, torch.zeros((), dtype=g.dtype)))


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_dropout_keep_rate(rate):
    n = 128 * 4096
    y = pt_drop.dropout_apply(torch.ones(n), rate, pt_drop.dropout_key(9, 0, 11))
    keep = (y != 0).double().mean().item()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep - (1 - rate)) < 4 * sigma


def test_dropout_rate_zero_is_identity():
    x = torch.randn(4, 1, 1, 8)
    assert pt_drop.dropout(x, 0.0, pt_drop.dropout_key(0, 0, 0)) is x


@pytest.mark.parametrize("rate", [0.5, 0.3, 0.1])
def test_dropout_scales_in_the_input_dtype(rate):
    """Kept values are x * bf16(1/(1-rate)), the reference's
    x * x.dtype.type(inv_keep) (dropout.py:89), not x / (1-rate)."""
    x = torch.randn(4096).to(torch.bfloat16)
    y = pt_drop.dropout_apply(x, rate, pt_drop.dropout_key(2, 0, 0))
    kept = y != 0
    want = (jnp.asarray(_np(x), jnp.bfloat16) * jnp.bfloat16(1.0 / (1.0 - rate)))
    np.testing.assert_array_equal(_np(y)[kept.numpy()], np.asarray(want, np.float32)[kept.numpy()])
    bits = pt_drop.dropout_bits(4096, pt_drop.dropout_key(2, 0, 0))
    assert torch.equal(kept, bits >= pt_drop.keep_threshold(rate))


def test_dropout_offset_selects_later_bits():
    key = pt_drop.dropout_key(5, 1, 2)
    bits = pt_drop.dropout_bits(64, key)
    assert torch.equal(pt_drop.dropout_bits(32, key, offset=32), bits[32:])


# ---------------------------------------------------------------------------
# Losses, activations' VJPs, the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "loss", [LOSS.CROSS_ENTROPY_MULTINOMIAL, LOSS.CROSS_ENTROPY_BINARY, LOSS.SQUARED_ERROR]
)
def test_losses_and_gradients_match_jax(loss):
    rng = np.random.default_rng(12)
    logits = (3.0 * rng.standard_normal((16, 10))).astype(np.float32)
    if loss == LOSS.CROSS_ENTROPY_MULTINOMIAL:
        target = rng.integers(0, 10, 16).astype(np.int32)
    else:
        target = rng.random((16, 10)).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda l: jax_losses.compute_loss(loss, l, jnp.asarray(target))
    )(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = pt_losses.compute_loss(loss, lt, torch.from_numpy(target))
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


def test_classification_errors_match_jax():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((64, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 64).astype(np.int32)
    got = pt_losses.classification_errors(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_losses.classification_errors(jnp.asarray(logits), jnp.asarray(labels))
    assert int(got) == int(want)


@pytest.mark.parametrize("act", [ACT.LINEAR, ACT.LOGISTIC, ACT.RECTIFIED_LINEAR, ACT.TANH,
                                 ACT.SOFTMAX])
def test_activation_vjps_match_jax(act):
    """ReLU masks by its output (gradient 0 at x == 0), sigmoid and tanh
    differentiate through theirs: torch's autograd does this already."""
    rng = np.random.default_rng(14)
    x = (3.0 * rng.standard_normal((4, 1, 1, 9))).astype(np.float32)
    x[0, 0, 0, :3] = 0.0  # the ReLU's kink
    g = rng.standard_normal((4, 1, 1, 9)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_act.apply_activation(a, act), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(pt_act.apply_activation(xt, act), xt, torch.from_numpy(g))
    # softmax's VJP subtracts sum(g * y), a 9-term f32 sum of size ~3: its
    # rounding (~3e-7) shows where the two packages sum in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if act == ACT.RECTIFIED_LINEAR:
        assert (got.numpy()[0, 0, 0, :3] == 0).all()


OPT_NET = """
name: "opt" seed: 1
layer {{ name: "input" is_input: true num_channels: 12 }}
{layers}
{edges}
"""

OPT_SPECS = [
    "base_epsilon: 0.1 initial_momentum: 0.5 final_momentum: 0.9 momentum_transition_timescale: 3",
    "base_epsilon: 0.05 epsilon_decay: EXPONENTIAL epsilon_decay_timescale: 2 l2_decay: 0.01",
    "base_epsilon: 0.2 epsilon_decay: INVERSE_T epsilon_decay_timescale: 3 gradient_clip: 0.5",
    "base_epsilon: 0.3 epsilon_decay: LINEAR epsilon_decay_timescale: 8 weight_norm_limit: 0.4",
    "base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 start_optimization_after: 2",
]


def _opt_graphs():
    names = [f"h{i}" for i in range(len(OPT_SPECS) - 1)] + ["output"]
    layers = "\n".join(f'layer {{ name: "{n}" num_channels: 12 }}' for n in names[:-1])
    layers += '\nlayer { name: "output" is_output: true num_channels: 12 }'
    src = ["input"] + names[:-1]
    edges = "\n".join(
        f'edge {{ source: "{s}" dest: "{d}" edge_type: FC initialization: DENSE_GAUSSIAN '
        f"init_wt: 0.3 weight_optimizer {{ {spec} }} bias_optimizer {{ {spec} }} }}"
        for s, d, spec in zip(src, names, OPT_SPECS)
    )
    return _graphs(OPT_NET.format(layers=layers, edges=edges))


def test_optimizer_matches_jax_five_steps():
    jg, g = _opt_graphs()
    assert {e.weight_optimizer.epsilon_decay for e in g.weighted_edges} >= {
        DECAY.EXPONENTIAL, DECAY.INVERSE_T, DECAY.LINEAR, DECAY.NONE}
    jp = jax_model.init_params(jg, seed=0)
    jm = jax_optim.init_momentum(jp)
    pp = pt_model.params_from_numpy(jp)
    pm = pt_optim.init_momentum(pp)
    rng = np.random.default_rng(15)
    for step in range(5):
        grads = {
            name: {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
            for name, p in jp.items()
        }
        jp, jm = jax_optim.apply_updates(jg, jp, jm, grads, jnp.asarray(step, jnp.int32))
        pt_optim.apply_updates(g, pp, pm, pt_model.params_from_numpy(grads), step)
    frozen = g.weighted_edges[-1].name  # start_optimization_after: moved only at steps 2-4
    assert not np.array_equal(np.asarray(jp[frozen]["w"]), jax_model.init_params(jg, 0)[frozen]["w"])
    for name in jp:
        for k in ("w", "b"):
            np.testing.assert_allclose(pp[name][k].numpy(), np.asarray(jp[name][k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(pm[name][k].numpy(), np.asarray(jm[name][k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [0, 1, 7, 100, 1234])
def test_schedules_match_jax(t):
    jg, g = _opt_graphs()
    for je, e in zip(jg.weighted_edges, g.weighted_edges):
        spec, jspec = e.weight_optimizer, je.weight_optimizer
        tt = jnp.asarray(float(t), jnp.float32)
        assert pt_optim.epsilon_at(spec, t) == float(jax_optim.epsilon_at(jspec, tt))
        assert pt_optim.momentum_at(spec, t) == float(jax_optim.momentum_at(jspec, tt))


# ---------------------------------------------------------------------------
# Train-time crops and flips
# ---------------------------------------------------------------------------


def test_crop_flip_equals_reference_gather():
    rng = np.random.default_rng(16)
    x = rng.integers(0, 256, (8, 14, 14, 3), dtype=np.uint8)
    oy = rng.integers(0, 5, 8).astype(np.int32)
    ox = rng.integers(0, 5, 8).astype(np.int32)
    flips = rng.random(8) < 0.5
    want = _onehot_crop_flip(jnp.asarray(x), 10, jnp.asarray(oy), jnp.asarray(ox), jnp.asarray(flips))
    got = pt_jitter.crop_flip(torch.from_numpy(x), 10, torch.from_numpy(oy), torch.from_numpy(ox),
                              torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32).astype(np.uint8))


def test_train_jitter_batch_draws_from_the_generator():
    """jitter_batch crops where the device draw (sample_crop_flip, from an
    int64 (seed, step) tensor) says; the same state draws the same crops,
    and a draw of flips alone keeps the center crop."""
    x = torch.from_numpy(np.random.default_rng(17).integers(0, 256, (16, 12, 12, 3), dtype=np.uint8))
    spec = pt_jitter.JitterSpec(image_size=9, can_translate=True, can_flip=True, scale=1 / 255)
    rng = torch.tensor([1, 0])
    crop = pt_jitter.sample_crop_flip(rng, "input", 16, 12, 12, 9, True, True)
    a = pt_jitter.jitter_batch(x, spec, crop=crop)
    b = pt_jitter.jitter_batch(x, spec, crop=pt_jitter.sample_crop_flip(rng, "input", 16, 12, 12, 9,
                                                                        True, True))
    assert a.shape == (16, 9, 9, 3) and torch.equal(a, b)
    oy, ox, flips = crop
    assert oy.dtype == ox.dtype == torch.int32 and flips.dtype == torch.bool
    assert 0 <= int(oy.min()) and int(oy.max()) <= 3 and 0 <= int(ox.min()) and int(ox.max()) <= 3
    want = pt_jitter.crop_flip(x, 9, oy, ox, flips).float() / 255
    torch.testing.assert_close(a, want * 1.0, rtol=0, atol=1e-7)
    eval_crop = pt_jitter.jitter_batch(x, spec)
    assert not torch.equal(a, eval_crop)
    oy, ox, flips = pt_jitter.sample_crop_flip(rng, "input", 16, 12, 12, 9, False, True)
    assert (oy == 1).all() and (ox == 1).all() and flips.any() and not flips.all()
    assert pt_jitter.sample_crop_flip(rng, "input", 16, 12, 12, 9, False, False) == (None,) * 3


def test_field_generator_is_keyed_by_seed_step_field():
    """A field's crops are keyed by (seed, step, crc32(field)), and a
    dropout key drawn on the device equals the host's dropout_key."""
    def draw(seed, step, field):
        oy, ox, flips = pt_jitter.sample_crop_flip(torch.tensor([seed, step]), field, 64, 40, 40, 9,
                                                   True, True)
        return torch.cat([oy.long(), ox.long(), flips.long()])

    a = draw(0, 5, "input")
    assert torch.equal(a, draw(0, 5, "input"))
    for other in ((1, 5, "input"), (0, 6, "input"), (0, 5, "image"), (0, 5 + (1 << 32), "input")):
        assert not torch.equal(a, draw(*other))
    assert zlib.crc32(b"input") != zlib.crc32(b"image")
    keys, crops = pt_drop.step_draws(torch.tensor([5, 7]), [(2, 0), (9, 0)])
    assert crops is None and keys.shape == (2, 2)
    assert tuple(keys[0].tolist()) == pt_drop.dropout_key(5, 7, 2)
    assert tuple(keys[1].tolist()) == pt_drop.dropout_key(5, 7, 9)
    # a key tensor draws the mask its host pair draws
    x = torch.ones(1000)
    assert torch.equal(pt_drop.dropout_apply(x, 0.5, keys[0]),
                       pt_drop.dropout_apply(x, 0.5, pt_drop.dropout_key(5, 7, 2)))


# ---------------------------------------------------------------------------
# The train step against the JAX one, on a tiny AlexNet-shaped net
# ---------------------------------------------------------------------------

RAW, CROP, BATCH = 48, 43, 128
MEAN = np.full((3,), 0.45, np.float32)
OPT = (" weight_optimizer {{ base_epsilon: 0.05 initial_momentum: 0.9 final_momentum: 0.9 "
       "l2_decay: 0.0005 }} bias_optimizer {{ base_epsilon: 0.1 initial_momentum: 0.9 "
       "final_momentum: 0.9 }}")

# test_torch_port_predictor.py's net plus a hidden fc: uint8 input into a
# k11/s4/p0 conv1 (the space-to-depth prologue), conv -> ReLU -> LRN
# (bias deferred into it) -> pool at C=16 and C=128, fc -> fc -> softmax
TRAIN_NET = """
name: "tiny_alexnet_train"
seed: 3
batch_size: 128
max_iter: 6
display_after: 2
validate_after: 3
compute_dtype: "{dtype}"
activation_dtype: "{adtype}"
parallel {{ data: {data} model: 1 }}
layer {{ name: "input" is_input: true num_channels: 3 image_size: {crop} }}
layer {{ name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }}
layer {{ name: "rnorm1" num_channels: 16 }}
layer {{ name: "pool1" num_channels: 16 }}
layer {{ name: "conv2" num_channels: 128 activation: RECTIFIED_LINEAR }}
layer {{ name: "rnorm2" num_channels: 128 }}
layer {{ name: "pool2" num_channels: 128 }}
layer {{ name: "fc" num_channels: 32 activation: RECTIFIED_LINEAR dropprob: {dropprob} }}
layer {{ name: "output" is_output: true num_channels: 10 activation: SOFTMAX data_field: "labels" }}
edge {{ source: "input" dest: "conv1" edge_type: CONV kernel_size: 11 stride: 4 padding: 0
        initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.05 OPT }}
edge {{ source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
        add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.3125 }}
edge {{ source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }}
edge {{ source: "pool1" dest: "conv2" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
        initialization: DENSE_GAUSSIAN init_wt: 0.05 init_bias: 0.1 OPT }}
edge {{ source: "conv2" dest: "rnorm2" edge_type: RESPONSE_NORM
        add_scale: 2.0 pow_scale: 0.75 frac_of_filters_response_norm: 0.0390625 }}
edge {{ source: "rnorm2" dest: "pool2" edge_type: MAXPOOL kernel_size: 3 stride: 2 }}
edge {{ source: "pool2" dest: "fc" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05
        init_bias: 0.1 OPT }}
edge {{ source: "fc" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.05 OPT }}
""".replace("OPT", OPT)


def _train_graphs(dtype, dropprob=0.0, data=1):
    adtype = "bfloat16" if dtype == "bfloat16" else ""
    text = TRAIN_NET.format(dtype=dtype, adtype=adtype, crop=CROP, dropprob=dropprob, data=data)
    return _graphs(text)


def _train_graph(dtype, dropprob=0.0, data=1):
    return _train_graphs(dtype, dropprob, data)[1]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"input": rng.integers(0, 256, (BATCH, RAW, RAW, 3), dtype=np.uint8),
         "labels": rng.integers(0, 10, (BATCH,), dtype=np.int32)}
        for _ in range(n)
    ]


def _port_state(jparams, seed=0):
    params = pt_model.params_from_numpy(jparams)
    return {"params": params, "moms": pt_optim.init_momentum(params), "step": 0, "seed": seed}


def _assert_updates_close(graph, p0, want, got, rel, ulps=0):
    """Each leaf's update (after - before) within rel of its largest, plus
    `ulps` f32 ulps of the leaf's largest |element| (a weight whose updates
    are a few hundred of its ulps is rounded to within half an ulp, so
    two results can differ by that much however close their updates)."""
    for e in graph.weighted_edges:
        for k in ("w", "b"):
            before = np.asarray(p0[e.name][k])
            upd_j = np.asarray(want[e.name][k]) - before
            upd_p = _np(got[e.name][k]) - before
            ulp = np.spacing(np.abs(before).max().astype(np.float32))
            err = np.abs(upd_p - upd_j).max() / np.abs(upd_j).max()
            bar = rel + ulps * ulp / np.abs(upd_j).max()
            print(f"{e.name}/{k}: update error {err:.3g} of the largest update (bar {bar:.3g})")
            assert err <= bar, (e.name, k, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax_three_steps(dtype, monkeypatch):
    _jax_tpu_train_path(monkeypatch)
    jg, g = _train_graphs(dtype)
    jstate = jax_trainer.init_state(jg, seed=0)
    p0 = jax.tree.map(np.asarray, jstate["params"])
    jstep = jax_trainer.make_train_step(
        jg, {"input": (JaxJitterSpec(image_size=CROP, scale=1 / 255), MEAN, None)}
    )
    pstate = _port_state(p0)
    pstep = pt_trainer.make_train_step(
        g, {"input": (pt_jitter.JitterSpec(image_size=CROP, scale=1 / 255), MEAN, None)}
    )
    s2d_before = pt_s2d.LAUNCHES
    for batch in _batches(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(pm) == {"loss", "output/errors"} and pm["loss"].requires_grad is False
        if dtype == "float32":
            np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-3)
    assert pstate["step"] == 3 and int(jstate["step"]) == 3
    assert pt_s2d.LAUNCHES == s2d_before  # the CPU runs the plain versions
    if dtype == "float32":
        for e in g.weighted_edges:
            for k in ("w", "b"):
                np.testing.assert_allclose(_np(pstate["params"][e.name][k]),
                                           np.asarray(jstate["params"][e.name][k]),
                                           rtol=1e-4, atol=1e-4)
        _assert_updates_close(g, p0, jstate["params"], pstate["params"], 1e-3)
    else:
        _assert_updates_close(g, p0, jstate["params"], pstate["params"], 6e-2)


def _learnable_images(n, seed=5, classes=10):
    """n uint8 RAW x RAW x 3 images whose class shows in a colour offset
    and a stripe texture, with uniform noise, and their int32 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    yy, xx = np.mgrid[0:RAW, 0:RAW].astype(np.float32)
    images = np.empty((n, RAW, RAW, 3), np.uint8)
    for k in range(classes):
        colour, angle, period = rng.uniform(40, 215, 3), np.pi * k / classes, 4.0 + 1.5 * k
        stripes = 35 * np.sin((xx * np.cos(angle) + yy * np.sin(angle)) * (2 * np.pi / period))
        rows = np.flatnonzero(labels == k)
        noise = rng.integers(-30, 31, (len(rows), RAW, RAW, 3))
        images[rows] = np.clip(colour + stripes[..., None] + noise, 0, 255).astype(np.uint8)
    return images, labels


def test_normalized_train_steps_match_jax_200_steps(monkeypatch):
    """200 f32 steps over a learnable set normalized by its per-channel
    mean and std (a compute_mean --per-channel file's affine, which the
    prologue takes), the same batches on both sides, centre crops: every
    step's loss within 1e-3 of JAX's and every parameter within 1e-2 of
    its largest at the end. The loss falls from ln 10 to about 1e-3. The
    parameters' gap comes from f32 rounding (other summation orders) that
    training carries along: about 3e-3 of the largest by step 60, then
    flat."""
    _jax_tpu_train_path(monkeypatch)
    jg, g = _train_graphs("float32")
    images, labels = _learnable_images(160)
    mean = images.reshape(-1, 3).mean(0).astype(np.float32)
    std = images.reshape(-1, 3).std(0).astype(np.float32)
    jstate = jax_trainer.init_state(jg, seed=0)
    pstate = _port_state(jax.tree.map(np.asarray, jstate["params"]))
    jstep = jax_trainer.make_train_step(
        jg, {"input": (JaxJitterSpec(image_size=CROP, normalize=True), mean, std)})
    pstep = pt_trainer.make_train_step(
        g, {"input": (pt_jitter.JitterSpec(image_size=CROP, normalize=True), mean, std)})
    losses = []
    for t in range(200):
        rows = np.random.default_rng(t).choice(len(images), BATCH, replace=False)
        batch = {"input": images[rows], "labels": labels[rows]}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append((float(jm["loss"]), pm["loss"].item()))
    losses = np.array(losses)
    print(f"losses every 20 steps (JAX, port): {losses[::20].tolist()}")
    assert np.isfinite(losses).all()
    assert np.abs(losses[:, 0] - losses[:, 1]).max() <= 1e-3
    assert losses[-20:, 0].mean() < 0.1  # the set was learned
    for e in g.weighted_edges:
        for k in ("w", "b"):
            want = np.asarray(jstate["params"][e.name][k])
            err = np.abs(_np(pstate["params"][e.name][k]) - want).max() / np.abs(want).max()
            print(f"{e.name}/{k}: {err:.3g} of the largest")
            assert err <= 1e-2, (e.name, k, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_with_injected_crops_and_flips(dtype, monkeypatch):
    """One step's gradients through jitter_s2d with the same random crop
    origins and flips on both sides (the two packages draw them from
    different generators). In f32 the bf16 S2D input is widened, so both
    sides run conv1 in f32 over the same values."""
    _jax_tpu_train_path(monkeypatch)
    jg, g = _train_graphs(dtype)
    jparams = jax_model.init_params(jg, seed=0)
    rng = np.random.default_rng(18)
    x = rng.integers(0, 256, (BATCH, RAW, RAW, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (BATCH,), dtype=np.int32)
    oy = rng.integers(0, RAW - CROP + 1, BATCH).astype(np.int32)
    ox = rng.integers(0, RAW - CROP + 1, BATCH).astype(np.int32)
    flips = rng.random(BATCH) < 0.5
    kw = dict(crop=CROP, kernel=11, stride=4, scale=1 / 255)
    js = jax_s2d.jitter_s2d(jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox), jnp.asarray(flips),
                            mean=MEAN, interpret=True, **kw)
    ps = pt_s2d.jitter_s2d(torch.from_numpy(x), torch.from_numpy(oy), torch.from_numpy(ox),
                           torch.from_numpy(flips), mean=torch.from_numpy(MEAN), **kw)
    np.testing.assert_array_equal(_np(ps.x), np.asarray(js.x, np.float32))
    if dtype == "float32":
        js = type(js)(js.x.astype(jnp.float32), js.stride)
        ps = pt_s2d.S2DInput(ps.x.float(), ps.stride)
    want = jax.grad(lambda p: jax_model.loss_fn(jg, p, {"input": js, "labels": jnp.asarray(labels)})[0])(
        jparams
    )
    params = pt_model.params_from_numpy(jparams)
    leaves = [params[e.name][k].requires_grad_() for e in g.weighted_edges for k in ("w", "b")]
    loss, _ = pt_model.loss_fn(g, params, {"input": ps, "labels": torch.from_numpy(labels)})
    got = torch.autograd.grad(loss, leaves)
    rel = 1e-4 if dtype == "float32" else 6e-2
    i = 0
    for e in g.weighted_edges:
        for k in ("w", "b"):
            w = np.asarray(want[e.name][k])
            err = np.abs(_np(got[i]) - w).max() / np.abs(w).max()
            print(f"{e.name}/{k}: gradient error {err:.3g} of the largest")
            assert err <= rel, (e.name, k, err)
            i += 1


DATA = """
name: "dummy"
batch_size: 128
randomize_cpu: true
pipeline_loads: {pipeline}
data_config {{ layer_name: "input" data_type: DUMMY raw_image_size: 48 image_size: 43
              can_translate: true can_flip: true scale: 0.0039215686 dummy_size: 384 }}
data_config {{ layer_name: "labels" data_type: DUMMY dummy_size: 384 dummy_num_classes: 10 }}
"""


def test_trainer_over_dummy_data(tmp_path):
    """A few steps of the port's Trainer on the CPU, with random crops and
    flips, dropout, display, validation and the train log; the same run
    twice gives the same parameters."""
    g = _train_graph("bfloat16", dropprob=0.5, data=8)

    def run():
        cfg = pt_config.parse_dataset_config(DATA.format(pipeline="true"))
        train, val = DataHandler(cfg), DataHandler(cfg, randomize=False)
        lines = []
        with pytest.warns(UserWarning, match="8x1 mesh"):
            tr = pt_trainer.Trainer(g, train, val, checkpoint_dir=str(tmp_path), log_fn=lines.append,
                                    device="cpu")
        p0 = {n: {k: v.clone() for k, v in p.items()} for n, p in tr.state["params"].items()}
        tr.train()
        verr, vloss = tr.validate(1)
        train.close()
        val.close()
        return tr, p0, lines, verr, vloss

    tr, p0, lines, verr, vloss = run()
    assert tr.state["step"] == g.max_iter == 6
    assert [l.split()[1] for l in lines if "loss" in l and "VALIDATION" not in l] == ["2", "4", "6"]
    assert [l.split()[1] for l in lines if "VALIDATION" in l] == ["3", "6"]
    assert np.isfinite(vloss) and 0.0 <= verr <= 1.0
    log = (tmp_path / "tiny_alexnet_train_train_log.txt").read_text().splitlines()
    assert log == lines
    for name, p in tr.state["params"].items():
        for k, v in p.items():
            assert torch.isfinite(v).all()
            assert not torch.equal(v, p0[name][k]), (name, k)
    (tmp_path / "tiny_alexnet_train_train_log.txt").unlink()
    again = run()[0]
    for name, p in tr.state["params"].items():
        for k, v in p.items():
            assert torch.equal(v, again.state["params"][name][k])


def test_trainer_raises_on_what_is_not_ported(tmp_path):
    """Several steps per launch and remat, which the port once refused,
    now run; a launch of fewer than one step raises."""
    g = _train_graph("bfloat16")
    cfg = pt_config.parse_dataset_config(DATA.format(pipeline="false"))
    data = DataHandler(cfg)
    with pytest.raises(ValueError, match="unroll"):
        pt_trainer.make_train_step(g, unroll=0)
    tr = pt_trainer.Trainer(g, data, device="cpu", steps_per_launch=2)
    assert tr.steps_per_launch == 2
    tr.train(max_iter=3)
    assert tr.state["step"] == 3
    text = TRAIN_NET.format(dtype="float32", adtype="", crop=CROP, dropprob=0.0, data=1)
    plain = pt_build_graph(pt_config.parse_model(text))
    remat = pt_build_graph(pt_config.parse_model(text.replace("seed: 3", "seed: 3 remat: true")))
    assert remat.remat and not plain.remat
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    proc = pt_trainer.preprocess(remat, {"input": (pt_jitter.JitterSpec(image_size=CROP), None, None)},
                                 batch)
    params = pt_model.init_params(remat)
    losses = [pt_model.loss_fn(gr, params, proc, train=True)[0].item() for gr in (plain, remat)]
    assert losses[0] == losses[1]
    data.close()
