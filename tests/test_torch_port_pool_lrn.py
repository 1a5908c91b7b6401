"""The port's reference-gradient pool path against the JAX package's, on the
CPU: the fused LRN -> max pool op with cuda-convnet's all-ties pool
gradient (TPU kernel table rows 12 and 13), the max pool against the JAX
package's Pallas kernel (row 10), the MaxPoolUndo oracle, the model's
deferral plan under CONVNET_POOL_LRN_FUSED=1, and the two other forms of
the train prologue (rows 8 and 9).

The port runs its kernels' plain versions here; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do
(tests/test_fused_pool_lrn.py), with CONVNET_POOL_LRN_BACKEND=pallas so
that it takes the fused kernels on the CPU. Inputs are quantized to
halves, so window maxima really tie.

Tolerances: f32 y within 1e-5 and dx within 1e-4, the JAX test's own bars;
bf16 within the reference's 2e-2; data movement exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import config
from convnet_tpu import trainer as jax_trainer
from convnet_tpu.graph import build_graph
from convnet_tpu.ops import fused_pool_lrn as jax_plrn
from convnet_tpu.ops import pool as jax_pool
from convnet_tpu.ops import prologue as jax_prologue
from convnet_tpu.ops import s2d_relayout as jax_s2d
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch import optim as pt_optim
from convnet_tpu_torch import trainer as pt_trainer
from convnet_tpu_torch.graph import build_graph as pt_build_graph
from convnet_tpu_torch.ops import dropout as pt_drop
from convnet_tpu_torch.ops import fused_pool_lrn as pt_plrn
from convnet_tpu_torch.ops import pool as pt_pool
from convnet_tpu_torch.ops import s2d_relayout as pt_s2d

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
ADD_SCALE, POW_SCALE = 0.001, 0.75


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _graphs(text):
    """(JAX graph, port graph): one pbtxt through each package's own
    reader and graph IR (their proto classes are distinct types)."""
    return build_graph(config.parse_model(text)), pt_build_graph(pt_config.parse_model(text))


def _halves(rng, shape):
    return (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)


def _pooled(h, k, s):
    return -(-max(h - k, 0) // s) + 1


# ---------------------------------------------------------------------------
# Rows 12 and 13: lrn_maxpool / lrn_maxpool_bias, forward and VJP
# ---------------------------------------------------------------------------

FUSED_CASES = [  # (b, h, c, k, s, frac, blocked, relu, bias)
    (8, 6, 8, 3, 2, 5 / 8, False, False, False),
    (8, 6, 8, 3, 2, 5 / 8, False, True, False),
    (8, 6, 8, 3, 2, 5 / 8, False, True, True),
    (8, 8, 16, 2, 2, 4 / 16, True, False, False),
    (8, 8, 16, 2, 2, 4 / 16, True, True, True),
    (4, 7, 8, 3, 2, 3 / 8, False, True, False),  # odd H: a ceil-mode window
    (4, 7, 8, 3, 2, 3 / 8, False, False, True),
    (8, 10, 8, 3, 3, 5 / 8, False, False, False),  # k3 s3: windows do not overlap
    (4, 6, 128, 3, 2, 5 / 128, False, True, True),  # lane-aligned C, as rnorm2's 256
]


def _fused_pair(dtype, b, h, c, k, s, frac, blocked, relu, bias, monkeypatch, seed=0, w=None):
    """(port m, JAX m, port dx, JAX dx, port db, JAX db) for one cotangent
    over a (b, h, w, c) input (w: h when not given)."""
    monkeypatch.setenv("CONVNET_POOL_LRN_BACKEND", "pallas")
    rng = np.random.default_rng(seed)
    w = h if w is None else w
    x = _halves(rng, (b, h, w, c))
    g = rng.standard_normal((b, _pooled(h, k, s), _pooled(w, k, s), c)).astype(np.float32)
    bb = np.round(rng.standard_normal(c)).astype(np.float32)  # keeps x + b on the grid
    # the values both sides start from
    xj, gj = jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(g, JAX_DT[dtype])
    args = (ADD_SCALE, POW_SCALE, frac, blocked, k, s, 0, relu, "pallas")
    if bias:
        want_m, vjp = jax.vjp(lambda a, v: jax_plrn.lrn_maxpool_bias(a, v, *args), xj,
                              jnp.asarray(bb))
        want_dx, want_db = vjp(gj)
    else:
        want_m, vjp = jax.vjp(lambda a: jax_plrn.lrn_maxpool(a, *args), xj)
        (want_dx,), want_db = vjp(gj), None

    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TORCH_DT[dtype]).requires_grad_()
    bt = torch.from_numpy(bb).requires_grad_() if bias else None
    m = pt_plrn.lrn_maxpool_bias(xt, bt, ADD_SCALE, POW_SCALE, frac, blocked, k, s, 0, relu)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(TORCH_DT[dtype])
    grads = torch.autograd.grad(m, [xt] + ([bt] if bias else []), gt)
    return m, want_m, grads[0], want_dx, (grads[1] if bias else None), want_db


@pytest.mark.parametrize("b,h,c,k,s,frac,blocked,relu,bias", FUSED_CASES)
def test_lrn_maxpool_matches_jax_f32(b, h, c, k, s, frac, blocked, relu, bias, monkeypatch):
    m, want_m, dx, want_dx, db, want_db = _fused_pair(
        "f32", b, h, c, k, s, frac, blocked, relu, bias, monkeypatch)
    assert m.dtype == dx.dtype == torch.float32
    np.testing.assert_allclose(_np(m), np.asarray(want_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(dx), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    if bias:
        np.testing.assert_allclose(_np(db), np.asarray(want_db), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,c,k,s,frac,blocked,relu,bias", FUSED_CASES[1:6:2])
def test_lrn_maxpool_matches_jax_bf16(b, h, c, k, s, frac, blocked, relu, bias, monkeypatch):
    m, want_m, dx, want_dx, db, want_db = _fused_pair(
        "bf16", b, h, c, k, s, frac, blocked, relu, bias, monkeypatch)
    assert m.dtype == dx.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(m), np.asarray(want_m, np.float32), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(dx), np.asarray(want_dx, np.float32), rtol=2e-2, atol=2e-2)
    if bias:
        assert db.dtype == torch.float32
        np.testing.assert_allclose(_np(db), np.asarray(want_db), rtol=2e-2, atol=2e-2)


# The geometries the fused kernels' card tests add (tests/test_torch_port_kernels.py,
# POOL_LRN_FAST), (b, h, w, c, k, s): a ceil-mode overhang on both edges with
# k 3/s 3, k 2/s 2 and k 3/s 2; a non-square image; a non-overlapping pool
# that covers exactly; 1x1 pools, also over a 1x1 image; a wide, short image.
CARD_GEOMETRIES = [
    (8, 10, 10, 16, 3, 3), (8, 9, 9, 16, 2, 2), (8, 8, 8, 16, 3, 2), (4, 21, 17, 32, 3, 2),
    (8, 12, 12, 8, 2, 2), (8, 6, 6, 16, 1, 1), (8, 1, 1, 96, 1, 1), (4, 5, 70, 64, 3, 2),
]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("b,h,w,c,k,s", CARD_GEOMETRIES)
def test_plain_versions_match_jax_on_the_card_tests_geometries(b, h, w, c, k, s, bias, monkeypatch):
    """On the CPU the wrappers run their plain versions, which the card tests
    hold the kernels against: here they meet the JAX op on those tests'
    overhang, non-square and 1x1 geometries (f32, n = 5, rtol as above)."""
    m, want_m, dx, want_dx, db, want_db = _fused_pair(
        "f32", b, h, c, k, s, 5 / c, False, bias, bias, monkeypatch, seed=k + s, w=w)
    assert tuple(m.shape) == (b, _pooled(h, k, s), _pooled(w, k, s), c)
    np.testing.assert_allclose(_np(m), np.asarray(want_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(dx), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    if bias:
        np.testing.assert_allclose(_np(db), np.asarray(want_db), rtol=1e-4, atol=1e-4)


def test_ties_credit_every_winner():
    """A window of equal maxima passes its whole cotangent to each of them;
    the default pool gradient passes it to one."""
    x = torch.zeros((1, 2, 2, 1)).requires_grad_()
    m = pt_plrn.lrn_maxpool(x, ADD_SCALE, POW_SCALE, 1.0, False, 2, 2)
    (dx,) = torch.autograd.grad(m, x, torch.ones_like(m))
    assert torch.equal(dx, torch.ones_like(x))
    (one,) = torch.autograd.grad(pt_pool.maxpool2d(x, 2, 2), x, torch.ones_like(m))
    assert one.sum() == 1.0


# ---------------------------------------------------------------------------
# Row 10: the max pool against the JAX package's Pallas kernel; the
# MaxPoolUndo oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,c,k,s", [(8, 13, 16, 3, 2), (8, 8, 16, 2, 2), (4, 9, 32, 3, 3)])
def test_maxpool_switch_matches_jax_pallas(dtype, b, h, c, k, s, monkeypatch):
    """Shapes the JAX kernel's gate accepts (exact cover, C*B % 128 == 0),
    the JAX package under CONVNET_POOL_BACKEND=pallas, which the port does
    not read (its one path): the forward array-equal, the VJP array-equal
    to the JAX package's (its Pallas forward, select-and-scatter's one
    winner), and the kernels' plain pair's forward and, where no position
    is credited by more than one window or in f32, its gradient too (the
    card sums a bf16 gradient in f32, the CPU and XLA here in bf16)."""
    monkeypatch.setenv("CONVNET_POOL_BACKEND", "pallas")
    assert jax_pool._pool_form(jnp.zeros((b, h, h, c)), k, s, 0) is not None
    rng = np.random.default_rng(h * c)
    xj = jnp.asarray(_halves(rng, (b, h, h, c)), JAX_DT[dtype])
    want, vjp = jax.vjp(lambda a: jax_pool.maxpool2d(a, k, s), xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TORCH_DT[dtype]).requires_grad_()
    got = pt_pool.maxpool2d(xt, k, s)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    g = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32)).to(TORCH_DT[dtype])
    (dx,) = torch.autograd.grad(got, xt, g)
    (want_dx,) = vjp(jnp.asarray(_np(g), JAX_DT[dtype]))
    np.testing.assert_array_equal(_np(dx), np.asarray(want_dx, np.float32))
    y, taps = pt_pool.maxpool_argmax_reference(xt.detach(), k, s)
    assert torch.equal(y, got)
    if dtype == "f32" or k <= s:
        assert torch.equal(pt_pool.maxpool_bwd_reference(g, taps, h, h, k, s), dx)


@pytest.mark.parametrize("h,k,s,p", [(8, 3, 2, 0), (7, 3, 2, 0), (9, 2, 2, 0), (9, 3, 2, 1),
                                     (10, 3, 3, 0)])
def test_maxpool_undo_matches_jax(h, k, s, p):
    rng = np.random.default_rng(h + 10 * k)
    x = np.maximum(_halves(rng, (3, h, h, 5)), 0.0)  # post-ReLU zeros: ties everywhere
    y = np.array(jax_pool.maxpool2d(jnp.asarray(x), k, s, p))
    g = rng.standard_normal(y.shape).astype(np.float32)
    want = jax_pool.maxpool2d_undo_reference(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g), k, s, p)
    got = pt_pool.maxpool2d_undo_reference(torch.from_numpy(x), torch.from_numpy(y),
                                           torch.from_numpy(g), k, s, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (x == 0).mean() > 0.3


# ---------------------------------------------------------------------------
# The model: LRN -> pool deferral under CONVNET_POOL_LRN_FUSED=1
# ---------------------------------------------------------------------------

NET = """
name: "fuse_train" seed: 7
layer {{ name: "input" num_channels: 8 is_input: true data_field: "input" image_size: 9 }}
layer {{ name: "conv1" num_channels: 8 activation: {act} }}
layer {{ name: "rnorm1" num_channels: 8 }}
layer {{ name: "pool1" num_channels: 8 }}
layer {{ name: "fc" num_channels: 12 activation: RECTIFIED_LINEAR dropprob: {dropprob} }}
layer {{ name: "output" num_channels: 4 is_output: true activation: SOFTMAX
         data_field: "labels" }}
edge {{ source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
        initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.1
        weight_optimizer {{ base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 }}
        bias_optimizer {{ base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 }} }}
edge {{ source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
        add_scale: 0.01 pow_scale: 0.75 frac_of_filters_response_norm: 0.5 }}
edge {{ source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }}
edge {{ source: "pool1" dest: "fc" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1
        weight_optimizer {{ base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 }} }}
edge {{ source: "fc" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1
        weight_optimizer {{ base_epsilon: 0.1 initial_momentum: 0.9 final_momentum: 0.9 }} }}
"""


def _switches(monkeypatch):
    monkeypatch.setenv("CONVNET_POOL_LRN_FUSED", "1")
    # the JAX package's TPU path on the CPU: its max pool and fused kernels
    # in interpret mode, the conv bias deferred into them as the port
    # always does (the port reads only CONVNET_POOL_LRN_FUSED)
    monkeypatch.setenv("CONVNET_POOL_BACKEND", "pallas")
    monkeypatch.setenv("CONVNET_POOL_LRN_BACKEND", "pallas")
    monkeypatch.setenv("CONVNET_LRN_BIAS_FUSED", "1")
    monkeypatch.setenv("CONVNET_LRN_BACKEND", "pallas")


def _batches(n, seed=0, b=8, h=9):
    rng = np.random.default_rng(seed)
    return [{"input": rng.standard_normal((b, h, h, 8)).astype(np.float32),
             "labels": rng.integers(0, 4, (b,)).astype(np.int32)} for _ in range(n)]


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_fused_train_steps_match_jax(monkeypatch):
    """Three f32 train steps with both switches on, from the same numpy
    parameters: every update within 1e-4 of its largest."""
    _switches(monkeypatch)
    jg, g = _graphs(NET.format(act="RECTIFIED_LINEAR", dropprob=0.0))
    fused = _count_calls(monkeypatch, pt_model, "lrn_maxpool_bias")
    jstate = jax_trainer.init_state(jg, seed=0)
    p0 = jax.tree.map(np.asarray, jstate["params"])
    jstep = jax_trainer.make_train_step(jg)
    params = pt_model.params_from_numpy(p0)
    pstate = {"params": params, "moms": pt_optim.init_momentum(params), "step": 0, "seed": 0}
    pstep = pt_trainer.make_train_step(g)
    for batch in _batches(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert len(fused) == 3  # rnorm1 -> pool1 went through lrn_maxpool each step
    for e in g.weighted_edges:
        for k in ("w", "b"):
            before = p0[e.name][k]
            want = np.asarray(jstate["params"][e.name][k]) - before
            got = _np(pstate["params"][e.name][k]) - before
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-4, (e.name, k, err)


def test_fusion_keeps_dropout_keys_and_tie_free_gradients(monkeypatch):
    """On tie-free input (LINEAR conv, continuous values) the all-ties
    gradient equals the single-winner one, so a train step's loss and
    gradients are the same with and without the deferral; that holds with
    a dropout layer after the pool only if the skipped LRN layer still
    counts in the dropout masks' layer index."""
    _, g = _graphs(NET.format(act="LINEAR", dropprob=0.5))
    params = pt_model.params_from_numpy(
        {n: {k: v.numpy() for k, v in p.items()} for n, p in pt_model.init_params(g, 1).items()})
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seed=3)[0].items()}
    layers = pt_model.dropout_layers(g)
    drawn, _ = pt_drop.step_draws_reference(torch.tensor([5, 2]), [(i, 0) for i in layers])
    keys = dict(zip(layers, drawn))

    def loss_and_grads():
        leaves = [params[e.name][k].requires_grad_() for e in g.weighted_edges for k in ("w", "b")]
        loss, _ = pt_model.loss_fn(g, params, batch, train=True, dropout_keys=keys)
        return loss, torch.autograd.grad(loss, leaves)

    l0, g0 = loss_and_grads()
    _switches(monkeypatch)
    fused = _count_calls(monkeypatch, pt_model, "lrn_maxpool_bias")
    l1, g1 = loss_and_grads()
    assert len(fused) == 1
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_fusion_skipped_when_lrn_requested(monkeypatch):
    """A caller asking for the LRN layer's activations gets them: the layer
    materializes and the pool runs unfused (tests/test_fused_pool_lrn.py:177
    is the JAX counterpart)."""
    _switches(monkeypatch)
    _, g = _graphs(NET.format(act="RECTIFIED_LINEAR", dropprob=0.0))
    params = pt_model.init_params(g, 0)
    batch = {"input": torch.from_numpy(_batches(1)[0]["input"])}
    fused = _count_calls(monkeypatch, pt_model, "lrn_maxpool_bias")
    outs = pt_model.apply_fn(g, params, batch, ["rnorm1", "pool1"], train=True)
    assert outs["rnorm1"].shape == (8, 9, 9, 8) and outs["pool1"].shape == (8, 4, 4, 8)
    assert not fused
    pt_model.apply_fn(g, params, batch, ["pool1"], train=True)
    assert len(fused) == 1
    pt_model.apply_fn(g, params, batch, ["pool1"], train=False)  # eval never fuses
    assert len(fused) == 1


# ---------------------------------------------------------------------------
# Rows 8 and 9: the other two forms of the train prologue
# ---------------------------------------------------------------------------

AFFINES = {
    "scale": dict(scale=1 / 255, mean=None, std=None),
    "mean": dict(scale=1 / 255, mean=np.asarray([0.4, 0.5, 0.6], np.float32), std=None),
    "mean+std": dict(scale=1 / 255, mean=np.asarray([0.4, 0.5, 0.6], np.float32),
                     std=np.asarray([0.2, 0.25, 0.3], np.float32)),
}


def _assert_prologue_close(got, want, affine):
    """Array-equal with scale only. With a mean or std, at most 1 bf16 ulp
    of the reference value, with 2e-7 of absolute slack where x*scale
    cancels the mean (tests/test_jitter_gather.py's bar): the JAX forms
    apply v*a + b or fuse the affine into an FMA, the port computes
    ((v*scale) - mean) / std, so the f32 values differ in their last bit
    and a value near 0 can round to another bf16 number."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    if affine == "scale":
        np.testing.assert_array_equal(g, w)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= np.maximum(ulp, 2e-7)).all()


def _crops(rng, b, raw, crop):
    x = rng.integers(0, 256, (b, raw, raw, 3), dtype=np.uint8)
    oy = rng.integers(0, raw - crop + 1, b).astype(np.int32)
    ox = rng.integers(0, raw - crop + 1, b).astype(np.int32)
    flips = rng.random(b) < 0.5
    return x, oy, ox, flips


def _port_s2d(x, oy, ox, flips, kw, affine):
    mean, std = (None if v is None else torch.from_numpy(v) for v in (affine["mean"], affine["std"]))
    return pt_s2d.jitter_s2d(torch.from_numpy(x), torch.from_numpy(oy), torch.from_numpy(ox),
                             torch.from_numpy(flips), scale=affine["scale"], mean=mean, std=std,
                             **kw)


@pytest.mark.parametrize("affine", list(AFFINES))
def test_prologue_form_matches_fused_crop_s2d(affine):
    """Row 8: `prologue.py:_prologue_kernel` (CONVNET_FUSED_PROLOGUE=1), with
    injected crops and flips, at AlexNet's conv1 geometry (k11 s4)."""
    rng = np.random.default_rng(21)
    x, oy, ox, flips = _crops(rng, 8, 44, 35)
    kw = dict(crop=35, kernel=11, stride=4)
    want = jax_prologue.fused_crop_s2d(
        jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox), jnp.asarray(flips), interpret=True,
        **AFFINES[affine], **kw)
    got = _port_s2d(x, oy, ox, flips, kw, AFFINES[affine])
    assert got.stride == want.stride and got.x.shape == want.x.shape
    _assert_prologue_close(got.x, want.x, affine)


@pytest.mark.parametrize("affine", list(AFFINES))
def test_gather_form_matches_jitter_s2d(affine, monkeypatch):
    """Row 9: `jitter_gather.py:_gather_kernel` (CONVNET_JITTER_GATHER=1) at
    the smallest geometry its gates accept: B = 128 (the relayout's lane
    batch), crop 32 / stride 4 (P = 8), offsets in [0, 8]."""
    monkeypatch.setenv("CONVNET_JITTER_GATHER", "1")
    rng = np.random.default_rng(22)
    x, oy, ox, flips = _crops(rng, 128, 40, 32)
    kw = dict(crop=32, kernel=5, stride=4)
    _, p_pad = jax_s2d.relayout_geometry(32, 5, 4)
    from convnet_tpu.ops.jitter_gather import gather_supported

    assert gather_supported(40, 40, 3, 32, 4, p_pad, AFFINES[affine]["mean"],
                            AFFINES[affine]["std"])
    want = jax_s2d.jitter_s2d(jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox),
                              jnp.asarray(flips), interpret=True, **AFFINES[affine], **kw)
    got = _port_s2d(x, oy, ox, flips, kw, AFFINES[affine])
    assert got.x.shape == want.x.shape
    _assert_prologue_close(got.x, want.x, affine)
