"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the repository's conftest imports JAX, hence `--noconftest`):

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

Tests that need a card skip without one; chip_smoke.py makes the same
comparisons at the serving and train paths' full shapes.
"""

import numpy as np
import pytest
import torch

from convnet_tpu_torch.ops import _build
from convnet_tpu_torch.ops import conv
from convnet_tpu_torch.ops import dropout as drop
from convnet_tpu_torch.ops import fused_pool_lrn as plrn
from convnet_tpu_torch.ops import lrn
from convnet_tpu_torch.ops import pool
from convnet_tpu_torch.ops import s2d_relayout as s2d
from convnet_tpu_torch.ops import copy_add as ca
from convnet_tpu_torch.ops import gather
from convnet_tpu_torch.tools import gather_probe as gp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py runs this check on the H100")
    return torch.device("cuda")


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i >= 0, i, -32768 - i)

    return int((ordered(a) - ordered(b)).abs().max().item())


# The bf16 bars of the two backward kernels (chip_smoke.py's LRN_BWD_ULPS and
# POOL_LRN_BWD_ULPS): the largest kernel-to-plain distance that
# `chip_smoke.py --ulp-study 16` measured on an NVIDIA H100 80GB HBM3, over 16
# seeds at rnorm1, rnorm2 and (3001, 100) and at both LRN -> pool chains.
LRN_BWD_ULPS = 1
POOL_LRN_BWD_ULPS = 1


def _lrn_bwd_f64(g, z, n, alpha, beta, bias, relu, blocked):
    """dx of the LRN backward in float64 by the plain chain's formula, the
    powers from pow (chip_smoke.py's lrn_bwd_f64)."""
    zf = z.double() if bias is None else z.double() + bias.double()
    x = torch.relu(zf) if relu else zf
    d = 1.0 + alpha * lrn._window_sum(x * x, n, blocked)
    inner = lrn._window_sum(g.double() * x * d ** -(beta + 1.0), n, blocked, transpose=True)
    dx = g.double() * d ** -beta - 2.0 * alpha * beta * x * inner
    return torch.where(zf > 0.0, dx, 0.0) if relu else dx


def assert_bf16_close(kernel, plain, ref64, kernel_to_plain):
    """The bf16 bar of a backward kernel (chip_smoke.py's expect_bf16_close):
    kernel and plain version each round an f32 chain once, in their own
    order, so the kernel is held to the plain version by the largest
    distance measured over many seeds, and to float64 by the plain
    version's own distance on these inputs plus that allowance."""
    ref = ref64.float().to(torch.bfloat16)
    assert bf16_ulps(kernel, plain) <= kernel_to_plain
    assert bf16_ulps(kernel, ref) <= bf16_ulps(plain, ref) + kernel_to_plain


# ---------------------------------------------------------------------------
# On any machine: the wrappers' CPU route and the build's bookkeeping
# ---------------------------------------------------------------------------


def test_lrn_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.standard_normal((50, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    before = lrn.LAUNCHES
    y = lrn.lrn_fwd(z, 5, 1e-4 / 5, 0.75, bias=b, relu=True)
    ref = lrn.response_norm_reference(z, 1e-4, 0.75, 5 / 96, bias=b, relu=True)
    assert torch.equal(y, ref)
    assert lrn.LAUNCHES == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="bias shape"):
        lrn.lrn_fwd(z, 5, 1e-4, 0.75, bias=b[:10])
    with pytest.raises(ValueError, match="rows"):
        lrn.lrn_fwd(z[None], 5, 1e-4, 0.75)


def test_prologue_wrapper_takes_the_plain_version_on_cpu():
    x = torch.randint(0, 256, (2, 12, 12, 3), dtype=torch.uint8)
    off = torch.full((2,), 1, dtype=torch.int32)
    before = s2d.LAUNCHES
    kw = dict(crop=9, stride=4, p=s2d.relayout_geometry(9, 5, 4), scale=1 / 255)
    out = s2d.s2d_prologue(x, off, off, None, **kw)
    assert out.shape == (2, 3, 3, 48) and out.dtype == torch.bfloat16
    assert torch.equal(out, s2d.s2d_prologue_reference(x, off, off, None, **kw))
    assert s2d.LAUNCHES == before
    # the third grid row/column lies past the 9-pixel crop: exactly zero
    assert (out.view(2, 3, 3, 4, 4, 3)[:, 2, :, 1:] == 0).all()
    with pytest.raises(TypeError, match="uint8"):
        s2d.s2d_prologue(x.float(), off, off, None, **kw)
    with pytest.raises(ValueError, match="mean"):
        s2d.s2d_prologue(x, off, off, None, mean=torch.zeros(4), **{**kw, "scale": 1.0})
    with pytest.raises(ValueError, match="ox outside"):
        s2d.s2d_prologue(x, off, off + 3, None, **kw)


def test_library_is_keyed_by_the_sources():
    path = _build._library_path()
    assert path == _build._library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    names = {p.name for p in _build._sources()}
    assert names == {"lrn_fwd.cu", "lrn_bwd.cu", "dropout.cu", "s2d_prologue.cu",
                     "maxpool_fwd.cu", "pool_lrn.cu", "copy_add.cu", "crop_window.cu",
                     "relayout.cu", "crop_deinterleave.cu"}
    # the shared headers are hashed too: editing one builds a new library
    assert {p.name for p in _build._hashed_files()} == names | {"lrn_math.cuh", "dtype.cuh",
                                                                     "stage.cuh", "span.cuh"}
    assert set(_build._SIGNATURES) == {"cn_lrn_fwd", "cn_lrn_bwd", "cn_dropout", "cn_step_draws",
                                       "cn_s2d_prologue", "cn_maxpool_fwd", "cn_pool_lrn_fwd",
                                       "cn_pool_lrn_bwd", "cn_copy_add", "cn_crop_window",
                                       "cn_relayout", "cn_crop_deinterleave"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_kernel_names_match_the_sources():
    """Each wrapper's pattern (ops.KERNEL_NAMES, read by traces) names a
    __global__ function of csrc/; relayout's, both of its routes."""
    import re

    from convnet_tpu_torch.ops import KERNEL_NAMES

    kernels = set()
    for src in _build._hashed_files():
        kernels |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                  src.read_text()))
    for name, pattern in KERNEL_NAMES.items():
        assert any(re.search(pattern, k) for k in kernels), name
    assert {k for k in kernels if re.search(KERNEL_NAMES["relayout"], k)} == {
        "relayout_run_kernel", "relayout_tile_kernel"}


@pytest.mark.parametrize("beta,q", [(0.75, 3), (1.0, 4), (1.25, 5), (0.6, 0), (5.0, 0)])
def test_quarter_power(beta, q):
    assert lrn.quarter_power(beta) == q
    d = torch.linspace(1.0, 9.0, 17)
    torch.testing.assert_close(lrn._neg_pow(d, beta), d ** -beta, rtol=1e-6, atol=0)


def test_lrn_bwd_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((40, 96)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((40, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    before = lrn.BWD_LAUNCHES
    dx, db = lrn.lrn_bwd(g, z, 5, 1e-4 / 5, 0.75, bias=b, relu=True)
    want_dx, want_db = lrn._bwd_math(g, z, 5, 1e-4 / 5, 0.75, b, True)
    assert torch.equal(dx, want_dx) and torch.equal(db, want_db)
    assert lrn.lrn_bwd(g, z, 5, 1e-4 / 5, 0.75)[1] is None  # no bias, no db
    assert lrn.BWD_LAUNCHES == before
    with pytest.raises(ValueError, match="g shape"):
        lrn.lrn_bwd(g[:10], z, 5, 1e-4, 0.75)


def test_pool_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(3)
    z = torch.from_numpy((np.round(rng.standard_normal((2, 7, 7, 16)) * 2) / 2).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 3, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    before = (pool.LAUNCHES, plrn.LAUNCHES, plrn.BWD_LAUNCHES)
    assert torch.equal(pool.maxpool_fwd(z, 3, 2), pool.maxpool_reference(z, 3, 2))
    m = plrn.pool_lrn_fwd(z, 5, 0.2, 0.75, 3, 2, bias=b, relu=True)
    assert torch.equal(m, pool.maxpool_reference(lrn._fwd_math(z, 5, 0.2, 0.75, b, True), 3, 2))
    dz, db = plrn.pool_lrn_bwd(g, m, z, 5, 0.2, 0.75, 3, 2, bias=b, relu=True)
    want_dz, want_db = plrn._bwd_reference(g, m, z, 5, 0.2, 0.75, 3, 2, b, True)
    assert torch.equal(dz, want_dz) and torch.equal(db, want_db)
    assert (pool.LAUNCHES, plrn.LAUNCHES, plrn.BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="pooled shape"):
        plrn.pool_lrn_bwd(g[:, :2], m, z, 5, 0.2, 0.75, 3, 2)
    with pytest.raises(ValueError, match="padding 0"):
        plrn.lrn_maxpool(z, 1.0, 0.75, 5 / 16, False, 3, 2, 1)


def test_dropout_wrapper_takes_the_plain_version_on_cpu():
    x = torch.randn(8, 1, 1, 64)
    key = drop.dropout_key(1, 2, 3)
    before = drop.LAUNCHES
    assert torch.equal(drop.dropout_apply(x, 0.5, key), drop.dropout_reference(x, 0.5, key))
    assert drop.LAUNCHES == before
    with pytest.raises(ValueError, match="rate"):
        drop.dropout_apply(x, 1.0, key)
    with pytest.raises(ValueError, match="multiple of 4"):
        drop.dropout_apply(x, 0.5, key, offset=2)


def test_copy_add_wrapper_takes_the_plain_version_on_cpu():
    a, b = (torch.randn(6, 24).to(torch.bfloat16) for _ in range(2))
    before = ca.LAUNCHES
    assert torch.equal(ca.copy_add(a, b, 4, 8), a + b)
    assert ca.LAUNCHES == before


# ---------------------------------------------------------------------------
# On a card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,tile_rows,tile_cols", [
    (1001, 1000, 16, None), (1001, 1000, 16, 128), (1001, 1000, 7, 128), (64, 1024, 128, 128),
    (5, 8, 1, 8), (3, 2048, 2, 1024)])
def test_copy_add_kernel_matches_plain(cuda, m, n, tile_rows, tile_cols):
    """The copy kernel array-equal to a + b: short last row and column
    tiles, a tile taller than the array, one word a row."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    a, b = (torch.randn((m, n), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = ca.LAUNCHES
    got = ca.copy_add(a, b, tile_rows, tile_cols)
    assert ca.LAUNCHES == before + 1
    assert torch.equal(got, a + b)


def test_copy_add_kernel_refuses_what_it_does_not_take(cuda):
    buf = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    a = buf[:8 * 64].view(8, 64)
    before = ca.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        ca.copy_add(buf[1:1 + 8 * 64].view(8, 64), a)
    with pytest.raises(ValueError, match="contiguous"):
        ca.copy_add(a.t().contiguous().t(), a)
    with pytest.raises(ValueError, match="multiples of 8"):
        ca.copy_add(buf[:8 * 60].view(8, 60), buf[:8 * 60].view(8, 60))
    with pytest.raises(ValueError, match="multiples of 8"):
        ca.copy_add(a, a, 4, 12)
    assert ca.LAUNCHES == before


@pytest.mark.parametrize("c", [96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias,relu,blocked", [(True, True, False), (False, False, False),
                                               (True, True, True)])
def test_lrn_kernel_matches_plain(cuda, c, dtype, bias, relu, blocked):
    gen = torch.Generator(device=cuda).manual_seed(c)
    z = (2.0 * torch.randn((3000, c), generator=gen, device=cuda)).to(dtype)
    b = 0.5 * torch.randn((c,), generator=gen, device=cuda) if bias else None
    before = lrn.LAUNCHES
    y = lrn.lrn_fwd(z, 5, 0.2, 0.75, bias=b, relu=relu, blocked=blocked)
    assert lrn.LAUNCHES == before + 1
    ref = lrn._fwd_math(z, 5, 0.2, 0.75, b, relu, blocked)
    assert y.dtype == dtype and y.shape == z.shape
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=0)
    else:
        assert bf16_ulps(y, ref) <= 1


def test_lrn_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.zeros((8, 16), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        lrn.lrn_fwd(z.half(), 5, 0.2, 0.75)
    with pytest.raises(ValueError, match="contiguous"):
        lrn.lrn_fwd(torch.zeros((16, 8), device=cuda).t(), 5, 0.2, 0.75)
    with pytest.raises(TypeError, match="bias"):
        lrn.lrn_fwd(z, 5, 0.2, 0.75, bias=torch.zeros(16, device=cuda).half())


@pytest.mark.parametrize("flip,std", [(False, False), (True, True)])
def test_s2d_kernel_matches_plain(cuda, flip, std):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(0, 256, (8, 40, 40, 3), generator=gen, device=cuda, dtype=torch.uint8)
    oy = torch.randint(0, 6, (8,), generator=gen, device=cuda, dtype=torch.int32)
    ox = torch.randint(0, 6, (8,), generator=gen, device=cuda, dtype=torch.int32)
    flips = torch.randint(0, 2, (8,), generator=gen, device=cuda).bool() if flip else None
    kw = dict(
        crop=35, stride=4, p=s2d.relayout_geometry(35, 11, 4), scale=1 / 255,
        mean=torch.tensor([0.4, 0.5, 0.6], device=cuda),
        std=torch.tensor([0.2, 0.25, 0.3], device=cuda) if std else None,
    )
    before = s2d.LAUNCHES
    got = s2d.s2d_prologue(x, oy, ox, flips, **kw)
    assert s2d.LAUNCHES == before + 1
    assert torch.equal(got, s2d.s2d_prologue_reference(x, oy, ox, flips, **kw))


# The prologue kernel's cases, (b, raw, c, crop, kernel, stride, flip, std,
# offset): random origins, so most crop rows start off a 16-byte boundary;
# flips; a std; C = 1 and C = 3; B = 1; crop < P*s (the ceil-mode pad:
# 35 < 9*4, 29 < 15*2) and crop > P*s (17 > 5*3, columns left unread);
# AlexNet's crop; rows of P*s*s*C elements that are no whole number of
# 16-byte words (5 * 45, element-wise stores); and an x that starts one
# byte past a 16-byte boundary (offset 1: the first and last staged words
# reach past x and are copied byte by byte).
S2D_CASES = [
    (8, 40, 3, 35, 11, 4, False, False, 0),
    (8, 40, 3, 35, 11, 4, True, True, 0),
    (1, 40, 3, 35, 11, 4, True, False, 0),
    (8, 40, 1, 36, 8, 4, True, True, 0),
    (4, 33, 3, 29, 5, 2, False, True, 0),
    (4, 256, 3, 224, 11, 4, True, False, 0),
    (3, 20, 5, 17, 3, 3, True, True, 0),
    (5, 40, 3, 35, 11, 4, True, True, 1),
]


@pytest.mark.parametrize("b,raw,c,crop,kernel,stride,flip,std,offset", S2D_CASES)
def test_s2d_kernel_paths(cuda, b, raw, c, crop, kernel, stride, flip, std, offset):
    gen = torch.Generator(device=cuda).manual_seed(b * raw + c)
    n = b * raw * raw * c
    buf = torch.randint(0, 256, (n + offset,), generator=gen, device=cuda, dtype=torch.uint8)
    x = buf[offset:].view(b, raw, raw, c)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    oy = torch.randint(0, raw - crop + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    ox = torch.randint(0, raw - crop + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    flips = torch.randint(0, 2, (b,), generator=gen, device=cuda).bool() if flip else None
    kw = dict(
        crop=crop, stride=stride, p=s2d.relayout_geometry(crop, kernel, stride), scale=1 / 255,
        mean=0.5 * torch.rand((c,), generator=gen, device=cuda),
        std=0.1 + torch.rand((c,), generator=gen, device=cuda) if std else None,
    )
    before = s2d.LAUNCHES
    got = s2d.s2d_prologue(x, oy, ox, flips, **kw)
    assert s2d.LAUNCHES == before + 1
    assert torch.equal(got, s2d.s2d_prologue_reference(x, oy, ox, flips, **kw))


def test_s2d_kernel_marks_crops_outside_the_image(cuda):
    x = torch.zeros((2, 12, 12, 3), dtype=torch.uint8, device=cuda)
    off = torch.tensor([0, 5], dtype=torch.int32, device=cuda)  # 5 > 12 - 9
    out = s2d.s2d_prologue(x, off, off, None, crop=9, stride=4, p=s2d.relayout_geometry(9, 5, 4))
    assert not torch.isnan(out[0].float()).any()
    assert torch.isnan(out[1].float()).any()


def _lrn_bwd_inputs(cuda, c, dtype, seed, m=3000):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    z = (2.0 * torch.randn((m, c), generator=gen, device=cuda)).to(dtype)
    g = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    b = 0.5 * torch.randn((c,), generator=gen, device=cuda)
    return g, z, b


@pytest.mark.parametrize("c", [96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias,relu,blocked", [(True, True, False), (False, False, False),
                                               (False, True, False), (True, True, True)])
def test_lrn_bwd_kernel_matches_plain(cuda, c, dtype, bias, relu, blocked):
    g, z, b = _lrn_bwd_inputs(cuda, c, dtype, c + 1)
    b = b if bias else None
    alpha = 1e-4 / 5  # AlexNet's: no cancellation in dx, so bf16 holds 1 ulp
    before = lrn.BWD_LAUNCHES
    dx, db = lrn.lrn_bwd(g, z, 5, alpha, 0.75, bias=b, relu=relu, blocked=blocked)
    assert lrn.BWD_LAUNCHES == before + 1
    want_dx, want_db = lrn._bwd_math(g, z, 5, alpha, 0.75, b, relu, blocked)
    assert dx.dtype == dtype and dx.shape == z.shape
    if dtype == torch.float32:
        torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=3e-5 * want_dx.abs().max().item())
    else:
        assert_bf16_close(dx, want_dx, _lrn_bwd_f64(g, z, 5, alpha, 0.75, b, relu, blocked),
                          LRN_BWD_ULPS)
    if bias:
        # the kernel sums the f32 dx: against a float64 sum of the plain f32 dx
        ref = lrn._bwd_math(g.float(), z.float(), 5, alpha, 0.75, b, relu, blocked)[0].double()
        torch.testing.assert_close(db.double(), ref.sum(0), rtol=1e-4,
                                   atol=1e-5 * ref.abs().sum(0).max().item())
        again = lrn.lrn_bwd(g, z, 5, alpha, 0.75, bias=b, relu=relu, blocked=blocked)[1]
        assert torch.equal(db, again)  # no atomics: the same sums every run
    else:
        assert db is None


def test_lrn_bwd_kernel_f32_large_alpha(cuda):
    g, z, b = _lrn_bwd_inputs(cuda, 96, torch.float32, 9)
    dx, db = lrn.lrn_bwd(g, z, 5, 1.0 / 5, 0.75, bias=b, relu=True)
    want_dx, want_db = lrn._bwd_math(g, z, 5, 1.0 / 5, 0.75, b, True)
    torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=3e-5 * want_dx.abs().max().item())
    torch.testing.assert_close(db, want_db, rtol=1e-4, atol=1e-5 * want_dx.abs().sum(0).max().item())


def test_lrn_autograd_runs_both_kernels(cuda):
    g, z, b = _lrn_bwd_inputs(cuda, 256, torch.bfloat16, 4, m=2 * 27 * 27)
    x = z.view(2, 27, 27, 256).clone().requires_grad_()
    bb = b.clone().requires_grad_()
    before = (lrn.LAUNCHES, lrn.BWD_LAUNCHES)
    y = lrn.response_norm_cross_map_bias(x, bb, 1e-4, 0.75, 5 / 256, False, True)
    dx, db = torch.autograd.grad(y, (x, bb), g.view(2, 27, 27, 256))
    assert (lrn.LAUNCHES, lrn.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want_dx, want_db = lrn._bwd_math(g, z, 5, 1e-4 / 5, 0.75, b, True)
    assert bf16_ulps(dx.reshape(-1, 256), want_dx) <= LRN_BWD_ULPS
    assert db.dtype == torch.float32
    torch.testing.assert_close(db, want_db, rtol=1e-4, atol=1e-5 * want_dx.abs().sum(0).max().item())


# Shapes for the LRN kernels' code paths, (m, c, n): C = 64, 96 and 256 on
# the backward's vector path (8 bf16 or 4 f32 channels a thread); C = 100
# on it in f32 but on the one-channel path in bf16 (200-byte rows); C = 3
# on the one-channel path; M = 1, and M = 3001, a multiple of no tile's
# rows; n = 16 (CIFAR-10's) and blocked windows take the generic window.
LRN_PATH_SHAPES = [(3001, 64, 5), (3001, 64, 16), (3001, 96, 5), (1, 96, 5), (3001, 256, 5),
                   (1, 256, 5), (3001, 100, 5), (3001, 3, 5), (1, 3, 5)]
LRN_BIAS_CASES = [(True, True, False), (False, False, False), (False, True, False),
                  (True, True, True)]


def _assert_lrn_fwd(z, n, alpha, b, relu, blocked):
    before = lrn.LAUNCHES
    y = lrn.lrn_fwd(z, n, alpha, 0.75, bias=b, relu=relu, blocked=blocked)
    assert lrn.LAUNCHES == before + 1
    ref = lrn._fwd_math(z, n, alpha, 0.75, b, relu, blocked)
    assert y.dtype == z.dtype and y.shape == z.shape
    if z.dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=0)
    else:
        assert bf16_ulps(y, ref) <= 1


def _assert_lrn_bwd(g, z, n, alpha, b, relu, blocked):
    before = lrn.BWD_LAUNCHES
    dx, db = lrn.lrn_bwd(g, z, n, alpha, 0.75, bias=b, relu=relu, blocked=blocked)
    assert lrn.BWD_LAUNCHES == before + 1
    want_dx, _ = lrn._bwd_math(g, z, n, alpha, 0.75, b, relu, blocked)
    assert dx.dtype == z.dtype and dx.shape == z.shape
    if z.dtype == torch.float32:
        torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=3e-5 * want_dx.abs().max().item())
    else:
        assert_bf16_close(dx, want_dx, _lrn_bwd_f64(g, z, n, alpha, 0.75, b, relu, blocked),
                          LRN_BWD_ULPS)
    if b is None:
        assert db is None
        return
    ref = lrn._bwd_math(g.float(), z.float(), n, alpha, 0.75, b, relu, blocked)[0].double()
    torch.testing.assert_close(db.double(), ref.sum(0), rtol=1e-4,
                               atol=1e-5 * ref.abs().sum(0).max().item())
    again = lrn.lrn_bwd(g, z, n, alpha, 0.75, bias=b, relu=relu, blocked=blocked)[1]
    assert torch.equal(db, again)


@pytest.mark.parametrize("m,c,n", LRN_PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias,relu,blocked", LRN_BIAS_CASES)
def test_lrn_kernels_on_every_path(cuda, m, c, n, dtype, bias, relu, blocked):
    """Both LRN kernels against their plain versions on each code path of
    the backward (the bars of test_lrn_kernel_matches_plain and
    test_lrn_bwd_kernel_matches_plain)."""
    g, z, b = _lrn_bwd_inputs(cuda, c, dtype, m + c + n, m)
    b = b if bias else None
    _assert_lrn_fwd(z, n, 0.2, b, relu, blocked)
    _assert_lrn_bwd(g, z, n, 1e-4 / n, b, relu, blocked)


# The forward kernel's code paths, (m, c, n, beta, blocked): the register
# path (sliding n = 5, beta = 0.75) with 1 to 256 chunks a row (bf16 C = 8
# is one chunk of 8 channels, so every halo is clipped; C = 2048 is 256,
# one row a pass); the generic path past 256 chunks (C = 2056), for n = 3,
# beta = 0.6 and blocked windows; one channel a thread for bf16 C = 100 and
# C = 3; M = 1 (fewer passes than the grid has blocks) and M = 3001 (a
# short last pass).
LRN_FWD_PATHS = [
    (3001, 96, 5, 0.75, False), (3001, 256, 5, 0.75, False), (3001, 8, 5, 0.75, False),
    (3001, 16, 5, 0.75, False), (777, 2048, 5, 0.75, False), (257, 2056, 5, 0.75, False),
    (1, 96, 5, 0.75, False), (3001, 100, 5, 0.75, False), (3001, 3, 5, 0.75, False),
    (3001, 96, 3, 0.75, False), (3001, 96, 5, 0.6, False), (3001, 96, 5, 0.75, True),
    (3001, 100, 3, 0.6, False),
]


@pytest.mark.parametrize("m,c,n,beta,blocked", LRN_FWD_PATHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_lrn_fwd_kernel_paths(cuda, m, c, n, beta, blocked, dtype, bias):
    gen = torch.Generator(device=cuda).manual_seed(m + c + n)
    z = (2.0 * torch.randn((m, c), generator=gen, device=cuda)).to(dtype)
    b = 0.5 * torch.randn((c,), generator=gen, device=cuda) if bias else None
    before = lrn.LAUNCHES
    y = lrn.lrn_fwd(z, n, 0.2, beta, bias=b, relu=bias, blocked=blocked)
    assert lrn.LAUNCHES == before + 1
    ref = lrn._fwd_math(z, n, 0.2, beta, b, bias, blocked)
    assert y.dtype == dtype and y.shape == z.shape
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=0)
    else:
        assert bf16_ulps(y, ref) <= 1


@pytest.mark.parametrize("m,c,n,beta,blocked", LRN_FWD_PATHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_fwd_is_lrn_y_bit_for_bit(cuda, m, c, n, beta, blocked, dtype):
    """The fused LRN -> max pool forward with a 1x1 pool writes lrn_y, the
    chain pool_lrn.cu's backward recomputes to find its ties: lrn_fwd must
    give the same bits on every path."""
    gen = torch.Generator(device=cuda).manual_seed(7 * m + c)
    z = (2.0 * torch.randn((m, 1, 1, c), generator=gen, device=cuda)).to(dtype)
    b = 0.5 * torch.randn((c,), generator=gen, device=cuda)
    kw = dict(bias=b, relu=True, blocked=blocked)
    y = lrn.lrn_fwd(z.view(m, c), n, 0.2, beta, **kw)
    assert torch.equal(y.view(z.shape), plrn.pool_lrn_fwd(z, n, 0.2, beta, 1, 1, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_kernels_unaligned_rows(cuda, dtype):
    """C = 96 rows whose bytes fit the vector path but which start 8 bytes
    past a 16-byte boundary: the backward takes the one-channel path."""
    m, c = 3001, 96
    gen = torch.Generator(device=cuda).manual_seed(8)

    def unaligned(scale):
        buf = torch.empty((m * c + 8,), dtype=dtype, device=cuda)
        t = buf[8 // buf.element_size():][: m * c].view(m, c)
        t.copy_(scale * torch.randn((m, c), generator=gen, device=cuda))
        assert t.is_contiguous() and t.data_ptr() % 16 == 8
        return t

    z, g = unaligned(2.0), unaligned(1.0)
    b = 0.5 * torch.randn((c,), generator=gen, device=cuda)
    for bias, relu, blocked in LRN_BIAS_CASES:
        _assert_lrn_fwd(z, 5, 0.2, b if bias else None, relu, blocked)
        _assert_lrn_bwd(g, z, 5, 1e-4 / 5, b if bias else None, relu, blocked)


@pytest.mark.parametrize("c", [96, 256])
def test_lrn_bwd_db_same_on_every_run(cuda, c):
    """Enough rows that every block of the backward's persistent grid walks
    many tiles: db, summed per thread across tiles and then per block in a
    fixed order, is the same in three runs."""
    g, z, b = _lrn_bwd_inputs(cuda, c, torch.bfloat16, 12, m=128 * 27 * 27)
    dbs = [lrn.lrn_bwd(g, z, 5, 1e-4 / 5, 0.75, bias=b, relu=True)[1] for _ in range(3)]
    assert all(torch.equal(dbs[0], d) for d in dbs[1:])
    ref = lrn._bwd_math(g.float(), z.float(), 5, 1e-4 / 5, 0.75, b, True)[0].double()
    torch.testing.assert_close(dbs[0].double(), ref.sum(0), rtol=1e-4,
                               atol=1e-5 * ref.abs().sum(0).max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,start", [(1, 0), (7, 0), (8, 0), (9, 0), (4099, 0), (4099, 1),
                                     (4096, 3)])
def test_dropout_kernel_tails_and_unaligned(cuda, dtype, n, start):
    """The dropout kernel's element-wise paths: a last group of fewer than 8
    elements, and an x (start > 0) that is not 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    buf = torch.randn((n + start,), generator=gen, device=cuda).to(dtype)
    x = buf[start:]
    assert (x.data_ptr() % 16 != 0) == (start > 0)
    key = drop.dropout_key(3, 1, 4)
    before = drop.LAUNCHES
    y = drop.dropout_apply(x, 0.5, key, offset=12)
    assert drop.LAUNCHES == before + 1
    assert torch.equal(y, drop.dropout_reference(x, 0.5, key, offset=12))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((128, 4096), 0), ((7, 33), 8)])
def test_dropout_kernel_bit_equal_to_plain(cuda, dtype, shape, offset):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    key = drop.dropout_key(11, 5, 13)
    before = drop.LAUNCHES
    y = drop.dropout_apply(x, 0.5, key, offset)
    assert drop.LAUNCHES == before + 1
    assert torch.equal(y, drop.dropout_reference(x, 0.5, key, offset))


def test_dropout_kernel_masks_agree_fwd_bwd(cuda):
    x = torch.randn((128, 1, 1, 4096), device=cuda, dtype=torch.bfloat16).requires_grad_()
    y = drop.dropout(x, 0.5, drop.dropout_key(4, 9, 12))
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(y != 0, gx != 0)
    assert torch.equal(gx[gx != 0], torch.full_like(gx[gx != 0], 2.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_offset_through_autograd(cuda, dtype):
    """A rank's rows through dropout(..., offset), forward and backward,
    are the rows of the whole batch through dropout(...): the element
    offset of a batch split over a mesh's data axis."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, f, data = 128, 4096, 4
    x = torch.randn((b, f), generator=gen, device=cuda).to(dtype)
    g = torch.randn((b, f), generator=gen, device=cuda).to(dtype)
    key = torch.tensor(drop.dropout_key(7, 3, 12), dtype=torch.int64, device=cuda)
    xw = x.clone().requires_grad_()
    yw = drop.dropout(xw, 0.5, key)
    (dw,) = torch.autograd.grad(yw, xw, g)
    rows = b // data
    before = drop.LAUNCHES
    for d in range(data):
        xr = x[d * rows:(d + 1) * rows].clone().requires_grad_()
        yr = drop.dropout(xr, 0.5, key, offset=d * rows * f)
        (dr,) = torch.autograd.grad(yr, xr, g[d * rows:(d + 1) * rows])
        assert torch.equal(yr, yw[d * rows:(d + 1) * rows].detach())
        assert torch.equal(dr, dw[d * rows:(d + 1) * rows])
    assert drop.LAUNCHES == before + 2 * data


@pytest.mark.parametrize("data", [2, 4])
def test_step_draws_kernel_rows_of_the_global_draw(cuda, data):
    """The step-draws kernel's crops for rows row0 .. row0 + b - 1 are those
    rows of one draw for the whole batch, and the plain version's."""
    from convnet_tpu_torch.data.jitter import crop_draw

    state = torch.tensor([11, 5], dtype=torch.int64, device=cuda)
    whole = drop.step_draws(state, [(3, 0)], crop_draw("input", 128, 256, 256, 224, True, True))
    b = 128 // data
    for d in range(data):
        draw = crop_draw("input", b, 256, 256, 224, True, True, d * b)
        keys, crops = drop.step_draws(state, [(3, 0)], draw)
        plain = drop.step_draws_reference(state, [(3, 0)], draw)
        assert torch.equal(keys, whole[0]) and torch.equal(keys, plain[0])
        for got, w, p in zip(crops, whole[1], plain[1]):
            assert torch.equal(got, w[d * b:(d + 1) * b]) and torch.equal(got, p)


def test_f32_conv_gradients_exact(cuda):
    """conv2's shape in f32: with TF32 left on for dgrad/wgrad the
    gradients would miss a float64 computation by about 1e-3."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((16, 27, 27, 96), generator=gen, device=cuda)
    w = 0.05 * torch.randn((5, 5, 96, 256), generator=gen, device=cuda)
    gy = torch.randn((16, 27, 27, 256), generator=gen, device=cuda)
    grads = []
    for dt in (torch.float32, torch.float64):
        xx = x.to(dt).requires_grad_()
        ww = w.to(dt).requires_grad_()
        grads.append(torch.autograd.grad(conv.conv2d(xx, ww, 1, 2), (xx, ww), gy.to(dt)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


# ---------------------------------------------------------------------------
# The max pool and the fused LRN -> max pool kernels
# ---------------------------------------------------------------------------


def _halves(gen, shape, cuda, dtype):
    """Values on a grid of halves: many equal window maxima, as post-ReLU
    zeros and quantized activations give (tests/test_fused_pool_lrn.py:49)."""
    return (torch.round(2.0 * torch.randn(shape, generator=gen, device=cuda)) / 2).to(dtype)


_INTS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
# quiet and signalling NaNs of both signs and other payloads (chip_smoke.py's NAN_BITS)
_NAN_BITS = {torch.bfloat16: (0x7FC0, -64, 0x7F81, -91),
             torch.float32: (0x7FC00000, -4194304, 0x7F800001, -8388607)}


def _same_bits(a, b):
    """Bit for bit: NaN payloads and the sign of zero count."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(_INTS[a.dtype]), b.contiguous().view(_INTS[b.dtype]))


def _plant_nans(gen, x, share=0.02):
    bits = torch.tensor(_NAN_BITS[x.dtype], dtype=_INTS[x.dtype], device=x.device)
    n = max(1, int(share * x.numel()))
    at = torch.randint(0, x.numel(), (n,), generator=gen, device=x.device)
    pick = torch.randint(0, len(bits), (n,), generator=gen, device=x.device)
    x.view(_INTS[x.dtype]).view(-1)[at] = bits[pick]
    return x


def _at_offset(x, elements):
    """x copied into a contiguous view `elements` elements into its storage:
    1 leaves it off a 16-byte boundary."""
    if not elements:
        return x
    base = torch.empty(x.numel() + elements, dtype=x.dtype, device=x.device)
    view = base[elements:].view(x.shape)
    view.copy_(x)
    return view


MAXPOOL_CASES = [  # (h, c, k, s, pad)
    (55, 96, 3, 2, 0), (27, 256, 3, 2, 0), (13, 256, 3, 2, 0),  # AlexNet's pools
    (14, 100, 3, 2, 1),  # no whole 16-byte words in bf16; padding; ceil-mode last window
    (8, 16, 2, 2, 0), (9, 8, 3, 2, 1), (10, 24, 3, 3, 0), (6, 1, 3, 2, 0),
    (7, 8, 5, 1, 2), (6, 3, 4, 3, 1),  # k outside the compiled 2 and 3
]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,k,s,p", MAXPOOL_CASES)
def test_maxpool_kernel_matches_plain(cuda, dtype, h, c, k, s, p, offset):
    """Bit for bit on tie-heavy inputs (halves: -0 and +0 among them) with
    planted NaNs, from aligned tensors and from views off a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(h + c + k)
    x = _plant_nans(gen, _halves(gen, (4, h, h, c), cuda, dtype))
    want = pool.maxpool_reference(x, k, s, p)
    before = pool.LAUNCHES
    y = pool.maxpool_fwd(_at_offset(x, offset), k, s, p)
    assert pool.LAUNCHES == before + 1
    assert _same_bits(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 5])
def test_maxpool_kernel_keeps_the_first_zero_and_the_last_nan(cuda, dtype, c):
    """Every 3x3 window of a 13x13 input holds -0 and +0 above -1, in one
    order and then the other, then two NaNs of other payloads: the kernel
    keeps the first zero and the last NaN, as ATen's scan does."""
    x = torch.full((2, 13, 13, c), -1.0, device=cuda, dtype=dtype)
    for first, second in ((-0.0, 0.0), (0.0, -0.0)):
        x[:, 0::2, 0::2] = first  # a window's first tap is at an even row and column
        x[:, 1::2, 1::2] = second
        want = pool.maxpool_reference(x, 3, 2)
        assert torch.equal(want.signbit(), torch.full_like(want, first).signbit())
        assert _same_bits(pool.maxpool_fwd(x, 3, 2), want)
    ints = x.view(_INTS[dtype])
    nans = _NAN_BITS[dtype]
    ints[:, 0::2, 0::2] = nans[0]
    ints[:, 1::2, 1::2] = nans[1]
    want = pool.maxpool_reference(x, 3, 2)
    assert _same_bits(pool.maxpool_fwd(x, 3, 2), want)
    assert _same_bits(pool.maxpool_fwd(_at_offset(x, 1), 3, 2), want)


def test_maxpool_switch_keeps_the_single_winner_gradient(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _halves(gen, (4, 13, 13, 32), cuda, torch.bfloat16)
    g = torch.randn((4, 6, 6, 32), generator=gen, device=cuda).to(torch.bfloat16)
    xx = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(pool.maxpool2d(xx, 3, 2), xx, g)
    monkeypatch.setenv("CONVNET_POOL_BACKEND", "pallas")
    before = pool.LAUNCHES
    xx = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(pool.maxpool2d(xx, 3, 2), xx, g)
    assert pool.LAUNCHES == before + 1
    assert torch.equal(got, want)


POOL_LRN_CASES = [  # (h, c, k, s, frac, bias + relu, blocked)
    (27, 96, 3, 2, 5 / 96, True, False),
    (13, 256, 3, 2, 5 / 256, True, False),
    (13, 256, 3, 2, 5 / 256, False, False),
    (8, 16, 2, 2, 4 / 16, True, True),
    (10, 8, 3, 3, 5 / 8, False, False),
]


def _assert_pool_lrn(z, b, n, alpha, beta, k, s, blocked, gen, g_scale=1.0):
    """Both fused kernels on one input. The forward is array-equal to the
    max pool of the LRN kernel's output (they share the LRN arithmetic);
    the backward holds assert_bf16_close's bar with POOL_LRN_BWD_ULPS (f32:
    rtol 1e-4, atol 3e-5 of the largest |dz|) against the plain chain fed
    with that same y; db within rtol 1e-4 of a float64 sum and the same on
    every run.
    Returns (m, y)."""
    c = z.shape[-1]
    kw = dict(bias=b, relu=b is not None, blocked=blocked)
    before = (plrn.LAUNCHES, plrn.BWD_LAUNCHES)
    m = plrn.pool_lrn_fwd(z, n, alpha, beta, k, s, **kw)
    y = lrn.lrn_fwd(z.reshape(-1, c), n, alpha, beta, **kw).view(z.shape)
    assert torch.equal(m, pool.maxpool_reference(y, k, s))
    g = (g_scale * torch.randn(m.shape, generator=gen, device=z.device)).to(z.dtype)
    dz, db = plrn.pool_lrn_bwd(g, m, z, n, alpha, beta, k, s, **kw)
    assert (plrn.LAUNCHES, plrn.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want_dz, _ = plrn._bwd_reference(g, m, z, n, alpha, beta, k, s, y=y, **kw)
    assert dz.dtype == z.dtype and dz.shape == z.shape
    if z.dtype == torch.float32:
        torch.testing.assert_close(dz, want_dz, rtol=1e-4, atol=3e-5 * want_dz.abs().max().item())
    else:
        # up to four bf16 cotangents summed in f32: exact to 2^-24
        g_lrn = pool.maxpool2d_undo_reference(y.float(), m.float(), g.float(), k, s)
        assert_bf16_close(dz, want_dz, _lrn_bwd_f64(g_lrn, z, n, alpha, beta, b, b is not None,
                                                    blocked), POOL_LRN_BWD_ULPS)
    if b is not None:
        ref = plrn._bwd_reference(g.float(), m.float(), z.float(), n, alpha, beta, k, s,
                                  y=y.float(), **kw)[0].double()
        ref = ref.reshape(-1, c)
        torch.testing.assert_close(db.double(), ref.sum(0), rtol=1e-4,
                                   atol=1e-5 * ref.abs().sum(0).max().item())
        assert torch.equal(db, plrn.pool_lrn_bwd(g, m, z, n, alpha, beta, k, s, **kw)[1])
    else:
        assert db is None
    return m, y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,k,s,frac,bias,blocked", POOL_LRN_CASES)
def test_pool_lrn_kernels_match_plain(cuda, dtype, h, c, k, s, frac, bias, blocked):
    """The bars of _assert_pool_lrn on tie-heavy inputs, at AlexNet's two
    chains and on two geometries of the generic kernels."""
    gen = torch.Generator(device=cuda).manual_seed(h * c)
    z = _halves(gen, (8, h, h, c), cuda, dtype)
    b = (0.5 * torch.randn((c,), generator=gen, device=cuda)).round() if bias else None
    n = lrn.norm_window_size(c, frac)
    _assert_pool_lrn(z, b, n, 1e-4 / n, 0.75, k, s, blocked, gen)


def _tied_windows(y, m, k, s) -> int:
    """How many windows of a k/s pool (padding 0, ceil-mode overhang) hold
    their max more than once."""
    h, w = y.shape[1], y.shape[2]
    oh, ow = m.shape[1], m.shape[2]
    count = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    for i in range(k):
        for j in range(k):
            rows = torch.arange(oh, device=m.device) * s + i
            cols = torch.arange(ow, device=m.device) * s + j
            tap = y[:, rows.clamp(max=h - 1)][:, :, cols.clamp(max=w - 1)]
            inside = (rows < h)[:, None] & (cols < w)[None, :]
            count += ((tap == m) & inside[None, :, :, None]).int()
    return int((count > 1).sum().item())


# The fused kernels' fast path (sliding n = 5, beta = 0.75, rows of whole
# 16-byte words, aligned tensors), (b, h, w, c, k, s): AlexNet's two chains;
# B = 1; batches that cut the images into bands of several rows, the last
# one short (the band count follows the batch and the card); a width that
# takes several passes of a block and one that takes one; channel counts
# whose positions fill a warp (C = 256 in bf16) and do not; a ceil-mode
# overhang on both edges (k 3/s 3 on 10, k 2/s 2 on 9, k 3/s 2 on 8); a
# non-square image; non-overlapping and 1x1 pools; one chunk a position
# (bf16 C = 8, every halo clipped).
POOL_LRN_FAST = [
    (4, 55, 55, 96, 3, 2), (4, 27, 27, 256, 3, 2), (1, 27, 27, 96, 3, 2), (100, 23, 23, 32, 3, 2),
    (48, 23, 23, 32, 3, 2), (200, 13, 13, 64, 3, 2), (7, 10, 10, 16, 3, 3), (7, 9, 9, 16, 2, 2),
    (7, 8, 8, 16, 3, 2), (3, 21, 17, 32, 3, 2), (3, 12, 12, 8, 2, 2), (5, 6, 6, 16, 1, 1),
    (3001, 1, 1, 96, 1, 1), (2, 5, 70, 64, 3, 2),
]


@pytest.mark.parametrize("b,h,w,c,k,s", POOL_LRN_FAST)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_pool_lrn_fast_path(cuda, b, h, w, c, k, s, dtype, bias):
    gen = torch.Generator(device=cuda).manual_seed(b * h + c + k)
    z = _halves(gen, (b, h, w, c), cuda, dtype)
    bb = (0.5 * torch.randn((c,), generator=gen, device=cuda)).round() if bias else None
    m, y = _assert_pool_lrn(z, bb, 5, 1e-4 / 5, 0.75, k, s, False, gen)
    if k > 1:
        assert _tied_windows(y, m, k, s) > 0  # the ties the backward must find


# The generic kernels, (h, c, k, s, n, beta, blocked, offset): blocked
# windows, n = 3, beta = 0.6 (powf), C = 8 and 16, rows of 200 bytes, and a
# z that starts 8 bytes past a 16-byte boundary (offset), each with
# overlapping, non-overlapping and 1x1 pools.
POOL_LRN_GENERIC = [
    (9, 16, 3, 2, 4, 0.75, True, 0), (8, 16, 2, 2, 4, 0.75, True, 0), (10, 8, 3, 3, 3, 0.75, False, 0),
    (9, 16, 3, 2, 5, 0.6, False, 0), (6, 16, 1, 1, 3, 0.6, False, 0), (9, 100, 3, 2, 5, 0.75, False, 0),
    (13, 96, 3, 2, 5, 0.75, False, 8), (10, 16, 3, 3, 5, 0.75, False, 8),
    (6, 16, 1, 1, 5, 0.75, False, 8),
]


@pytest.mark.parametrize("h,c,k,s,n,beta,blocked,offset", POOL_LRN_GENERIC)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_pool_lrn_generic_path(cuda, h, c, k, s, n, beta, blocked, offset, dtype, bias):
    gen = torch.Generator(device=cuda).manual_seed(h * c + n)
    shape = (5, h, h, c)
    numel = 5 * h * h * c
    buf = torch.empty((numel + 8,), dtype=dtype, device=cuda)
    z = buf[offset // buf.element_size():][:numel].view(shape)
    z.copy_(_halves(gen, shape, cuda, dtype))
    assert z.is_contiguous() and z.data_ptr() % 16 == offset
    bb = (0.5 * torch.randn((c,), generator=gen, device=cuda)).round() if bias else None
    _assert_pool_lrn(z, bb, n, 1e-4 / n, beta, k, s, blocked, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n", [(96, 5), (16, 3)])
def test_pool_lrn_fwd_keeps_a_nan(cuda, dtype, c, n):
    """A NaN in z makes y NaN across its channel window, and every pool
    window that holds it NaN, on the fast path (n = 5) and the generic one;
    all other maxima stay array-equal."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    z = _halves(gen, (3, 13, 13, c), cuda, dtype)
    z[1, 6, 6, 7] = float("nan")  # windows 2 and 3 of both axes hold position 6
    z[2, 12, 0, 0] = float("nan")  # the last row, the first column
    m = plrn.pool_lrn_fwd(z, n, 1e-4 / n, 0.75, 3, 2)
    y = lrn.lrn_fwd(z.view(-1, c), n, 1e-4 / n, 0.75).view(z.shape)
    want = pool.maxpool_reference(y, 3, 2)
    nan = torch.isnan(m)
    assert torch.equal(nan, torch.isnan(want))
    assert nan[1, 2:4, 2:4, 7].all() and nan[2, 5, 0, 0] and not nan[0].any()
    assert torch.equal(m[~nan], want[~nan])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n", [(96, 5), (16, 3)])
@pytest.mark.parametrize("bias", [True, False])
def test_pool_lrn_fwd_bit_for_bit_with_nans_and_signed_zeros(cuda, dtype, c, n, bias):
    """The fused forward is bit for bit the max pool of the LRN kernel's y,
    on the fast path (n = 5) and the generic one: on tie-heavy inputs with
    planted NaNs, and on windows that hold -0 and +0 in either order (the
    first is kept, as ATen's scan keeps it; without bias and ReLU, which map
    -0 to +0). It once pooled bf16 with __hmax2_nan, which does not."""
    gen = torch.Generator(device=cuda).manual_seed(c + n)
    kw = {"bias": (0.5 * torch.randn((c,), generator=gen, device=cuda)).round(),
          "relu": True} if bias else {}
    z = _plant_nans(gen, _halves(gen, (3, 13, 13, c), cuda, dtype))
    m = plrn.pool_lrn_fwd(z, n, 1e-4 / n, 0.75, 3, 2, **kw)
    y = lrn.lrn_fwd(z.view(-1, c), n, 1e-4 / n, 0.75, **kw).view(z.shape)
    assert _same_bits(m, pool.maxpool_reference(y, 3, 2))
    if bias:
        return
    z = torch.full((2, 13, 13, c), -1.0, device=cuda, dtype=dtype)
    for first, second in ((-0.0, 0.0), (0.0, -0.0)):
        z[:, 0::2, 0::2] = first  # a window's first tap is at an even row and column
        z[:, 1::2, 1::2] = second
        y = lrn.lrn_fwd(z.view(-1, c), n, 1e-4 / n, 0.75).view(z.shape)
        want = pool.maxpool_reference(y, 3, 2)
        assert torch.equal(want.signbit(), torch.full_like(want, first).signbit())
        assert _same_bits(plrn.pool_lrn_fwd(z, n, 1e-4 / n, 0.75, 3, 2), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [96, 256])
def test_pool_lrn_fast_path_outside_the_roots_fast_range(cuda, dtype, c):
    """A z so large that its window sum overflows makes d infinite, outside
    the range in which the fast kernels take their roots without a branch
    (lrn_math.cuh, lrn_roots): they then take rsqrtf and sqrtf themselves,
    and every bar still holds."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    z = _halves(gen, (3, 13, 13, c), cuda, dtype)
    z[1, 4, 5, 9] = 3e19
    z[2, 12, 12, c - 1] = -3e19
    b = (0.5 * torch.randn((c,), generator=gen, device=cuda)).round()
    m, y = _assert_pool_lrn(z, b, 5, 1e-4 / 5, 0.75, 3, 2, False, gen)
    assert torch.isfinite(m).all() and (y[1, 4, 5, 7:12] == 0).all()


@pytest.mark.parametrize("shape", [(128, 27, 27, 96), (128, 13, 13, 256)])
def test_pool_lrn_bwd_db_same_on_every_run(cuda, shape):
    """Enough images that every block of the backward's persistent grid
    walks several tiles: db is the same in three runs."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    c = shape[-1]
    z = _halves(gen, shape, cuda, torch.bfloat16)
    b = (0.5 * torch.randn((c,), generator=gen, device=cuda)).round()
    kw = dict(bias=b, relu=True)
    m = plrn.pool_lrn_fwd(z, 5, 1e-4 / 5, 0.75, 3, 2, **kw)
    g = torch.randn(m.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dbs = [plrn.pool_lrn_bwd(g, m, z, 5, 1e-4 / 5, 0.75, 3, 2, **kw)[1] for _ in range(3)]
    assert all(torch.equal(dbs[0], d) for d in dbs[1:])
    ref = plrn._bwd_reference(g.float(), m.float(), z.float(), 5, 1e-4 / 5, 0.75, 3, 2, b, True,
                              y=lrn.lrn_fwd(z.view(-1, c), 5, 1e-4 / 5, 0.75, **kw).view(shape).float())
    ref = ref[0].double().reshape(-1, c)
    torch.testing.assert_close(dbs[0].double(), ref.sum(0), rtol=1e-4,
                               atol=1e-5 * ref.abs().sum(0).max().item())


def test_lrn_maxpool_autograd_runs_both_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _halves(gen, (4, 27, 27, 96), cuda, torch.bfloat16).requires_grad_()
    b = (0.5 * torch.randn((96,), generator=gen, device=cuda)).requires_grad_()
    before = (plrn.LAUNCHES, plrn.BWD_LAUNCHES)
    m = plrn.lrn_maxpool_bias(x, b, 1e-4, 0.75, 5 / 96, False, 3, 2, 0, True)
    g = torch.randn(m.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dx, db = torch.autograd.grad(m, (x, b), g)
    assert (plrn.LAUNCHES, plrn.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    y = lrn.lrn_fwd(x.detach().view(-1, 96), 5, 1e-4 / 5, 0.75, bias=b.detach(), relu=True)
    want = plrn._bwd_reference(g, m.detach(), x.detach(), 5, 1e-4 / 5, 0.75, 3, 2,
                               b.detach(), True, y=y.view(x.shape))
    assert bf16_ulps(dx, want[0]) <= POOL_LRN_BWD_ULPS and db.dtype == torch.float32


# ---------------------------------------------------------------------------
# The gather probes' kernels (ops/gather.py): chip_smoke.py phase 12a
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry,mode,unaligned", [("PROBE", "random", False),
                                                      ("RAGGED", "low", False),
                                                      ("RAGGED", "high", False),
                                                      ("PROBE", "random", True)])
def test_gather_probes_match_their_plain_versions(cuda, geometry, mode, unaligned):
    """Every sub-probe of tools/gather_probe.py through its kernel, bit for
    bit its plain version: at the probes' shapes, at a ragged one with the
    offsets at both ends of their range, from inputs off a 16-byte boundary."""
    for p in gp.PROBES:
        case = p.build(getattr(gp, geometry), gp.Draw(cuda, 3, mode, unaligned))
        got = gp.run(p, case)
        assert gp.same_bits(got, gp.run(p, case, "plain")), p.name


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_crop_window_writes_zeros_outside_its_input(cuda, dtype):
    x = torch.randint(1, 200, (4, 256, 768), device=cuda).to(dtype)
    off = torch.tensor([0, 33, -1, 10], dtype=torch.int32, device=cuda)
    before = gather.CROP_WINDOW_LAUNCHES
    got = gather.crop_window(x, 224, 768, row_off=off)
    assert gather.CROP_WINDOW_LAUNCHES == before + 1
    assert not got[1:3].any() and got[0].all() and torch.equal(got[3], x[3, 10:234])
    assert gp.same_bits(got, gather.crop_window_reference(x, 224, 768, row_off=off))


def test_crop_deinterleave_writes_nan_outside_its_input(cuda):
    x = torch.randint(0, 256, (4, 256, 768), dtype=torch.uint8, device=cuda)
    off = torch.tensor([0, 33, -1, 10], dtype=torch.int32, device=cuda)
    zero = torch.zeros(4, dtype=torch.int32, device=cuda)
    got = gather.crop_deinterleave(x, zero, off, zero)
    assert torch.isnan(got.float()).flatten(1).all(1).tolist() == [False, True, True, False]
    assert gp.same_bits(got, gather.crop_deinterleave_reference(x, zero, off, zero))


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("name", [e.name for e in gp.EDGES])
def test_gather_edges_match_their_plain_versions(cuda, name, unaligned):
    """The geometries that reach every branch of crop_window.cu,
    relayout.cu and crop_deinterleave.cu (gather_probe.EDGES: column and
    crop origins at every byte of a 16-byte word, rows of no whole 16-byte
    word, u8 and bf16, windows and crops outside the input, a roll that
    splits a run, reversed runs of 203, ragged tiles, the row epilogues and
    the anti-diagonal at other ranks, flips, even and odd q, items of one
    crop row and of several, the last one short, rows of 15,600 elements),
    from aligned inputs and from inputs one element off a 16-byte boundary:
    one launch each, bit for bit."""
    edge = next(e for e in gp.EDGES if e.name == name)
    case = edge.build(gp.Draw(cuda, 5, unaligned=unaligned))
    counters = ("CROP_WINDOW_LAUNCHES", "RELAYOUT_LAUNCHES", "CROP_DEINTERLEAVE_LAUNCHES")
    counts = [getattr(gather, c) for c in counters]
    got = gp.run_edge(edge, case)
    moved = [getattr(gather, c) - n for c, n in zip(counters, counts)]
    assert moved == [int(edge.kernel == k) for k in gp.KERNELS], moved
    assert gp.same_bits(got, gp.run_edge(edge, case, "plain")), name


@pytest.mark.parametrize("name", ["P1-fix", "P13b"])
def test_crop_window_at_the_bench_batch(cuda, name):
    """crop_window at 4096 images: the persistent grid walks many rows a warp."""
    probe = next(p for p in gp.PROBES if p.name == name)
    case = probe.build(gp.PROBE._replace(b=gp.BATCH), gp.Draw(cuda, 9))
    assert gp.same_bits(gp.run(probe, case), gp.run(probe, case, "plain"))


@pytest.mark.parametrize("name", ["P24", "P31"])
def test_crop_deinterleave_at_the_bench_batch(cuda, name):
    """crop_deinterleave at 4096 images: the persistent grid walks many
    items a CTA, through both buffers."""
    probe = next(p for p in gp.PROBES if p.name == name)
    case = probe.build(gp.PROBE._replace(b=gp.BATCH), gp.Draw(cuda, 9))
    before = gather.CROP_DEINTERLEAVE_LAUNCHES
    got = gp.run(probe, case)
    assert gather.CROP_DEINTERLEAVE_LAUNCHES == before + 1
    assert gp.same_bits(got, gp.run(probe, case, "plain"))
