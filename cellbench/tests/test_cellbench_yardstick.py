"""The benchmark's arithmetic: FLOPs, shares of a peak, roofline bytes,
the idle share from a trace, and a tail taken over every request."""

import importlib.util
import statistics
from types import SimpleNamespace

import pytest

from cellbench import harness, measure, yardstick
from cellbench.tests.tiny import REPO


def _reader(name):
    path = REPO / "cellbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_alexnet_flops_are_the_repos_count():
    net = harness.Cell(REPO, "alexnet.train.b1024").net
    # convnet_tpu_torch.bench.conv_flops_per_image of the same model
    assert net.flops_per_image() == 2_270_512_192
    local = harness.Cell(REPO, "alexnet_local.train.b1024").net
    assert local.flops_per_image() == 2_270_512_192
    assert sum(s["w"][0] * s["w"][1] * s["w"][2] * s["w"][3]
               for n, s in local.param_shapes().items() if n == "conv3:conv4") == 224_280_576


def test_peaks_and_shares():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert yardstick.peaks("cpu") == (None, None)
    assert yardstick.share(989e12, 989e12, 2.0) == pytest.approx(50.0)
    assert yardstick.share(1.0, None, 1.0) is None


def test_mfu_readers():
    net = harness.Cell(REPO, "alexnet.train.b1024").net
    ctx = SimpleNamespace(kind="train", net=net, peak_flops=989e12,
                          window={"images_per_s": 40_000.0, "batch": 1024})
    # 40,000 img/s x 3 x 2.27 GFLOP over 989 TFLOP/s
    assert _reader("train.mfu")(ctx) == pytest.approx(100 * 40_000 * 3 * 2_270_512_192 / 989e12)
    assert _reader("serve.mfu")(ctx) is None
    ctx.kind, ctx.window = "serve", {"images_per_s": 20_000.0, "batch": 64,
                                     "ms": [2.0] * 95 + [4.0] * 5}
    assert _reader("serve.mfu")(ctx) == pytest.approx(100 * 20_000 * 2_270_512_192 / 989e12)
    p95 = yardstick.quantile(ctx.window["ms"], 0.95)
    assert _reader("serve.p95_mfu")(ctx) == pytest.approx(
        100 * 64 * 2_270_512_192 / 989e12 / (p95 / 1e3))
    ctx.peak_flops = None
    assert _reader("serve.mfu")(ctx) is None


def test_roofline_counts():
    # forward: z and y bf16, the f32 bias; backward: g, z, dz bf16, bias and its gradient f32
    assert yardstick.lrn_bytes(10, 4) == 2 * 80 + 16 + 3 * 80 + 32
    assert yardstick.conv_train_flops(100, True) == 300
    assert yardstick.conv_train_flops(100, False) == 200


def _ev(ts, dur, name="k", cat="kernel"):
    return {"ts": ts, "dur": dur, "name": name, "cat": cat}


def test_idle_share_and_gaps():
    events = [_ev(0, 10, "a"), _ev(5, 10, "b"), _ev(30, 10, "a"), _ev(60, 40, "c"),
              _ev(15, 14, "aten::copy_", "cpu_op"), _ev(40, 20, "step", "user_annotation"),
              _ev(45, 5, "aten::mm", "cpu_op")]
    got = measure.busy(events)
    # busy 0-15, 30-40, 60-100 = 65 us of a 100 us window
    assert got["busy_s"] == pytest.approx(65e-6) and got["window_s"] == pytest.approx(100e-6)
    assert got["device_ops"][0] == ["c", pytest.approx(40e-6)]
    ctx = SimpleNamespace(kind="train", trace=got)
    assert _reader("device.idle_share.train")(ctx) == pytest.approx(35.0)
    assert _reader("device.idle_share.serve")(ctx) is None
    gaps = dict((n, s) for n, s in measure.idle_gaps(events))
    # 15-30 under aten::copy_, 40-60 under aten::mm (the innermost at its middle, 50)
    assert gaps == {"aten::copy_": pytest.approx(15e-6), "aten::mm": pytest.approx(20e-6)}
    assert measure.busy([_ev(0, 5, "x", "cpu_op")]) is None


def test_p95_is_over_every_request_and_sees_a_stall():
    steady = [2.0 + 0.001 * (i % 7) for i in range(2000)]
    stalled = list(steady)
    # one stall of 0.3 s holds up the 150 requests queued behind it by 1.5 ms to 0.3 s
    for i in range(1000, 1150):
        stalled[i] += 300.0 * (1150 - i) / 150
    assert yardstick.quantile(steady, 0.95) == pytest.approx(2.006, abs=1e-3)
    assert yardstick.quantile(stalled, 0.95) > 50.0
    assert statistics.median(stalled) == pytest.approx(statistics.median(steady), abs=1e-3)


def test_spread():
    assert yardstick.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    q1, med, q3 = statistics.quantiles([9, 10, 10, 11, 12], n=4)
    assert yardstick.spread([9, 10, 10, 11, 12]) == pytest.approx((q3 - q1) / med)
