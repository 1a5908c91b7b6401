"""The port's measurement and data-making scripts on the CPU: the bench
(`convnet_tpu_torch.bench`), the pipeline bench, the profile, the sweep,
`make_synth_dataset` and `train_digits_release`, at tiny sizes. The FLOP
count is held to the repo's `bench.py` over every example model (loaded as
tests/test_bench.py loads it), the synthetic dataset to
`tools/make_synth_dataset.py`'s arrays and the digits split to
`tools/train_digits_release.py`'s (h5py reads both tools' files, as the
independent reference). Without a card, every entry point that measures
must exit non-zero unless it is given --device cpu."""

import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from convnet_tpu_torch import bench, config
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.tools import (
    bench_pipeline,
    make_synth_dataset,
    profile_alexnet,
    sweep,
    train_digits_release,
)
from convnet_tpu_torch.utils import card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = sorted(glob.glob(os.path.join(REPO, "examples", "*", "*.pbtxt")))
MODELS = [m for m in MODELS if "_data" not in m and "_dummy_" not in m]
ALEXNET_FLOPS = 2270512192
H100 = "NVIDIA H100 80GB HBM3"
LINE_KEYS = {"metric", "value", "unit", "mfu", "device", "power_limit_w", "batch", "steps",
             "steps_per_launch", "data", "final_loss"}
# AlexNet cropped to 67 from 99-pixel raw images: every edge at its full width
TINY = ["--device", "cpu", "--image-size", "67"]


@pytest.fixture()
def jax_bench():
    sys.path.insert(0, REPO)
    import bench as jax_bench_module

    return jax_bench_module


def json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


@pytest.mark.parametrize("path", MODELS, ids=lambda p: os.path.relpath(p, REPO))
def test_conv_flops_equal_the_jax_benchs(jax_bench, path):
    from convnet_tpu import config as jax_config
    from convnet_tpu.graph import build_graph as jax_build_graph

    want = jax_bench.conv_flops_per_image(jax_build_graph(jax_config.read_model(path)))
    got = bench.conv_flops_per_image(build_graph(config.read_model(path)))
    assert got == want and got > 0


def test_alexnet_flops_peak_and_mfu(monkeypatch):
    flops = bench.conv_flops_per_image(bench.alexnet_graph())
    assert flops == ALEXNET_FLOPS
    peak = card.bf16_peak(H100)
    assert peak == 989e12
    roofline = peak / (3 * flops)
    assert round(roofline) == 145195
    assert card.bf16_peak("NVIDIA H100 PCIe") is None  # no guess for another part
    assert card.bf16_peak("NVIDIA A100-SXM4-80GB") is None
    assert card.mfu(roofline, 3 * flops, torch.device("cpu")) is None
    monkeypatch.setattr(card.torch.cuda, "get_device_name", lambda *_: H100)
    assert card.mfu(roofline / 2, 3 * flops, torch.device("cuda")) == pytest.approx(0.5)
    monkeypatch.setattr(card.torch.cuda, "get_device_name", lambda *_: "NVIDIA L4")
    assert card.mfu(roofline, 3 * flops, torch.device("cuda")) is None


def test_power_limit_parse():
    assert card.power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    assert card.power_limit_w("NVIDIA H100 80GB HBM3, [N/A]") is None


@pytest.mark.parametrize("data,k", [("synthetic", 1), ("synthetic", 2), ("rawcache", 1)])
def test_bench_prints_its_line_on_the_cpu(capsys, tmp_path, data, k):
    got = bench.main(batch=4, steps=2, steps_per_launch=k, data=data, image_size=67,
                     device="cpu", cache_dir=str(tmp_path))
    (line,) = json_lines(capsys.readouterr().out)
    assert line == got and set(line) == LINE_KEYS
    assert line["metric"] == bench.METRIC + ("_rawcache" if data == "rawcache" else "")
    assert line["value"] > 0 and line["unit"] == "images/sec"
    assert line["device"] == "cpu" and line["mfu"] is None and line["power_limit_w"] is None
    assert (line["batch"], line["steps"], line["steps_per_launch"], line["data"]) == (4, 2, k, data)
    assert math.isfinite(line["final_loss"])
    assert os.listdir(tmp_path) == []  # the raw cache's directory is gone


def test_bench_rawcache_takes_one_step_a_launch():
    with pytest.raises(ValueError, match="synthetic"):
        bench.main(batch=4, steps=2, steps_per_launch=2, data="rawcache", image_size=67,
                   device="cpu")


ENTRY_POINTS = [
    ("convnet_tpu_torch.bench", []),
    ("convnet_tpu_torch.tools.bench_pipeline", []),
    ("convnet_tpu_torch.tools.profile_alexnet", []),
    ("convnet_tpu_torch.tools.sweep", []),
    ("convnet_tpu_torch.tools.train_digits_release", ["--output", "unused.h5"]),
    ("convnet_tpu_torch.tools.copy_probe", []),
    ("convnet_tpu_torch.tools.serving_probe", []),
]


@pytest.mark.parametrize("module,args", ENTRY_POINTS, ids=[m for m, _ in ENTRY_POINTS])
def test_entry_points_need_a_card_or_device_cpu(tmp_path, module, args):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run on it")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""
    assert not (tmp_path / "unused.h5").exists()


def test_bench_pipeline_on_the_cpu(capsys):
    assert bench_pipeline.main(["--steps", "2", "--aug-batch", "4", "--cifar-batch", "8",
                                "--infer-batches", "4,2", *TINY]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert [(l["metric"], l["batch"]) for l in lines] == [
        ("alexnet_infer_images_per_sec_per_chip", 4), ("alexnet_infer_images_per_sec_per_chip", 2),
        ("aug_pipeline_throughput", 4), ("cifar10_train_step_time", 8)]
    assert [l["unit"] for l in lines] == ["images/sec", "images/sec", "MB/s", "ms"]
    for l in lines:
        assert l["value"] > 0 and l["device"] == "cpu" and l["power_limit_w"] is None
    assert lines[0]["ms_per_batch"] > 0 and lines[3]["images_per_sec"] > 0


def test_profile_on_the_cpu(capsys, tmp_path):
    assert profile_alexnet.main(["--batch", "2", "--steps", "1", "--trace-dir", str(tmp_path),
                                 *TINY]) == 0
    lines = json_lines(capsys.readouterr().out)
    rows, trace = lines[:-1], lines[-1]
    names = [r["name"] for r in rows]
    assert names[:5] == ["train step", "eval forward (loss)", "forward + backward (no update)",
                         "update (apply_updates)", "prologue"]
    assert {"conv1:rnorm1 [kernel] fwd+bwd", "conv1:rnorm1 [plain] fwd+bwd",
            "conv2:rnorm2 [plain] fwd", "input:conv1 fwd", "pool5:fc6 fwd+bwd"} <= set(names)
    assert all(r["host_ms"] > 0 and r["device_ms"] is None for r in rows)
    assert trace["trace_steps"] == profile_alexnet.TRACE_STEPS and trace["device"] == "cpu"
    assert trace["idle_share"] is None and trace["device_ms_per_step"] == {}
    assert (tmp_path / "train_steps.pt.trace.json").exists()


@pytest.mark.parametrize("name,want", [
    ("void lrn_fwd_regs<__nv_bfloat16, 8, 5>(__nv_bfloat16 const*, float const*)", "lrn"),
    ("void lrn_bwd_kernel<__nv_bfloat16, 8>(...)", "lrn"),
    ("void pool_lrn_bwd_fast<__nv_bfloat16>(...)", "lrn"),
    ("void (anonymous namespace)::s2d_prologue_kernel<false, 4, 3>(Geometry, Args)", "prologue"),
    ("void dropout_kernel<__nv_bfloat16>(...)", "dropout"),
    ("step_draws_kernel(long const*, KeyWords, int, long*, CropDraw, int*, int*, unsigned char*)",
     "dropout"),
    ("void maxpool_fwd_kernel<__nv_bfloat16, 3, 2>(...)", "pool-fwd"),
    ("void (anonymous namespace)::maxpool_bwd_tiles<__nv_bfloat16, 4, unsigned char, 3, 2>(...)",
     "pool-bwd"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16, float>",
     "pool-fwd"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<c10::BFloat16, float>",
     "pool-bwd"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "conv"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>",
     "conv"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda>",
     "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "other"),
])
def test_profile_categories(name, want):
    assert profile_alexnet.category(name) == want


def test_trace_categories_and_idle_share():
    """Two steps: 3 us of device events (two kernels that overlap by half
    a microsecond, and a copy) cover 2.5 of the 8 us from the first
    event's start to the last one's end, so an idle share of 0.6875; host
    events do not count."""
    events = [
        {"cat": "user_annotation", "name": "train_step", "ts": 100.0, "dur": 4.0},
        {"cat": "user_annotation", "name": "train_step", "ts": 104.0, "dur": 4.0},
        {"cat": "cpu_op", "name": "aten::conv2d", "ts": 100.5, "dur": 3.0},
        {"cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16", "ts": 102.0, "dur": 1.0},
        {"cat": "kernel", "name": "void lrn_bwd_kernel<float, 4>", "ts": 102.5, "dur": 1.0},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 109.0, "dur": 1.0},
    ]
    got = profile_alexnet.trace_categories(events, steps=2)
    assert got["window_ms"] == pytest.approx(0.008)
    assert got["idle_share"] == pytest.approx(0.6875)
    assert got["device_busy_ms_per_step"] == pytest.approx(0.00125)
    cats = got["device_ms_per_step"]
    assert set(cats) == set(profile_alexnet.CATEGORIES)
    assert (cats["conv"], cats["lrn"], cats["copy"]) == pytest.approx((5e-4, 5e-4, 5e-4))
    assert sum(cats.values()) == pytest.approx(1.5e-3)


def test_sweep_on_the_cpu(capsys):
    assert sweep.main(["--batches", "2", "--dtypes", "bfloat16,float32", "--steps-per-launch",
                       "1,2", "--steps", "1", *TINY]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert [(l["batch"], l["dtype"], l["steps_per_launch"]) for l in lines] == [
        (2, "bfloat16", 1), (2, "bfloat16", 2), (2, "float32", 1), (2, "float32", 2)]
    for l in lines:
        assert l["images_per_sec"] > 0 and l["ms_per_step"] > 0 and l["mfu"] is None
        assert l["max_memory_allocated"] is None and l["device"] == "cpu"


@pytest.mark.parametrize("rows,size,seed", [(7, 16, 0), (20, 24, 1), (3, 32, 5)])
def test_make_synth_dataset_equals_the_tools(tmp_path, rows, size, seed):
    h5py = pytest.importorskip("h5py")
    sys.path.insert(0, REPO)
    from tools import make_synth_dataset as reference

    data, labels = make_synth_dataset.generate(rows, size, seed)
    want_data, want_labels = reference.generate(rows, size, seed)
    np.testing.assert_array_equal(data, want_data)
    np.testing.assert_array_equal(labels, want_labels)
    out = str(tmp_path / "synth.h5")
    assert make_synth_dataset.main([out, "--rows", str(rows), "--size", str(size),
                                    "--seed", str(seed)]) == 0
    with h5py.File(out, "r") as f:
        assert f["data"].dtype == np.uint8 and f["labels"].dtype == np.int32
        np.testing.assert_array_equal(f["data"][...], want_data)
        np.testing.assert_array_equal(f["labels"][...], want_labels)


def test_digits_shards_equal_the_tools(tmp_path):
    pytest.importorskip("sklearn", reason="the digits tools' only data is sklearn's")
    h5py = pytest.importorskip("h5py")
    sys.path.insert(0, REPO)
    from tools import train_digits_release as reference

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = reference.write_shards(str(tmp_path / "jax"))
    got = train_digits_release.write_shards(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == ["train", "val"]
    for split in ("train", "val"):
        with h5py.File(want[split], "r") as a, h5py.File(got[split], "r") as b:
            for name in ("data", "labels"):
                assert a[name].dtype == b[name].dtype
                np.testing.assert_array_equal(a[name][...], b[name][...])
    with h5py.File(got["train"], "r") as f:
        assert f["data"].shape == (1500, 8, 8, 1)


def test_train_digits_release_without_sklearn(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(SystemExit, match="sklearn"):
        train_digits_release.main(["--output", str(tmp_path / "d.h5"), "--device", "cpu"])
    assert not (tmp_path / "d.h5").exists()
