#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py [--profile-dir DIR]

Run from the root of a checkout. It imports no JAX. Phases, in order;
any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), and the build
   of the CUDA kernels from convnet_tpu_torch/csrc.
2. Each kernel against its plain PyTorch version on the card, at the
   serving path's shapes: the input prologue must be array-equal; the
   response norm within 1 bf16 ulp in bf16 and rtol 1e-5 in f32.
3. Serving: a Predictor on full-width AlexNet (examples/imagenet/
   alexnet.pbtxt, bf16, crop 224 from 256, uint8 wire, batch 128, random
   weights from the port's seeded init, mean 0.45, scale 1/255) answers
   requests of 128, 128 and 57 images. The outputs must be finite, of
   shape (n, 1000), with softmax rows summing to 1 within 1e-3; both
   kernels' launch counts must show the requests went through them; and
   the logits must agree with AlexNet's forward composed directly from
   the plain versions (tolerance printed below).
4. Timing with CUDA events (median of 20 runs after warm-up): each kernel
   and its plain version, the forward pass, and the Predictor's
   milliseconds per batch and images per second.

The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' launch counts, errors and times as JSON. With --profile-dir
the forward pass is also traced with torch.profiler into that directory.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ALEXNET = REPO / "examples" / "imagenet" / "alexnet.pbtxt"
BATCH, RAW, CROP = 128, 256, 224
REQUESTS = (128, 128, 57)
ITERS, WARMUP = 20, 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median device milliseconds of fn(), timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i >= 0, i, -32768 - i)

    return int((ordered(a) - ordered(b)).abs().max().item())


def check_prologue(dev, gen, card):
    """Kernel B vs its plain version: array-equal. Returns max |err|."""
    import torch

    from convnet_tpu_torch.ops import s2d_relayout as s2d

    x = torch.randint(0, 256, (BATCH, RAW, RAW, 3), generator=gen, device=dev, dtype=torch.uint8)
    p = s2d.relayout_geometry(CROP, 11, 4)
    centered = torch.full((BATCH,), (RAW - CROP) // 2, dtype=torch.int32, device=dev)

    def offsets():
        return torch.randint(0, RAW - CROP + 1, (BATCH,), generator=gen, device=dev,
                             dtype=torch.int32)

    flips = torch.randint(0, 2, (BATCH,), generator=gen, device=dev).bool()
    mean = torch.full((3,), 0.45, device=dev)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev)
    cases = [
        ("centered, mean", centered, centered, None, 1 / 255, mean, None),
        ("random, flips, mean", offsets(), offsets(), flips, 1 / 255, mean, None),
        ("random, flips, mean+std", offsets(), offsets(), flips, 1 / 255, mean, std),
        ("centered, raw bytes", centered, centered, None, 1.0, None, None),
    ]
    worst = 0.0
    for name, oy, ox, fl, scale, mn, sd in cases:
        kw = dict(crop=CROP, stride=4, p=p, scale=scale, mean=mn, std=sd)
        got = s2d.s2d_prologue(x, oy, ox, fl, **kw)
        want = s2d.s2d_prologue_reference(x, oy, ox, fl, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        print(f"[{card}] s2d_prologue {tuple(got.shape)} {name}: max_abs_err {err}")
        if not torch.equal(got, want):
            raise AssertionError(f"s2d_prologue ({name}) is not array-equal to its plain version")
    return worst


LRN_SHAPES = {"rnorm1": (BATCH * 55 * 55, 96), "rnorm2": (BATCH * 27 * 27, 256)}


def check_lrn(dev, gen, card):
    """Kernel A vs its plain version: 1 bf16 ulp, f32 rtol 1e-5. Returns
    max |err| over the cases."""
    import torch

    from convnet_tpu_torch.ops import lrn

    worst = 0.0
    for shape_name, (m, c) in LRN_SHAPES.items():
        z32 = 2.0 * torch.randn((m, c), generator=gen, device=dev)
        bias = 0.5 * torch.randn((c,), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            z = z32.to(dtype)
            for add_scale in (1e-4, 1.0):  # AlexNet's, and one where d is far from 1
                for use_bias, blocked in ((True, False), (False, False), (True, True)):
                    b = bias if use_bias else None
                    n, alpha = 5, add_scale / 5
                    got = lrn.lrn_fwd(z, n, alpha, 0.75, bias=b, relu=use_bias, blocked=blocked)
                    want = lrn._fwd_math(z, n, alpha, 0.75, b, use_bias, blocked)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    worst = max(worst, err)
                    tag = (f"lrn_fwd {shape_name} ({m},{c}) {str(dtype)[6:]} add_scale={add_scale} "
                           f"bias+relu={use_bias} blocked={blocked}")
                    if dtype == torch.bfloat16:
                        ulps = bf16_ulps(got, want)
                        print(f"[{card}] {tag}: max_abs_err {err} bf16_ulps {ulps}")
                        if ulps > 1:
                            raise AssertionError(f"{tag}: {ulps} bf16 ulps from the plain version")
                    else:
                        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
                        print(f"[{card}] {tag}: max_abs_err {err} max_rel_err {rel}")
                        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    return worst


def plain_alexnet(graph, params, x_u8, spec, mean_t):
    """AlexNet's eval logits composed directly from the plain versions of
    the kernels (and the same cuDNN/cuBLAS ops), not through apply_fn."""
    import torch

    from convnet_tpu_torch.data.jitter import center_offsets
    from convnet_tpu_torch.ops.conv import S2DInput, conv2d, fc
    from convnet_tpu_torch.ops.lrn import response_norm_reference
    from convnet_tpu_torch.ops.pool import maxpool2d
    from convnet_tpu_torch.ops.s2d_relayout import relayout_geometry, s2d_prologue_reference

    bf = torch.bfloat16

    def inc(layer):
        (e,) = graph.incoming(layer)
        return e

    b, h, w, _ = x_u8.shape
    c1 = inc("conv1")
    cy, cx = center_offsets(h, w, spec.image_size)
    oy = torch.full((b,), cy, dtype=torch.int32, device=x_u8.device)
    ox = torch.full((b,), cx, dtype=torch.int32, device=x_u8.device)
    xs = s2d_prologue_reference(
        x_u8, oy, ox, None, crop=spec.image_size, stride=c1.stride,
        p=relayout_geometry(spec.image_size, c1.kernel_size, c1.stride),
        scale=spec.scale, mean=mean_t,
    )
    x = S2DInput(xs, c1.stride)
    for conv, norm, pool in (("conv1", "rnorm1", "pool1"), ("conv2", "rnorm2", "pool2")):
        ce, ne, pe = inc(conv), inc(norm), inc(pool)
        z = conv2d(x, params[ce.name]["w"], ce.stride, ce.padding, bf)
        x = response_norm_reference(
            z, ne.add_scale, ne.pow_scale, ne.frac_of_filters_response_norm,
            ne.response_norm_blocked, bias=params[ce.name]["b"], relu=True,
        )
        x = maxpool2d(x, pe.kernel_size, pe.stride, pe.padding)
    for conv in ("conv3", "conv4", "conv5"):
        ce = inc(conv)
        z = conv2d(x, params[ce.name]["w"], ce.stride, ce.padding, bf)
        x = torch.relu(z + params[ce.name]["b"].to(bf))
    pe = inc("pool5")
    x = maxpool2d(x, pe.kernel_size, pe.stride, pe.padding)
    for layer in ("fc6", "fc7"):
        fe = inc(layer)
        x = torch.relu(fc(x, params[fe.name]["w"], bf) + params[fe.name]["b"].to(bf))
        x = x[:, None, None, :]
    fe = inc("output")
    return (fc(x, params[fe.name]["w"], bf) + params[fe.name]["b"].to(bf)).float()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", type=Path, help="trace the forward pass into this directory")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    if not (REPO / "convnet_tpu_torch").is_dir() or not ALEXNET.is_file():
        print("chip_smoke: run it from the root of a checkout of the repository", file=sys.stderr)
        return 1
    from convnet_tpu.config import read_model
    from convnet_tpu.graph import build_graph
    from convnet_tpu_torch.data.jitter import JitterSpec
    from convnet_tpu_torch.model import init_params
    from convnet_tpu_torch.ops import _build
    from convnet_tpu_torch.ops import lrn
    from convnet_tpu_torch.ops import s2d_relayout as s2d
    from convnet_tpu_torch.predictor import Predictor
    from convnet_tpu_torch.trainer import make_forward

    if "jax" in sys.modules:
        raise RuntimeError("the port imported JAX")

    # -- 1. device and build -------------------------------------------------
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    load_s = time.perf_counter() - t0
    print(f"[{card}] kernel library: nvcc build {_build.build_seconds} s, "
          f"build+load {load_s:.3f} s")

    # -- 2. kernels vs plain versions at the slice's shapes -----------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s2d_err = check_prologue(dev, gen, card)
    lrn_err = check_lrn(dev, gen, card)

    # -- 3. serving ----------------------------------------------------------
    graph = build_graph(read_model(str(ALEXNET)))
    params = init_params(graph, seed=0, device=dev)
    spec = JitterSpec(image_size=CROP, scale=1 / 255)
    mean = np.full((3,), 0.45, np.float32)
    jitter = {"input": (spec, mean, None)}
    pred = Predictor(graph, params, batch_size=BATCH, jitter=jitter, raw_size=RAW,
                     input_dtype=np.uint8, device=dev)
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (n, RAW, RAW, 3), dtype=np.uint8) for n in REQUESTS]

    lrn.LAUNCHES = 0
    s2d.LAUNCHES = 0
    outs = [pred({"input": r}) for r in requests]
    launches = {"lrn_fwd": lrn.LAUNCHES, "s2d_prologue": s2d.LAUNCHES}
    print(f"[{card}] launches during {len(REQUESTS)} requests: {launches}")
    if launches != {"lrn_fwd": 2 * len(REQUESTS), "s2d_prologue": len(REQUESTS)}:
        raise AssertionError(f"the requests did not go through the kernels: {launches}")

    mean_t = torch.as_tensor(mean, device=dev)
    for req, out in zip(requests, outs):
        n = len(req)
        logits, probs = out["output:preact"], out["output"].reshape(n, -1)
        if logits.shape != (n, 1000) or probs.shape != (n, 1000):
            raise AssertionError(f"output shapes {logits.shape}, {probs.shape} != ({n}, 1000)")
        if not (np.isfinite(logits).all() and np.isfinite(probs).all()):
            raise AssertionError("non-finite outputs")
        row_err = np.abs(probs.sum(-1) - 1.0).max()
        if row_err > 1e-3:
            raise AssertionError(f"softmax rows sum to 1 +- {row_err}")
        with torch.inference_mode():
            ref = plain_alexnet(graph, params, torch.from_numpy(req).to(dev), spec, mean_t)
        ref = ref.cpu().numpy()
        # the kernel and its plain version may round a bf16 LRN output the
        # other way (1 ulp); through five bf16 layers that stays far below
        # 1e-2 of the largest logit
        tol = 1e-2 * np.abs(ref).max()
        err = np.abs(logits - ref).max()
        top2 = np.sort(ref, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * tol
        agree = logits.argmax(-1) == ref.argmax(-1)
        print(f"[{card}] request of {n}: max|logit - plain| {err} (tol {tol}); top-1 agrees on "
              f"{int(agree.sum())}/{n}, on {int(agree[decided].sum())}/{int(decided.sum())} with "
              f"top-2 margin > 2*tol; softmax row-sum error {row_err}")
        if err > tol or not agree[decided].all():
            raise AssertionError("the served logits disagree with the plain-composed forward")

    # -- 4. timing -----------------------------------------------------------
    torch.cuda.synchronize()
    times = {}
    for shape_name, (m, c) in LRN_SHAPES.items():
        z = (2.0 * torch.randn((m, c), generator=gen, device=dev)).to(torch.bfloat16)
        b = 0.5 * torch.randn((c,), generator=gen, device=dev)
        alpha = 1e-4 / 5
        times[f"lrn_fwd {shape_name}"] = (
            cuda_ms(lambda: lrn.lrn_fwd(z, 5, alpha, 0.75, bias=b, relu=True)),
            cuda_ms(lambda: lrn._fwd_math(z, 5, alpha, 0.75, b, True)),
        )
    x = torch.randint(0, 256, (BATCH, RAW, RAW, 3), generator=gen, device=dev, dtype=torch.uint8)
    off = torch.full((BATCH,), (RAW - CROP) // 2, dtype=torch.int32, device=dev)
    kw = dict(crop=CROP, stride=4, p=s2d.relayout_geometry(CROP, 11, 4), scale=1 / 255,
              mean=mean_t)
    times["s2d_prologue"] = (
        cuda_ms(lambda: s2d.s2d_prologue(x, off, off, None, **kw)),
        cuda_ms(lambda: s2d.s2d_prologue_reference(x, off, off, None, **kw)),
    )
    for name, (k_ms, p_ms) in times.items():
        print(f"[{card}] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    fwd = make_forward(graph, pred.layers, jitter)
    staged = {"input": torch.from_numpy(requests[0]).to(dev)}
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: fwd(pred.params, staged))
        plain_fwd_ms = cuda_ms(lambda: plain_alexnet(graph, params, staged["input"], spec, mean_t))
    host = []
    for i in range(WARMUP + ITERS):
        t0 = time.perf_counter()
        pred({"input": requests[0]})
        if i >= WARMUP:
            host.append((time.perf_counter() - t0) * 1e3)
    req_ms = statistics.median(host)
    print(f"[{card}] AlexNet forward, batch {BATCH}, device time: {fwd_ms:.4f} ms "
          f"(plain-composed forward {plain_fwd_ms:.4f} ms)")
    print(f"[{card}] Predictor, batch {BATCH}: {req_ms:.4f} ms per request, "
          f"{BATCH / req_ms * 1e3:.1f} img/s (host clock, uint8 in, numpy out)")

    if args.profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        args.profile_dir.mkdir(parents=True, exist_ok=True)
        with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(5):
                fwd(pred.params, staged)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
        (args.profile_dir / "forward_profile.txt").write_text(f"{card}\n{table}\n")
        prof.export_chrome_trace(str(args.profile_dir / "forward_trace.json"))
        print(table)

    kernels = [
        {
            "name": "lrn_fwd",
            "route": "cuda",
            "source": "convnet_tpu_torch/csrc/lrn_fwd.cu",
            "replaces": "convnet_tpu/ops/lrn.py:212",
            "also_replaces": "convnet_tpu/ops/lrn.py:535",
            "launches": launches["lrn_fwd"],
            "max_abs_err": lrn_err,
            # one forward pass launches it at both shapes
            "ms": times["lrn_fwd rnorm1"][0] + times["lrn_fwd rnorm2"][0],
            "plain_ms": times["lrn_fwd rnorm1"][1] + times["lrn_fwd rnorm2"][1],
        },
        {
            "name": "s2d_prologue",
            "route": "cuda",
            "source": "convnet_tpu_torch/csrc/s2d_prologue.cu",
            "replaces": "convnet_tpu/ops/s2d_relayout.py:200",
            "launches": launches["s2d_prologue"],
            "max_abs_err": s2d_err,
            "ms": times["s2d_prologue"][0],
            "plain_ms": times["s2d_prologue"][1],
        },
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
