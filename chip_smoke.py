#!/usr/bin/env python3
"""Drive the PyTorch port's serving and train paths once on one CUDA card.

    python3 chip_smoke.py [--profile-dir DIR]
    python3 chip_smoke.py --time-only [--root CHECKOUT] [--kernels TEXT]
    python3 chip_smoke.py --ulp-study SEEDS

Run from the root of a checkout. It imports no JAX. Phases, in order;
any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), and the build
   of the CUDA kernels from convnet_tpu_torch/csrc.
2. Each kernel against its plain PyTorch version on the card, at the
   serving and train paths' shapes (the LRN kernels also at a ragged
   (3001, 100)): the input prologue must be
   array-equal; the response norm within 1 bf16 ulp in bf16 and rtol
   1e-5 in f32, and array-equal to the fused LRN -> max pool kernel with
   a 1x1 pool (the y that kernel's backward recomputes to find its ties);
   its backward within 1 bf16 ulp of the plain version at AlexNet's alpha
   and no further from a float64 dx than the plain version is plus that
   ulp (the bar --ulp-study measured), f32 dx
   within rtol 1e-4 and atol 3e-5 of the largest |dx|, db within rtol
   1e-4 of a float64 column sum; dropout array-equal, with the backward's
   mask equal to the forward's; the step-draws kernel (a train step's
   dropout keys, crop origins and flips from the (seed, step) the card
   holds) array-equal at four (seed, step). The max pool at pool1, pool2, pool5 and a
   ragged geometry (C = 100, 14x14, pad 1, the ceil-mode last window), each
   also from a view off a 16-byte boundary, bit for bit (NaN payloads and
   the sign of zero included) on inputs with planted NaNs; the fused
   LRN -> max pool forward at rnorm1/pool1 and rnorm2/pool2, with bias and
   ReLU, bit for bit the max pool of the LRN kernel's output, and so again
   without them on inputs with planted NaNs and windows that hold both -0
   and +0; its backward held to the plain chain fed with that
   same y by the same bar (f32: rtol 1e-4, atol 3e-5 of the largest |dz|),
   db within rtol 1e-4 of a float64 sum and the same in two runs; inputs
   on a grid of halves, so window maxima tie (the count is printed). An
   f32 conv's gradients at conv2's shape must match float64 within rtol
   1e-5 (no TF32 in dgrad or wgrad).
3. Serving: a Predictor on full-width AlexNet (examples/imagenet/
   alexnet.pbtxt, bf16, crop 224 from 256, uint8 wire, batch 128, random
   weights from the port's seeded init, mean 0.45, scale 1/255) answers
   requests of 128, 128 and 57 images. The outputs must be finite, of
   shape (n, 1000), with softmax rows summing to 1 within 1e-3; both
   kernels' launch counts must show the requests went through them; and
   the logits must agree with AlexNet's forward composed directly from
   the plain versions (tolerance printed below).
4. Training: a Trainer on the same full-width AlexNet over DUMMY data
   (uint8 256x256x3 images, 1000 classes, random 224 crops and flips,
   scale 1/255, mean 0.45, batch 128) takes 20 steps and one validation
   pass. The parameters must move and stay finite, the losses be finite,
   each step launch lrn_fwd 2, lrn_bwd 2, dropout 4, s2d_prologue 1 and
   step_draws 1 times, and three steps from one state must agree with a train step
   composed from the plain versions with autograd (tolerance printed).
5. Training with the reference's pool gradient: the same Trainer takes 20
   more steps with CONVNET_POOL_LRN_FUSED=1 and CONVNET_POOL_BACKEND=pallas
   set (and restored after). Each step must launch pool_lrn_fwd 2,
   pool_lrn_bwd 2, maxpool_fwd 1, lrn_fwd 0, lrn_bwd 0, dropout 4,
   s2d_prologue 1 and step_draws 1 times; the parameters stay finite; three steps from one
   state must agree with a step composed from the plain versions with
   autograd, the LRN -> pool chains taking cuda-convnet's all-ties pool
   gradient. Then (5b) the trained state through a checkpoint save ->
   load round trip, written and read by the port's own HDF5 module
   (convnet_tpu_torch/hdf5.py; no h5py), params and momenta array-equal,
   the seconds of each printed; and the shipped digits network, a file
   h5py wrote, served from examples/digits/digits_pretrained.h5 through
   Predictor.from_checkpoint: finite softmax rows, and top-1 error < 0.05
   (where sklearn imports).
6. Timing. Every kernel, its plain version and, where one PyTorch call
   computes the same function, that call, by device time with the
   launches hidden (device_ms: up to 20 calls over two input sets queued
   behind a spin, so no call finds its inputs in L2 and the card never
   waits for the host; each call first runs under
   set_sync_debug_mode("error")),
   beside its bound (the larger of its bytes over 3.35 TB/s and its
   operations over 67 TFLOP/s), the input prologue in its serving form
   (center crops) and its train form (random crops and flips) apart;
   each wrapper's host cost per call (the median of 200 calls queued
   behind a spin, no synchronize); the forward pass and the train step
   on both paths (device time with the launches hidden, one call a
   spin, median of 20; host clock
   with a synchronize, and CUDA events around one call); the Predictor's
   milliseconds per batch and images per second and the Trainer's images
   per second over 50 steps.
7. The model zoo and the CLIs. (a) LOCAL at alexnet_local's conv4
   ((128, 13, 13, 384) in, weight (13, 13, 3456, 384), pad 1): forward, dx
   and dw against float64 on the card, f32 within 1e-5 and bf16 within
   1e-2 of the largest element, and the bf16 forward's and backward's
   device times. (b) examples/imagenet/alexnet_local.pbtxt at full width
   (bf16, batch 128), 10 steps through the train CLI
   (convnet_tpu_torch.cli.train.main, in this process) over DUMMY
   ImageNet-shaped data with --profile-dir, from a temp copy of the model
   that logs a loss every 5 steps (the model's own checkpoint_after, so
   the CLI writes its 2.28 GB checkpoint at its end): each step must
   launch lrn_fwd 2, lrn_bwd 2,
   dropout 4, s2d_prologue 1 and step_draws 1 times, every parameter (the 224M-element
   LOCAL weight too) move and stay finite, the logged losses be finite
   and a trace be written; then its train step's times beside AlexNet's.
   (c) the grad_check CLI on the card in f32 at its defaults (eps 1e-3,
   tol 2e-3) over a small conv -> LRN -> max pool -> LOCAL ->
   CONV_ONETOONE -> FC model: no failure, and the LRN kernels launched.
   (d) conv_autoencoder, 5 train steps over DUMMY 32x32x3 data: finite
   losses, every parameter moved. (e) fc7 from (b)'s checkpoint through
   the extract CLI, read back with hdf5.py: 256 finite rows.
8. Stored data, several steps per launch, remat. (a) A learnable set
   (1280 uint8 256x256x3 images over 10 classes, each class its colour
   offset and stripes, plus noise; int32 labels), written with the port's
   write_raw_cache and as two HDF5 files by hdf5.py (contiguous, and
   chunked by 128 rows), with compute_mean's full-pixel and per-channel
   mean files (the host ms per batch of the C++ gather, the plain memmap
   read and DataHandler.get_batch over the raw cache and both HDF5 files
   printed), trains full-width AlexNet (scale 1/255, no mean) through the
   train CLI
   at --steps-per-launch 4 for 600 steps, logging every 20: the last
   logged loss must fall below ln 10 and the last window's train error
   below 0.5 (the pbtxt's eps first, then x2, x4 and x8 from the same
   state; the eps used is printed); the CLI's --profile-dir traces its
   window of replays, and each replayed step must launch there, counted
   by kernel name in the trace and tied to its cudaGraphLaunch by the
   trace's correlation id, what an eager step does (and so by its
   capture's count): exactly so for every replay inside the window, at
   most so for the first and the last, which the profiler's start and
   stop may cut. (b) Where PIL imports:
   JPEG and mixed JPEG/PNG lists through IMAGE_RAW (each reader printed),
   SLIDING_WINDOW's features on the card against the CPU, and through the
   extract CLI, and a TXT stream. (c) From one state
   and 8 staged batches, replays of the captured step against eager
   steps: each step's crops, flips and dropout keys and masks
   array-equal, parameters and momenta array-equal or within UPDATE_TOL;
   the step's time at 1 and 4 a launch on both train paths, and
   Trainer.train's img/s over 48 steps at 1 and 4 a launch on DUMMY and
   on the raw cache (each with the phase's mean) and on the contiguous
   HDF5 file (with the per-channel mean file, so the input prologue
   kernel takes the file's affine), with its host stages' ms. (d) One AlexNet
   step with remat on and off from one state: parameters equal or within
   UPDATE_TOL; max_memory_allocated of each. (e) HDF5 end to end:
   full-width AlexNet (bf16, batch 128) through the train CLI over the
   contiguous HDF5 file with the full-pixel mean file (random crops and
   flips; the jitter takes the plain path, as the JAX package's does for
   a full-pixel mean), 15 steps writing two checkpoints (step 10's and the
   CLI's at its end), then a second CLI run on the same directory to step
   20 that must resume at step 15 with params array-equal to the newest
   checkpoint; then fc7 through the extract CLI from the newest checkpoint
   over the chunked HDF5 file, written by the port's DataWriter and read
   back with hdf5.py: 1280 finite rows, within 1e-2 of the largest |fc7|
   of a Predictor's fc7 of the same rows, and the extract's rows/s. (f) The
   normalize path: AlexNet from seed-0 params over the contiguous HDF5
   file with the per-channel mean and std (the prologue kernel takes the
   file's affine); 3 steps against the plain-composed step (UPDATE_TOL),
   then at eps x1, x0.5 and x0.25 of the pbtxt's (and over (a)'s 1/255
   set at x1), 400 steps of the kernel path (eager, TRAIN_PER_STEP
   launches a step) and of the plain-composed path side by side on the
   same batches, each path's losses and first non-finite step printed
   (one path diverging alone would be a kernel fault; both, the
   dynamics); at x0.25 the kernel path must stay finite and meet (a)'s
   bars on the normalized set. A JSON line holds
   phase 8's numbers (and phase 5b's checkpoint seconds).
9. The mesh path (convnet_tpu_torch/parallel). (a) Full-width
   examples/imagenet/alexnet_2tower.pbtxt (bf16, and again in f32, batch
   128, uint8 256x256 images with random 224 crops and flips, dropout 0.5)
   in worlds of ranks that share this card over gloo with CUDA tensors,
   each rank a process started with "spawn": meshes 2x1 and 1x2 (2 ranks)
   and 2x2 (4 ranks: the pbtxt's 4x2 clamped, with the JAX package's
   warning). Each takes 3 steps from seed-0 params over 3 global batches
   and is held to one device's 3 steps on this card: every rank launches
   lrn_fwd 2, lrn_bwd 2, dropout 4, s2d_prologue 1 (bf16; f32 crops in
   plain PyTorch) and step_draws 1 times a step; its sharded leaves are
   1/n of the full ones; its crops, flips and dropout masks (each
   dropout call's key and element offset, as the model made them) are
   array-equal to one device's rows. In f32 the gathered momenta are
   within UPDATE_TOL of their largest element and the params within
   UPDATE_TOL of their largest update plus 2 ulps. In bf16 one device's
   own steps move by up to 0.15 of the largest momentum when it computes
   each half of the batch in turn (cuDNN sums another batch in another
   order, and max pools then route gradients through other winners), so
   each mesh is held to twice that distance, measured in the same run, and
   the 2x1 mesh array-equal to that in-turn computation. Several steps a
   launch over gloo must raise, naming the backend. (b) A world of one over NCCL in this
   process and make_mesh(1, 1), so the gradient all-reduce really runs:
   phase 8c's replays against eager steps with that mesh (the capture
   holds the all-reduce), the AlexNet step's times at 1 and 4 a launch
   beside phase 8c's (the all-reduce's own cost on one card, no scaling
   figure), and a Trainer on that mesh at 4 a launch. (c) The train CLI
   in a world of 2 ranks over gloo on this card, torchrun's environment
   set by hand: a few alexnet_2tower steps, rank 0's log alone and its
   two checkpoints. A JSON line holds phase 9's numbers;
   the kernels' line counts each 9a mesh's rank 0 launches. A failing
   rank fails the phase.
10. The port's measurement scripts. (a) `python -m
   convnet_tpu_torch.bench` in a subprocess at its default batch and
   steps a launch on synthetic data, 20 timed launches, then with --data
   rawcache at one step a launch: each last line must parse, with img/s
   above 0, an mfu in (0, 1.05], a finite final loss and the card's name
   holding "H100". (b) Where the bench's batch is above phase 2's 128,
   each kernel its step launches at that batch against its plain version
   by phase 2's bars (the plain LRN versions a million rows at a time
   over every row). (c) The pipeline bench (AlexNet's inference at 1024
   and 256, the prologue's MB/s, the CIFAR-10 step) with 5 timed calls,
   each path's launches counted, and three CIFAR-10 f32 train steps
   against a step composed from the plain versions (UPDATE_TOL). (d)
   profile_alexnet at batch 128 with 3 calls a row (its trace's device
   time by category and idle share) and the sweep's bf16 variants at 128,
   1 and 4 steps a launch. (e) The bench's step at its batch launches
   lrn_fwd 2, lrn_bwd 2, dropout 4, s2d_prologue 1 and step_draws 1 a
   step, eager (and, where the bench takes several steps a launch, as the
   graph it replays). A JSON line holds phase 10's
   numbers and its seconds; the kernels' line counts its paths.
11. The chip probes. (a) The copy kernel (csrc/copy_add.cu, o = a + b on
   bf16) at the JAX sweep's (290400, 1024) pair in each of its six
   tilings, and at a ragged (1001, 1000) in whole rows and 128-column
   tiles, array-equal to a + b over every row (the kernels line's
   max_abs_err is the largest |kernel - (a + b)| of those calls); an
   input off a 16-byte boundary, or not contiguous, refused before any
   launch. `python -m convnet_tpu_torch.tools.copy_probe` and `python -m
   convnet_tpu_torch.tools.serving_probe` (512 extract rows) run in
   subprocesses with 5 calls a line: each line must parse and name the
   H100 and its power limit; each tiling's line holds every kernel's
   launches while it was timed, copy_add's at least one a call and no
   other kernel's (their sums are the copy probe's path in the kernels
   line). (b) The kernel at the probe's fastest tiling, its plain version
   and torch.add by device time, beside its bound. (c) The serving
   probe's Predictor (full-width AlexNet, seed-0 params) at batch 1 and
   64: a request launches lrn_fwd 2 and s2d_prologue 1, and its outputs
   meet phase 3's bars; the batch-1 forward's host enqueue four ways
   (inside calls that read the outputs, after a synchronize, after a 50
   ms host sleep, with the card held behind a spin). (d) The probe's extracted fc7 within phase 8e's
   bar of a Predictor's fc7 of the same rows. A JSON line holds phase
   11's numbers.
12. The gather probes (ROADMAP Queue B rows 15-29: the sub-probes of
   tools/r5_probe_gather{,2,3,4}.py, through csrc/crop_window.cu,
   csrc/relayout.cu and csrc/crop_deinterleave.cu). (a) Every sub-probe
   of convnet_tpu_torch/tools/gather_probe.py through its kernel, bit for
   bit equal to its plain version on the card: at the probes' shapes, at
   a ragged shape (7 images of 252 x 760 cropped to 220 x 660) with the
   offsets at both ends of their range in turn, and from inputs one
   element past a 16-byte boundary; the edge geometries that reach every
   branch of the three kernels (gather_probe.EDGES), aligned and not;
   P1-fix, P13b, P24 and P31 at batch 4096; windows that leave their input
   written as zeros (crop_window, in u8 and bf16) and NaN
   (crop_deinterleave), as the plain versions write them, and a relayout
   map that reads outside its input refused before any launch. (b)
   `python -m convnet_tpu_torch.tools.gather_probe --calls 5` in a
   subprocess: every line must parse and name the H100 and its power
   limit, each sub-probe's line launch its own kernel (at least once a
   timed call) and no other, with max_abs_err 0, and the last line
   (crop_deinterleave with flips against jitter_s2d's train form at batch
   4096) launch those two only; their sums are the gather probe's path
   in the kernels line. (c) Each kernel's entry in the kernels line: its
   times from the probe's line of P1-fix at batch 4096 (crop_window), P30
   (relayout) and P31 at batch 4096 (crop_deinterleave), every sub-probe's
   times beside them, the wrapper's host cost there, and phase 12a's
   largest |kernel - plain|. A JSON line holds phase 12's numbers.

The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' launch counts, errors and times as JSON. With --profile-dir
the forward pass and five train steps of each path are also traced with
torch.profiler into that directory (with --time-only too), and phase 7a
writes a table of five LOCAL forwards and backwards there, phase 7b one
of five alexnet_local train steps. --time-only
runs phases 1 and 6 alone, without the plain versions and library calls,
and prints the times as one JSON line (with the step at 4 a launch and
the Trainer's img/s at 4 a launch where the checkout has them, else
"n/a"); --root imports convnet_tpu_torch from another checkout, so that
two commits' kernels can be timed in turns in one call; --kernels TEXT
times just the kernels whose name holds TEXT, a few seconds a turn while a
kernel is being tuned. --ulp-study runs
phase 1 and then measures, over SEEDS seeds a shape, how far the two
backward kernels' bf16 results and their plain versions' fall from a
float64 result and from each other: the measurement behind the bf16 bars.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# device timing: KCALLS back-to-back calls behind a spin, median of REPS
# runs; a wrapper's host cost: median of HOST_CALLS calls
KCALLS, REPS, HOST_CALLS = 20, 3, 200
HOST_SPIN_MS = 100  # outlasts HOST_CALLS calls of the slowest wrapper (about 90 us each)
TRAIN_STEPS, TRAINER_STEPS, PARITY_STEPS = 20, 50, 3
DUMMY_ROWS = 384
MEAN = 0.45
# bf16 train steps: each parameter's update within this share of its
# largest update from the plain-composed step (see check_train_parity)
UPDATE_TOL = 6e-2
# the switches of the reference-gradient train path (the JAX package's)
POOL_SWITCHES = {"CONVNET_POOL_LRN_FUSED": "1", "CONVNET_POOL_BACKEND": "pallas"}
# the bound of a kernel: the larger of its bytes over the card's memory
# rate and its operations over the card's f32 rate outside the tensor
# cores (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores (LOCAL's products)


def device_ms(*calls, k: int = KCALLS, reps: int = REPS) -> float:
    """Device milliseconds per call with the host's launches hidden behind
    a spin (`convnet_tpu_torch/utils/card.py device_ms`)."""
    from convnet_tpu_torch.utils import card

    return card.device_ms(*calls, k=k, reps=reps)


def host_us(fn, n: int = HOST_CALLS) -> float:
    """Median host microseconds of one call of fn over n calls, without a
    synchronize: what a wrapper costs the host (checks, allocation, the
    launch), not the kernel's time. The calls queue behind a spin kernel
    that outlasts them, so every wrapper launches onto a card in the same
    state (busy), however fast its own kernel drains the queue."""
    import torch

    from convnet_tpu_torch.utils.card import SPIN_CYCLES_PER_MS

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(HOST_SPIN_MS * SPIN_CYCLES_PER_MS))
    spent = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        spent.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(spent) * 1e6


def enqueue_ms(fn, calls: int = 2, reps: int = ITERS) -> float:
    """Host milliseconds to enqueue one call of fn with the card held
    behind a spin (`convnet_tpu_torch/utils/card.py enqueue_ms`)."""
    from convnet_tpu_torch.utils import card

    return card.enqueue_ms(fn, calls=calls, reps=reps)


def request_ms(pred, x) -> float:
    """Median host clock of one Predictor request (numpy in, numpy out)
    over ITERS requests after WARMUP."""
    host = []
    for i in range(WARMUP + ITERS):
        t0 = time.perf_counter()
        pred({"input": x})
        if i >= WARMUP:
            host.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host)


def bf16_ulp_map(a, b):
    """The distance in bf16 ulps between two bf16 tensors, element by element."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i >= 0, i, -32768 - i)

    return (ordered(a) - ordered(b)).abs()


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    return int(bf16_ulp_map(a, b).max().item())


def lrn_bwd_f64(g, z, n, alpha, beta, bias=None, relu=False, blocked=False):
    """dx of the LRN backward in float64, by the plain chain's formula with
    the powers from pow: the yardstick of the bf16 bars. g: the cotangent of
    the LRN output (any float dtype); z: the conv output without its bias."""
    import torch

    from convnet_tpu_torch.ops import lrn

    zf = z.double()
    if bias is not None:
        zf = zf + bias.double()
    x = torch.relu(zf) if relu else zf
    gf = g.double()
    d = 1.0 + alpha * lrn._window_sum(x * x, n, blocked)
    inner = lrn._window_sum(gf * x * d ** -(beta + 1.0), n, blocked, transpose=True)
    dx = gf * d ** -beta - 2.0 * alpha * beta * x * inner
    return torch.where(zf > 0.0, dx, 0.0) if relu else dx


def bf16_distances(kernel, plain, ref64):
    """(kernel to float64, plain to float64, kernel to plain): the largest
    distances in bf16 ulps, float64 rounded to bf16 through f32."""
    import torch

    ref = ref64.float().to(torch.bfloat16)
    return bf16_ulps(kernel, ref), bf16_ulps(plain, ref), bf16_ulps(kernel, plain)


def expect_bf16_close(tag, kernel, plain, ref64, kernel_to_plain) -> str:
    """The bf16 bar of a backward kernel. Neither the kernel nor its plain
    version is the truth: each rounds an f32 chain once, in its own order
    of operations, so near a rounding boundary they land one bf16 value
    apart, and where dx's two summands cancel both stray far from float64
    (tens of ulps on a handful of elements in 6e8) while staying together.
    So the kernel is held to the plain version by `kernel_to_plain`, the
    largest kernel-to-plain distance measured over many seeds (--ulp-study),
    and to float64 by the plain version's own distance on these inputs plus
    that allowance. Returns the distances as text; raises beyond the bar."""
    k64, p64, kp = bf16_distances(kernel, plain, ref64)
    msg = f"bf16_ulps kernel-plain {kp}, kernel-float64 {k64}, plain-float64 {p64}"
    if kp > kernel_to_plain or k64 > p64 + kernel_to_plain:
        raise AssertionError(f"{tag}: {msg}; bar: kernel-plain <= {kernel_to_plain} and "
                             f"kernel-float64 <= plain-float64 + {kernel_to_plain}")
    return msg


def expect_served(what, graph, params, req, out, spec, mean_t, card) -> float:
    """Phase 3's bars for one request of AlexNet's Predictor (uint8 req,
    numpy outputs): outputs finite, of shape (n, 1000), softmax rows
    summing to 1 within 1e-3, and the logits within 1e-2 of the largest
    |logit| of the forward composed from the plain versions, top-1 agreeing
    wherever the plain forward's top-2 margin is above twice that. Returns
    the largest |logit - plain|."""
    import numpy as np
    import torch

    n = len(req)
    logits, probs = out["output:preact"], out["output"].reshape(n, -1)
    if logits.shape != (n, 1000) or probs.shape != (n, 1000):
        raise AssertionError(f"{what}: output shapes {logits.shape}, {probs.shape} != ({n}, 1000)")
    if not (np.isfinite(logits).all() and np.isfinite(probs).all()):
        raise AssertionError(f"{what}: non-finite outputs")
    row_err = np.abs(probs.sum(-1) - 1.0).max()
    if row_err > 1e-3:
        raise AssertionError(f"{what}: softmax rows sum to 1 +- {row_err}")
    with torch.inference_mode():
        ref = plain_alexnet(graph, params, torch.from_numpy(req).to(mean_t.device), spec, mean_t)
    ref = ref.cpu().numpy()
    # the kernel and its plain version may round a bf16 LRN output the
    # other way (1 ulp); through five bf16 layers that stays far below
    # 1e-2 of the largest logit
    tol = 1e-2 * np.abs(ref).max()
    err = float(np.abs(logits - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * tol
    agree = logits.argmax(-1) == ref.argmax(-1)
    print(f"[{card}] {what}: max|logit - plain| {err} (tol {tol}); top-1 agrees on "
          f"{int(agree.sum())}/{n}, on {int(agree[decided].sum())}/{int(decided.sum())} with "
          f"top-2 margin > 2*tol; softmax row-sum error {row_err}")
    if err > tol or not agree[decided].all():
        raise AssertionError(f"{what}: the served logits disagree with the plain-composed forward")
    return err


def reset_launches():
    from convnet_tpu_torch.ops import (copy_add, dropout, fused_pool_lrn, gather, lrn, pool,
                                       s2d_relayout)

    lrn.LAUNCHES = lrn.BWD_LAUNCHES = dropout.LAUNCHES = s2d_relayout.LAUNCHES = 0
    pool.LAUNCHES = fused_pool_lrn.LAUNCHES = fused_pool_lrn.BWD_LAUNCHES = 0
    dropout.DRAW_LAUNCHES = copy_add.LAUNCHES = 0
    gather.CROP_WINDOW_LAUNCHES = gather.RELAYOUT_LAUNCHES = 0
    gather.CROP_DEINTERLEAVE_LAUNCHES = 0


def read_launches():
    from convnet_tpu_torch.ops import launch_counts

    return launch_counts()


# a train step's launches on the default path (step_draws: the dropout keys
# and the crops, drawn on the card)
TRAIN_PER_STEP = {"lrn_fwd": 2, "lrn_bwd": 2, "dropout": 4, "s2d_prologue": 1, "step_draws": 1}


def expect_launches(what, got, per_call, calls):
    """Raise unless every kernel launched per_call[k] * calls times (0 for
    a kernel not named)."""
    want = {k: per_call.get(k, 0) * calls for k in got}
    if got != want:
        raise AssertionError(f"{what} did not go through the kernels: {got}, expected {want}")


@contextlib.contextmanager
def pool_switches():
    """The reference-gradient path's switches, set for the block and
    restored after it."""
    saved = {k: os.environ.get(k) for k in POOL_SWITCHES}
    os.environ.update(POOL_SWITCHES)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(the least milliseconds the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dummy_imagenet_text(batch: int, rows: int, randomize: bool) -> str:
    """A DUMMY DatasetConfig shaped like ImageNet's train data, as pbtxt
    text: uint8 256x256x3 images cropped to 224 with random translations
    and flips, scale 1/255, 1000 classes."""
    return f"""
        name: "dummy_imagenet" batch_size: {batch} randomize_cpu: {str(randomize).lower()}
        data_config {{ layer_name: "input" data_type: DUMMY raw_image_size: {RAW}
                      image_size: {CROP} num_colors: 3 can_translate: true can_flip: true
                      scale: {1 / 255} dummy_size: {rows} }}
        data_config {{ layer_name: "labels" data_type: DUMMY dummy_size: {rows}
                      dummy_num_classes: 1000 }}
    """


def dummy_imagenet(batch: int, rows: int, randomize: bool):
    """dummy_imagenet_text's DatasetConfig. Nothing is read from or written
    to disk."""
    from convnet_tpu_torch.config import parse_dataset_config

    return parse_dataset_config(dummy_imagenet_text(batch, rows, randomize))


def clone_state(state):
    def copy(tree):
        return {n: {k: v.detach().clone() for k, v in p.items()} for n, p in tree.items()}

    return {"params": copy(state["params"]), "moms": copy(state["moms"]),
            "step": state["step"], "seed": state["seed"]}


def check_train_parity(graph, state, jitter, batches, spec, mean_t, card, fused=False,
                       std_t=None, plain_step=None):
    """PARITY_STEPS steps of the port's train step and of the plain-
    composed one from the same state, keys and batches (fused: the
    reference-gradient path, under pool_switches()); plain_step(state,
    batch) -> loss takes the place of AlexNet's plain_train_step. Each momentum
    buffer (the sum of the steps' updates) must agree within UPDATE_TOL of
    its largest element, and each parameter within UPDATE_TOL of its
    largest update plus 2 ulps of its largest element (an update below
    half an ulp leaves an f32 weight unchanged). UPDATE_TOL because the
    LRN kernels may round a bf16 value the other way (1 ulp), and a max
    pool can then pick another winner among near-equal bf16 values, which
    routes that window's gradient elsewhere."""
    import numpy as np
    import torch

    from convnet_tpu_torch.trainer import make_train_step

    step = make_train_step(graph, jitter)
    if plain_step is None:
        def plain_step(st, b):
            return plain_train_step(graph, st, b, spec, mean_t, fused, std_t)
    port, plain, start = clone_state(state), clone_state(state), clone_state(state)
    losses, plain_losses = [], []
    for b in batches:
        losses.append(step(port, b)["loss"].item())
        plain_losses.append(plain_step(plain, b).item())
    print(f"[{card}] {PARITY_STEPS} train steps: port losses {losses}, plain-composed {plain_losses}")
    for name in start["params"]:
        for k in ("w", "b"):
            m_port, m_plain = port["moms"][name][k], plain["moms"][name][k]
            m_err = (m_port - m_plain).abs().max().item()
            m_scale = m_plain.abs().max().item()
            p0 = start["params"][name][k]
            upd = (plain["params"][name][k] - p0).abs().max().item()
            p_err = (port["params"][name][k] - plain["params"][name][k]).abs().max().item()
            big = p0.abs().max()
            ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big).item()
            p_tol = UPDATE_TOL * upd + 2 * ulp
            print(f"[{card}]   {name}/{k}: momentum |port - plain| {m_err} = "
                  f"{m_err / m_scale if m_scale else 0.0:.4g} of its largest {m_scale}; "
                  f"param |port - plain| {p_err} (largest update {upd}, tolerance {p_tol})")
            if m_err > UPDATE_TOL * m_scale or p_err > p_tol:
                raise AssertionError(f"{name}/{k}: the port's step differs from the plain one")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")


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
# phase 2 adds a ragged shape: C = 100 takes the kernels' one-channel path
# (200 bytes a bf16 row), M = 3001 leaves a short last tile. Its inputs
# come from a generator of their own, so the AlexNet shapes' inputs stay
# the draws of the shared one. It keeps that generator: --ulp-study found
# the backward kernel 0 or 1 bf16 ulp from its plain version on every
# seed, but 2 have been seen once on other inputs (a cancelling element),
# and fixed inputs keep this check from turning on a draw.
CHECK_SHAPES = {**LRN_SHAPES, "ragged": (3001, 100)}
RAGGED_SEED = 1


def shape_generators(dev, gen):
    """(name, (m, c), generator) of each CHECK_SHAPES entry."""
    import torch

    ragged = torch.Generator(device=dev)
    ragged.manual_seed(RAGGED_SEED)
    return [(name, mc, gen if name in LRN_SHAPES else ragged) for name, mc in CHECK_SHAPES.items()]


def check_lrn(dev, gen, card):
    """Kernel A vs its plain version: 1 bf16 ulp, f32 rtol 1e-5; and array-
    equal to lrn_y, as the fused LRN -> max pool kernel computes it. Returns
    max |err| over the cases."""
    import torch

    from convnet_tpu_torch.ops import fused_pool_lrn as plrn
    from convnet_tpu_torch.ops import lrn

    worst = 0.0
    for shape_name, (m, c), rng in shape_generators(dev, gen):
        z32 = 2.0 * torch.randn((m, c), generator=rng, device=dev)
        bias = 0.5 * torch.randn((c,), generator=rng, device=dev)
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
                    # the fused LRN -> max pool kernel with a 1x1 pool writes
                    # lrn_y, the y its backward recomputes to find ties
                    lrn_y = plrn.pool_lrn_fwd(z.view(m, 1, 1, c), n, alpha, 0.75, 1, 1, bias=b,
                                              relu=use_bias, blocked=blocked)
                    if not torch.equal(got.view(m, 1, 1, c), lrn_y):
                        raise AssertionError(f"{tag}: y differs from pool_lrn.cu's lrn_y")
    return worst


# The bf16 bars of the two backward kernels, in bf16 ulps between kernel and
# plain version (expect_bf16_close): the largest distance --ulp-study found
# over 16 seeds at each of rnorm1, rnorm2 and (3001, 100) in three forms
# (lrn_bwd: 0 or 1 in 8.8e9 elements) and at both chains on tie-heavy and on
# normal inputs (pool_lrn_bwd: 0 or 1 in 3.9e9), NVIDIA H100 80GB HBM3.
LRN_BWD_ULPS = 1
POOL_LRN_BWD_ULPS = 1


def check_lrn_bwd(dev, gen, card):
    """The LRN backward kernel vs its plain version. bf16 dx at AlexNet's
    alpha: the bar of expect_bf16_close with LRN_BWD_ULPS; f32 dx: rtol
    1e-4, atol 3e-5 of the largest |dx| (also at alpha = 0.2, where it
    cancels); db: rtol 1e-4 of a float64 column sum of the plain f32 dx.
    Returns max |dx err|."""
    import torch

    from convnet_tpu_torch.ops import lrn

    worst = 0.0
    for shape_name, (m, c), rng in shape_generators(dev, gen):
        z32 = 2.0 * torch.randn((m, c), generator=rng, device=dev)
        g32 = torch.randn((m, c), generator=rng, device=dev)
        bias = 0.5 * torch.randn((c,), generator=rng, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            z, g = z32.to(dtype), g32.to(dtype)
            scales = (1e-4, 1.0) if dtype == torch.float32 else (1e-4,)
            for add_scale in scales:
                for use_bias, blocked in ((True, False), (False, False), (True, True)):
                    b = bias if use_bias else None
                    n, alpha = 5, add_scale / 5
                    dx, db = lrn.lrn_bwd(g, z, n, alpha, 0.75, bias=b, relu=use_bias,
                                         blocked=blocked)
                    want = lrn._bwd_math(g, z, n, alpha, 0.75, b, use_bias, blocked)[0]
                    torch.cuda.synchronize()
                    err = (dx.float() - want.float()).abs().max().item()
                    worst = max(worst, err)
                    tag = (f"lrn_bwd {shape_name} ({m},{c}) {str(dtype)[6:]} add_scale={add_scale} "
                           f"bias+relu={use_bias} blocked={blocked}")
                    if dtype == torch.bfloat16:
                        ref64 = lrn_bwd_f64(g, z, n, alpha, 0.75, b, use_bias, blocked)
                        msg = f"max_abs_err {err} " + expect_bf16_close(tag, dx, want, ref64,
                                                                        LRN_BWD_ULPS)
                        del ref64
                    else:
                        msg = f"max_abs_err {err}"
                        torch.testing.assert_close(dx, want, rtol=1e-4,
                                                   atol=3e-5 * want.abs().max().item())
                    if use_bias:
                        ref = lrn._bwd_math(g.float(), z.float(), n, alpha, 0.75, b, True,
                                            blocked)[0].double()
                        db_rel = ((db.double() - ref.sum(0)).abs() / ref.sum(0).abs()).max().item()
                        msg += f"; db max_rel_err {db_rel}"
                        torch.testing.assert_close(db.double(), ref.sum(0), rtol=1e-4,
                                                   atol=1e-5 * ref.abs().sum(0).max().item())
                        again = lrn.lrn_bwd(g, z, n, alpha, 0.75, bias=b, relu=True,
                                            blocked=blocked)[1]
                        if not torch.equal(db, again):
                            raise AssertionError(f"{tag}: db differs between two runs")
                    print(f"[{card}] {tag}: {msg}")
    return worst


def check_dropout(dev, gen, card):
    """The dropout kernel vs its plain version at fc6/fc7's shape: array-
    equal; the backward's mask equals the forward's; the keep fraction
    within 4 sigma of 0.5; another step or layer draws another mask.
    Returns max |err| (0)."""
    import torch

    from convnet_tpu_torch.ops import dropout as drop

    n = BATCH * 4096
    sigma = 0.5 / n ** 0.5
    key = drop.dropout_key(0, 7, 10)
    keep = drop.dropout_bits(n, key, device=dev).view(BATCH, 1, 1, 4096) >= drop.keep_threshold(0.5)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.rand((BATCH, 1, 1, 4096), generator=gen, device=dev) + 0.5).to(dtype)
        got = drop.dropout_apply(x, 0.5, key)
        want = drop.dropout_reference(x, 0.5, key)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        xg = x.clone().requires_grad_()
        y = drop.dropout(xg, 0.5, key)
        (gx,) = torch.autograd.grad(y, xg, torch.ones_like(y))
        frac = keep.double().mean().item()
        other = [
            drop.dropout_apply(x, 0.5, drop.dropout_key(0, 8, 10)),
            drop.dropout_apply(x, 0.5, drop.dropout_key(0, 7, 11)),
        ]
        print(f"[{card}] dropout ({BATCH},1,1,4096) {str(dtype)[6:]}: max_abs_err {err}, "
              f"keep fraction {frac} (0.5 +- {4 * sigma})")
        if not torch.equal(got, want):
            raise AssertionError(f"dropout {dtype} is not array-equal to its plain version")
        if not (torch.equal(y != 0, keep) and torch.equal(gx != 0, keep)):
            raise AssertionError("dropout's backward mask differs from its forward mask")
        if abs(frac - 0.5) > 4 * sigma:
            raise AssertionError(f"keep fraction {frac} is more than 4 sigma from 0.5")
        if any(torch.equal(o != 0, keep) for o in other):
            raise AssertionError("another step or layer drew the same mask")
    # a batch split over a mesh's data axis: each rank's rows through
    # dropout at their element offset, forward and backward, are the rows
    # of the whole batch through it (inputs of a generator of their own,
    # so the shared one's later draws stay as they were)
    own = torch.Generator(device=dev)
    own.manual_seed(10)
    x = (torch.rand((BATCH, 1, 1, 4096), generator=own, device=dev) + 0.5).to(torch.bfloat16)
    xw = x.clone().requires_grad_()
    yw = drop.dropout(xw, 0.5, key)
    (gw,) = torch.autograd.grad(yw, xw, torch.ones_like(yw))
    for data in (2, 4):
        b = BATCH // data
        for d in range(data):
            xr = x[d * b:(d + 1) * b].clone().requires_grad_()
            yr = drop.dropout(xr, 0.5, key, d * b * 4096)
            (gr,) = torch.autograd.grad(yr, xr, torch.ones_like(yr))
            if not (torch.equal(yr, yw[d * b:(d + 1) * b]) and torch.equal(gr, gw[d * b:(d + 1) * b])):
                raise AssertionError(f"dropout of rows {d * b}.. at their offset differs from the "
                                     "whole batch's rows")
    print(f"[{card}] dropout at an element offset: each data rank's rows of ({BATCH},1,1,4096) "
          "bf16, at data 2 and 4, forward and backward array-equal to the whole batch's rows")
    return worst


# AlexNet's dropout layers, fc6 and fc7, by their index among the non-input
# layers (the number their keys are derived from)
ALEXNET_DROPOUT_LAYERS = (10, 11)


def check_step_draws(dev, card):
    """The step-draws kernel vs its plain version at a train step's draw:
    AlexNet's two dropout keys and the crops and flips of BATCH images RAW
    -> CROP, at several (seed, step), both halves of the 64-bit words in
    use: array-equal; the keys equal dropout_key's host derivation; the
    origins cover [0, RAW - CROP]; about half the images flip. Returns max
    |err| (0)."""
    import torch

    from convnet_tpu_torch.data.jitter import crop_draw
    from convnet_tpu_torch.ops import dropout as drop

    words = [(i, 0) for i in ALEXNET_DROPOUT_LAYERS]
    draw = crop_draw("input", BATCH, RAW, RAW, CROP, True, True)
    origins, flipped = set(), 0
    for seed, step in ((42, 0), (42, 1), (7, (1 << 32) + 5), ((1 << 33) + 1, 123)):
        state = torch.tensor([seed, step], dtype=torch.int64, device=dev)
        keys, crops = drop.step_draws(state, words, draw)
        want_keys, want_crops = drop.step_draws_reference(state, words, draw)
        torch.cuda.synchronize()
        if not (torch.equal(keys, want_keys)
                and all(torch.equal(a, b) for a, b in zip(crops, want_crops))):
            raise AssertionError(f"step_draws at (seed, step) ({seed}, {step}) differs from its "
                                 "plain version")
        host = [drop.dropout_key(seed, step, i) for i in ALEXNET_DROPOUT_LAYERS]
        if [tuple(k) for k in keys.tolist()] != host:
            raise AssertionError("step_draws' keys differ from dropout_key's")
        origins |= set(crops[0].tolist()) | set(crops[1].tolist())
        flipped += int(crops[2].sum().item())
    print(f"[{card}] step_draws ({len(words)} keys, crops of {BATCH} images {RAW} -> {CROP} with "
          f"flips) at 4 (seed, step): array-equal to its plain version, keys equal to "
          f"dropout_key's; {len(origins)} of {RAW - CROP + 1} origins drawn, {flipped} of "
          f"{4 * BATCH} images flipped")
    if origins - set(range(RAW - CROP + 1)) or not 0.35 < flipped / (4 * BATCH) < 0.65:
        raise AssertionError("step_draws' crops fall outside their range or its flips are skewed")
    # a data rank's rows (row0 = d * BATCH / data): its draw is those rows of
    # the whole batch's, and the plain version's
    state = torch.tensor([42, 3], dtype=torch.int64, device=dev)
    whole = drop.step_draws(state, words, draw)
    for data in (2, 4):
        b = BATCH // data
        for d in range(data):
            part = crop_draw("input", b, RAW, RAW, CROP, True, True, d * b)
            keys, crops = drop.step_draws(state, words, part)
            want_keys, want_crops = drop.step_draws_reference(state, words, part)
            same = torch.equal(keys, whole[0]) and torch.equal(keys, want_keys) and all(
                torch.equal(a, w[d * b:(d + 1) * b]) and torch.equal(a, p)
                for a, w, p in zip(crops, whole[1], want_crops))
            if not same:
                raise AssertionError(f"step_draws of rows {d * b}.. differs from the whole "
                                     "batch's rows or from its plain version")
    print(f"[{card}] step_draws of a data rank's rows (data 2 and 4): array-equal to the whole "
          "batch's rows and to the plain version")
    return 0.0


# AlexNet's max pools (k3 s2) and its LRN -> pool chains at batch 128
POOL_SHAPES = {"pool1": (BATCH, 55, 55, 96), "pool2": (BATCH, 27, 27, 256),
               "pool5": (BATCH, 13, 13, 256)}
CHAINS = {"rnorm1": (BATCH, 55, 55, 96), "rnorm2": (BATCH, 27, 27, 256)}
LRN_N, LRN_ALPHA = 5, 1e-4 / 5  # AlexNet's size-5 window, add_scale 1e-4


def halves(gen, shape, dev, dtype):
    """Normal values rounded to halves: window maxima tie often, as they do
    on post-ReLU zeros and quantized activations."""
    import torch

    return (torch.round(2.0 * torch.randn(shape, generator=gen, device=dev)) / 2).to(dtype)


def tied_windows(y, m, k, s) -> int:
    """How many windows of a k/s pool (exact cover) hold its max more than once."""
    import torch

    oh, ow = m.shape[1], m.shape[2]
    count = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    for i in range(k):
        for j in range(k):
            count += y[:, i: i + s * (oh - 1) + 1: s, j: j + s * (ow - 1) + 1: s] == m
    return int((count > 1).sum().item())


# NaN bit patterns planted in the max pool's inputs: quiet and signalling,
# both signs, other payloads. ATen's scan keeps a window's last NaN as it is.
NAN_BITS = {"bfloat16": (0x7FC0, -64, 0x7F81, -91), "float32": (0x7FC00000, -4194304, 0x7F800001,
                                                                 -8388607)}
# the max pool's checks beyond AlexNet's pools: a channel row of no whole
# number of 16-byte words in bf16 (C = 100), padding and the ceil-mode last
# window (14 -> 8 at k3 s2 p1)
POOL_RAGGED = ((BATCH, 14, 14, 100), 3, 2, 1)


def plant_nans(gen, x, share=0.01):
    """x with `share` of its elements set to NaN bit patterns (NAN_BITS):
    windows that hold one NaN or several, of other payloads."""
    import torch

    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[x.dtype]
    bits = torch.tensor(NAN_BITS[str(x.dtype)[6:]], dtype=ints, device=x.device)
    n = int(share * x.numel())
    at = torch.randint(0, x.numel(), (n,), generator=gen, device=x.device)
    pick = torch.randint(0, len(bits), (n,), generator=gen, device=x.device)
    x.view(ints).view(-1)[at] = bits[pick]
    return x


def same_bits(a, b) -> bool:
    """Bit for bit: NaN payloads and the sign of zero count."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def unaligned(x, elements=1):
    """A contiguous copy of x whose storage starts `elements` elements past
    a 16-byte boundary (a view with a storage offset)."""
    import torch

    base = torch.empty(x.numel() + elements, dtype=x.dtype, device=x.device)
    view = base[elements:].view(x.shape)
    view.copy_(x)
    return view


def check_maxpool(dev, gen, card):
    """The max pool kernel vs its plain version, bit for bit (NaN payloads
    and the sign of zero included): at pool1, pool2 and pool5 and at
    POOL_RAGGED, on tie-heavy inputs (halves, with -0 and +0) with planted
    NaNs, each also from a view 2 or 4 bytes past a 16-byte boundary (the
    kernel's one-value form), bf16 and f32. Returns max |err| over the
    non-NaN outputs (0)."""
    import torch

    from convnet_tpu_torch.ops import pool

    worst = 0.0
    cases = [(name, shape, 3, 2, 0) for name, shape in POOL_SHAPES.items()]
    cases.append(("ragged", *POOL_RAGGED))
    for name, shape, k, s, p in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = plant_nans(gen, halves(gen, shape, dev, dtype))
            want = pool.maxpool_reference(x, k, s, p)
            for form, xin in (("aligned", x), ("unaligned", unaligned(x))):
                got = pool.maxpool_fwd(xin, k, s, p)
                torch.cuda.synchronize()
                fin = torch.isfinite(want)
                err = (got.float() - want.float())[fin].abs().max().item()
                worst = max(worst, err)
                tag = f"maxpool_fwd {name} {shape} k{k} s{s} p{p} {str(dtype)[6:]} {form}"
                print(f"[{card}] {tag}: bit for bit {same_bits(got, want)}, max_abs_err {err}; "
                      f"{int(want.isnan().sum().item())} NaN and "
                      f"{int(((want == 0) & want.signbit()).sum().item())} -0 outputs of "
                      f"{want.numel()}" + (f", {tied_windows(x, want, k, s)} window maxima tied"
                                           if p == 0 else ""))
                if not same_bits(got, want):
                    raise AssertionError(f"{tag} is not bit for bit its plain version")
    return worst


def check_pool_lrn(dev, gen, card):
    """The fused LRN -> max pool kernels at both AlexNet chains, with bias
    and ReLU, tie-heavy inputs. Forward: array-equal to the plain max pool
    of the LRN kernel's output. Backward: the bar of expect_bf16_close with
    POOL_LRN_BWD_ULPS against the plain chain (all-ties pool-undo in f32,
    plain LRN backward) fed with that same y, float64 taking the same f32
    pool-undo sum; f32 dz within rtol 1e-4 and atol 3e-5 of the largest |dz|; db
    within rtol 1e-4 of a float64 sum and the same in two runs. Returns
    (max |m err|, max |dz err|)."""
    import torch

    from convnet_tpu_torch.ops import fused_pool_lrn as plrn
    from convnet_tpu_torch.ops import lrn, pool
    from convnet_tpu_torch.ops.pool import maxpool2d_undo_reference

    worst_m = worst_dz = 0.0
    for name, shape in CHAINS.items():
        c = shape[-1]
        z32 = halves(gen, shape, dev, torch.float32)
        bias = torch.round(0.5 * torch.randn((c,), generator=gen, device=dev))
        for dtype in (torch.bfloat16, torch.float32):
            z = z32.to(dtype)
            kw = dict(bias=bias, relu=True)
            tag = f"{name} {shape} {str(dtype)[6:]} bias+relu"
            m = plrn.pool_lrn_fwd(z, LRN_N, LRN_ALPHA, 0.75, 3, 2, **kw)
            y = lrn.lrn_fwd(z.view(-1, c), LRN_N, LRN_ALPHA, 0.75, **kw).view(shape)
            want_m = pool.maxpool_reference(y, 3, 2)
            torch.cuda.synchronize()
            err = (m.float() - want_m.float()).abs().max().item()
            worst_m = max(worst_m, err)
            print(f"[{card}] pool_lrn_fwd {tag}: max_abs_err {err} vs maxpool(lrn_fwd), bit for bit "
                  f"{same_bits(m, want_m)}; {tied_windows(y, m, 3, 2)} of {m.numel()} window "
                  "maxima tied")
            if not same_bits(m, want_m):
                raise AssertionError(f"pool_lrn_fwd {tag} is not bit for bit maxpool(lrn_fwd)")
            # without bias and ReLU (a ReLU maps NaN and -0 to +0): planted
            # NaNs, and windows that hold -0 and +0 (halves round to both)
            zn = plant_nans(gen, z.clone())
            mn = plrn.pool_lrn_fwd(zn, LRN_N, LRN_ALPHA, 0.75, 3, 2)
            yn = lrn.lrn_fwd(zn.view(-1, c), LRN_N, LRN_ALPHA, 0.75).view(shape)
            want_n = pool.maxpool_reference(yn, 3, 2)
            torch.cuda.synchronize()
            zeros = yn == 0
            neg = pool.maxpool_reference((zeros & yn.signbit()).float(), 3, 2) > 0
            pos = pool.maxpool_reference((zeros & ~yn.signbit()).float(), 3, 2) > 0
            both = int((neg & pos).sum().item())
            ok = same_bits(mn, want_n)
            print(f"[{card}] pool_lrn_fwd {name} {shape} {str(dtype)[6:]} NaNs and signed zeros: "
                  f"bit for bit {ok}; {int(want_n.isnan().sum().item())} NaN and "
                  f"{int(((want_n == 0) & want_n.signbit()).sum().item())} -0 outputs of "
                  f"{want_n.numel()}, {both} windows hold both -0 and +0")
            if not ok:
                differ = (mn.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                          != want_n.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
                raise AssertionError(f"pool_lrn_fwd {name} {dtype} with NaNs and signed zeros: "
                                     f"{int(differ.sum().item())} outputs differ in their bits "
                                     "from maxpool(lrn_fwd)")
            del zn, mn, yn, want_n, zeros
            g = torch.randn(m.shape, generator=gen, device=dev).to(dtype)
            dz, db = plrn.pool_lrn_bwd(g, m, z, LRN_N, LRN_ALPHA, 0.75, 3, 2, **kw)
            want_dz, _ = plrn._bwd_reference(g, m, z, LRN_N, LRN_ALPHA, 0.75, 3, 2, y=y, **kw)
            torch.cuda.synchronize()
            err = (dz.float() - want_dz.float()).abs().max().item()
            worst_dz = max(worst_dz, err)
            if dtype == torch.bfloat16:
                # up to four bf16 cotangents summed in f32: exact to 2^-24
                g_lrn = maxpool2d_undo_reference(y.float(), m.float(), g.float(), 3, 2)
                ref64 = lrn_bwd_f64(g_lrn, z, LRN_N, LRN_ALPHA, 0.75, bias, True)
                msg = f"max_abs_err {err} " + expect_bf16_close(f"pool_lrn_bwd {tag}", dz, want_dz,
                                                                ref64, POOL_LRN_BWD_ULPS)
                del g_lrn, ref64
            else:
                msg = f"max_abs_err {err}"
                torch.testing.assert_close(dz, want_dz, rtol=1e-4,
                                           atol=3e-5 * want_dz.abs().max().item())
            ref = plrn._bwd_reference(g.float(), m.float(), z.float(), LRN_N, LRN_ALPHA, 0.75, 3, 2,
                                      y=y.float(), **kw)[0].double().reshape(-1, c)
            db_rel = ((db.double() - ref.sum(0)).abs() / ref.sum(0).abs()).max().item()
            print(f"[{card}] pool_lrn_bwd {tag}: {msg}; db max_rel_err {db_rel}")
            torch.testing.assert_close(db.double(), ref.sum(0), rtol=1e-4,
                                       atol=1e-5 * ref.abs().sum(0).max().item())
            again = plrn.pool_lrn_bwd(g, m, z, LRN_N, LRN_ALPHA, 0.75, 3, 2, **kw)[1]
            if not torch.equal(db, again):
                raise AssertionError(f"pool_lrn_bwd {tag}: db differs between two runs")
    return worst_m, worst_dz


def ulp_study(dev, card, seeds: int) -> int:
    """--ulp-study: how far the bf16 results of the two backward kernels and
    of their plain versions fall from float64, and from each other, over
    `seeds` seeds a shape: lrn_bwd at rnorm1, rnorm2 and (3001, 100), with
    and without bias + ReLU and blocked; pool_lrn_bwd at both chains, on
    tie-heavy inputs (halves) and on normal ones. Prints, for each case, the
    largest distance in bf16 ulps over all seeds and how many elements lie 2
    or more ulps apart, then everything as one JSON line. The bars of
    check_lrn_bwd and check_pool_lrn (LRN_BWD_ULPS, POOL_LRN_BWD_ULPS) come
    from this."""
    import torch

    from convnet_tpu_torch.ops import fused_pool_lrn as plrn
    from convnet_tpu_torch.ops import lrn
    from convnet_tpu_torch.ops.pool import maxpool2d_undo_reference

    out = {}

    def record(name, kernel, plain, ref64):
        ref = ref64.float().to(torch.bfloat16)
        maps = {"kernel_float64": bf16_ulp_map(kernel, ref), "plain_float64": bf16_ulp_map(plain, ref),
                "kernel_plain": bf16_ulp_map(kernel, plain)}
        row = out.setdefault(name, {"elements": 0, "kernel_further_than_plain": 0,
                                    **{k: 0 for k in maps}, **{k + "_ge2": 0 for k in maps}})
        row["elements"] += kernel.numel()
        row["kernel_further_than_plain"] += int(
            (maps["kernel_float64"] > maps["plain_float64"].max()).sum().item())
        for k, d in maps.items():
            row[k] = max(row[k], int(d.max().item()))
            row[k + "_ge2"] += int((d >= 2).sum().item())

    n, alpha, beta = LRN_N, LRN_ALPHA, 0.75
    for seed in range(seeds):
        rng = torch.Generator(device=dev)
        rng.manual_seed(1000 + seed)
        for shape_name, (m, c) in CHECK_SHAPES.items():
            z = (2.0 * torch.randn((m, c), generator=rng, device=dev)).to(torch.bfloat16)
            g = torch.randn((m, c), generator=rng, device=dev).to(torch.bfloat16)
            bias = 0.5 * torch.randn((c,), generator=rng, device=dev)
            for use_bias, blocked in ((True, False), (False, False), (True, True)):
                kw = dict(bias=bias if use_bias else None, relu=use_bias, blocked=blocked)
                record(f"lrn_bwd {shape_name} bias+relu={use_bias} blocked={blocked}",
                       lrn.lrn_bwd(g, z, n, alpha, beta, **kw)[0],
                       lrn._bwd_math(g, z, n, alpha, beta, *kw.values())[0],
                       lrn_bwd_f64(g, z, n, alpha, beta, *kw.values()))
            del z, g
        for chain, shape in CHAINS.items():
            c = shape[-1]
            for kind in ("halves", "normal"):
                if kind == "halves":
                    z = halves(rng, shape, dev, torch.bfloat16)
                    bias = torch.round(0.5 * torch.randn((c,), generator=rng, device=dev))
                else:
                    z = (2.0 * torch.randn(shape, generator=rng, device=dev)).to(torch.bfloat16)
                    bias = 0.5 * torch.randn((c,), generator=rng, device=dev)
                kw = dict(bias=bias, relu=True)
                mx = plrn.pool_lrn_fwd(z, n, alpha, beta, 3, 2, **kw)
                y = lrn.lrn_fwd(z.view(-1, c), n, alpha, beta, **kw).view(shape)
                g = torch.randn(mx.shape, generator=rng, device=dev).to(torch.bfloat16)
                # up to four bf16 cotangents summed in f32: exact to 2^-24
                g_lrn = maxpool2d_undo_reference(y.float(), mx.float(), g.float(), 3, 2)
                record(f"pool_lrn_bwd {chain} {kind}",
                       plrn.pool_lrn_bwd(g, mx, z, n, alpha, beta, 3, 2, **kw)[0],
                       plrn._bwd_reference(g, mx, z, n, alpha, beta, 3, 2, y=y, **kw)[0],
                       lrn_bwd_f64(g_lrn, z, n, alpha, beta, bias, True))
                del z, mx, y, g, g_lrn
    for name, row in out.items():
        print(f"[{card}] {name}, {seeds} seeds, {row['elements']} elements, largest bf16 ulps: "
              f"kernel-float64 {row['kernel_float64']} ({row['kernel_float64_ge2']} of 2 or more), "
              f"plain-float64 {row['plain_float64']} ({row['plain_float64_ge2']}), "
              f"kernel-plain {row['kernel_plain']} ({row['kernel_plain_ge2']}); "
              f"{row['kernel_further_than_plain']} elements where the kernel is further from "
              f"float64 than the plain version ever is")
    print(json.dumps({"ulp_study": {"card": card, "seeds": seeds, "cases": out}}))
    return 0


DIGITS = REPO / "examples" / "digits"
CKPT_DIR = REPO / "build" / "chip_smoke_checkpoint"


def check_checkpoints(dev, graph, state, card) -> dict:
    """Phase 5b: the trained AlexNet state through a save -> load round trip
    (params and momenta array-equal; the seconds of each, the port's HDF5
    writer and reader on this machine's disk), and the shipped digits
    network, a file h5py wrote, served from its checkpoint through
    Predictor.from_checkpoint on the card: finite softmax rows on a fixed
    batch, and top-1 error < 0.05 on the held-out rows of sklearn's bundled
    digits (tests/test_checkpoint.py's split; skipped with a line when
    sklearn does not import)."""
    import shutil

    import numpy as np
    import torch

    from convnet_tpu_torch import checkpoint as ckpt
    from convnet_tpu_torch.config import read_model
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.model import param_shapes, params_from_numpy
    from convnet_tpu_torch.predictor import Predictor

    def host(tree):
        return {n: {k: v.detach().float().cpu().numpy() for k, v in p.items()}
                for n, p in tree.items()}

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        params_h, moms_h = host(state["params"]), host(state["moms"])
        t0 = time.perf_counter()
        path = ckpt.save(str(CKPT_DIR), graph.name, params_h, moms_h, step=state["step"])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, moms, step = ckpt.load(path, expected_shapes=param_shapes(graph))
        load_s = time.perf_counter() - t0
        for name, tree in (("params", params), ("moms", moms)):
            loaded = params_from_numpy(tree, dev)
            for edge, p in state[name].items():
                for k, v in p.items():
                    if not torch.equal(loaded[edge][k], v.detach()):
                        raise AssertionError(f"checkpoint round trip changed {name} {edge}/{k}")
        if step != state["step"]:
            raise AssertionError(f"checkpoint round trip step {step} != {state['step']}")
        size = Path(path).stat().st_size
        print(f"[{card}] checkpoint round trip of the trained AlexNet state at step {step}: "
              f"params and momenta array-equal ({size} bytes); save {save_s:.3f} s, load "
              f"{load_s:.3f} s (host clock: numpy arrays to the file and back, page cache warm)")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    facts = {"bytes": size, "save_s": save_s, "load_s": load_s}
    dg = build_graph(read_model(str(DIGITS / "digits.pbtxt")), {"input": 8})
    pred = Predictor.from_checkpoint(dg, str(DIGITS / "digits_pretrained.h5"), batch_size=128,
                                     device=dev)
    probe = np.random.default_rng(0).uniform(0, 1, (128, 8, 8, 1)).astype(np.float32)
    probs = pred({"input": probe})["output"].reshape(128, -1)
    if probs.shape != (128, 10) or not np.isfinite(probs).all() or \
            np.abs(probs.sum(-1) - 1).max() > 1e-3:
        raise AssertionError(f"the digits network's outputs {probs.shape} are not softmax rows")
    print(f"[{card}] digits network from examples/digits/digits_pretrained.h5 (written by h5py, "
          "read by the port's hdf5.py) through Predictor.from_checkpoint: 128 softmax rows of 10")
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        print(f"[{card}] digits network from its checkpoint: needs sklearn's bundled digits, "
              "which do not import on this machine; not run")
        return facts
    d = load_digits()
    images = (d.images * (255.0 / 16.0)).astype(np.uint8)[..., None]
    held_out = np.random.RandomState(0).permutation(len(images))[1500:]
    x = images[held_out].astype(np.float32) * (1.0 / 255.0)
    labels = np.concatenate([pred.predict_labels({"input": x[i: i + 128]})
                             for i in range(0, len(x), 128)])
    err = float(np.mean(labels != d.target[held_out]))
    print(f"[{card}] digits network from examples/digits/digits_pretrained.h5 on the card: top-1 "
          f"error {err} on {len(x)} held-out images")
    if err >= 0.05:
        raise AssertionError(f"the shipped digits network misclassifies {err} of the held-out rows")
    facts["digits_top1_error"] = err
    return facts


def check_conv_grad(dev, gen, card):
    """An f32 conv's input and weight gradients at conv2's shape (B=16,
    27x27x96 -> 256, k5 p2) against float64: rtol 1e-5, atol 1e-5 of the
    largest gradient. Autograd through cuDNN's default (TF32 on) is shown
    for contrast and not checked."""
    import torch
    import torch.nn.functional as F

    from convnet_tpu_torch.ops.conv import conv2d

    x = torch.randn((16, 27, 27, 96), generator=gen, device=dev)
    w = 0.05 * torch.randn((5, 5, 96, 256), generator=gen, device=dev)
    gy = torch.randn((16, 27, 27, 256), generator=gen, device=dev)

    def grads(dt):
        xx, ww = x.to(dt).requires_grad_(), w.to(dt).requires_grad_()
        return torch.autograd.grad(conv2d(xx, ww, 1, 2), (xx, ww), gy.to(dt))

    got, want = grads(torch.float32), grads(torch.float64)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        xt = x.permute(0, 3, 1, 2).requires_grad_()
        wt = w.permute(3, 2, 0, 1).contiguous().requires_grad_()
        tf_dx, tf_dw = torch.autograd.grad(F.conv2d(xt, wt, padding=2), (xt, wt),
                                           gy.permute(0, 3, 1, 2))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    tf32 = (tf_dx.permute(0, 2, 3, 1), tf_dw.permute(2, 3, 1, 0))
    worst = 0.0
    for name, g, ref, t in zip(("input", "weight"), got, want, tf32):
        scale = ref.abs().max().item()
        err = (g.double() - ref).abs().max().item()
        worst = max(worst, err)
        print(f"[{card}] f32 conv grad wrt {name} {tuple(g.shape)}: max_abs_err {err} "
              f"({err / scale} of the largest) vs float64; cuDNN TF32 default: "
              f"{(t.double() - ref).abs().max().item() / scale} of the largest")
        torch.testing.assert_close(g.double(), ref, rtol=1e-5, atol=1e-5 * scale)
    return worst


def plain_lrn_maxpool(z, b, conf):
    """lrn_maxpool from the plain versions, for autograd: the plain LRN and
    max pool forward; backward, the plain all-ties pool-undo and the plain
    LRN backward. conf = (n, alpha, beta, k, s, relu, blocked)."""
    import torch

    from convnet_tpu_torch.ops import fused_pool_lrn as plrn

    n, alpha, beta, k, s, relu, blocked = conf

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z, b):
            m = plrn._fwd_reference(z, n, alpha, beta, k, s, b, relu, blocked)
            ctx.save_for_backward(z, b, m)
            return m

        @staticmethod
        def backward(ctx, g):
            z, b, m = ctx.saved_tensors
            return plrn._bwd_reference(g.to(z.dtype), m, z, n, alpha, beta, k, s, b, relu, blocked)

    return Plain.apply(z, b)


def plain_logits(graph, params, x, dropout_seed=None, fused=False):
    """AlexNet's logits composed directly from the plain versions of the
    kernels (and the same cuDNN/cuBLAS/ATen ops), not through apply_fn;
    differentiable by autograd. x: the S2DInput of conv1. dropout_seed =
    (seed, step) applies fc6's and fc7's dropout with the masks apply_fn
    draws (keyed by the layer's index among the non-input layers). fused:
    the LRN -> pool chains as one op with the all-ties pool gradient."""
    import torch

    from convnet_tpu_torch.ops.conv import conv2d, fc
    from convnet_tpu_torch.ops.dropout import dropout_key, dropout_reference
    from convnet_tpu_torch.ops.lrn import norm_window_size, response_norm_reference
    from convnet_tpu_torch.ops.pool import maxpool_reference

    bf = torch.bfloat16
    layer_index = [n for n in graph.topo_layer_order() if not graph.layer(n).is_input]

    def inc(layer):
        (e,) = graph.incoming(layer)
        return e

    for conv, norm, pool in (("conv1", "rnorm1", "pool1"), ("conv2", "rnorm2", "pool2")):
        ce, ne, pe = inc(conv), inc(norm), inc(pool)
        z = conv2d(x, params[ce.name]["w"], ce.stride, ce.padding, bf)
        if fused:
            n = norm_window_size(z.shape[-1], ne.frac_of_filters_response_norm)
            conf = (n, ne.add_scale / n, ne.pow_scale, pe.kernel_size, pe.stride, True,
                    ne.response_norm_blocked)
            x = plain_lrn_maxpool(z, params[ce.name]["b"], conf)
            continue
        x = response_norm_reference(
            z, ne.add_scale, ne.pow_scale, ne.frac_of_filters_response_norm,
            ne.response_norm_blocked, bias=params[ce.name]["b"], relu=True,
        )
        x = maxpool_reference(x, pe.kernel_size, pe.stride, pe.padding)
    for conv in ("conv3", "conv4", "conv5"):
        ce = inc(conv)
        z = conv2d(x, params[ce.name]["w"], ce.stride, ce.padding, bf)
        x = torch.relu(z + params[ce.name]["b"].to(bf))
    pe = inc("pool5")
    x = maxpool_reference(x, pe.kernel_size, pe.stride, pe.padding)
    for layer in ("fc6", "fc7"):
        fe = inc(layer)
        x = torch.relu(fc(x, params[fe.name]["w"], bf) + params[fe.name]["b"].to(bf))
        x = x[:, None, None, :]
        rate = graph.layer(layer).dropprob
        if dropout_seed is not None and rate > 0.0:
            key = dropout_key(*dropout_seed, layer_index.index(layer))
            x = dropout_reference(x, rate, key)
    fe = inc("output")
    return (fc(x, params[fe.name]["w"], bf) + params[fe.name]["b"].to(bf)).float()


def plain_prologue(graph, x_u8, spec, mean_t, oy, ox, flips, std_t=None):
    """conv1's S2DInput from the prologue kernel's plain version."""
    from convnet_tpu_torch.ops.conv import S2DInput
    from convnet_tpu_torch.ops.s2d_relayout import relayout_geometry, s2d_prologue_reference

    (c1,) = graph.incoming("conv1")
    xs = s2d_prologue_reference(
        x_u8, oy, ox, flips, crop=spec.image_size, stride=c1.stride,
        p=relayout_geometry(spec.image_size, c1.kernel_size, c1.stride),
        scale=spec.scale, mean=mean_t, std=std_t,
    )
    return S2DInput(xs, c1.stride)


def plain_alexnet(graph, params, x_u8, spec, mean_t):
    """AlexNet's eval logits from the plain versions: center crop."""
    import torch

    from convnet_tpu_torch.data.jitter import center_offsets

    b, h, w, _ = x_u8.shape
    cy, cx = center_offsets(h, w, spec.image_size)
    oy = torch.full((b,), cy, dtype=torch.int32, device=x_u8.device)
    ox = torch.full((b,), cx, dtype=torch.int32, device=x_u8.device)
    return plain_logits(graph, params, plain_prologue(graph, x_u8, spec, mean_t, oy, ox, None))


def plain_sgd_step(graph, state, labels, logits_of):
    """The loss of logits_of(params) (softmax cross entropy over labels,
    divided by the batch), its gradients by autograd and the port's
    optimizer at the state's step; state["step"] advances. Returns the
    loss."""
    import torch

    from convnet_tpu_torch import optim
    from convnet_tpu_torch.ops.losses import softmax_cross_entropy

    step, params = state["step"], state["params"]
    keys = [(n, k) for n in params for k in ("w", "b")]
    with torch.enable_grad():
        leaves = [params[n][k].requires_grad_() for n, k in keys]
        labels = labels.reshape(-1)
        loss = softmax_cross_entropy(logits_of(params), labels) / labels.shape[0]
        flat = torch.autograd.grad(loss, leaves)
    grads = {n: {} for n in params}
    for (n, k), g in zip(keys, flat):
        grads[n][k] = g
    optim.apply_updates(graph, params, state["moms"], grads, step=step)
    state["step"] = step + 1
    return loss.detach()


def plain_train_step(graph, state, batch, spec, mean_t, fused=False, std_t=None):
    """One AlexNet train step composed from the plain versions: the same
    crops, flips and dropout masks as the port's step (drawn from the
    same keys), autograd for the backward, the port's optimizer. fused:
    the reference-gradient path's LRN -> pool chains (plain_logits)."""
    import torch

    from convnet_tpu_torch.data.jitter import crop_draw
    from convnet_tpu_torch.ops.dropout import step_draws_reference

    seed, step = state["seed"], state["step"]
    x = batch["input"]
    b, h, w, _ = x.shape
    rng = torch.tensor([seed, step], dtype=torch.int64, device=x.device)
    draw = crop_draw("input", b, h, w, spec.image_size, spec.can_translate, spec.can_flip)
    oy, ox, flips = step_draws_reference(rng, (), draw)[1]
    xs = plain_prologue(graph, x, spec, mean_t, oy, ox, flips, std_t)
    return plain_sgd_step(graph, state, batch["labels"], lambda params: plain_logits(
        graph, params, xs, dropout_seed=(seed, step), fused=fused))


def time_kernels(dev, gen, card, mean_t, plain=True, only=None):
    """Phase 6's kernel times at the main paths' shapes, bf16, with bias and
    ReLU where the kernel takes them: each wrapper's device time
    (device_ms, two input sets taken in turn) and host cost (host_us);
    with `plain`, also its plain version's and the library call's device
    times; and an empty kernel's device time, the floor of any launch.
    `only`: time just the parts whose name holds this text. Returns (times
    {part: (kernel ms, plain ms or None)}, library {part: ms}, work {part:
    (bytes, operations)}, host {part: us}, floor ms).

    Bytes: bf16 activations and f32 bias and db, each read or written
    once. Operations per element, counted from the kernels' arithmetic
    with AlexNet's n = 5: LRN forward 2n + 8, LRN backward 3n + 19, the
    fused backward both and the pool-undo (57), Philox dropout 27 (a
    10-round Philox per 4 elements), the prologue 4 per output, a 3x3 max
    pool 9 compares per output."""
    import functools

    import torch
    import torch.nn.functional as F

    from convnet_tpu_torch.ops import dropout as drop
    from convnet_tpu_torch.ops import fused_pool_lrn as plrn
    from convnet_tpu_torch.ops import lrn, pool
    from convnet_tpu_torch.ops import s2d_relayout as s2d
    from convnet_tpu_torch.utils.card import cuda_ms

    times, library, work, host = {}, {}, {}, {}

    def timed(part, kernel, reference, inputs, lib=None, plain_timer=None, **kw):
        """Time kernel (and, with `plain`, reference and lib) on each of
        the input tuples in turn; plain_timer(calls) times the reference
        where device_ms cannot."""
        if only and only not in part:
            return
        calls = [functools.partial(kernel, *x, **kw) for x in inputs]
        host[part] = host_us(calls[0])
        ref_ms = None
        if plain:
            ref_calls = [functools.partial(reference, *x, **kw) for x in inputs]
            ref_ms = (plain_timer or (lambda c: device_ms(*c)))(ref_calls)
            if lib is not None:
                library[part] = device_ms(*[functools.partial(lib, *x) for x in inputs])
        times[part] = (device_ms(*calls), ref_ms)

    def bf16(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    def torch_lrn(z, *_):
        # torch's own LRN on the same tensor (NCHW view), without bias or ReLU
        zt = z.view(BATCH, -1, z.shape[1]).permute(0, 2, 1)[..., None]
        return F.local_response_norm(zt, LRN_N, alpha=1e-4, beta=0.75, k=1.0)

    conf = (LRN_N, LRN_ALPHA, 0.75)
    for shape_name, (m, c) in LRN_SHAPES.items():
        b = 0.5 * torch.randn((c,), generator=gen, device=dev)
        zs = [bf16((m, c), 2.0) for _ in range(2)]
        timed(f"lrn_fwd {shape_name}", lrn.lrn_fwd, lrn._fwd_math, [(z, *conf) for z in zs],
              torch_lrn, bias=b, relu=True)
        work[f"lrn_fwd {shape_name}"] = (4 * m * c + 4 * c, 18 * m * c)
        timed(f"lrn_bwd {shape_name}", lrn.lrn_bwd, lrn._bwd_math,
              [(bf16((m, c)), z, *conf) for z in zs], bias=b, relu=True)
        work[f"lrn_bwd {shape_name}"] = (6 * m * c + 8 * c, 34 * m * c)
        del zs

    # the prologue in its serving form (center crops, trainer.py's eval
    # prologue) and in its train form (random crops and flips, as
    # sample_crop_flip draws them for the train step)
    off = torch.full((BATCH,), (RAW - CROP) // 2, dtype=torch.int32, device=dev)
    kw = dict(crop=CROP, stride=4, p=s2d.relayout_geometry(CROP, 11, 4), scale=1 / 255,
              mean=mean_t)
    images = [torch.randint(0, 256, (BATCH, RAW, RAW, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(2)]

    def origins():
        return torch.randint(0, RAW - CROP + 1, (BATCH,), generator=gen, device=dev,
                             dtype=torch.int32)

    forms = {
        "s2d_prologue": [(x, off, off, None) for x in images],
        "s2d_prologue train": [
            (x, origins(), origins(), torch.randint(0, 2, (BATCH,), generator=gen, device=dev).bool())
            for x in images
        ],
    }
    s2d_out = BATCH * kw["p"] * kw["p"] * 48
    for part, xs in forms.items():
        timed(part, s2d.s2d_prologue, s2d.s2d_prologue_reference, xs, **kw)
        work[part] = (BATCH * CROP * CROP * 3 + 2 * s2d_out, 4 * s2d_out)  # the crops
    del images, forms

    # the key on the card, as the train step derives it there (a checkout
    # whose kernel takes the key by value, without step_draws, gets the pair)
    key = drop.dropout_key(0, 0, 10)
    if hasattr(drop, "step_draws"):
        key = torch.tensor(key, dtype=torch.int64, device=dev)
    xds = [(bf16((BATCH, 1, 1, 4096)), 0.5, key) for _ in range(2)]
    timed("dropout", drop.dropout_apply, drop.dropout_reference, xds,
          lambda x, rate, _: F.dropout(x, rate, training=True))
    work["dropout"] = (4 * BATCH * 4096, 27 * BATCH * 4096)

    if hasattr(drop, "step_draws"):
        from convnet_tpu_torch.data.jitter import crop_draw

        words = [(i, 0) for i in ALEXNET_DROPOUT_LAYERS]
        draw = crop_draw("input", BATCH, RAW, RAW, CROP, True, True)
        states = [(torch.tensor([42, t], dtype=torch.int64, device=dev), words, draw)
                  for t in (0, 1)]
        # the plain version is about a thousand small launches, more than
        # CUDA's launch queue holds: it is timed by events around a call
        timed("step_draws", drop.step_draws, drop.step_draws_reference, states,
              plain_timer=lambda calls: statistics.median(cuda_ms(c) for c in calls))
        # bytes: the state, the keys, the origins and the flips; operations:
        # a 10-round Philox (about 100 integer operations) per key, two per
        # image (its field's key, then its draw)
        work["step_draws"] = (16 + 16 * len(words) + 9 * BATCH, 100 * len(words) + 200 * BATCH)

    # pool5 runs on the reference-gradient path; pool1 and pool2 are timed
    # for the default path's choice. Each is an exact cover, where torch's
    # floor-mode pool is the same function.
    for shape_name, shape in POOL_SHAPES.items():
        xps = [(bf16(shape), 3, 2) for _ in range(2)]
        timed(f"maxpool_fwd {shape_name}", pool.maxpool_fwd, pool.maxpool_reference, xps,
              lambda x, k, s: F.max_pool2d(x.permute(0, 3, 1, 2), k, s))
        out = pool.maxpool_reference(xps[0][0], 3, 2).numel()
        work[f"maxpool_fwd {shape_name}"] = (2 * (xps[0][0].numel() + out), 9 * out)
        del xps

    for shape_name, shape in CHAINS.items():
        c = shape[-1]
        b = 0.5 * torch.randn((c,), generator=gen, device=dev)
        kw = dict(bias=b, relu=True)
        zs = [bf16(shape, 2.0) for _ in range(2)]
        ms = [plrn.pool_lrn_fwd(z, LRN_N, LRN_ALPHA, 0.75, 3, 2, **kw) for z in zs]
        args = (LRN_N, LRN_ALPHA, 0.75, 3, 2)
        timed(f"pool_lrn_fwd {shape_name}", plrn.pool_lrn_fwd, plrn._fwd_reference,
              [(z, *args) for z in zs], **kw)
        gs = [bf16(m.shape) for m in ms]
        timed(f"pool_lrn_bwd {shape_name}", plrn.pool_lrn_bwd, plrn._bwd_reference,
              [(g, m, z, *args) for g, m, z in zip(gs, ms, zs)], **kw)
        z, m = zs[0], ms[0]
        work[f"pool_lrn_fwd {shape_name}"] = (2 * (z.numel() + m.numel()) + 4 * c,
                                              18 * z.numel() + 9 * m.numel())
        work[f"pool_lrn_bwd {shape_name}"] = (4 * (z.numel() + m.numel()) + 8 * c, 57 * z.numel())
        del zs, ms, gs, z, m

    # the card's floor for one launch on this timing: an empty spin kernel
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    print(f"[{card}] one empty kernel (torch.cuda._sleep(0)), device time with the launches "
          f"hidden: {floor_ms:.4f} ms, the least any launch takes here")
    print(f"[{card}] host cost of each kernel's wrapper, median of {HOST_CALLS} calls queued behind "
          f"a spin, without a synchronize (host time, not the kernel's): "
          + ", ".join(f"{name} {us:.1f} us" for name, us in host.items()))
    for name, (k_ms, p_ms) in times.items():
        b_ms, b_by = bound(*work[name])
        plain_txt = f", plain {p_ms:.4f} ms" if p_ms is not None else ""
        lib = f", library {library[name]:.4f} ms" if name in library else ""
        print(f"[{card}] {name}: kernel {k_ms:.4f} ms{plain_txt}{lib} (device time, launches "
              f"hidden, two input sets in turn), bound {b_ms:.4f} ms ({b_by}: "
              f"{work[name][0]} bytes, {work[name][1]} operations), {b_ms / k_ms:.3f} of it")
    return times, library, work, host, floor_ms


def step_times(step, state, batch):
    """(events, device time with the launches hidden, host clock with a
    synchronize) of one train step on the staged batch, in ms."""
    import torch

    from convnet_tpu_torch.utils.card import cuda_ms

    ev = cuda_ms(lambda: step(state, batch))
    # one step (about 280 launches) per spin: k steps would fill the queue
    dev_ms = device_ms(lambda: step(state, batch), k=1, reps=ITERS)
    host = []
    for i in range(WARMUP + ITERS):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        if i >= WARMUP:
            host.append((time.perf_counter() - t0) * 1e3)
    return ev, dev_ms, statistics.median(host)


def time_paths(fwd, fwd_params, staged, step, state, batch, card):
    """The serving forward's time (events, device time with the launches
    hidden, and the host's time to enqueue it) and the train step's on
    both train paths (step_times, and the enqueue time). Prints them;
    returns {"forward": (events, device, enqueue), "train": (events,
    device, host, enqueue), "reference_gradient": (...)}."""
    import torch

    from convnet_tpu_torch.utils.card import cuda_ms

    with torch.inference_mode():
        fwd_ev = cuda_ms(lambda: fwd(fwd_params, staged))
        fwd_dev = device_ms(lambda: fwd(fwd_params, staged), k=1, reps=ITERS)
        fwd_enq = enqueue_ms(lambda: fwd(fwd_params, staged))
    print(f"[{card}] AlexNet forward, batch {BATCH}: device time with the launches hidden "
          f"{fwd_dev:.4f} ms; events around one call {fwd_ev:.4f} ms; host enqueue (card held "
          f"behind a spin) {fwd_enq:.4f} ms")
    out = {"forward": (fwd_ev, fwd_dev, fwd_enq),
           "train": (*step_times(step, state, batch), enqueue_ms(lambda: step(state, batch)))}
    with pool_switches():
        out["reference_gradient"] = (*step_times(step, state, batch),
                                     enqueue_ms(lambda: step(state, batch)))
    for path, what in (("train", "AlexNet train step"),
                       ("reference_gradient", f"AlexNet train step with {POOL_SWITCHES}")):
        ev, dev_ms, host_ms, enq_ms = out[path]
        print(f"[{card}] {what}, batch {BATCH}, on a staged batch: device time with the "
              f"launches hidden {dev_ms:.4f} ms ({BATCH / dev_ms * 1e3:.1f} img/s); host clock "
              f"with synchronize {host_ms:.4f} ms ({BATCH / host_ms * 1e3:.1f} img/s), so the "
              f"card idles {1 - dev_ms / host_ms:.3f} of it; events {ev:.4f} ms; host enqueue "
              f"(card held behind a spin) {enq_ms:.4f} ms")
    return out


def profile_paths(fwd, fwd_params, staged, step, state, batch, card, out: Path) -> None:
    """torch.profiler tables (kernels by device time) of five forwards and
    five train steps of each train path, into `out`; Chrome traces of the
    forward and the default step beside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def trace(name, fn, rows, chrome=False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        table = averages.table(sort_by="cuda_time_total", row_limit=rows)
        # the host's CUDA API calls a call: launches, copies, events
        api = {e.key: e.count / 5 for e in averages if e.key.startswith(("cuda", "cu"))
               and e.key not in ("cudaDeviceSynchronize",)}
        print(f"[{card}] {name}: CUDA API calls per call (torch.profiler, 5 calls): "
              f"{json.dumps(dict(sorted(api.items())))}")
        (out / f"{name}_profile.txt").write_text(f"{card}\n{table}\n")
        if chrome:
            prof.export_chrome_trace(str(out / f"{name}_trace.json"))

    out.mkdir(parents=True, exist_ok=True)
    with torch.inference_mode():
        trace("forward", lambda: fwd(fwd_params, staged), 60, chrome=True)
    trace("train", lambda: step(state, batch), 100, chrome=True)
    with pool_switches():
        trace("train_ref_grad", lambda: step(state, batch), 100)
    print(f"[{card}] profiles of the forward and of 5 train steps of each path -> {out}")


def time_only(dev, card, root, only=None, profile_dir=None) -> int:
    """--time-only: phase 6 without the plain versions and library calls,
    on random weights and one DUMMY batch, untrained. Prints the kernels'
    device times and host costs and the forward's and train steps' times
    as one JSON line, so that two checkouts can be timed in turns. With
    `only` (--kernels), just the kernels whose name holds that text, and
    no forward or step."""
    import numpy as np
    import torch

    import convnet_tpu_torch
    from convnet_tpu_torch.config import read_model
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.data.jitter import JitterSpec
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.model import init_params
    from convnet_tpu_torch.predictor import Predictor
    from convnet_tpu_torch.trainer import Trainer, make_forward, make_train_step

    print(f"[{card}] timing convnet_tpu_torch from {Path(convnet_tpu_torch.__file__).parent}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    mean = np.full((3,), MEAN, np.float32)
    times, _, work, host, floor_ms = time_kernels(dev, gen, card, torch.as_tensor(mean, device=dev),
                                                  plain=False, only=only)
    kernels = {name: {"ms": ms, "bound_ms": bound(*work[name])[0], "host_us": host[name]}
               for name, (ms, _) in times.items()}
    if only:
        print(json.dumps({"time_only": {"root": str(root), "card": card, "kernels": kernels,
                                        "empty_launch_ms": floor_ms}}))
        return 0
    graph = build_graph(read_model(str(ALEXNET)))
    jitter = {"input": (JitterSpec(image_size=CROP, scale=1 / 255), mean, None)}
    pred = Predictor(graph, init_params(graph, seed=0, device=dev), batch_size=BATCH,
                     jitter=jitter, raw_size=RAW, input_dtype=np.uint8, device=dev)
    x = np.random.default_rng(0).integers(0, 256, (BATCH, RAW, RAW, 3), dtype=np.uint8)
    train_data = DataHandler(dummy_imagenet(BATCH, DUMMY_ROWS, True))
    train_jitter = {"input": (train_data.jitter_specs()["input"][0], mean, None)}
    trainer = Trainer(graph, train_data, device=dev, jitter=train_jitter)
    fwd, staged = make_forward(graph, pred.layers, jitter), {"input": torch.from_numpy(x).to(dev)}
    step, state = make_train_step(graph, train_jitter), clone_state(trainer.state)
    batch = trainer.device_batch(train_data.get_batch())
    paths = time_paths(fwd, pred.params, staged, step, state, batch, card)
    paths["predictor_ms"] = request_ms(pred, x)
    print(f"[{card}] Predictor, batch {BATCH}: {paths['predictor_ms']:.4f} ms per request")
    if profile_dir is not None:
        profile_paths(fwd, pred.params, staged, step, state, batch, card, profile_dir)
    import convnet_tpu_torch.trainer as trainer_module

    launch = "n/a"  # a checkout without several steps per launch
    if hasattr(trainer_module, "TrainSteps"):
        batches = [trainer.device_batch(train_data.get_batch()) for _ in range(LAUNCH_K)]
        launch = {"step_ms": launch_times(graph, state, train_jitter, batches, card)}
        trainer_k = Trainer(graph, train_data, device=dev, jitter=train_jitter,
                            steps_per_launch=LAUNCH_K, log_fn=lambda _: None)
        trainer_k.train(max_iter=2 * LAUNCH_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer_k.train(max_iter=2 * LAUNCH_K + TRAINER_LAUNCH_STEPS)
        torch.cuda.synchronize()
        launch["trainer_img_s"] = TRAINER_LAUNCH_STEPS * BATCH / (time.perf_counter() - t0)
        print(f"[{card}] Trainer.train over DUMMY, {LAUNCH_K} steps a launch, "
              f"{TRAINER_LAUNCH_STEPS} steps: {launch['trainer_img_s']:.1f} img/s")
    train_data.close()
    print(json.dumps({"time_only": {"root": str(root), "card": card, "kernels": kernels,
                                    "empty_launch_ms": floor_ms, "paths": paths,
                                    f"k{LAUNCH_K}": launch}}))
    return 0


# -- phase 7: the model zoo and the CLIs ---------------------------------------

ALEXNET_LOCAL = REPO / "examples" / "imagenet" / "alexnet_local.pbtxt"
AUTOENCODER = REPO / "examples" / "autoencoder" / "conv_autoencoder.pbtxt"
CLI_STEPS, AUTOENCODER_STEPS = 10, 5
# LOCAL at alexnet_local's conv4: (B, 13, 13, 384) -> 384, k3 s1 p1, so the
# weight is (13, 13, 3*3*384, 384), 224.3M elements
CONV4 = dict(x=(BATCH, 13, 13, 384), cout=384, kernel=3, stride=1, padding=1)
# LOCAL against float64, as a share of the largest |element|: f32 is one
# f32 sum of 3456 products a site (no TF32); bf16 rounds the output once
LOCAL_F32_RTOL, LOCAL_BF16_RTOL = 1e-5, 1e-2
# Phase 7c's model, written to a temp dir: a ReLU conv whose bias the LRN
# kernels take (bias deferral), a max pool, LOCAL, CONV_ONETOONE and an FC
# softmax, f32. A finite difference across a ReLU or max-pool kink fails
# the check by itself; at seed 0 and batch 2 none is crossed (the largest
# error is under 2e-4 on the CPU and on the card, against 2e-3).
GRAD_CHECK_MODEL = """
name: "lrn_local_check"
seed: 7
layer { name: "input" is_input: true num_channels: 3 image_size: 6 }
layer { name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 16 }
layer { name: "pool1" num_channels: 16 }
layer { name: "local2" num_channels: 8 activation: TANH }
layer { name: "mix3" num_channels: 8 activation: TANH }
layer { name: "output" is_output: true num_channels: 5 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.3 init_bias: 1.0 }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
       add_scale: 0.01 pow_scale: 0.75 frac_of_filters_response_norm: 0.3 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 2 stride: 2 }
edge { source: "pool1" dest: "local2" edge_type: LOCAL kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.05 }
edge { source: "local2" dest: "mix3" edge_type: CONV_ONETOONE initialization: DENSE_GAUSSIAN init_wt: 0.3 }
edge { source: "mix3" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0 }
"""


def check_local(dev, gen, card, profile_dir=None):
    """Phase 7a: LOCAL at alexnet_local's conv4 in f32 and bf16, forward,
    dx and dw against float64 on the card (the bf16 case on the bf16-rounded
    inputs), each within its share of the largest |element|; then the
    bf16 forward's and backward's device times with the launches hidden
    beside their bounds (and, with profile_dir, a torch.profiler table of
    five of each)."""
    import torch

    from convnet_tpu_torch.ops.local import local_conv2d

    b, h, w_, c = CONV4["x"]
    k, s, p, cout = CONV4["kernel"], CONV4["stride"], CONV4["padding"], CONV4["cout"]
    wshape = (h, w_, k * k * c, cout)  # stride 1, pad 1: 13x13 sites
    x = torch.randn(CONV4["x"], generator=gen, device=dev)
    w = 0.01 * torch.randn(wshape, generator=gen, device=dev)
    gy = torch.randn((b, h, w_, cout), generator=gen, device=dev)

    def run(dt):
        # as the model calls it: bf16 through compute_dtype, f32 without one
        xx = x.to(dt).requires_grad_()
        ww = w.to(dt).requires_grad_()
        y = local_conv2d(xx, ww, s, p, k, None if dt == torch.float32 else dt)
        dx, dw = torch.autograd.grad(y, (xx, ww), gy.to(dt))
        return y.detach(), dx, dw

    for dt, rtol in ((torch.float32, LOCAL_F32_RTOL), (torch.bfloat16, LOCAL_BF16_RTOL)):
        got = run(dt)
        # float64 on the same inputs: the bf16 case rounds x, w and g first
        xd, wd = x.to(dt).double().requires_grad_(), w.to(dt).double().requires_grad_()
        yd = local_conv2d(xd, wd, s, p, k)
        want = (yd.detach(), *torch.autograd.grad(yd, (xd, wd), gy.to(dt).double()))
        del xd, wd, yd
        for name, g_, ref in zip(("y", "dx", "dw"), got, want):
            scale = ref.abs().max().item()
            err = (g_.double() - ref).abs().max().item() / scale
            print(f"[{card}] LOCAL conv4 {str(dt).removeprefix('torch.')} {name} "
                  f"{tuple(g_.shape)}: max |err| {err:.3g} of the largest vs float64 "
                  f"(tolerance {rtol})")
            if err > rtol:
                raise AssertionError(f"LOCAL {dt} {name} is {err} of the largest from float64")
        del got, want
    torch.cuda.empty_cache()

    xb = x.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    bf16 = torch.bfloat16
    with torch.no_grad():
        fwd_ms = device_ms(lambda: local_conv2d(xb, wb, s, p, k, bf16), k=4)
    y = local_conv2d(xb, wb, s, p, k, bf16)
    gb = gy.to(torch.bfloat16)
    bwd_ms = device_ms(lambda: torch.autograd.grad(y, (xb, wb), gb, retain_graph=True), k=4)
    sites, kkc = h * w_, k * k * c
    flops = 2 * b * sites * kkc * cout
    act = 2 * (x.numel() + gy.numel())  # bf16 x and y (or g and dx)
    fb, fb_by = bound(2 * w.numel() + act, flops, BF16_OPS_PER_S)
    bb, bb_by = bound(4 * w.numel() + 2 * act, 2 * flops, BF16_OPS_PER_S)
    print(f"[{card}] LOCAL conv4, bf16, batch {b}: forward {fwd_ms:.4f} ms (bound {fb:.4f} ms, "
          f"{fb_by}), backward dx + dw {bwd_ms:.4f} ms (bound {bb:.4f} ms, {bb_by}); device "
          f"time with the launches hidden; {flops / 1e9:.1f} GFLOP forward")
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                with torch.no_grad():
                    local_conv2d(xb, wb, s, p, k, bf16)
                torch.autograd.grad(y, (xb, wb), gb, retain_graph=True)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
        profile_dir.mkdir(parents=True, exist_ok=True)
        (profile_dir / "local_conv4_profile.txt").write_text(f"{card}\n{table}\n")


class _CapturingTrainer:
    """A hook around the train CLI's Trainer: keeps each Trainer it makes
    and a copy of its initial params, so the phase can check what the
    CLI trained."""

    def __init__(self, cli_module):
        self.made = []
        self._cli = cli_module
        self._orig = cli_module.Trainer

    def __enter__(self):
        made, orig = self.made, self._orig

        class Capturing(orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.p_init = clone_state(self.state)["params"]
                made.append(self)

        self._cli.Trainer = Capturing
        return self

    def __exit__(self, *exc):
        self._cli.Trainer = self._orig


def expect_trained(what, params, p_init, card):
    import torch

    moved = 0
    for name, p in params.items():
        for k, v in p.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{what}: {name}/{k} is not finite")
            moved += int(not torch.equal(v, p_init[name][k]))
    print(f"[{card}] {what}: {moved}/{2 * len(p_init)} parameter tensors moved, all finite")
    if moved != 2 * len(p_init):
        raise AssertionError(f"{what}: some parameters did not move")


def check_zoo_and_clis(dev, gen, card, alexnet_times, profile_dir=None):
    """Phase 7. (a) LOCAL at conv4 (check_local); (b) alexnet_local at full
    width, 10 steps through the train CLI over DUMMY ImageNet-shaped data,
    with a trace of steps 5-10 (--profile-dir); (c) grad_check through its
    CLI on the card in f32 (eps 1e-3, tol 2e-3) over GRAD_CHECK_MODEL; (d)
    conv_autoencoder, 5 train steps over DUMMY 32x32x3 data; (e) fc7
    extracted from (b)'s checkpoint (the one the CLI writes at its end, the
    model's own checkpoint_after) through the extract CLI, read back with
    the port's hdf5.py.
    With profile_dir, torch.profiler tables of LOCAL and of five
    alexnet_local steps go there. Returns the alexnet_local run's
    launches."""
    import re
    import tempfile

    import numpy as np
    import torch

    from convnet_tpu_torch import hdf5
    from convnet_tpu_torch.cli import extract as extract_cli
    from convnet_tpu_torch.cli import grad_check as grad_check_cli
    from convnet_tpu_torch.cli import train as train_cli
    from convnet_tpu_torch.config import model_to_text, parse_dataset_config, read_model
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.trainer import device_batch, init_state, make_train_step

    check_local(dev, gen, card, profile_dir)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- (b) --
        model = read_model(str(ALEXNET_LOCAL))
        # widths untouched; a loss line every 5 steps for the log
        model.display_after = 5
        (tmp / "alexnet_local.pbtxt").write_text(model_to_text(model))
        (tmp / "train.pbtxt").write_text(dummy_imagenet_text(BATCH, DUMMY_ROWS, True))
        out, prof = tmp / "run", tmp / "profile"
        reset_launches()
        t0 = time.perf_counter()
        with _CapturingTrainer(train_cli) as cap:
            rc = train_cli.main([str(tmp / "alexnet_local.pbtxt"), str(tmp / "train.pbtxt"),
                                 "--output-dir", str(out), "--max-iter", str(CLI_STEPS),
                                 "--profile-dir", str(prof)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        local_launches = read_launches()
        print(f"[{card}] launches during {CLI_STEPS} alexnet_local steps through the train CLI "
              f"({cli_s:.3f} s, rc {rc}): {local_launches}")
        if rc != 0:
            raise AssertionError(f"the train CLI returned {rc}")
        expect_launches("alexnet_local's steps", local_launches, TRAIN_PER_STEP, CLI_STEPS)
        trainer = cap.made[0]
        if trainer.state["step"] != CLI_STEPS:
            raise AssertionError(f"the CLI stopped at step {trainer.state['step']}")
        w4 = trainer.state["params"]["conv3:conv4"]["w"]
        print(f"[{card}] alexnet_local conv3:conv4 LOCAL weight {tuple(w4.shape)}, "
              f"{w4.numel()} elements")
        expect_trained(f"alexnet_local after {CLI_STEPS} CLI steps", trainer.state["params"],
                       trainer.p_init, card)
        log = (out / "alexnet_local_train_log.txt").read_text()
        losses = [float(v) for v in re.findall(r"^step \d+ loss (\S+)", log, re.M)]
        print(f"[{card}] alexnet_local train log: losses {losses}; "
              f"{sorted(q.name for q in prof.iterdir()) if prof.is_dir() else 'no'} trace files")
        if len(losses) != CLI_STEPS // 5 or not np.isfinite(losses).all():
            raise AssertionError(f"alexnet_local's logged losses {losses}")
        if not prof.is_dir() or not any(prof.iterdir()):
            raise AssertionError("--profile-dir wrote no trace")
        graph = trainer.graph
        del trainer.p_init
        data = DataHandler(dummy_imagenet(BATCH, DUMMY_ROWS, True))
        batch = trainer.device_batch(data.get_batch())
        data.close()
        step = make_train_step(graph, data.jitter_specs())
        ev, dev_ms, host_ms = step_times(step, trainer.state, batch)
        a_ev, a_dev, a_host, _ = alexnet_times["train"]
        print(f"[{card}] alexnet_local train step, batch {BATCH}, on a staged batch: device time "
              f"with the launches hidden {dev_ms:.4f} ms ({BATCH / dev_ms * 1e3:.1f} img/s); host "
              f"clock with synchronize {host_ms:.4f} ms, so the card idles "
              f"{1 - dev_ms / host_ms:.3f} of it; events {ev:.4f} ms. AlexNet's in this run: "
              f"{a_dev:.4f} ms device, {a_host:.4f} ms host clock, idle {1 - a_dev / a_host:.3f}")
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tr:
                for _ in range(5):
                    step(trainer.state, batch)
                torch.cuda.synchronize()
            table = tr.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            (profile_dir / "alexnet_local_train_profile.txt").write_text(f"{card}\n{table}\n")
        del trainer, cap, batch, step
        torch.cuda.empty_cache()

        # -- (c) --
        (tmp / "check.pbtxt").write_text(GRAD_CHECK_MODEL)
        reset_launches()
        rc = grad_check_cli.main([str(tmp / "check.pbtxt"), "--batch-size", "2"])
        gc_launches = read_launches()
        print(f"[{card}] grad_check CLI, f32 on the card (eps 1e-3, tol 2e-3): rc {rc}; "
              f"launches {gc_launches}")
        if rc != 0:
            raise AssertionError("grad_check found failures on the card")
        if not (gc_launches["lrn_fwd"] > 0 and gc_launches["lrn_bwd"] > 0):
            raise AssertionError("grad_check did not go through the LRN kernels")

        # -- (d) --
        auto_cfg = parse_dataset_config(f"""
            name: "dummy_32" batch_size: 128 randomize_cpu: true
            data_config {{ layer_name: "input" data_type: DUMMY image_size: 32 num_colors: 3
                          scale: {1 / 255} dummy_size: 512 }}
        """)
        ag = build_graph(read_model(str(AUTOENCODER)))
        data = DataHandler(auto_cfg)
        step = make_train_step(ag, data.jitter_specs())
        state = init_state(ag, device=dev)
        p_init = clone_state(state)["params"]
        losses = [step(state, device_batch(data.get_batch(), dev))["loss"].item()
                  for _ in range(AUTOENCODER_STEPS)]
        data.close()
        print(f"[{card}] conv_autoencoder, {AUTOENCODER_STEPS} train steps over DUMMY 32x32x3 "
              f"data: losses {losses}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"conv_autoencoder losses {losses}")
        expect_trained("conv_autoencoder", state["params"], p_init, card)

        # -- (e) --
        ckpts = sorted(out.glob("alexnet_local_*.h5"))
        if len(ckpts) != 1:
            raise AssertionError(f"the train CLI wrote checkpoints {ckpts}")
        (tmp / "val.pbtxt").write_text(dummy_imagenet_text(BATCH, 2 * BATCH, False))
        feats = tmp / "fc7.h5"
        rc = extract_cli.main([str(tmp / "alexnet_local.pbtxt"), str(tmp / "val.pbtxt"),
                               "--checkpoint", str(ckpts[-1]), "--output", str(feats),
                               "--layers", "fc7"])
        with hdf5.File(feats) as f:
            fc7 = f["fc7"][...]
        print(f"[{card}] extract CLI from alexnet_local's checkpoint {ckpts[-1].name} "
              f"({ckpts[-1].stat().st_size} bytes): fc7 {fc7.shape}, finite "
              f"{bool(np.isfinite(fc7).all())}")
        if rc != 0 or fc7.shape != (2 * BATCH, 4096) or not np.isfinite(fc7).all():
            raise AssertionError(f"extract gave rc {rc}, fc7 {fc7.shape}")
    return local_launches


# -- phase 8: stored data, several steps per launch, remat ---------------------

LEARN_ROWS, LEARN_CLASSES = 1280, 10  # 1280 x 256 x 256 x 3 bytes: 252 MB
LEARN_STEPS, LEARN_LOG, LAUNCH_K = 600, 20, 4
# the bars of phase 8a: the logged loss below ln 10 (a uniform guess over
# the 10 classes; it starts near ln 1000), the last window's error below 0.5
# (chance is 0.9)
LEARN_LOSS, LEARN_ERR = 2.302585, 0.5
# eps multipliers tried in turn, each run from the same initial state, until
# one meets both bars within LEARN_STEPS (the first is the pbtxt's own)
EPS_LADDER = (1.0, 2.0, 4.0, 8.0)
LAUNCH_STEPS, TRAINER_LAUNCH_STEPS = 8, 48


def learnable_set(n: int, classes: int, seed: int = 0):
    """A learnable set of n uint8 RAW x RAW x 3 images and int32 labels, from
    numpy with a fixed seed: class k has its own colour offset and stripe
    texture (angle and period), and every image adds uniform noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % classes).astype(np.int32)
    rng.shuffle(labels)
    yy, xx = np.mgrid[0:RAW, 0:RAW].astype(np.float32)
    images = np.empty((n, RAW, RAW, 3), np.uint8)
    for k in range(classes):
        colour = rng.uniform(40, 215, 3).astype(np.float32)
        angle, period = np.pi * k / classes, 6.0 + 3.0 * k
        stripes = 35.0 * np.sin((xx * np.cos(angle) + yy * np.sin(angle)) * (2 * np.pi / period))
        base = colour[None, None, :] + stripes[:, :, None]
        rows = np.flatnonzero(labels == k)
        noise = rng.integers(-30, 31, (len(rows), RAW, RAW, 3), dtype=np.int16)
        images[rows] = np.clip(base[None] + noise, 0, 255).astype(np.uint8)
    return images, labels


def raw_cache_data_text(directory: Path, batch: int, pipeline: bool = True) -> str:
    """Two RAW_CACHE streams over learnable_set's files: random CROP crops
    and flips, scale 1/255. (Normalized by the per-channel mean file
    instead, AlexNet diverges at the pbtxt's eps on the kernel path and on
    the plain-composed one alike: phase 8f.)"""
    return f"""
        name: "learnable" batch_size: {batch} randomize_cpu: true
        pipeline_loads: {str(pipeline).lower()}
        data_config {{ layer_name: "input" data_type: RAW_CACHE
                      file_pattern: "{directory / 'images.cache'}" raw_image_size: {RAW}
                      image_size: {CROP} num_colors: 3 can_translate: true can_flip: true
                      scale: {1 / 255} }}
        data_config {{ layer_name: "labels" data_type: RAW_CACHE
                      file_pattern: "{directory / 'labels.cache'}" }}
    """


def hdf5_data_text(data: Path, mean: Path, batch: int, randomize: bool,
                   pipeline: bool = True) -> str:
    """Two HDF5 streams over one of learnable_set's HDF5 files (images
    "data", labels "labels"): CROP crops, random with flips where
    `randomize` (train) and centred otherwise (extract), and the mean and
    std of a compute_mean file (normalize)."""
    jitter = "can_translate: true can_flip: true" if randomize else ""
    return f"""
        name: "learnable_hdf5" batch_size: {batch} randomize_cpu: {str(randomize).lower()}
        pipeline_loads: {str(pipeline).lower()}
        data_config {{ layer_name: "input" data_type: HDF5 file_pattern: "{data}"
                      dataset_name: "data" raw_image_size: {RAW} image_size: {CROP}
                      num_colors: 3 {jitter} mean_file: "{mean}" normalize: true }}
        data_config {{ layer_name: "labels" data_type: HDF5 file_pattern: "{data}"
                      dataset_name: "labels" }}
    """


# phase 8's HDF5 copies of the learnable set: one contiguous, one chunked by
# HDF5_CHUNK rows (tools/make_hdf5_dataset.py's chunk), written a chunk at a
# time; and compute_mean's full-pixel and per-channel mean files
HDF5_CHUNK = 128


def write_learnable_set(directory: Path, card):
    """Phase 8's data: learnable_set written as a raw cache with the port's
    write_raw_cache, and as two HDF5 files with the port's hdf5.py
    (images.h5 contiguous, images_chunked.h5 chunked), with the full-pixel
    (mean_pixel.h5) and per-channel (mean_channel.h5) mean files of the
    port's compute_mean tool. Prints each reader's host milliseconds per
    batch: the C++ gather and the plain memmap read of the raw cache, and
    DataHandler.get_batch over the raw cache and both HDF5 files."""
    import numpy as np

    from convnet_tpu_torch import hdf5
    from convnet_tpu_torch.config import parse_dataset_config
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.data.native import (
        RawCacheReader, raw_cache_gather_reference, write_raw_cache)
    from convnet_tpu_torch.tools import compute_mean

    t0 = time.perf_counter()
    images, labels = learnable_set(LEARN_ROWS, LEARN_CLASSES)
    write_raw_cache(str(directory / "images.cache"), images)
    write_raw_cache(str(directory / "labels.cache"), labels)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with hdf5.File(directory / "images.h5", "w") as f:
        f.create_dataset("data", data=images)
        f.create_dataset("labels", data=labels)
    contiguous_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with hdf5.File(directory / "images_chunked.h5", "w") as f:
        ds = f.create_appendable("data", (RAW, RAW, 3), np.uint8, chunk_rows=HDF5_CHUNK)
        for i in range(0, LEARN_ROWS, 64):
            ds.append(images[i: i + 64])
        f.create_dataset("labels", data=labels)
    chunked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, flags in (("mean_pixel.h5", []), ("mean_channel.h5", ["--per-channel"])):
        compute_mean.main([str(directory / "images.h5"), str(directory / name), "--chunk", "128",
                           *flags])
    mean_s = time.perf_counter() - t0
    with hdf5.File(directory / "images_chunked.h5") as f, \
            hdf5.File(directory / "mean_pixel.h5") as m:
        if not (np.array_equal(f["data"][...], images) and np.array_equal(f["labels"][...], labels)):
            raise AssertionError("the chunked HDF5 copy differs from the rows written")
        want = images.astype(np.float64).mean(0)
        if np.abs(m["mean"][...] - want).max() > 1e-3:
            raise AssertionError("compute_mean's full-pixel mean differs from numpy's")
    size = (directory / "images.cache").stat().st_size
    reader = RawCacheReader(str(directory / "images.cache"))
    idx = np.random.default_rng(1).integers(0, LEARN_ROWS, (20, BATCH))
    if not np.array_equal(reader.gather(idx[0]), images[idx[0]]):
        raise AssertionError("the raw cache gather differs from the rows written")
    gather_ms = statistics.median(_ms(lambda i=i: reader.gather(i)) for i in idx)
    plain_ms = statistics.median(
        _ms(lambda i=i: raw_cache_gather_reference(str(directory / "images.cache"), i)) for i in idx)
    reader.close()
    batch_ms = {}
    for name, text in (
            ("RAW_CACHE", raw_cache_data_text(directory, BATCH, False)),
            ("HDF5 contiguous", hdf5_data_text(directory / "images.h5",
                                               directory / "mean_channel.h5", BATCH, True, False)),
            ("HDF5 chunked", hdf5_data_text(directory / "images_chunked.h5",
                                            directory / "mean_channel.h5", BATCH, True, False))):
        data = DataHandler(parse_dataset_config(text))
        first = data.get_batch()
        if not np.array_equal(first["input"], images[data._order[:BATCH]]):
            raise AssertionError(f"{name}: the first batch differs from the rows written")
        batch_ms[name] = statistics.median(_ms(data.get_batch) for _ in range(20))
        data.close()
    print(f"[{card}] learnable set: {LEARN_ROWS} images {RAW}x{RAW}x3 over {LEARN_CLASSES} classes, "
          f"raw cache {size} bytes, made and written in {made_s:.3f} s; HDF5 written by the port's "
          f"hdf5.py in {contiguous_s:.3f} s contiguous, {chunked_s:.3f} s chunked by {HDF5_CHUNK} "
          f"rows; compute_mean's two mean files in {mean_s:.3f} s. Host ms per {BATCH}-row batch "
          f"({BATCH * RAW * RAW * 3} bytes, page cache warm): C++ gather {gather_ms:.4f}, numpy "
          f"memmap gather (the plain version) {plain_ms:.4f}; DataHandler.get_batch without "
          f"prefetch: " + ", ".join(f"{k} {v:.4f}" for k, v in batch_ms.items()))
    del images, labels
    return {"gather_ms": gather_ms, "plain_gather_ms": plain_ms, "get_batch_ms": batch_ms,
            "hdf5_write_s": {"contiguous": contiguous_s, "chunked": chunked_s},
            "compute_mean_s": mean_s}


# each wrapper's main kernel, as torch.profiler names it in a trace
def traced_launches(trace_dir: Path):
    """From the Chrome traces torch.profiler wrote into trace_dir, one dict
    for each of the host's cudaGraphLaunch calls, in the order they were
    made: the card's launches of each wrapper's kernel (kernel events by
    name) that the trace ties to that call by its correlation id."""
    import re

    from convnet_tpu_torch.ops import KERNEL_NAMES

    replays = []
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if not files:
        raise AssertionError(f"no torch.profiler trace in {trace_dir}")
    for f in files:
        events = json.loads(f.read_text()).get("traceEvents", [])
        launches = sorted((ev.get("ts", 0), ev["args"]["correlation"]) for ev in events
                          if ev.get("cat") == "cuda_runtime"
                          and ev.get("name") == "cudaGraphLaunch")
        by_launch = {c: dict.fromkeys(KERNEL_NAMES, 0) for _, c in launches}
        for ev in events:
            counts = by_launch.get(ev.get("args", {}).get("correlation"))
            if ev.get("cat") == "kernel" and counts is not None:
                for k, pat in KERNEL_NAMES.items():
                    if re.search(pat, ev.get("name", "")):
                        counts[k] += 1
        replays += [by_launch[c] for _, c in launches]
    return replays


def expect_traced_replays(replays, per_call):
    """Raise unless every replay inside the traced window launched each
    kernel per_call[k] times (0 for a kernel not named), and the first and
    the last, which the profiler's start and stop may cut, no more than
    that; returns the launches summed over the replays."""
    if len(replays) < 3:
        raise AssertionError(f"the trace holds {len(replays)} cudaGraphLaunch calls, "
                             "fewer than 3")
    for i, got in enumerate(replays[1:-1], 1):
        expect_launches(f"replay {i} of the {len(replays)} traced", got, per_call, 1)
    for i in (0, len(replays) - 1):
        if any(n > per_call.get(k, 0) for k, n in replays[i].items()):
            raise AssertionError(f"replay {i} of the {len(replays)} traced launched "
                                 f"{replays[i]}, more than a step's {per_call}")
    return {k: sum(r[k] for r in replays) for k in replays[0]}


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def check_learning(directory: Path, card):
    """Phase 8a: full-width AlexNet from a temp copy of the pbtxt that logs
    every LEARN_LOG steps, trained through the train CLI in this process at
    --steps-per-launch LAUNCH_K over the learnable set, LEARN_STEPS steps at
    most; the pbtxt's eps first, then larger ones (EPS_LADDER) until the
    last logged loss is below LEARN_LOSS and the last window's train error
    below LEARN_ERR. Returns (the run's Trainer facts, its launches)."""
    import re
    import tempfile

    import torch

    from convnet_tpu_torch.cli import train as train_cli
    from convnet_tpu_torch.config import model_to_text, read_model

    (directory / "train.pbtxt").write_text(raw_cache_data_text(directory, BATCH))
    for factor in EPS_LADDER:
        model = read_model(str(ALEXNET))
        model.display_after, model.checkpoint_after, model.validate_after = LEARN_LOG, 0, 0
        for e in model.edge:
            for opt in (e.weight_optimizer, e.bias_optimizer):
                opt.base_epsilon *= factor
        eps = sorted({(e.weight_optimizer.base_epsilon, e.bias_optimizer.base_epsilon)
                      for e in model.edge if e.HasField("weight_optimizer")})
        with tempfile.TemporaryDirectory(dir=directory) as out:
            path = Path(out) / "alexnet.pbtxt"
            path.write_text(model_to_text(model))
            reset_launches()
            t0 = time.perf_counter()
            with _CapturingTrainer(train_cli) as cap:
                rc = train_cli.main([str(path), str(directory / "train.pbtxt"), "--output-dir", out,
                                     "--max-iter", str(LEARN_STEPS), "--steps-per-launch",
                                     str(LAUNCH_K), "--profile-dir", str(Path(out) / "trace")])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counted = read_launches()
            replays = traced_launches(Path(out) / "trace")
            log = (Path(out) / "alexnet_train_log.txt").read_text()
        trainer = cap.made[0]
        steps = [(int(a), float(b), float(c)) for a, b, c in
                 re.findall(r"^step (\d+) loss (\S+) train_err (\S+)", log, re.M)]
        print(f"[{card}] AlexNet through the train CLI over the learnable raw cache, "
              f"--steps-per-launch {LAUNCH_K}, eps x{factor} (weight, bias base_epsilon {eps}): "
              f"rc {rc}, {run_s:.3f} s; (step, loss, train_err) every {LEARN_LOG} steps: {steps}")
        print(f"[{card}]   the train log's lines about the data: "
              f"{[l for l in log.splitlines() if 'data:' in l]}")
        if rc != 0 or trainer.state["step"] != LEARN_STEPS or len(steps) != LEARN_STEPS // LEARN_LOG:
            raise AssertionError(f"the train CLI returned {rc} at step {trainer.state['step']}")
        captured = trainer.steps.captured
        facts = {"eps_factor": factor, "eps": eps, "seconds": run_s, "log": steps,
                 "per_capture": dict(captured.launches), "replays": captured.replays,
                 "wrapper_counts": counted, "traced_graph_launches": len(replays),
                 "traced_edges": [replays[0], replays[-1]] if replays else [],
                 "timers_ms": {k: t.mean * 1e3 for k, t in trainer.timers.items() if t.count}}
        print(f"[{card}]   kernels launched in the traced window of {len(replays)} replays "
              f"(torch.profiler, by kernel name and the replay's correlation id): first "
              f"{replays[:1]}, last {replays[-1:]}; through the wrappers in the whole run (the "
              f"warm-up and the capture): {counted}")
        expect_launches("the step's capture", captured.launches, TRAIN_PER_STEP, 1)
        facts["traced"] = expect_traced_replays(replays, TRAIN_PER_STEP)
        print(f"[{card}]   summed over the traced replays: {facts['traced']}")
        if captured.replays != LEARN_STEPS:
            raise AssertionError(f"{captured.replays} replays for {LEARN_STEPS} steps")
        expect_trained(f"AlexNet after {LEARN_STEPS} steps", trainer.state["params"],
                       trainer.p_init, card)
        del trainer, cap, captured
        torch.cuda.empty_cache()
        last_loss, last_err = steps[-1][1], steps[-1][2]
        if last_loss < LEARN_LOSS and last_err < LEARN_ERR:
            print(f"[{card}] phase 8a: AlexNet learned the raw cache at eps x{factor}: last logged "
                  f"loss {last_loss} < {LEARN_LOSS}, last window's train error {last_err} < "
                  f"{LEARN_ERR}; {facts['replays']} replays of a captured step; host stages, "
                  f"ms each: {facts['timers_ms']}")
            return facts
        print(f"[{card}] phase 8a: at eps x{factor} the last logged loss is {last_loss} and the "
              f"train error {last_err}: not both below the bars ({LEARN_LOSS}, {LEARN_ERR})")
    raise AssertionError("AlexNet did not learn the raw cache at any eps of the ladder")


def check_image_streams(dev, card):
    """Phase 8b, where PIL imports: 16 JPEGs and 4 PNGs of mixed sizes
    through IMAGE_RAW (a JPEG-only list and the mixed one, each reader's
    backend printed), SLIDING_WINDOW through a forward on the card and the
    CPU and through the extract CLI (its checkpoint and output written by
    the port's hdf5.py) and TXT through a DataHandler; the card's forward
    of one batch against the CPU's read of the same files."""
    try:
        from PIL import Image
    except ImportError:
        print(f"[{card}] phase 8b: needs PIL, which does not import on this machine; not run")
        return
    import tempfile

    import numpy as np
    import torch

    from convnet_tpu_torch.config import parse_dataset_config, parse_model
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.model import init_params
    from convnet_tpu_torch.trainer import device_batch, make_forward

    rng = np.random.default_rng(8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = []
        for i in range(20):
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            p = tmp / (f"img{i}.jpg" if i < 16 else f"img{i}.png")
            Image.fromarray(arr).save(p)
            paths.append(p)
        (tmp / "jpeg.txt").write_text("\n".join(str(p) for p in paths[:16]))
        (tmp / "mixed.txt").write_text("\n".join(str(p) for p in paths))
        (tmp / "rows.txt").write_text("\n".join(" ".join(str(v) for v in r)
                                                for r in rng.normal(size=(12, 6)).round(4)))

        def handler(kind, listfile, extra=""):
            return DataHandler(parse_dataset_config(f"""
                name: "{kind}" batch_size: 4 randomize_cpu: false pipeline_loads: false
                data_config {{ layer_name: "input" data_type: {kind} file_pattern: "{listfile}"
                              {extra} }}"""))

        reads = {}
        for name in ("jpeg", "mixed"):
            data = handler("IMAGE_RAW", tmp / f"{name}.txt",
                           "image_size: 24 raw_image_size: 32 num_colors: 3")
            batch = data.get_batch()["input"]
            reads[name] = (data.backends()["input"], batch.shape, batch.dtype, float(batch.std()))
            print(f"[{card}] IMAGE_RAW {name}: {'; '.join(data.backend_log())}")
            data.close()
        print(f"[{card}] IMAGE_RAW (reader, batch shape, dtype, std): {reads}")
        if any(r[1] != (4, 32, 32, 3) or r[2] != np.uint8 or r[3] < 1 for r in reads.values()):
            raise AssertionError(f"IMAGE_RAW batches {reads}")
        if reads["mixed"][0] != "pil":
            raise AssertionError("a list with PNGs must take the PIL reader")
        window = "image_size: 16 window_stride: 16 num_colors: 3"
        model = parse_model("""
            name: "windows" seed: 1
            layer { name: "input" is_input: true num_channels: 3 image_size: 16 }
            layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }
            layer { name: "fc2" is_output: true num_channels: 5 activation: SOFTMAX
                    data_field: "labels" }
            edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1
                   padding: 1 initialization: DENSE_GAUSSIAN init_wt: 0.1 }
            edge { source: "conv1" dest: "fc2" edge_type: FC initialization: DENSE_GAUSSIAN
                   init_wt: 0.1 }""")
        graph = build_graph(model)
        params = {dname: init_params(graph, seed=1, device=dname) for dname in ("cpu", dev)}
        feats = {}
        for dname in ("cpu", dev):
            data = handler("SLIDING_WINDOW", tmp / "jpeg.txt", window)
            fwd = make_forward(graph, ["fc2"], data.jitter_specs())
            batch = data.get_batch()
            with torch.inference_mode():
                feats[str(dname)] = fwd(params[dname], device_batch(batch, dname))["fc2"].cpu()
            rows = data.num_rows
            data.close()
        diff = (feats["cpu"] - feats[str(dev)]).abs().max().item()
        print(f"[{card}] SLIDING_WINDOW: {rows} windows of 16x16 over 16 JPEGs; fc2 of one batch on "
              f"the card against the CPU: max |diff| {diff}")
        if diff > 1e-4 * max(1.0, feats["cpu"].abs().max().item()):
            raise AssertionError("SLIDING_WINDOW features differ between the card and the CPU")
        from convnet_tpu_torch import checkpoint as ckpt
        from convnet_tpu_torch import hdf5
        from convnet_tpu_torch.cli import extract as extract_cli
        from convnet_tpu_torch.config import model_to_text

        host = {n: {k: v.numpy() for k, v in p.items()} for n, p in params["cpu"].items()}
        path = ckpt.save(str(tmp), "windows", host, None, step=0)
        (tmp / "windows.pbtxt").write_text(model_to_text(model))
        (tmp / "windows_data.pbtxt").write_text(f"""
            name: "w" batch_size: 4 data_config {{ layer_name: "input"
            data_type: SLIDING_WINDOW file_pattern: "{tmp / 'jpeg.txt'}" {window} }}""")
        rc = extract_cli.main([str(tmp / "windows.pbtxt"), str(tmp / "windows_data.pbtxt"),
                               "--checkpoint", path, "--output", str(tmp / "f.h5"),
                               "--layers", "fc2", "--device", str(dev)])
        with hdf5.File(tmp / "f.h5") as f:
            got, written = f["fc2"][:4], f["fc2"].shape
        err = np.abs(got - feats["cpu"].numpy().reshape(4, -1)).max()
        print(f"[{card}] extract CLI over SLIDING_WINDOW on the card: rc {rc}, {written} rows "
              f"written; first batch against the CPU's forward max |diff| {err}")
        if rc != 0 or err > 1e-4 or written != (rows, 5):
            raise AssertionError("the extract CLI's SLIDING_WINDOW features differ")
        data = handler("TXT", tmp / "rows.txt")
        rows = data.get_batch()["input"]
        want = np.loadtxt(tmp / "rows.txt", dtype=np.float32, ndmin=2)[:4]
        data.close()
        print(f"[{card}] TXT: batch {rows.shape} {rows.dtype}, array-equal to numpy's read "
              f"{np.array_equal(rows, want)}")
        if not np.array_equal(rows, want):
            raise AssertionError("the TXT stream's rows differ from numpy's read")


def _stacked(batches, lo, hi):
    import torch

    return {k: torch.stack([b[k] for b in batches[lo:hi]]) for k in batches[0]}


def _same_or_close(what, a, b, card):
    """(array-equal, the largest |a - b| over the leaves as a share of the
    leaf's largest |b|) of two {edge: {w, b}} trees."""
    import torch

    equal, worst = True, 0.0
    for name, p in b.items():
        for k, v in p.items():
            if not torch.equal(a[name][k], v):
                equal = False
                scale = v.abs().max().item() or 1.0
                worst = max(worst, (a[name][k] - v).abs().max().item() / scale)
    print(f"[{card}]   {what}: array-equal {equal}, largest difference {worst} of the largest "
          "element")
    return equal, worst


def check_steps_per_launch(dev, graph, state0, jitter, batches, card, mesh=None,
                           phase="phase 8c"):
    """Phase 8c's comparison: from one state and the same LAUNCH_STEPS staged
    batches, two launches of LAUNCH_K (replays of the captured step) against
    LAUNCH_STEPS eager steps. The crop origins, flips and dropout keys of
    every step must be array-equal (a mask is a function of its key: the
    masks of the two keys are compared too), the parameters and momenta
    array-equal or within UPDATE_TOL of their largest update; the launches
    a replayed step makes (counted from the capture) must be the eager
    step's. mesh: the steps of that mesh's rank (phase 9b: a 1x1 mesh over
    NCCL, whose collectives the capture holds). Returns the replayed path's
    facts."""
    import torch

    from convnet_tpu_torch.ops import dropout as drop
    from convnet_tpu_torch.trainer import TrainSteps

    eager, replayed = TrainSteps(graph, jitter, mesh), TrainSteps(graph, jitter, mesh)
    a, b = clone_state(state0), clone_state(state0)
    draws_e, draws_r = [], []

    def snap(draws):
        keys, crops = draws
        return ({i: k.clone() for i, k in keys.items()},
                {f: tuple(None if t is None else t.clone() for t in c) for f, c in crops.items()})

    for x in batches:
        eager.step(a, x)
        draws_e.append(snap(eager.last_draws))
    for lo in range(0, LAUNCH_STEPS, LAUNCH_K):
        stacked = _stacked(batches, lo, lo + LAUNCH_K)
        # one replay at a time, so that each step's draws can be read
        for i in range(LAUNCH_K):
            replayed.launch(b, {k: v[i: i + 1] for k, v in stacked.items()}, 1)
            draws_r.append(snap(replayed.last_draws))
    torch.cuda.synchronize()
    for t, ((ke, ce), (kr, cr)) in enumerate(zip(draws_e, draws_r)):
        same_keys = ke.keys() == kr.keys() and all(torch.equal(ke[i], kr[i]) for i in ke)
        same_crops = all(all(torch.equal(p, q) if p is not None else q is None
                             for p, q in zip(ce[f], cr[f])) for f in ce)
        masks = all(torch.equal(drop.dropout_apply(torch.ones(4096, device=dev), 0.5, ke[i]),
                                drop.dropout_apply(torch.ones(4096, device=dev), 0.5, kr[i]))
                    for i in ke)
        if not (same_keys and same_crops and masks):
            raise AssertionError(f"step {t}: the replayed step drew other crops or masks")
    print(f"[{card}] {phase}: {LAUNCH_STEPS} steps as {LAUNCH_STEPS} replays against "
          f"{LAUNCH_STEPS} eager steps: crop origins, flips and dropout keys and masks "
          "array-equal at every step")
    expect_launches("a replayed step (counted from its capture)", replayed.captured.launches,
                    TRAIN_PER_STEP, 1)
    # the launch path proper: two launches of LAUNCH_K from the same state
    c = clone_state(state0)
    staged = TrainSteps(graph, jitter, mesh)
    for lo in range(0, LAUNCH_STEPS, LAUNCH_K):
        metrics = staged.launch(c, _stacked(batches, lo, lo + LAUNCH_K), LAUNCH_K)
    torch.cuda.synchronize()
    if metrics["loss"].shape != (LAUNCH_K,) or c["step"] != a["step"]:
        raise AssertionError(f"a launch's metrics {metrics['loss'].shape}, step {c['step']}")
    results = {}
    for what, other in (("one replay a launch", b), (f"{LAUNCH_K} replays a launch", c)):
        for tree in ("params", "moms"):
            results[(what, tree)] = _same_or_close(f"{what}, {tree} against the eager steps'",
                                                   other[tree], a[tree], card)
    for (what, tree), (equal, worst) in results.items():
        if not equal and worst > UPDATE_TOL:
            raise AssertionError(f"{what}: {tree} differ from the eager steps' by {worst}")
    return {"launches_per_capture": dict(replayed.captured.launches),
            "array_equal": {f"{w}, {t}": e for (w, t), (e, _) in results.items()},
            "largest_difference": {f"{w}, {t}": d for (w, t), (_, d) in results.items()}}


def launch_times(graph, state, jitter, batches, card, mesh=None,
                 paths=("train", "reference_gradient")):
    """The train step at k = 1 (eager) and k = LAUNCH_K (replays), on the
    train paths `paths` (under `mesh`, that mesh's rank's step): device
    time with the launches hidden (a launch a spin), host clock with a
    synchronize, and the card's idle share. Returns {path: {k: (device ms a
    step, host ms a step)}}."""
    import torch

    from convnet_tpu_torch.trainer import TrainSteps

    out = {}
    stacked = _stacked(batches, 0, LAUNCH_K)
    where = "" if mesh is None else f", {mesh.data}x{mesh.model} mesh over {mesh.backend}"
    for path in paths:
        ctx = pool_switches() if path == "reference_gradient" else contextlib.nullcontext()
        with ctx:
            steps = TrainSteps(graph, jitter, mesh)
            st = clone_state(state)
            runs = {1: lambda: steps.step(st, batches[0]),
                    LAUNCH_K: lambda: steps.launch(st, stacked, LAUNCH_K)}
            runs[LAUNCH_K]()  # captures
            out[path] = {}
            for k, fn in runs.items():
                dev_ms = device_ms(fn, k=1, reps=ITERS) / k
                host = []
                for i in range(WARMUP + ITERS // k * 2):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if i >= WARMUP:
                        host.append((time.perf_counter() - t0) * 1e3 / k)
                host_ms = statistics.median(host)
                out[path][k] = (dev_ms, host_ms)
                print(f"[{card}] AlexNet train step ({path}{where}), batch {BATCH}, {k} a launch"
                      f"{' (CUDA-graph replays)' if k > 1 else ' (eager)'}: device time with the "
                      f"launches hidden {dev_ms:.4f} ms a step; host clock with synchronize "
                      f"{host_ms:.4f} ms a step, so the card idles {1 - dev_ms / host_ms:.3f} of it")
            del steps, st
            torch.cuda.empty_cache()
    return out


def trainer_rates(dev, graph, jitter, directory, card):
    """Trainer.train images a second over TRAINER_LAUNCH_STEPS steps at k = 1
    and k = LAUNCH_K, on DUMMY data and the learnable set's raw cache (each
    with the phase's mean) and on its contiguous HDF5 file (with the
    per-channel mean file), with the host stages' mean ms (the Trainer's
    timers) and, at k = 1, the wrappers' launches over the timed steps.
    Returns ({data: {k: (img/s, timers)}}, {path: launches})."""
    import torch

    from convnet_tpu_torch.config import parse_dataset_config
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.trainer import Trainer

    out, launches = {}, {}
    for data_name, text in (("DUMMY", dummy_imagenet_text(BATCH, DUMMY_ROWS, True)),
                            ("RAW_CACHE", raw_cache_data_text(directory, BATCH)),
                            ("HDF5", hdf5_data_text(directory / "images.h5",
                                                    directory / "mean_channel.h5", BATCH, True))):
        out[data_name] = {}
        for k in (1, LAUNCH_K):
            data = DataHandler(parse_dataset_config(text))
            jit = data.jitter_specs()
            if data_name != "HDF5":
                jit = {"input": (jit["input"][0], jitter["input"][1], None)}
            trainer = Trainer(graph, data, device=dev, jitter=jit, steps_per_launch=k,
                              log_fn=lambda _: None)
            trainer.train(max_iter=2 * LAUNCH_K)  # warm-up (and the capture)
            torch.cuda.synchronize()
            for t in trainer.timers.values():
                t.total, t.count = 0.0, 0
            reset_launches()
            t0 = time.perf_counter()
            trainer.train(max_iter=2 * LAUNCH_K + TRAINER_LAUNCH_STEPS)
            torch.cuda.synchronize()
            ips = TRAINER_LAUNCH_STEPS * BATCH / (time.perf_counter() - t0)
            if k == 1 and data_name != "DUMMY":
                launches[f"{data_name.lower()}_trainer_k1"] = read_launches()
                expect_launches(f"Trainer.train over {data_name}", read_launches(),
                                TRAIN_PER_STEP, TRAINER_LAUNCH_STEPS)
            timers = {n: t.total * 1e3 / TRAINER_LAUNCH_STEPS for n, t in trainer.timers.items()
                      if t.count}
            data.close()
            out[data_name][k] = (ips, timers)
            print(f"[{card}] Trainer.train over {data_name}, {k} steps a launch, "
                  f"{TRAINER_LAUNCH_STEPS} steps: {ips:.1f} img/s (host clock, staging included); "
                  f"host ms a step by stage: "
                  + ", ".join(f"{n} {v:.4f}" for n, v in timers.items()))
            del trainer
            torch.cuda.empty_cache()
    return out, launches


# phase 8e: checkpoints every HDF5_CKPT_AFTER steps of a first CLI run of
# HDF5_STEPS steps (step 10's and the CLI's save at its end: two files),
# then a second run on the same directory to HDF5_RESUME_STEPS
HDF5_CKPT_AFTER, HDF5_STEPS, HDF5_RESUME_STEPS = 10, 15, 20
# a train step over a full-pixel mean file: the jitter takes the plain path
# (the prologue kernel takes a per-channel affine only, as the JAX
# package's does: convnet_tpu/trainer.py:104), the rest runs the kernels
PIXEL_MEAN_STEP = {"lrn_fwd": 2, "lrn_bwd": 2, "dropout": 4, "step_draws": 1}


# phase 8f: AlexNet over the learnable set normalized by compute_mean's
# per-channel mean and std, at these factors of the pbtxt's eps (and over
# the set scaled by 1/255 at the pbtxt's eps), NORM_STEPS steps of the
# kernel path and of the plain-composed one on the same batches; at
# NORM_LEARN the kernel path must learn the normalized set (phase 8a's bars)
NORM_STEPS, NORM_EPS, NORM_LEARN = 400, (1.0, 0.5, 0.25), 0.25


def check_normalize(dev, directory: Path, card, steps=NORM_STEPS):
    """Phase 8f. Full-width AlexNet (bf16, batch 128) from the seed-0
    initial state over the learnable set's contiguous HDF5 file with
    compute_mean's per-channel mean and std (normalize: the prologue kernel
    takes the file's affine), random crops and flips. (a) PARITY_STEPS steps
    of the port's step against the plain-composed one (check_train_parity,
    with the std). (b) For the normalized set at each factor of NORM_EPS,
    and the set scaled by 1/255 (phase 8a's) at the pbtxt's eps, up to
    `steps` steps of the port's eager step (the kernels) and of
    plain_train_step (no kernel of the port) side by side on the same
    batches from the same state: the loss every LEARN_LOG steps, the
    least, and the first step whose loss is not finite, for each path. A
    kernel fault shows as one path diverging alone; unstable dynamics as
    both. The kernel path's launches are counted; at eps x NORM_LEARN it
    must stay finite and meet phase 8a's bars (its last logged loss below
    LEARN_LOSS, its last window's train error below LEARN_ERR). Returns
    ({label: facts}, the NORM_LEARN run's launches)."""
    import numpy as np
    import torch

    from convnet_tpu_torch.config import parse_dataset_config, read_model
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.trainer import device_batch, init_state, make_train_step

    normalized = hdf5_data_text(directory / "images.h5", directory / "mean_channel.h5", BATCH,
                                True, False)
    runs = [(f"normalize eps x{f}", normalized, f) for f in NORM_EPS]
    runs.append(("scale 1/255 eps x1", raw_cache_data_text(directory, BATCH, False), 1.0))

    def setup(text, factor):
        data = DataHandler(parse_dataset_config(text))
        spec, mean, std = data.jitter_specs()["input"]

        def on_card(v):
            return None if v is None else torch.as_tensor(np.asarray(v, np.float32), device=dev)

        model = read_model(str(ALEXNET))
        for e in model.edge:
            for opt in (e.weight_optimizer, e.bias_optimizer):
                opt.base_epsilon *= factor
        return data, build_graph(model), {"input": (spec, mean, std)}, on_card(mean), on_card(std)

    data, graph, jitter, mean_t, std_t = setup(normalized, 1.0)
    spec = jitter["input"][0]
    print(f"[{card}] phase 8f: per-channel mean {jitter['input'][1]}, std {jitter['input'][2]}")
    state = init_state(graph, seed=0, device=dev)
    batches = [device_batch(data.get_batch(), dev) for _ in range(PARITY_STEPS)]
    data.close()
    check_train_parity(graph, state, jitter, batches, spec, mean_t, card, std_t=std_t)
    del state, batches

    facts, learn_launches = {}, None
    for label, text, factor in runs:
        data, graph, jitter, mean_t, std_t = setup(text, factor)
        spec = jitter["input"][0]
        step = make_train_step(graph, jitter)
        port = init_state(graph, seed=0, device=dev)
        plain = clone_state(port)
        paths = {
            "kernels": lambda b: step(port, b),
            "plain": lambda b: {"loss": plain_train_step(graph, plain, b, spec, mean_t, False,
                                                         std_t)},
        }
        losses = {name: [] for name in paths}
        errors = []
        first_bad = {name: None for name in paths}
        reset_launches()
        t0 = time.perf_counter()
        for t in range(steps):
            b = device_batch(data.get_batch(), dev)
            for name, fn in paths.items():
                if first_bad[name] is not None:
                    continue
                m = fn(b)
                loss = float(m["loss"].item())
                losses[name].append(loss)
                if name == "kernels":
                    errors.append(sum(float(v.item()) for k, v in m.items()
                                      if k.endswith("/errors")) / BATCH)
                if not np.isfinite(loss):
                    first_bad[name] = t + 1
            if all(v is not None for v in first_bad.values()):
                break
        torch.cuda.synchronize()
        data.close()
        run_s = time.perf_counter() - t0
        counted = read_launches()
        expect_launches(f"phase 8f {label}'s kernel path", counted, TRAIN_PER_STEP,
                        len(losses["kernels"]))
        f = {"eps_factor": factor, "seconds": run_s, "first_nonfinite_step": first_bad,
             "launches": counted}
        for name, ls in losses.items():
            finite = [v for v in ls if np.isfinite(v)]
            f[name] = {"steps": len(ls), "least_loss": min(finite) if finite else None,
                       "least_at": (int(np.argmin(finite)) + 1) if finite else None,
                       "log": [(i + 1, ls[i]) for i in range(LEARN_LOG - 1, len(ls), LEARN_LOG)]}
        windows = [float(np.mean(errors[i:i + LEARN_LOG])) for i in range(0, len(errors), LEARN_LOG)]
        f["kernels"]["train_err_by_window"] = windows
        facts[label] = f
        print(f"[{card}] phase 8f {label}: {run_s:.3f} s; first non-finite loss at step "
              f"{first_bad}; least loss kernels {f['kernels']['least_loss']} at step "
              f"{f['kernels']['least_at']}, plain {f['plain']['least_loss']} at step "
              f"{f['plain']['least_at']}")
        print(f"[{card}]   (step, loss) every {LEARN_LOG}: kernels {f['kernels']['log']}; "
              f"plain {f['plain']['log']}; kernel path's train error by window {windows}")
        del port, plain, paths, step
        torch.cuda.empty_cache()
        if factor == NORM_LEARN and text == normalized:
            learn_launches = counted
            last_loss = f["kernels"]["log"][-1][1] if f["kernels"]["log"] else float("nan")
            if first_bad["kernels"] is not None or not (last_loss < LEARN_LOSS
                                                        and windows[-1] < LEARN_ERR):
                raise AssertionError(f"phase 8f: the normalized set at eps x{factor} did not "
                                     f"train on the kernel path: last loss {last_loss}, last "
                                     f"window's error {windows[-1]}, first non-finite step "
                                     f"{first_bad['kernels']}")
            print(f"[{card}] phase 8f: AlexNet learned the normalized set at eps x{factor} on "
                  f"the kernel path: last logged loss {last_loss} < {LEARN_LOSS}, last window's "
                  f"train error {windows[-1]} < {LEARN_ERR}")
    return facts, learn_launches


def check_hdf5_path(dev, directory: Path, card):
    """Phase 8e: full-width AlexNet (bf16, batch 128) through the train CLI
    over the contiguous HDF5 file with the full-pixel mean file, random
    crops and flips: HDF5_STEPS steps writing two checkpoints, then a second
    CLI run on the same directory that must resume at the newest one's step
    with params array-equal to it; then fc7 through the extract CLI from the
    newest checkpoint over the chunked HDF5 file (centre crops), written by
    the port's DataWriter and read back with hdf5.py: one finite row per
    input row, within phase 3's bar (1e-2 of the largest |value|) of a
    Predictor's fc7 of the same rows from the same checkpoint. Returns the
    phase's facts and {path: launches}."""
    import re

    import numpy as np
    import torch

    from convnet_tpu_torch import checkpoint as ckpt
    from convnet_tpu_torch import hdf5
    from convnet_tpu_torch.cli import extract as extract_cli
    from convnet_tpu_torch.cli import train as train_cli
    from convnet_tpu_torch.config import model_to_text, parse_dataset_config, read_model
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.model import param_shapes, params_from_numpy
    from convnet_tpu_torch.predictor import Predictor

    model = read_model(str(ALEXNET))
    model.display_after, model.checkpoint_after, model.validate_after = 5, HDF5_CKPT_AFTER, 0
    model_path = directory / "hdf5_alexnet.pbtxt"
    model_path.write_text(model_to_text(model))
    train_text = hdf5_data_text(directory / "images.h5", directory / "mean_pixel.h5", BATCH, True)
    val_text = hdf5_data_text(directory / "images_chunked.h5", directory / "mean_pixel.h5",
                              BATCH, False)
    (directory / "hdf5_train.pbtxt").write_text(train_text)
    (directory / "hdf5_val.pbtxt").write_text(val_text)
    out = directory / "hdf5_run"
    launches, runs = {}, []
    for run, steps in ((1, HDF5_STEPS), (2, HDF5_RESUME_STEPS)):
        reset_launches()
        t0 = time.perf_counter()
        with _CapturingTrainer(train_cli) as cap:
            rc = train_cli.main([str(model_path), str(directory / "hdf5_train.pbtxt"),
                                 "--output-dir", str(out), "--max-iter", str(steps)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[f"hdf5_train_cli_run{run}"] = read_launches()
        trainer = cap.made[0]
        start = HDF5_STEPS if run == 2 else 0
        if rc != 0 or trainer.state["step"] != steps:
            raise AssertionError(f"HDF5 CLI run {run}: rc {rc} at step {trainer.state['step']}")
        expect_launches(f"HDF5 CLI run {run}", launches[f"hdf5_train_cli_run{run}"],
                        PIXEL_MEAN_STEP, steps - start)
        ckpts = sorted(out.glob("alexnet_*.h5"))
        runs.append({"seconds": run_s, "checkpoints": [p.name for p in ckpts]})
        if run == 1:
            if len(ckpts) != 2:
                raise AssertionError(f"HDF5 CLI run 1 wrote checkpoints {ckpts}")
            saved = []
            for p in ckpts:
                with hdf5.File(p) as f:
                    saved.append(int(f.attrs["step"]))
            if saved != [HDF5_CKPT_AFTER, HDF5_STEPS]:
                raise AssertionError(f"HDF5 CLI run 1's checkpoints hold steps {saved}")
            newest = ckpts[-1]
            params, _, step = ckpt.load(str(newest), expected_shapes=param_shapes(trainer.graph))
            want = params_from_numpy(params, dev)
            expect_trained(f"AlexNet after {steps} HDF5 steps", trainer.state["params"],
                           trainer.p_init, card)
        else:
            # p_init: the Trainer's params right after it resumed
            same = all(torch.equal(trainer.p_init[e][k], want[e][k]) for e in want for k in want[e])
            log = (out / "alexnet_train_log.txt").read_text()
            said = re.findall(r"^resumed from (\S+) at step (\d+)", log, re.M)
            print(f"[{card}] phase 8e run 2 resumed: {said}; params array-equal to "
                  f"{newest.name}: {same}")
            if not same or said != [(str(newest), str(HDF5_STEPS))]:
                raise AssertionError("the second HDF5 CLI run did not resume from the newest "
                                     "checkpoint")
            losses = [float(v) for v in re.findall(r"^step \d+ loss (\S+)", log, re.M)]
            if len(losses) != HDF5_RESUME_STEPS // 5 or not np.isfinite(losses).all():
                raise AssertionError(f"the HDF5 runs' logged losses {losses}")
        print(f"[{card}] phase 8e: AlexNet through the train CLI over HDF5 (contiguous, "
              f"full-pixel mean file), run {run} to step {steps}: rc {rc}, {run_s:.3f} s; "
              f"launches {launches[f'hdf5_train_cli_run{run}']}; checkpoints {runs[-1]['checkpoints']}")
        del trainer, cap
        torch.cuda.empty_cache()
    newest = sorted(out.glob("alexnet_*.h5"))[-1]
    feats = directory / "fc7.h5"
    reset_launches()
    t0 = time.perf_counter()
    rc = extract_cli.main([str(model_path), str(directory / "hdf5_val.pbtxt"), "--checkpoint",
                           str(newest), "--output", str(feats), "--layers", "fc7"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches["hdf5_extract"] = read_launches()
    batches = -(-LEARN_ROWS // BATCH)
    expect_launches("the HDF5 extract", launches["hdf5_extract"], {"lrn_fwd": 2}, batches)
    with hdf5.File(feats) as f:
        fc7 = f["fc7"][...]
        chunks = f["fc7"]._layout.chunk
    if rc != 0 or fc7.shape != (LEARN_ROWS, 4096) or not np.isfinite(fc7).all():
        raise AssertionError(f"the HDF5 extract gave rc {rc}, fc7 {fc7.shape}")
    data = DataHandler(parse_dataset_config(val_text), randomize=False)
    graph = build_graph(model, data.input_image_sizes())
    pred = Predictor.from_checkpoint(graph, str(newest), layers=["fc7"], batch_size=BATCH,
                                     jitter=data.jitter_specs(), raw_size=RAW,
                                     input_dtype=np.uint8, device=dev)
    want_fc7 = np.concatenate([pred({"input": b["input"]})["fc7"].reshape(BATCH, -1)[:valid]
                               for b, valid in data.iter_epoch()])
    data.close()
    tol = 1e-2 * np.abs(want_fc7).max()
    err = float(np.abs(fc7 - want_fc7).max())
    print(f"[{card}] phase 8e: extract CLI, fc7 from {newest.name} over the chunked HDF5 file: "
          f"rc {rc}, {fc7.shape} rows (chunks {chunks}), {extract_s:.3f} s wall clock "
          f"(checkpoint load included): {LEARN_ROWS / extract_s:.1f} rows/s; against a "
          f"Predictor's fc7 of the same rows max |diff| {err} (bar {tol}); launches "
          f"{launches['hdf5_extract']}")
    if err > tol:
        raise AssertionError("the extract CLI's fc7 differs from the Predictor's")
    return {"runs": runs, "extract_s": extract_s, "extract_rows_per_s": LEARN_ROWS / extract_s,
            "extract_vs_predictor_max_abs": err, "bar": tol}, launches


def check_remat(dev, state, jitter, batch, card):
    """Phase 8d: one AlexNet train step with remat on and one with it off,
    from the same state and batch: the parameters equal, or within
    UPDATE_TOL of their largest update; torch.cuda.max_memory_allocated of
    each."""
    import torch

    from convnet_tpu_torch.config import read_model
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.trainer import make_train_step

    peaks, states = {}, {}
    for remat in (False, True):
        model = read_model(str(ALEXNET))
        model.remat = remat
        g = build_graph(model)
        st = clone_state(state)
        step = make_train_step(g, jitter)
        step(clone_state(state), batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step(st, batch)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(dev), base)
        states[remat] = st
        del step
    equal, worst = _same_or_close("remat on against off, params", states[True]["params"],
                                  states[False]["params"], card)
    upd = max((states[False]["params"][n][k] - state["params"][n][k]).abs().max().item()
              for n in state["params"] for k in ("w", "b"))
    step_bytes = {k: peak - base for k, (peak, base) in peaks.items()}
    print(f"[{card}] phase 8d: one AlexNet step, batch {BATCH}: max_memory_allocated with remat "
          f"off {peaks[False][0]} bytes, on {peaks[True][0]} bytes; above what was allocated "
          f"before the step: off {step_bytes[False]}, on {step_bytes[True]}; params "
          f"array-equal {equal}")
    if not equal and worst > UPDATE_TOL:
        raise AssertionError(f"remat changes the step's parameters by {worst} (largest update {upd})")
    return {"peak_bytes": {"off": peaks[False][0], "on": peaks[True][0]},
            "step_bytes": {"off": step_bytes[False], "on": step_bytes[True]},
            "array_equal": equal, "largest_difference": worst}


# -- phase 9: the mesh path ----------------------------------------------------

TOWERS = REPO / "examples" / "imagenet" / "alexnet_2tower.pbtxt"
MESH_STEPS = 3
# a world of ranks that is not done within this many seconds fails the phase
MESH_TIMEOUT_S = 420
# phase 9a's bars, as tree_errors measures them. A rank's convs run at
# another batch or channel count than one device's, so cuDNN sums in
# another order, a value rounds the other way, and a max pool picks another
# winner among near-equal values, which routes that window's gradient
# elsewhere. f32 (TF32 off): UPDATE_TOL of one device's step, as for the
# plain-composed step. bf16: one device computing each data rank's rows in
# turn (rows_in_turn_steps) differs from its own batch-128 step by that
# effect alone (0.146 of the largest momentum on an NVIDIA H100 80GB HBM3
# at 700 W), so a mesh's bf16 step is held to MESH_BF16_FLOOR times that
# distance, measured in the same run; and the 2x1 mesh, whose ranks'
# convs run at that same batch, array-equal to it.
MESH_DTYPES = ("bfloat16", "float32")
MESH_BF16_FLOOR = 2.0
# a step's launches by precision: an f32 model's uint8 input takes the
# plain crop, not the prologue kernel, which writes bf16 (prologue_plan)
MESH_PER_STEP = {"bfloat16": TRAIN_PER_STEP, "float32": dict(TRAIN_PER_STEP, s2d_prologue=0)}


def mesh_batches():
    """MESH_STEPS global batches of uint8 RAW x RAW x 3 images and 1000-class
    labels, the same in every process (a numpy seed)."""
    import numpy as np

    rng = np.random.default_rng(9)
    return [{"input": rng.integers(0, 256, (BATCH, RAW, RAW, 3), dtype=np.uint8),
             "labels": rng.integers(0, 1000, BATCH).astype(np.int32)} for _ in range(MESH_STEPS)]


def towers_graph(dtype: str):
    """Full-width alexnet_2tower in its own bf16, or in f32."""
    from convnet_tpu_torch.config import read_model
    from convnet_tpu_torch.graph import build_graph

    model = read_model(str(TOWERS))
    if dtype == "float32":
        model.ClearField("compute_dtype")
        model.ClearField("activation_dtype")
    return build_graph(model)


def towers_steps(dev, mesh, dtype):
    """MESH_STEPS train steps of full-width alexnet_2tower (in dtype, random
    crops and flips, dropout 0.5) from init_params' seed 0 over
    mesh_batches(), on this mesh's rank or (mesh None) on one device.
    Returns its facts: each
    step's crops and the dropout masks of its rows (from the key and element
    offset of each dropout call the model made), the kernels' launches, the
    local leaf shapes, the host seconds of the steps, and the gathered params
    and momenta (numpy, on rank 0 only); and the TrainSteps and state."""
    import numpy as np
    import torch

    from convnet_tpu_torch import model as model_lib
    from convnet_tpu_torch.data.jitter import JitterSpec
    from convnet_tpu_torch.ops import dropout as drop
    from convnet_tpu_torch.parallel.mesh import batch_rows, gather_params, param_shardings
    from convnet_tpu_torch.trainer import TrainSteps, device_batch, init_state

    graph = towers_graph(dtype)
    spec = JitterSpec(image_size=CROP, can_translate=True, can_flip=True, scale=1 / 255)
    jitter = {"input": (spec, np.full((3,), MEAN, np.float32), None)}
    state = init_state(graph, seed=0, device=dev, mesh=mesh)
    steps = TrainSteps(graph, jitter, mesh)
    calls = []
    real = model_lib.dropout

    def recording(x, rate, key, offset=0):
        calls.append((key.clone(), rate, offset, tuple(x.shape)))
        return real(x, rate, key, offset)

    model_lib.dropout = recording
    crops = []
    rows = batch_rows(mesh, BATCH)
    try:
        reset_launches()
        t0 = time.perf_counter()
        for batch in mesh_batches():
            steps.step(state, device_batch({k: v[rows] for k, v in batch.items()}, dev))
            crops.append(tuple(None if t is None else t.cpu().numpy()
                               for t in steps.last_draws[1]["input"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    finally:
        model_lib.dropout = real
    masks = [(drop.dropout_apply(torch.ones(shape, device=dev), rate, key, offset) != 0).cpu().numpy()
             for key, rate, offset, shape in calls]
    specs = param_shardings(graph, mesh.model) if mesh is not None else None
    lead = mesh is None or mesh.rank == 0
    trees = {t: gather_params(state[t], specs, mesh) for t in ("params", "moms")}
    return {
        "launches": launches, "crops": crops, "masks": masks, "seconds": seconds,
        "local_shapes": {n: {k: tuple(v.shape) for k, v in p.items()}
                         for n, p in state["params"].items()},
        "params": trees["params"] if lead else None, "moms": trees["moms"] if lead else None,
        "coords": None if mesh is None else (mesh.d, mesh.m),
        "shape": None if mesh is None else (mesh.data, mesh.model),
    }, steps, state


def rows_in_turn_steps(dev, data):
    """One device's MESH_STEPS bf16 alexnet_2tower steps as towers_steps
    takes them, but each batch's rows split into `data` parts computed in
    turn, as the data ranks of a data x 1 mesh compute them (each part's
    crops and dropout bits those rows' of the whole batch, its loss divided
    by `data`, the gradients summed in rank order), with no process group.
    Returns the params and momenta (numpy)."""
    import types

    import numpy as np
    import torch

    from convnet_tpu_torch import model as model_lib
    from convnet_tpu_torch import optim
    from convnet_tpu_torch.data.jitter import JitterSpec
    from convnet_tpu_torch.trainer import (
        JitterTensors,
        device_batch,
        draw_step,
        init_state,
        preprocess,
        rng_tensor,
    )

    graph = towers_graph("bfloat16")
    spec = JitterSpec(image_size=CROP, can_translate=True, can_flip=True, scale=1 / 255)
    jitter = {"input": (spec, np.full((3,), MEAN, np.float32), None)}
    consts = JitterTensors(jitter)
    state = init_state(graph, seed=0, device=dev)
    params, moms = state["params"], state["moms"]
    keys = [(n, k) for n in params for k in params[n]]
    b = BATCH // data
    for step, batch in enumerate(mesh_batches()):
        rng = rng_tensor(state, dev)
        total = None
        for d in range(data):
            # what apply_fn and draw_step read of a data rank's mesh
            rank = types.SimpleNamespace(d=d, data=data, model=1, m=0)
            part = device_batch({k: v[d * b:(d + 1) * b] for k, v in batch.items()}, dev)
            with torch.enable_grad():
                for n, k in keys:
                    params[n][k].requires_grad_(True)
                drop_keys, crops = draw_step(graph, jitter, part, rng, rank)
                proc = preprocess(graph, jitter, part, crops, consts)
                loss, _ = model_lib.loss_fn(graph, params, proc, train=True,
                                            dropout_keys=drop_keys, mesh=rank)
                grads = torch.autograd.grad(loss / data, [params[n][k] for n, k in keys])
            total = list(grads) if total is None else [a + g for a, g in zip(total, grads)]
        tree = {n: {} for n in params}
        for (n, k), g in zip(keys, total):
            tree[n][k] = g
        optim.apply_updates(graph, params, moms, tree, step=step)
        rng[1:].add_(1)
        state["step"] = state["rng_step"] = step + 1

    def host(t):
        return {n: {k: v.detach().float().cpu().numpy() for k, v in p.items()} for n, p in t.items()}

    return {"params": host(params), "moms": host(moms)}


def mesh_rank(rank, world, init, results, shape):
    """One rank of phase 9a: a gloo world on the card (CUDA tensors), the
    mesh `shape` or (None) alexnet_2tower's own, clamped to the world; its
    towers_steps in bf16 and in f32. Rank 0 of a 2x1 mesh also checks that
    several steps a launch over gloo raise, naming the backend."""
    import warnings

    import torch
    import torch.distributed as dist

    from convnet_tpu_torch.parallel.mesh import make_mesh, mesh_for_graph

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if shape is None:
                mesh = mesh_for_graph(towers_graph("bfloat16"))
            else:
                mesh = make_mesh(*shape)
        out = {"warnings": [str(w.message) for w in caught]}
        for dtype in MESH_DTYPES:
            out[dtype], steps, state = towers_steps(dev, mesh, dtype)
            torch.cuda.empty_cache()
        if shape == (2, 1) and rank == 0:
            staged = {"input": torch.zeros((4, 1, RAW, RAW, 3), dtype=torch.uint8, device=dev),
                      "labels": torch.zeros((4, 1), dtype=torch.int32, device=dev)}
            try:
                steps.launch(state, staged, 4)
                out["k4_over_gloo"] = "ran"
            except ValueError as e:
                out["k4_over_gloo"] = str(e)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def spawn_ranks(fn, world, *args):
    """fn(rank, world, init, results, *args) in `world` processes started
    with "spawn" (each imports this script, not its main); their results in
    rank order. A rank that fails fails the call; every process is gone when
    it returns."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        results = mp.get_context("spawn").Queue()
        ctx = mp.start_processes(fn, args=(world, f"file://{tmp}/init", results, *args),
                                 nprocs=world, start_method="spawn", join=False)
        deadline = time.monotonic() + MESH_TIMEOUT_S
        got = {}
        try:
            while len(got) < world:  # drain the queue before joining
                try:
                    rank, out = results.get(timeout=1)
                    got[rank] = out
                except queue.Empty:
                    ctx.join(timeout=0)  # raises once a rank has failed
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world} ranks ran past {MESH_TIMEOUT_S} s")
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world} ranks ran past {MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return [got[r] for r in range(world)]


def tree_errors(p0, want, got, want_m, got_m, rel):
    """check_train_parity's bar over numpy trees: the largest momentum
    error as a share of its largest element (at most rel), and the largest
    parameter error over its tolerance (rel of the largest update plus 2
    ulps of the largest element; at most 1)."""
    import numpy as np

    worst_m = worst_p = 0.0
    for name, p in want.items():
        for k, w in p.items():
            m_scale = np.abs(want_m[name][k]).max()
            if m_scale:
                worst_m = max(worst_m, np.abs(got_m[name][k] - want_m[name][k]).max() / m_scale)
            big = np.float32(np.abs(p0[name][k]).max())
            ulp = float(np.nextafter(big, np.float32(np.inf)) - big)
            tol = rel * np.abs(w - p0[name][k]).max() + 2 * ulp
            worst_p = max(worst_p, np.abs(got[name][k] - w).max() / tol)
    return float(worst_m), float(worst_p)


def check_mesh_ranks(dev, card):
    """Phase 9a: full-width alexnet_2tower over gloo worlds of ranks that
    share this card, on meshes 2x1, 1x2 and (a world of 4, the pbtxt's 4x2
    clamped with the JAX package's warning) 2x2, each against one device's
    MESH_STEPS steps on this card from the same params and batches, in bf16
    and in f32: each rank's launches MESH_PER_STEP a step, its sharded
    leaves 1/n of the full ones, its crops, flips and dropout masks
    array-equal to one device's rows. f32: the gathered momenta within
    UPDATE_TOL of their largest element and the params within UPDATE_TOL of
    their largest update plus 2 ulps. bf16: within MESH_BF16_FLOOR times
    the distance of rows_in_turn_steps(2) from one device's step, and the
    2x1 mesh array-equal to rows_in_turn_steps(2). Returns the phase's
    facts."""
    import numpy as np
    import torch

    from convnet_tpu_torch.model import init_params, param_shapes
    from convnet_tpu_torch.parallel.mesh import param_shardings

    graph = towers_graph("bfloat16")
    p0 = {n: {k: v.numpy() for k, v in p.items()} for n, p in init_params(graph, seed=0).items()}
    single = {}
    for dtype in MESH_DTYPES:
        single[dtype] = towers_steps(dev, None, dtype)[0]
        torch.cuda.empty_cache()
        print(f"[{card}] phase 9a: alexnet_2tower ({dtype}), batch {BATCH}, {MESH_STEPS} steps "
              f"on one device: launches {single[dtype]['launches']}, host clock "
              f"{single[dtype]['seconds']:.3f} s")
        expect_launches("one device's alexnet_2tower steps", single[dtype]["launches"],
                        MESH_PER_STEP[dtype], MESH_STEPS)
    in_turn = rows_in_turn_steps(dev, 2)
    torch.cuda.empty_cache()
    floor = tree_errors(p0, single["bfloat16"]["params"], in_turn["params"],
                        single["bfloat16"]["moms"], in_turn["moms"], UPDATE_TOL)
    bars = {"float32": (UPDATE_TOL, 1.0),
            "bfloat16": (MESH_BF16_FLOOR * floor[0], MESH_BF16_FLOOR * floor[1])}
    print(f"[{card}] phase 9a: one device computing each half of the batch in turn against its "
          f"own batch-{BATCH} bf16 steps: largest momentum difference {floor[0]} of its largest "
          f"element, largest param difference {floor[1]} of UPDATE_TOL's tolerance; bf16 bars "
          f"{bars['bfloat16']}")
    full = param_shapes(graph)
    report = {"bf16_in_turn_vs_one_device": floor, "meshes": {}}
    for world, shape in ((2, (2, 1)), (2, (1, 2)), (4, None)):
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_rank, world, shape)
        wall = time.perf_counter() - t0
        data, model = ranks[0]["bfloat16"]["shape"]
        name = f"{data}x{model}"
        if shape is None:
            want = (f"model requests a 4x2 mesh but only {world} device(s) are available — "
                    f"clamped to {name}")
            if (data, model) != (2, 2) or ranks[0]["warnings"] != [want]:
                raise AssertionError(f"alexnet_2tower's mesh in a world of {world}: {name}, "
                                     f"warnings {ranks[0]['warnings']}")
        specs = param_shardings(graph, model)
        b = BATCH // data
        facts = report["meshes"][name] = {"world_s": wall}
        for dtype in MESH_DTYPES:
            ref = single[dtype]
            for r, rank_out in enumerate(ranks):
                out = rank_out[dtype]
                d, m = out["coords"]
                if (d, m) != divmod(r, model):
                    raise AssertionError(f"rank {r} sits at {(d, m)}")
                expect_launches(f"rank {r} of the {name} mesh ({dtype})", out["launches"],
                                MESH_PER_STEP[dtype], MESH_STEPS)
                for n, leaves in full.items():
                    for k, shp in leaves.items():
                        local = list(shp)
                        if specs[n][k] is not None:
                            local[specs[n][k]] //= model
                        if out["local_shapes"][n][k] != tuple(local):
                            raise AssertionError(f"rank {r}: {n}/{k} is "
                                                 f"{out['local_shapes'][n][k]}, not {tuple(local)}")
                for t in range(MESH_STEPS):
                    for got, want in zip(out["crops"][t], ref["crops"][t]):
                        if not np.array_equal(got, want[d * b:(d + 1) * b]):
                            raise AssertionError(f"rank {r}, step {t}: other crops or flips")
                if len(out["masks"]) != len(ref["masks"]) or not all(
                        np.array_equal(got, want[d * b:(d + 1) * b])
                        for got, want in zip(out["masks"], ref["masks"])):
                    raise AssertionError(f"rank {r}: other dropout masks than one device's rows")
            lead = ranks[0][dtype]
            m_err, p_err = tree_errors(p0, ref["params"], lead["params"], ref["moms"],
                                       lead["moms"], UPDATE_TOL)
            seconds = [o[dtype]["seconds"] for o in ranks]
            print(f"[{card}] phase 9a: {name} mesh ({dtype}), {world} ranks over gloo on this "
                  f"card: per rank launches {lead['launches']}; crops, flips and "
                  f"{len(ref['masks'])} dropout masks array-equal to one device's rows; largest "
                  f"momentum difference {m_err} of its largest element (bar {bars[dtype][0]}), "
                  f"largest param difference {p_err} of UPDATE_TOL's tolerance (bar "
                  f"{bars[dtype][1]}); ranks' seconds for {MESH_STEPS} steps "
                  f"{[round(x, 3) for x in seconds]} (host clock: a correctness run's, ranks "
                  f"sharing one card), world {wall:.1f} s")
            if m_err > bars[dtype][0] or p_err > bars[dtype][1]:
                raise AssertionError(f"the {name} mesh's {dtype} steps differ from one device's")
            facts[dtype] = {"launches_per_rank": [o[dtype]["launches"] for o in ranks],
                            "momentum_err": m_err, "param_err_over_tol": p_err,
                            "rank_seconds": seconds}
            if (name, dtype) == ("2x1", "bfloat16"):
                equal = all(np.array_equal(lead[t][n][k], in_turn[t][n][k])
                            for t in ("params", "moms") for n in full for k in full[n])
                print(f"[{card}] phase 9a: 2x1 mesh (bfloat16) against one device computing each "
                      f"rank's rows in turn: params and momenta array-equal {equal}")
                if not equal:
                    raise AssertionError("the 2x1 mesh differs from one device computing its "
                                         "ranks' rows in turn")
                facts[dtype]["array_equal_to_rows_in_turn"] = equal
        if shape == (2, 1):
            said = ranks[0]["k4_over_gloo"]
            print(f"[{card}] phase 9a: 4 steps a launch over gloo on a card: {said}")
            if "gloo" not in said:
                raise AssertionError("several steps a launch over gloo did not raise")
        del ranks
    return report


def check_nccl_mesh(dev, graph, state0, jitter, batches, card):
    """Phase 9b: a world of one over NCCL (this process, this card) and
    make_mesh(1, 1): its gradient all-reduce really runs, and is captured
    with the step at k = LAUNCH_K. The replayed steps against eager ones as
    phase 8c requires; the step's times at 1 and LAUNCH_K a launch beside
    phase 8c's unsharded ones; and Trainer(mesh=...) trains LAUNCH_STEPS
    steps at LAUNCH_K a launch over DUMMY data."""
    import tempfile

    import torch
    import torch.distributed as dist

    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.parallel.mesh import make_mesh
    from convnet_tpu_torch.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0, world_size=1,
                                device_id=dev)
        try:
            mesh = make_mesh(1, 1)
            facts = check_steps_per_launch(dev, graph, state0, jitter, batches, card, mesh=mesh,
                                           phase="phase 9b (1x1 mesh over nccl)")
            facts["step_ms"] = launch_times(graph, state0, jitter, batches, card, mesh=mesh,
                                            paths=("train",))
            data = DataHandler(dummy_imagenet(BATCH, DUMMY_ROWS, True))
            tr = Trainer(graph, data, device=dev, jitter=jitter, mesh=mesh,
                         steps_per_launch=LAUNCH_K, log_fn=lambda _: None)
            reset_launches()
            tr.train(max_iter=LAUNCH_STEPS)
            torch.cuda.synchronize()
            data.close()
            if tr.state["step"] != LAUNCH_STEPS or not all(
                    torch.isfinite(v).all() for p in tr.state["params"].values()
                    for v in p.values()):
                raise AssertionError("the Trainer on a 1x1 nccl mesh did not train")
            expect_launches("the 1x1 nccl mesh's captured step", tr.steps.captured.launches,
                            TRAIN_PER_STEP, 1)
            print(f"[{card}] phase 9b: Trainer(mesh=make_mesh(1, 1)) over nccl took "
                  f"{LAUNCH_STEPS} steps at {LAUNCH_K} a launch (CUDA-graph replays holding the "
                  "all-reduce); parameters finite")
            del tr
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return facts


def cli_rank(rank, world, init, results, argv, port):
    """One rank of phase 9c: torchrun's environment by hand (a localhost
    port), then the train CLI with --backend gloo on the card."""
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    from convnet_tpu_torch.cli import train

    results.put((rank, train.main(argv)))


def check_cli_ranks(card):
    """Phase 9c: the train CLI in a world of 2 ranks over gloo on this card
    (alexnet_2tower's 4x2 clamped to 1x2), a few steps over DUMMY data from
    a temp copy of the model that logs every 2 steps and checkpoints every
    4: rank 0's log alone, with finite losses, and rank 0's two checkpoints
    (step 4's, and the CLI's save at its end)."""
    import math
    import socket
    import tempfile

    from convnet_tpu_torch.config import model_to_text, read_model

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model = read_model(str(TOWERS))
        model.display_after = 2
        model.checkpoint_after = 4
        (tmp / "towers.pbtxt").write_text(model_to_text(model))
        (tmp / "data.pbtxt").write_text(dummy_imagenet_text(BATCH, DUMMY_ROWS, True))
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        argv = [str(tmp / "towers.pbtxt"), str(tmp / "data.pbtxt"), "--output-dir", str(tmp / "out"),
                "--max-iter", "4", "--backend", "gloo", "--device", "cuda"]
        rcs = spawn_ranks(cli_rank, 2, argv, port)
        log = (tmp / "out" / "alexnet_2tower_train_log.txt").read_text().splitlines()
        ckpts = sorted(p.name for p in (tmp / "out").glob("*.h5"))
    losses = [float(l.split()[3]) for l in log if l.startswith("step ")]
    print(f"[{card}] phase 9c: the train CLI on 2 ranks over gloo on this card: exit codes {rcs}; "
          f"rank 0's log {log}; checkpoints {ckpts}")
    if rcs != [0, 0] or len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError("the train CLI on 2 ranks did not train")
    if len(ckpts) != 2:
        raise AssertionError(f"the train CLI on 2 ranks wrote checkpoints {ckpts}")
    return {"exit_codes": rcs, "logged_losses": losses, "checkpoints": ckpts}


# -- phase 10: the port's measurement scripts ----------------------------------

# the bench's runs (timed launches) and the pipeline bench's timed calls
BENCH_STEPS, PIPELINE_STEPS = 20, 5
# the bench's mfu must lie in (0, MFU_MAX]: above 1 the FLOP count or the
# peak is wrong (a little over 1 is left to the count's rounding)
MFU_MAX = 1.05
# a CIFAR-10 f32 train step's launches: rnorm1 and rnorm2, fc1's dropout
# forward and backward, one step_draws (its dropout key); an f32 model's
# input takes no prologue kernel
CIFAR_PER_STEP = {"lrn_fwd": 2, "lrn_bwd": 2, "dropout": 2, "step_draws": 1}
# phase 10b holds the LRN kernels' outputs against the plain version this
# many rows at a time (rnorm1 at batch 4096 has 12.4M rows of 96)
CHECK_ROWS = 1 << 20
BENCH_CHECK_SEED = 12


def run_bench(root: Path, card, *args) -> dict:
    """`python -m convnet_tpu_torch.bench --steps BENCH_STEPS *args` in a
    subprocess: its last line must parse, with value > 0, 0 < mfu <=
    MFU_MAX, a finite final loss and an H100's name. Returns the line."""
    import math

    cmd = [sys.executable, "-m", "convnet_tpu_torch.bench", "--steps", str(BENCH_STEPS), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=600)
    said = " ".join(cmd[2:])
    if proc.returncode != 0:
        raise AssertionError(f"{said} exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line))
    print(f"[{card}] phase 10a: {said}: {time.perf_counter() - t0:.1f} s in all")
    mfu = line["mfu"]
    if not (line["value"] > 0 and mfu is not None and 0 < mfu <= MFU_MAX
            and math.isfinite(line["final_loss"]) and "H100" in line["device"]):
        raise AssertionError(f"the bench's line fails its checks: {line}")
    return line


def check_kernels_at(dev, batch, card) -> dict:
    """Phase 10b: each kernel of the bench's train step once at the bench's
    batch against its plain version, by phase 2's bars: step_draws (the
    step's dropout keys, crops and flips) and the prologue array-equal;
    lrn_fwd (bf16, the deferred bias and the fused ReLU, AlexNet's n,
    alpha, beta) within 1 bf16 ulp at rnorm1 and rnorm2; lrn_bwd's dx by
    expect_bf16_close's bar with LRN_BWD_ULPS, its db within rtol 1e-4 of
    a float64 sum of the plain f32 dx; dropout array-equal at fc6/fc7. The
    kernels run over the whole batch; the plain versions, and float64,
    CHECK_ROWS rows at a time over all of them. Returns {kernel: max
    |err|}."""
    import torch

    from convnet_tpu_torch.data.jitter import crop_draw
    from convnet_tpu_torch.ops import dropout as drop
    from convnet_tpu_torch.ops import lrn
    from convnet_tpu_torch.ops import s2d_relayout as s2d

    gen = torch.Generator(device=dev)
    gen.manual_seed(BENCH_CHECK_SEED)
    rng = torch.tensor([0, 1], dtype=torch.int64, device=dev)
    words = [(i, 0) for i in ALEXNET_DROPOUT_LAYERS]
    draw = crop_draw("input", batch, RAW, RAW, CROP, True, True)
    keys, crops = drop.step_draws(rng, words, draw)
    want_keys, want_crops = drop.step_draws_reference(rng, words, draw)
    if not (torch.equal(keys, want_keys)
            and all(torch.equal(a, b) for a, b in zip(crops, want_crops))):
        raise AssertionError(f"step_draws at batch {batch} differs from its plain version")
    errs = {"step_draws": 0.0}

    x = torch.randint(0, 256, (batch, RAW, RAW, 3), generator=gen, device=dev, dtype=torch.uint8)
    kw = dict(crop=CROP, stride=4, p=s2d.relayout_geometry(CROP, 11, 4), scale=1 / 255,
              mean=torch.full((3,), MEAN, device=dev))
    got = s2d.s2d_prologue(x, *crops, **kw)
    if not torch.equal(got, s2d.s2d_prologue_reference(x, *crops, **kw)):
        raise AssertionError(f"s2d_prologue at batch {batch} is not array-equal to its plain "
                             "version")
    errs["s2d_prologue"] = 0.0
    print(f"[{card}] phase 10b: step_draws and s2d_prologue {tuple(got.shape)} (crops and "
          f"flips of {batch} images) array-equal to their plain versions")
    del x, got

    n, alpha, beta = 5, 1e-4 / 5, 0.75
    errs["lrn_fwd"] = errs["lrn_bwd"] = 0.0
    for shape_name, side, c in (("rnorm1", 55, 96), ("rnorm2", 27, 256)):
        m = batch * side * side
        z = (2.0 * torch.randn((m, c), generator=gen, device=dev)).to(torch.bfloat16)
        g = torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn((c,), generator=gen, device=dev)
        y = lrn.lrn_fwd(z, n, alpha, beta, bias=bias, relu=True)
        dx, db = lrn.lrn_bwd(g, z, n, alpha, beta, bias=bias, relu=True)
        y_ulps = k64 = p64 = kp = 0
        db64 = torch.zeros(c, dtype=torch.float64, device=dev)
        db_abs = torch.zeros(c, dtype=torch.float64, device=dev)
        for r0 in range(0, m, CHECK_ROWS):
            zs, gs = z[r0:r0 + CHECK_ROWS], g[r0:r0 + CHECK_ROWS]
            want_y = lrn._fwd_math(zs, n, alpha, beta, bias, True, False)
            y_ulps = max(y_ulps, bf16_ulps(y[r0:r0 + CHECK_ROWS], want_y))
            errs["lrn_fwd"] = max(errs["lrn_fwd"], (y[r0:r0 + CHECK_ROWS].float()
                                                    - want_y.float()).abs().max().item())
            want_dx = lrn._bwd_math(gs, zs, n, alpha, beta, bias, True, False)[0]
            errs["lrn_bwd"] = max(errs["lrn_bwd"], (dx[r0:r0 + CHECK_ROWS].float()
                                                    - want_dx.float()).abs().max().item())
            d = bf16_distances(dx[r0:r0 + CHECK_ROWS], want_dx,
                               lrn_bwd_f64(gs, zs, n, alpha, beta, bias, True))
            k64, p64, kp = max(k64, d[0]), max(p64, d[1]), max(kp, d[2])
            ref = lrn._bwd_math(gs.float(), zs.float(), n, alpha, beta, bias, True,
                                False)[0].double()
            db64 += ref.sum(0)
            db_abs += ref.abs().sum(0)
        tag = f"phase 10b: {shape_name} ({m},{c}) bf16 at batch {batch}"
        db_rel = ((db.double() - db64).abs() / db64.abs()).max().item()
        print(f"[{card}] {tag}: lrn_fwd bf16_ulps {y_ulps}; lrn_bwd bf16_ulps kernel-plain {kp}, "
              f"kernel-float64 {k64}, plain-float64 {p64}; db max_rel_err {db_rel}")
        if y_ulps > 1:
            raise AssertionError(f"{tag}: lrn_fwd {y_ulps} bf16 ulps from the plain version")
        if kp > LRN_BWD_ULPS or k64 > p64 + LRN_BWD_ULPS:
            raise AssertionError(f"{tag}: lrn_bwd beyond its bar (kernel-plain <= "
                                 f"{LRN_BWD_ULPS}, kernel-float64 <= plain-float64 + "
                                 f"{LRN_BWD_ULPS})")
        torch.testing.assert_close(db.double(), db64, rtol=1e-4,
                                   atol=1e-5 * db_abs.max().item())
        del z, g, y, dx

    x = (torch.rand((batch, 1, 1, 4096), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    for key in keys:
        if not torch.equal(drop.dropout_apply(x, 0.5, key), drop.dropout_reference(x, 0.5, key)):
            raise AssertionError(f"dropout at ({batch}, 1, 1, 4096) is not array-equal to its "
                                 "plain version")
    errs["dropout"] = 0.0
    print(f"[{card}] phase 10b: dropout ({batch}, 1, 1, 4096) bf16 with fc6's and fc7's keys "
          "array-equal to its plain version")
    return errs


def plain_cifar_logits(graph, params, x, dropout_seed=None):
    """The CIFAR-10 net's f32 logits composed directly from the plain
    versions of the kernels (and the same cuDNN, cuBLAS and ATen ops), not
    through apply_fn; differentiable by autograd. dropout_seed = (seed,
    step) applies fc1's dropout with the mask apply_fn draws."""
    import torch

    from convnet_tpu_torch.ops.conv import conv2d, fc
    from convnet_tpu_torch.ops.dropout import dropout_key, dropout_reference
    from convnet_tpu_torch.ops.lrn import response_norm_reference
    from convnet_tpu_torch.ops.pool import maxpool_reference

    def inc(layer):
        (e,) = graph.incoming(layer)
        return e

    def conv(layer, x):
        e = inc(layer)
        return conv2d(x, params[e.name]["w"], e.stride, e.padding)

    def pool(layer, x):
        e = inc(layer)
        return maxpool_reference(x, e.kernel_size, e.stride, e.padding)

    def norm(layer, x, bias=None):
        e = inc(layer)
        return response_norm_reference(x, e.add_scale, e.pow_scale,
                                       e.frac_of_filters_response_norm, e.response_norm_blocked,
                                       bias=bias, relu=bias is not None)

    def bias(layer):
        return params[inc(layer).name]["b"]

    x = torch.relu(conv("conv1", x) + bias("conv1"))
    x = norm("rnorm1", pool("pool1", x))
    # conv2's bias and ReLU go into rnorm2, as apply_fn defers them
    x = pool("pool2", norm("rnorm2", conv("conv2", x), bias("conv2")))
    x = pool("pool3", torch.relu(conv("conv3", x) + bias("conv3")))
    x = torch.relu(fc(x, params[inc("fc1").name]["w"]) + bias("fc1"))[:, None, None, :]
    if dropout_seed is not None:
        layers = [n for n in graph.topo_layer_order() if not graph.layer(n).is_input]
        key = dropout_key(*dropout_seed, layers.index("fc1"))
        x = dropout_reference(x, graph.layer("fc1").dropprob, key)
    return fc(x, params[inc("output").name]["w"]) + bias("output")


def check_pipeline(dev, card):
    """Phase 10c: the pipeline bench's three metrics with PIPELINE_STEPS
    timed calls, each path's launches counted (AlexNet's inference at 1024
    and 256: lrn_fwd 2 and s2d_prologue 1 a call; the prologue's bench:
    s2d_prologue 1 and step_draws 1 a call; the CIFAR-10 step:
    CIFAR_PER_STEP), then three CIFAR-10 f32 train steps against the step
    composed from the plain versions (check_train_parity's bar). Returns
    ({metric: line}, {path: launches})."""
    import torch

    from convnet_tpu_torch import models
    from convnet_tpu_torch.tools import bench_pipeline as bp
    from convnet_tpu_torch.trainer import init_state

    calls = PIPELINE_STEPS + 1  # one warm-up call
    runs = (
        ("alexnet_inference", lambda: [bp.bench_alexnet_inference(dev, b, PIPELINE_STEPS)
                                       for b in (1024, 256)],
         {"lrn_fwd": 2, "s2d_prologue": 1}, 2 * calls),
        ("aug_pipeline", lambda: [bp.bench_aug(dev, steps=PIPELINE_STEPS)],
         {"s2d_prologue": 1, "step_draws": 1}, calls),
        ("cifar_step", lambda: [bp.bench_cifar_step(dev, steps=PIPELINE_STEPS)], CIFAR_PER_STEP,
         PIPELINE_STEPS + bp.WARMUP),
    )
    lines, paths = {}, {}
    for path, run, per_call, n in runs:
        reset_launches()
        got = run()
        torch.cuda.synchronize()
        paths[path] = read_launches()
        expect_launches(f"phase 10c's {path}", paths[path], per_call, n)
        for line in got:
            print(json.dumps(line))
            if not line["value"] > 0:
                raise AssertionError(f"phase 10c: {line}")
            lines[f"{line['metric']}@{line['batch']}"] = line
    graph = models.cifar10()
    state = init_state(graph, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(BENCH_CHECK_SEED)
    batches = [{"input": torch.rand((256, 32, 32, 3), generator=gen, device=dev),
                "labels": torch.randint(0, 10, (256,), generator=gen, device=dev,
                                        dtype=torch.int32)} for _ in range(PARITY_STEPS)]

    def plain_step(st, b):
        seed, step = st["seed"], st["step"]
        return plain_sgd_step(graph, st, b["labels"], lambda params: plain_cifar_logits(
            graph, params, b["input"], dropout_seed=(seed, step)))

    print(f"[{card}] phase 10c: CIFAR-10 (f32, batch 256), the port's step against the plain "
          "one:")
    check_train_parity(graph, state, None, batches, None, None, card, plain_step=plain_step)
    return lines, paths


def check_profile_and_sweep(dev, card) -> dict:
    """Phase 10d: profile_alexnet at batch BATCH with 3 calls a row (its
    trace must put time in the lrn category and give an idle share in [0,
    1); each response-norm edge has a [plain] row), and the sweep's bf16
    variants at batch BATCH, 1 and LAUNCH_K steps a launch (img/s > 0, 0 <
    mfu <= MFU_MAX). Returns the trace's line and the sweep's lines."""
    from convnet_tpu_torch.tools import profile_alexnet, sweep
    from convnet_tpu_torch.utils.card import device_facts

    got = profile_alexnet.profile(dev, batch=BATCH, steps=3)
    trace = got["trace"]
    cats = trace["device_ms_per_step"]
    plain_rows = [r for r in got["rows"] if "[plain]" in r["name"]]
    if not cats or cats["lrn"] <= 0 or not 0 <= trace["idle_share"] < 1 or len(plain_rows) != 4:
        raise AssertionError(f"phase 10d: the profile's trace {trace}, plain rows {plain_rows}")
    facts = device_facts(dev)
    lines = []
    for k in (1, LAUNCH_K):
        line = {**sweep.time_variant(BATCH, "bfloat16", k, PIPELINE_STEPS, dev), **facts}
        print(json.dumps(line))
        if not (line["images_per_sec"] > 0 and 0 < line["mfu"] <= MFU_MAX):
            raise AssertionError(f"phase 10d: the sweep's line {line}")
        lines.append(line)
    return {"profile_trace": trace, "sweep": lines}


def check_bench_launches(dev, batch, k, card) -> dict:
    """Phase 10e: the bench's train step at its batch: two eager steps must
    launch TRAIN_PER_STEP a step through the wrappers, and at k > 1 the
    captured step (the graph the bench replays) TRAIN_PER_STEP. Returns
    {path: launches}."""
    import torch

    from convnet_tpu_torch.bench import alexnet_graph, random_batch, train_jitter
    from convnet_tpu_torch.trainer import TrainSteps, init_state

    graph = alexnet_graph(CROP)
    steps = TrainSteps(graph, train_jitter(CROP))
    state = init_state(graph, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(BENCH_CHECK_SEED)
    reset_launches()
    batch_data = random_batch((batch,), RAW, dev, gen)
    for _ in range(2):
        steps.step(state, batch_data)
    torch.cuda.synchronize()
    paths = {"bench_step_eager": read_launches()}
    expect_launches(f"the bench's eager step at batch {batch}", paths["bench_step_eager"],
                    TRAIN_PER_STEP, 2)
    if k > 1:
        del batch_data
        steps.launch(state, random_batch((k, batch), RAW, dev, gen), k)
        torch.cuda.synchronize()
        paths["bench_step_captured"] = steps.captured.launches
        expect_launches(f"the bench's captured step at batch {batch}",
                        paths["bench_step_captured"], TRAIN_PER_STEP, 1)
    print(f"[{card}] phase 10e: the bench's step at batch {batch}: {paths}")
    return paths


def check_measurement_scripts(root: Path, dev, card):
    """Phase 10 (a-e). Returns (facts, {path: launches}, {kernel: max |err|
    at the bench's batch} or {} where the batch is BATCH)."""
    import torch

    from convnet_tpu_torch.bench import DEFAULT_BATCH, DEFAULT_STEPS_PER_LAUNCH

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the bench's subprocess shares the card
    bench = [run_bench(root, card),
             run_bench(root, card, "--data", "rawcache", "--steps-per-launch", "1")]
    errs = {}
    if DEFAULT_BATCH > BATCH:
        errs = check_kernels_at(dev, DEFAULT_BATCH, card)
    else:
        print(f"[{card}] phase 10b: the bench's batch is {DEFAULT_BATCH}, phase 2's")
    torch.cuda.empty_cache()
    pipeline, paths = check_pipeline(dev, card)
    measured = check_profile_and_sweep(dev, card)
    paths.update(check_bench_launches(dev, DEFAULT_BATCH, DEFAULT_STEPS_PER_LAUNCH, card))
    seconds = time.perf_counter() - t0
    print(f"[{card}] phase 10: {seconds:.1f} s")
    return {"bench": bench, "pipeline": pipeline, **measured, "seconds": seconds}, paths, errs


# -- phase 11: the chip probes --------------------------------------------------

# timed calls a line of either probe, and the rows the serving probe's
# extract runs over
PROBE_CALLS, PROBE_ROWS = 5, 512
ENQUEUE_REST_S = 0.05  # phase 11c: the host's sleep before an enqueue (a held run's spin)
# phase 11a's ragged shape: a short last row tile and, at 128 columns, a
# short last column tile (1000 = 7 * 128 + 104)
RAGGED_COPY = (1001, 1000)


def run_probe(root: Path, card, module: str, *args, phase: int = 11) -> list:
    """`python -m convnet_tpu_torch.tools.<module> *args` in a subprocess:
    it must exit 0, and every line it prints must parse as JSON and name
    an H100 with a power limit. Returns the lines."""
    cmd = [sys.executable, "-m", f"convnet_tpu_torch.tools.{module}", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=600)
    said = " ".join(cmd[2:])
    if proc.returncode != 0:
        raise AssertionError(f"{said} exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(l) for l in proc.stdout.strip().splitlines()]
    for line in lines:
        print(json.dumps(line))
        if "H100" not in line["device"] or not line["power_limit_w"]:
            raise AssertionError(f"{said}: a line without the card's name and power limit: {line}")
    print(f"[{card}] phase {phase}: {said}: {len(lines)} lines, {time.perf_counter() - t0:.1f} s")
    return lines


def check_copy_add(dev, card):
    """Phase 11a: the copy kernel at the JAX sweep's (290400, 1024) bf16
    pair, at each of the six tilings, array-equal to a + b over every row;
    at RAGGED_COPY with whole rows and with 128-column tiles (16 and 7 rows
    a tile), array-equal; an input off a 16-byte boundary, or not
    contiguous, refused with a ValueError before any launch. Returns the
    full-size inputs, for the timing, and the largest |kernel - (a + b)|
    over all those calls."""
    import torch

    from convnet_tpu_torch.ops import copy_add as ca
    from convnet_tpu_torch.tools import copy_probe as cp

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def pair(m, n):
        return [torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2)]

    def max_err(got, want):
        return (got.float() - want.float()).abs().max().item()

    a, b = pair(cp.ROWS, cp.COLS)
    want = a + b
    err = 0.0
    for block, (tile_rows, tile_cols) in cp.TILINGS:
        got = ca.copy_add(a, b, tile_rows, tile_cols)
        err = max(err, max_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"copy_add with {tile_rows} x {tile_cols} tiles (the JAX block "
                                 f"{block}) is not array-equal to a + b")
        del got
    del want
    ra, rb = pair(*RAGGED_COPY)
    for tile_rows, tile_cols in ((16, None), (16, 128), (7, 128)):
        got = ca.copy_add(ra, rb, tile_rows, tile_cols)
        err = max(err, max_err(got, ra + rb))
        if not torch.equal(got, ra + rb):
            raise AssertionError(f"copy_add at {RAGGED_COPY} with {tile_rows} x {tile_cols} "
                                 "tiles is not array-equal to a + b")
    before = ca.LAUNCHES
    off = torch.empty(RAGGED_COPY[0] * RAGGED_COPY[1] + 8, dtype=torch.bfloat16,
                      device=dev)[1:1 + RAGGED_COPY[0] * RAGGED_COPY[1]].view(RAGGED_COPY)
    for bad, why in ((off, "16-byte boundary"), (ra.t().contiguous().t(), "contiguous")):
        try:
            ca.copy_add(bad, rb)
        except ValueError as e:
            if why not in str(e):
                raise
        else:
            raise AssertionError(f"copy_add took an input that is not {why}")
    if ca.LAUNCHES != before:
        raise AssertionError("copy_add launched on an input it refused")
    print(f"[{card}] phase 11a: copy_add array-equal to a + b at ({cp.ROWS}, {cp.COLS}) bf16 in "
          f"the six tilings {[t for _, t in cp.TILINGS]} and at {RAGGED_COPY} (max |diff| "
          f"{err}); inputs off a 16-byte boundary or not contiguous refused")
    return a, b, err


def time_copy_add(dev, a, b, best, card) -> dict:
    """Phase 11b: the copy kernel at the probe's best tiling, its plain
    version and torch.add by device_ms (two input sets in turn), the
    wrapper's host cost, and the bound: 6 bytes a value over the card's
    memory rate."""
    import torch

    from convnet_tpu_torch.ops import copy_add as ca

    a2, b2 = a.roll(1, 0), b.roll(1, 0)
    sets = ((a, b), (a2, b2))
    tile_rows, tile_cols = best
    ms = device_ms(*[lambda x=x, y=y: ca.copy_add(x, y, tile_rows, tile_cols) for x, y in sets])
    plain_ms = device_ms(*[lambda x=x, y=y: ca.copy_add_reference(x, y) for x, y in sets])
    library_ms = device_ms(*[lambda x=x, y=y: torch.add(x, y) for x, y in sets])
    host = host_us(lambda: ca.copy_add(a, b, tile_rows, tile_cols))
    bound_ms, bound_by = bound(3 * a.numel() * a.element_size(), a.numel())
    print(f"[{card}] phase 11b: copy_add at {tile_rows} x {tile_cols} tiles: {ms:.4f} ms "
          f"(bound {bound_ms:.4f} ms, {bound_ms / ms:.3f} of it; "
          f"{3 * a.numel() * a.element_size() / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f}, "
          f"torch.add {library_ms:.4f}; host {host:.1f} us a call")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "host_us": host,
            "bound_ms": bound_ms, "bound_by": bound_by, "tile": [tile_rows, tile_cols]}


def check_probe_predictors(dev, card) -> dict:
    """Phase 11c: the serving probe's Predictor (full-width AlexNet, seed-0
    params, uint8 requests cropped from 256) at batch 1 and 64: a request
    launches lrn_fwd 2 and s2d_prologue 1, and its outputs meet phase 3's
    bars against the plain-composed forward; at batch 1 the forward's
    enqueue is taken four ways (enqueue_four_ways). Returns {path:
    launches}, the largest |logit - plain| by batch and those enqueues."""
    import numpy as np
    import torch

    from convnet_tpu_torch.data.jitter import JitterSpec
    from convnet_tpu_torch.model import init_params
    from convnet_tpu_torch.tools import serving_probe as sp

    graph = sp.read_graph(str(ALEXNET))
    params = init_params(graph, seed=0, device=dev)
    spec = JitterSpec(image_size=CROP, scale=1 / 255)
    mean_t = torch.full((3,), MEAN, device=dev)
    rng = np.random.default_rng(11)
    paths, errs = {}, {}
    for batch in (1, 64):
        pred = sp.make_predictor(graph, params, batch, dev)
        req = rng.integers(0, 256, (batch, RAW, RAW, 3), dtype=np.uint8)
        reset_launches()
        out = pred({"input": req})
        paths[f"serving_probe_batch{batch}"] = read_launches()
        expect_launches(f"a request of {batch} to the serving probe's Predictor",
                        paths[f"serving_probe_batch{batch}"], {"lrn_fwd": 2, "s2d_prologue": 1},
                        1)
        errs[batch] = expect_served(f"phase 11c: the serving probe's Predictor at batch {batch}",
                                    graph, params, req, out, spec, mean_t, card)
        if batch == 1:
            enqueue = enqueue_four_ways(pred, torch.from_numpy(req).to(dev), card)
    return {"paths": paths, "max_abs_logit_err": errs, "batch1_enqueue_ms": enqueue}


def enqueue_four_ways(pred, x, card) -> dict:
    """Phase 11c: the host milliseconds to enqueue the Predictor's forward
    on a batch already on the card (until the forward returns), medians of
    ITERS calls, four ways, each taken twice in turns: "in_call", inside
    calls that then read the outputs back (the serving probe's enqueue_ms);
    "after_synchronize", each call after torch.cuda.synchronize() with its
    outputs dropped unread; "after_sleep", each call after a synchronize
    and an ENQUEUE_REST_S sleep of the host thread, outputs read back; and
    "held", with the card held behind a spin (card.enqueue_ms, one call a
    spin). Which of them reads above the whole call says what slows the
    host's launches."""
    import torch

    from convnet_tpu_torch.utils import card as card_mod

    def forward():
        return pred._forward(pred.params, {"input": x})

    def read(out):
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def timed(before, keep):
        read(forward())
        runs = []
        for _ in range(ITERS):
            before()
            t0 = time.perf_counter()
            out = forward()
            runs.append((time.perf_counter() - t0) * 1e3)
            if keep:
                read(out)
            del out
        torch.cuda.synchronize()
        return runs

    def rest():
        torch.cuda.synchronize()
        time.sleep(ENQUEUE_REST_S)

    ways = {"in_call": lambda: timed(lambda: None, True),
            "after_synchronize": lambda: timed(torch.cuda.synchronize, False),
            "after_sleep": lambda: timed(rest, True),
            "held": lambda: [card_mod.enqueue_ms(forward, calls=1, reps=ITERS)]}
    got = {k: [] for k in ways}
    with torch.inference_mode():
        for _ in range(2):
            for k, way in ways.items():
                got[k].append(statistics.median(way()))
    print(f"[{card}] phase 11c: enqueueing the batch-1 forward, host ms (median of {ITERS}, "
          f"two turns): " + ", ".join(f"{k} {v}" for k, v in got.items()))
    return got


def check_probe_extract(dev, out_dir: Path, card) -> float:
    """Phase 11d: the serving probe's extract (the features it left in
    out_dir) against a Predictor's fc7 of the same rows from the same
    checkpoint, under the data pbtxt's eval prologue: within phase 8e's bar
    (1e-2 of the largest |fc7|). Returns the largest |difference|."""
    import numpy as np

    from convnet_tpu_torch import hdf5
    from convnet_tpu_torch.config import read_dataset_config
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.data.native import raw_cache_gather_reference
    from convnet_tpu_torch.predictor import Predictor
    from convnet_tpu_torch.tools import serving_probe as sp

    graph = sp.read_graph(str(ALEXNET))
    data = DataHandler(read_dataset_config(str(out_dir / "data.pbtxt")), randomize=False)
    jitter = data.jitter_specs()
    data.close()
    (ckpt,) = out_dir.glob(f"{graph.name}_*.h5")
    pred = Predictor.from_checkpoint(graph, str(ckpt), layers=[sp.EXTRACT_LAYER],
                                     batch_size=sp.EXTRACT_BATCH, jitter=jitter,
                                     input_dtype=np.uint8, device=dev)
    rows = raw_cache_gather_reference(str(out_dir / "img.cache"), np.arange(PROBE_ROWS))
    want = np.concatenate([pred({"input": rows[i:i + sp.EXTRACT_BATCH]})[sp.EXTRACT_LAYER]
                           .reshape(-1, 4096) for i in range(0, PROBE_ROWS, sp.EXTRACT_BATCH)])
    with hdf5.File(str(out_dir / "feats.h5")) as f:
        got = f[sp.EXTRACT_LAYER][...]
    if got.shape != (PROBE_ROWS, 4096) or not np.isfinite(got).all():
        raise AssertionError(f"phase 11d: the extract wrote {sp.EXTRACT_LAYER} {got.shape}")
    tol = 1e-2 * np.abs(want).max()
    err = float(np.abs(got - want).max())
    print(f"[{card}] phase 11d: the serving probe's extract, {PROBE_ROWS} rows of "
          f"{sp.EXTRACT_LAYER}, against a Predictor's of the same rows: max |diff| {err} "
          f"(bar {tol})")
    if err > tol:
        raise AssertionError("phase 11d: the extract's fc7 differs from the Predictor's")
    return err


def check_probes(root: Path, dev, card):
    """Phase 11 (a-d). Returns (facts, {path: launches}, copy_add's kernel
    numbers)."""
    import tempfile

    import torch

    from convnet_tpu_torch.tools import copy_probe as cp

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the probes' subprocesses share the card
    copy_lines = run_probe(root, card, "copy_probe", "--calls", str(PROBE_CALLS))
    # the probe's own counts, each tiling's every kernel: copy_add at least
    # once a timed call, every other kernel never
    counts = [l["launches"] for l in copy_lines]
    if len(counts) != len(cp.JAX_BLOCKS) or any(
            set(c) != set(read_launches()) or c["copy_add"] < PROBE_CALLS
            or any(v for k, v in c.items() if k != "copy_add") for c in counts):
        raise AssertionError(f"the copy probe's tilings launched {counts}")
    paths = {"copy_probe": {k: sum(c[k] for c in counts) for k in counts[0]}}
    best = max(copy_lines, key=lambda l: l["gb_per_s"])
    with tempfile.TemporaryDirectory() as tmp:
        serving_lines = run_probe(root, card, "serving_probe", "--calls", str(PROBE_CALLS),
                                  "--rows", str(PROBE_ROWS), "--out-dir", tmp)
        split = [l for l in serving_lines if l.get("mode") == "device"]
        if not (all(l["value"] > 0 for l in serving_lines) and len(split) == 2
                and all(l["enqueue_ms"] > 0 and l["forward_device_ms"] > 0 for l in split)):
            raise AssertionError("phase 11: a serving probe line is not above 0, or a device "
                                 "line lacks its enqueue and device times")
        extract_err = check_probe_extract(dev, Path(tmp), card)
    a, b, copy_err = check_copy_add(dev, card)
    timed = time_copy_add(dev, a, b, (best["tile_rows"], best["tile_cols"]), card)
    del a, b
    predictors = check_probe_predictors(dev, card)
    paths.update(predictors.pop("paths"))
    seconds = time.perf_counter() - t0
    print(f"[{card}] phase 11: {seconds:.1f} s")
    facts = {"copy_probe": copy_lines, "serving_probe": serving_lines,
             "extract_vs_predictor_max_abs": extract_err, **predictors, "seconds": seconds}
    return facts, paths, {"max_abs_err": copy_err, **timed}


# -- phase 12: the gather probes --------------------------------------------------

# phase 12a: (label, geometry, offset mode, inputs off a 16-byte boundary);
# the geometries are tools/gather_probe.py's PROBE and RAGGED
GATHER_RUNS = (("at the probes' shapes", "PROBE", "random", False),
               ("at a ragged shape, offsets from the low end", "RAGGED", "low", False),
               ("at a ragged shape, offsets from the high end", "RAGGED", "high", False),
               ("from inputs off a 16-byte boundary", "PROBE", "random", True))
#: each kernel's line in the kernels line: the sub-probe, at the probe
#: script's batch (None: the probe's own shape)
GATHER_MAIN = {"crop_window": ("P1-fix", "batch"), "relayout": ("P30", None),
               "crop_deinterleave": ("P31", "batch")}


def check_gather_kernels(dev, card) -> dict:
    """Phase 12a: every sub-probe of tools/gather_probe.py through its
    kernel, bit for bit equal to its plain version on the card, in each of
    GATHER_RUNS; its EDGES (every branch of crop_window.cu, relayout.cu
    and crop_deinterleave.cu) from aligned and unaligned inputs;
    crop_window and crop_deinterleave at the bench's batch;
    then windows that leave their input, written as the plain
    versions write them (crop_window: zeros; crop_deinterleave: NaN) in
    u8 and bf16, and a relayout map that reads outside its input
    refused before any launch. Returns the largest |kernel - plain| by
    kernel."""
    import torch

    from convnet_tpu_torch.ops import gather
    from convnet_tpu_torch.tools import gather_probe as gp

    t0 = time.perf_counter()
    errs = dict.fromkeys(gp.KERNELS, 0.0)
    for label, geometry, mode, unaligned in GATHER_RUNS:
        for p in gp.PROBES:
            case = p.build(getattr(gp, geometry), gp.Draw(dev, 12, mode, unaligned))
            if unaligned and case.args[-1].data_ptr() % 16 == 0:
                raise AssertionError(f"phase 12a: {p.name}'s input is on a 16-byte boundary")
            got, want = gp.run(p, case), gp.run(p, case, "plain")
            errs[p.kernel] = max(errs[p.kernel], gp.max_abs_err(got, want))
            if not gp.same_bits(got, want):
                raise AssertionError(f"phase 12a: {p.name} ({p.kernel}) {label} is not bit for "
                                     f"bit its plain version (max |diff| "
                                     f"{gp.max_abs_err(got, want)})")
    # the geometries that reach every branch of the three kernels, from
    # aligned inputs and inputs off a 16-byte boundary
    for e in gp.EDGES:
        for unaligned in (False, True):
            case = e.build(gp.Draw(dev, 12, unaligned=unaligned))
            got, want = gp.run_edge(e, case), gp.run_edge(e, case, "plain")
            errs[e.kernel] = max(errs[e.kernel], gp.max_abs_err(got, want))
            if not gp.same_bits(got, want):
                raise AssertionError(f"phase 12a: {e.kernel} {e.name} (unaligned {unaligned}) is "
                                     f"not bit for bit its plain version (max |diff| "
                                     f"{gp.max_abs_err(got, want)})")
    # at the bench's batch: crop_window's many rows a warp, crop_deinterleave's
    # many items a CTA
    for name in ("P1-fix", "P13b", "P24", "P31"):
        p = next(p for p in gp.PROBES if p.name == name)
        case = p.build(gp.PROBE._replace(b=gp.BATCH), gp.Draw(dev, 12))
        got, want = gp.run(p, case), gp.run(p, case, "plain")
        if not gp.same_bits(got, want):
            raise AssertionError(f"phase 12a: {name} at batch {gp.BATCH} is not bit for bit its "
                                 f"plain version (max |diff| {gp.max_abs_err(got, want)})")
        del case, got, want
        torch.cuda.empty_cache()
    off = torch.tensor([0, 33, -1, 10], dtype=torch.int32, device=dev)
    zero = torch.zeros(4, dtype=torch.int32, device=dev)
    for dtype in (torch.uint8, torch.bfloat16):
        x = torch.randint(1, 200, (4, 256, 768), device=dev).to(dtype)
        for kw in (dict(row_off=off), dict(col_off=off, col_mult=3)):
            rows, cols = (224, 768) if "row_off" in kw else (256, 672)
            got = gather.crop_window(x, rows, cols, **kw)
            want = gather.crop_window_reference(x, rows, cols, **kw)
            if not (gp.same_bits(got, want) and not got[1:3].any() and got[0].all()
                    and got[3].all()):
                raise AssertionError(f"phase 12a: crop_window {dtype} {kw} does not write zeros "
                                     "where the window leaves its input, and only there")
    u8 = torch.randint(0, 256, (4, 256, 768), dtype=torch.uint8, device=dev)
    for oy, ox in ((off, zero), (zero, off)):
        got = gather.crop_deinterleave(u8, oy, ox, zero)
        want = gather.crop_deinterleave_reference(u8, oy, ox, zero)
        nan = torch.isnan(got.float()).flatten(1).all(1).tolist()
        if not gp.same_bits(got, want) or nan != [False, True, True, False]:
            raise AssertionError("phase 12a: crop_deinterleave does not write NaN where the "
                                 f"crop leaves its input, and only there ({nan})")
    before = gather.RELAYOUT_LAUNCHES
    try:
        gather.relayout(u8[0], [gather.Dim(256, 768), gather.Dim(768, -1)])
    except ValueError as e:
        if "reads elements" not in str(e):
            raise
    else:
        raise AssertionError("phase 12a: relayout took a map that reads outside its input")
    if gather.RELAYOUT_LAUNCHES != before:
        raise AssertionError("phase 12a: relayout launched on a map it refused")
    torch.cuda.synchronize()
    print(f"[{card}] phase 12a: the {len(gp.PROBES)} gather sub-probes bit for bit equal to "
          f"their plain versions {', '.join(r[0] for r in GATHER_RUNS)}, the {len(gp.EDGES)} "
          f"edge geometries aligned and not, P1-fix, P13b, P24 and P31 at batch {gp.BATCH} "
          f"(max |diff| "
          f"by kernel {errs}); windows outside their input zeros (crop_window) and NaN "
          f"(crop_deinterleave), a map outside its input refused; "
          f"{time.perf_counter() - t0:.1f} s")
    return errs


def check_gather_probes(root: Path, dev, card):
    """Phase 12 (a-c). Returns (facts, {path: launches}, the three kernels'
    entries of the kernels line but their launches by path)."""
    import re

    import torch

    from convnet_tpu_torch.tools import gather_probe as gp

    t0 = time.perf_counter()
    errs = check_gather_kernels(dev, card)
    torch.cuda.empty_cache()  # the probe's subprocess shares the card
    lines = run_probe(root, card, "gather_probe", "--calls", str(PROBE_CALLS), "--trace",
                      phase=12)
    probes = [l for l in lines if l["metric"] == "gather_probe"]
    (versus,) = [l for l in lines if l["metric"] == "crop_deinterleave_vs_jitter_s2d"]
    per_image = sum(p.per_image for p in gp.PROBES)
    if len(probes) != len(gp.PROBES) + per_image:
        raise AssertionError(f"phase 12b: {len(probes)} gather_probe lines")
    for l in probes:  # each line's own kernel, at least once a timed call, and no other
        c = l["launches"]
        if (set(c) != set(read_launches()) or c[l["kernel"]] < PROBE_CALLS
                or any(v for k, v in c.items() if k != l["kernel"]) or l["max_abs_err"] != 0):
            raise AssertionError(f"phase 12b: {l['probe']} launched {c}, max |diff| "
                                 f"{l['max_abs_err']}")
    # the traced single blocks: one device activity a call, the kernel that
    # ops.KERNEL_NAMES names for the line's wrapper
    from convnet_tpu_torch.ops import KERNEL_NAMES

    traced = {}
    for l in probes:
        if l["batch"] is None:
            acts = l["trace"]["kernel"]
            if (sum(a["per_call"] for a in acts.values()) != 1
                    or not all(re.search(KERNEL_NAMES[l["kernel"]], n) for n in acts)):
                raise AssertionError(f"phase 12b: {l['probe']}'s trace holds {acts}")
            traced[l["probe"]] = {"kernel_us": sum(a["mean_us"] for a in acts.values()),
                                  "library_us": l["trace"]["library"] and sum(
                                      a["mean_us"] for a in l["trace"]["library"].values()),
                                  "tries": l["trace"]["tries"]}
    c = versus["launches"]
    if (c["crop_deinterleave"] < PROBE_CALLS or c["s2d_prologue"] < PROBE_CALLS
            or any(v for k, v in c.items() if k not in ("crop_deinterleave", "s2d_prologue"))):
        raise AssertionError(f"phase 12b: the jitter_s2d line launched {c}")
    paths = {"gather_probe": {k: sum(l["launches"][k] for l in lines) for k in c}}
    entries = []
    for name, (probe, at) in GATHER_MAIN.items():
        (main,) = [l for l in probes if l["probe"] == probe and (l["batch"] is None) == (at is None)]
        p = next(p for p in gp.PROBES if p.name == probe)
        case = p.build(gp.PROBE._replace(b=main["batch"] or gp.PROBE.b), gp.Draw(dev, 0))
        host = host_us(lambda: gp.run(p, case))
        del case
        torch.cuda.empty_cache()
        entries.append({
            "name": name, "route": "cuda", "source": f"convnet_tpu_torch/csrc/{name}.cu",
            "replaces": gp.SITES[name][0], "also_replaces": gp.SITES[name][1:],
            "launches": paths["gather_probe"][name], "max_abs_err": errs[name],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library")},
            "host_us": host, "timed_at": f"{probe} {main['out_shape']}",
            "sub_probes": {f"{l['probe']}" + (f" batch {l['batch']}" if l["batch"] else ""):
                           {k: l[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                           for l in probes if l["kernel"] == name},
        })
    seconds = time.perf_counter() - t0
    print(f"[{card}] phase 12: crop_deinterleave {versus['crop_deinterleave_ms']:.4f} ms against "
          f"jitter_s2d's train form {versus['jitter_s2d_train_ms']:.4f} ms at batch "
          f"{versus['batch']}; {seconds:.1f} s")
    facts = {"max_abs_err": errs, "versus_jitter_s2d": versus, "traced_us": traced,
             "seconds": seconds}
    return facts, paths, entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", type=Path,
                    help="trace five forwards and five train steps of each train path into "
                         "this directory (also with --time-only, after its timings)")
    ap.add_argument("--time-only", action="store_true",
                    help="skip phases 2-5 and the plain versions: time the kernels, the "
                         "forward and the train steps, and print them as one JSON line")
    ap.add_argument("--kernels", metavar="TEXT",
                    help="with --time-only: time just the kernels whose name holds TEXT "
                         "(e.g. pool_lrn), and no forward or train step")
    ap.add_argument("--ulp-study", type=int, metavar="SEEDS", default=0,
                    help="skip phases 2-6: measure over SEEDS seeds how far the backward "
                         "kernels' bf16 results and their plain versions' fall from float64")
    ap.add_argument("--root", type=Path, default=REPO,
                    help="import convnet_tpu_torch from this checkout (with --time-only, to "
                         "time another commit's kernels in the same call; it must have "
                         "convnet_tpu_torch/utils/card.py with device_ms and enqueue_ms)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    root = args.root.resolve()
    if not (root / "convnet_tpu_torch").is_dir() or not ALEXNET.is_file():
        print("chip_smoke: run it from the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from convnet_tpu_torch.config import read_model
    from convnet_tpu_torch.graph import build_graph
    from convnet_tpu_torch.data.jitter import JitterSpec
    from convnet_tpu_torch.model import init_params
    from convnet_tpu_torch.ops import _build
    from convnet_tpu_torch.predictor import Predictor
    from convnet_tpu_torch.trainer import make_forward
    from convnet_tpu_torch.utils.card import card_line, cuda_ms

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

    if args.time_only:
        return time_only(dev, card, root, args.kernels, args.profile_dir)
    if args.ulp_study:
        return ulp_study(dev, card, args.ulp_study)

    # -- 2. kernels vs plain versions at the slice's shapes -----------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s2d_err = check_prologue(dev, gen, card)
    lrn_err = check_lrn(dev, gen, card)
    lrn_bwd_err = check_lrn_bwd(dev, gen, card)
    drop_err = check_dropout(dev, gen, card)
    draws_err = check_step_draws(dev, card)
    pool_err = check_maxpool(dev, gen, card)
    plrn_err, plrn_bwd_err = check_pool_lrn(dev, gen, card)
    check_conv_grad(dev, gen, card)

    # -- 3. serving ----------------------------------------------------------
    graph = build_graph(read_model(str(ALEXNET)))
    params = init_params(graph, seed=0, device=dev)
    spec = JitterSpec(image_size=CROP, scale=1 / 255)
    mean = np.full((3,), MEAN, np.float32)
    jitter = {"input": (spec, mean, None)}
    pred = Predictor(graph, params, batch_size=BATCH, jitter=jitter, raw_size=RAW,
                     input_dtype=np.uint8, device=dev)
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (n, RAW, RAW, 3), dtype=np.uint8) for n in REQUESTS]

    reset_launches()
    outs = [pred({"input": r}) for r in requests]
    serve_launches = read_launches()
    print(f"[{card}] launches during {len(REQUESTS)} requests: {serve_launches}")
    expect_launches("the requests", serve_launches, {"lrn_fwd": 2, "s2d_prologue": 1},
                    len(REQUESTS))

    mean_t = torch.as_tensor(mean, device=dev)
    for req, out in zip(requests, outs):
        expect_served(f"request of {len(req)}", graph, params, req, out, spec, mean_t, card)

    # -- 4. training -----------------------------------------------------------
    from convnet_tpu_torch.data.datahandler import DataHandler
    from convnet_tpu_torch.trainer import Trainer, device_batch, make_train_step

    train_data = DataHandler(dummy_imagenet(BATCH, DUMMY_ROWS, True))
    val_data = DataHandler(dummy_imagenet(BATCH, DUMMY_ROWS, False))
    train_spec = train_data.jitter_specs()["input"][0]
    train_jitter = {"input": (train_spec, mean, None)}  # no HDF5 mean file on the card
    trainer = Trainer(graph, train_data, val_data, device=dev, jitter=train_jitter)
    p_init = clone_state(trainer.state)["params"]
    reset_launches()
    t0 = time.perf_counter()
    trainer.train(max_iter=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    print(f"[{card}] launches during {TRAIN_STEPS} train steps ({train_s:.3f} s): {train_launches}")
    expect_launches("the train steps", train_launches, TRAIN_PER_STEP, TRAIN_STEPS)
    moved = 0
    for name, p in trainer.state["params"].items():
        for k, v in p.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{name}/{k} is not finite after training")
            moved += int(not torch.equal(v, p_init[name][k]))
    print(f"[{card}] after {TRAIN_STEPS} steps {moved}/{2 * len(p_init)} parameter tensors moved")
    if moved != 2 * len(p_init):
        raise AssertionError("some parameters did not move")
    del p_init
    verr, vloss = trainer.validate()
    print(f"[{card}] validation over {val_data.num_batches} batches: loss {vloss}, error {verr}")
    if not (np.isfinite(vloss) and 0.0 <= verr <= 1.0):
        raise AssertionError(f"validation loss {vloss}, error {verr}")
    batches = [trainer.device_batch(train_data.get_batch()) for _ in range(PARITY_STEPS)]
    check_train_parity(graph, trainer.state, train_jitter, batches, train_spec, mean_t, card)

    # -- 5. training with the reference's pool gradient ------------------------
    with pool_switches():
        reset_launches()
        t0 = time.perf_counter()
        trainer.train(max_iter=trainer.state["step"] + TRAIN_STEPS)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref_launches = read_launches()
        print(f"[{card}] launches during {TRAIN_STEPS} train steps with {POOL_SWITCHES} "
              f"({ref_s:.3f} s): {ref_launches}")
        expect_launches("the reference-gradient train steps", ref_launches,
                        {"pool_lrn_fwd": 2, "pool_lrn_bwd": 2, "maxpool_fwd": 1, "dropout": 4,
                         "s2d_prologue": 1, "step_draws": 1}, TRAIN_STEPS)
        for name, p in trainer.state["params"].items():
            for k, v in p.items():
                if not torch.isfinite(v).all():
                    raise AssertionError(f"{name}/{k} is not finite after the reference-gradient steps")
        ref_batches = [trainer.device_batch(train_data.get_batch()) for _ in range(PARITY_STEPS)]
        check_train_parity(graph, trainer.state, train_jitter, ref_batches, train_spec, mean_t,
                           card, fused=True)

    # -- 5b. checkpoints (host I/O: no kernel of its own) ----------------------
    checkpoint_facts = check_checkpoints(dev, graph, trainer.state, card)

    # -- 6. timing -----------------------------------------------------------
    torch.cuda.synchronize()
    times, library, work, host_cost, _ = time_kernels(dev, gen, card, mean_t)

    fwd = make_forward(graph, pred.layers, jitter)
    staged = {"input": torch.from_numpy(requests[0]).to(dev)}
    step = make_train_step(graph, train_jitter)
    step_state = clone_state(trainer.state)
    step_batch = batches[0]
    alexnet_times = time_paths(fwd, pred.params, staged, step, step_state, step_batch, card)
    with torch.inference_mode():
        plain_fwd_ms = cuda_ms(lambda: plain_alexnet(graph, params, staged["input"], spec, mean_t))
    req_ms = request_ms(pred, requests[0])
    print(f"[{card}] plain-composed forward, batch {BATCH}: events {plain_fwd_ms:.4f} ms")
    print(f"[{card}] Predictor, batch {BATCH}: {req_ms:.4f} ms per request, "
          f"{BATCH / req_ms * 1e3:.1f} img/s (host clock, uint8 in, numpy out)")
    t0 = time.perf_counter()
    trainer.train(max_iter=trainer.state["step"] + TRAINER_STEPS)
    torch.cuda.synchronize()
    trainer_ips = TRAINER_STEPS * BATCH / (time.perf_counter() - t0)
    train_data.close()
    val_data.close()
    print(f"[{card}] Trainer, batch {BATCH}, {TRAINER_STEPS} steps over DUMMY data: "
          f"{trainer_ips:.1f} img/s (host clock, data staging included)")

    if args.profile_dir is not None:
        profile_paths(fwd, pred.params, staged, step, step_state, step_batch, card,
                      args.profile_dir)

    # -- 7. the model zoo and the CLIs ------------------------------------------
    local_launches = check_zoo_and_clis(dev, gen, card, alexnet_times, args.profile_dir)

    # -- 8. stored data, several steps per launch, remat -------------------------
    import tempfile

    state0 = clone_state(trainer.state)
    del trainer
    torch.cuda.empty_cache()
    data8 = DataHandler(dummy_imagenet(BATCH, DUMMY_ROWS, True))
    batches8 = [device_batch(data8.get_batch(), dev) for _ in range(LAUNCH_STEPS)]
    data8.close()
    with tempfile.TemporaryDirectory() as tmp8:
        tmp8 = Path(tmp8)
        cache_ms = write_learnable_set(tmp8, card)
        learned = check_learning(tmp8, card)
        check_image_streams(dev, card)
        launch = check_steps_per_launch(dev, graph, state0, train_jitter, batches8, card)
        launch["step_ms"] = launch_times(graph, state0, train_jitter, batches8, card)
        launch["trainer_img_s"], rate_launches = trainer_rates(dev, graph, train_jitter, tmp8,
                                                               card)
        hdf5_facts, hdf5_launches = check_hdf5_path(dev, tmp8, card)
        normalize, normalize_launches = check_normalize(dev, tmp8, card)
    remat = check_remat(dev, state0, train_jitter, batches8[0], card)
    print(json.dumps({"phase8": {"read_ms": cache_ms, "learning": learned,
                                 "steps_per_launch": launch, "remat": remat,
                                 "hdf5": hdf5_facts, "normalize": normalize,
                                 "checkpoint_5b": checkpoint_facts}},
                     default=str))

    # -- 9. the mesh path: ranks sharing the card, and a 1x1 mesh over nccl -----
    mesh_ranks = check_mesh_ranks(dev, card)
    nccl = check_nccl_mesh(dev, graph, state0, train_jitter, batches8, card)
    print(f"[{card}] phase 9b beside phase 8c: the AlexNet train step (device ms, host ms) at "
          f"1 and {LAUNCH_K} a launch, one device {launch['step_ms']['train']}, 1x1 mesh over "
          f"nccl {nccl['step_ms']['train']}: the gradient all-reduce's own cost on one card, "
          "no scaling figure")
    cli_ranks = check_cli_ranks(card)
    print(json.dumps({"phase9": {"mesh_ranks": mesh_ranks, "nccl_1x1": nccl,
                                 "train_cli_2_ranks": cli_ranks}}, default=str))

    # -- 10. the port's measurement scripts ----------------------------------------
    del state0, batches8
    measured, measure_paths, bench_errs = check_measurement_scripts(root, dev, card)
    print(json.dumps({"phase10": measured}, default=str))

    # -- 11. the chip probes: the streaming copy and the serving numbers ---------
    probes, probe_paths, copy_add = check_probes(root, dev, card)
    print(json.dumps({"phase11": probes}, default=str))

    # -- 12. the gather probes: crop_window, relayout, crop_deinterleave --------
    gathers, gather_paths, gather_kernels = check_gather_probes(root, dev, card)
    print(json.dumps({"phase12": gathers}, default=str))

    paths = {"serving": serve_launches, "train": train_launches,
             "reference_gradient": ref_launches, "alexnet_local": local_launches,
             # phase 8a: through the wrappers (the warm-up and capture steps;
             # the wrappers do not run when the graph replays), and on the
             # card in the traced window of replays (torch.profiler)
             "raw_cache_k4_wrappers": learned["wrapper_counts"],
             "raw_cache_k4_traced_replays": learned["traced"],
             # phase 8c's Trainer at k = 1 over the raw cache and over HDF5
             # (a per-channel mean file); phase 8e's CLI runs over HDF5 with a
             # full-pixel mean file (the prologue takes the plain path) and
             # its extract; phase 8f's eager steps over the per-channel mean
             # and std at eps x NORM_LEARN
             **rate_launches, **hdf5_launches, "hdf5_normalize_eager": normalize_launches,
             # phase 10: the pipeline bench's paths and the bench's step
             **measure_paths,
             # phase 11: the copy probe's tilings (counted in its process)
             # and a request of 1 and of 64 to the serving probe's Predictor
             **probe_paths,
             # phase 12: the gather probe's lines (counted in its process)
             **gather_paths}
    # phase 9a: each rank's launches over its MESH_STEPS steps (every rank's
    # the same, checked)
    for name, facts in mesh_ranks["meshes"].items():
        paths[f"alexnet_2tower_mesh_{name}_rank0"] = facts["bfloat16"]["launches_per_rank"][0]

    def kernel(name, source, replaces, also, err, parts, path):
        b_ms, b_by = bound(sum(work[t][0] for t in parts), sum(work[t][1] for t in parts))
        lib = [library[t] for t in parts if t in library]
        return {
            "name": name,
            "route": "cuda",
            "source": f"convnet_tpu_torch/csrc/{source}",
            "replaces": f"convnet_tpu/ops/{replaces}",
            "also_replaces": [f"convnet_tpu/ops/{r}" for r in also],
            # the count of the path that runs the kernel; every path's beside it
            "launches": paths[path][name],
            "launches_by_path": {p: v[name] for p, v in paths.items()},
            "max_abs_err": err,
            # a step launches the LRN kernels at both shapes: the sums of both
            "ms": sum(times[t][0] for t in parts),
            "plain_ms": sum(times[t][1] for t in parts),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": sum(lib) if lib else None,
            # host microseconds of the wrapper's calls (host_us), not device time
            "host_us": sum(host_cost[t] for t in parts),
        }

    kernels = [
        kernel("lrn_fwd", "lrn_fwd.cu", "lrn.py:212", ["lrn.py:535", "lrn.py:447"], lrn_err,
               ["lrn_fwd rnorm1", "lrn_fwd rnorm2"], "train"),
        kernel("lrn_bwd", "lrn_bwd.cu", "lrn.py:230", ["lrn.py:558", "lrn.py:455"], lrn_bwd_err,
               ["lrn_bwd rnorm1", "lrn_bwd rnorm2"], "train"),
        kernel("dropout", "dropout.cu", "dropout.py:58", [], drop_err, ["dropout"], "train"),
        # the seed that the TPU kernel takes as a prefetched scalar (and the
        # crops), derived on the card from the (seed, step) it holds
        kernel("step_draws", "dropout.cu", "dropout.py:58", [], draws_err, ["step_draws"],
               "train"),
        kernel("s2d_prologue", "s2d_prologue.cu", "s2d_relayout.py:200",
               ["prologue.py:93", "jitter_gather.py:96"], s2d_err, ["s2d_prologue"], "train"),
        kernel("maxpool_fwd", "maxpool_fwd.cu", "pool.py:87", [], pool_err, ["maxpool_fwd pool5"],
               "reference_gradient"),
        kernel("pool_lrn_fwd", "pool_lrn.cu", "fused_pool_lrn.py:388", [], plrn_err,
               ["pool_lrn_fwd rnorm1", "pool_lrn_fwd rnorm2"], "reference_gradient"),
        kernel("pool_lrn_bwd", "pool_lrn.cu", "fused_pool_lrn.py:134", [], plrn_bwd_err,
               ["pool_lrn_bwd rnorm1", "pool_lrn_bwd rnorm2"], "reference_gradient"),
    ]
    # the card's streaming probe, on no model's path: its main path is the
    # copy probe's sweep of tilings (phase 11)
    kernels.append({
        "name": "copy_add",
        "route": "cuda",
        "source": "convnet_tpu_torch/csrc/copy_add.cu",
        "replaces": "tools/r3_chip2.py:56",
        "also_replaces": ["tools/r3_chip4.py:192", "tools/r3_warm4.py:104"],
        "launches": paths["copy_probe"]["copy_add"],
        "launches_by_path": {p: v["copy_add"] for p, v in paths.items()},
        **{k: copy_add[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "host_us", "tile")},
    })
    # the gather probes' kernels, on no model's path: their main path is the
    # gather probe's lines (phase 12)
    for entry in gather_kernels:
        entry["launches_by_path"] = {p: v[entry["name"]] for p, v in paths.items()}
        kernels.append(entry)
    print(card)
    # phase 9a: the largest differences of each mesh's steps from one
    # device's (momentum share, param error over tolerance), beside the
    # kernels that the mesh path runs
    mesh_diffs = {name: {dt: (f[dt]["momentum_err"], f[dt]["param_err_over_tol"])
                         for dt in MESH_DTYPES}
                  for name, f in mesh_ranks["meshes"].items()}
    for k in kernels:
        if paths["alexnet_2tower_mesh_2x2_rank0"][k["name"]]:
            k["mesh_step_max_differences"] = mesh_diffs
        if k["name"] in bench_errs:  # phase 10b, at the bench's batch
            k["max_abs_err_bench_batch"] = bench_errs[k["name"]]
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
