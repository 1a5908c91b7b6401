"""Crediting the card's time to the port's spans (`cellbench.spans`), on
hand-built Chrome-trace event lists, and the seven span metrics in a
traced run of the tiny cell on the CPU, where nothing runs on a device."""

import json

import pytest

from cellbench import harness, spans
from cellbench.tests.tiny import REPO

MAIN, ENGINE, STREAM = 1, 2, 7
METRICS = ("trainer.prologue_ms", "model.forward_ms", "model.backward_ms", "optim.update_ms",
           "model.pool_ms", "model.conv_ms", "model.lrn_ms")


def span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def op(name, ts, dur, tid=MAIN, seq=None):
    args = {} if seq is None else {"Sequence number": seq}
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def launch(ts, corr, tid=MAIN, cat="cuda_runtime"):
    name = "cudaLaunchKernel" if cat == "cuda_runtime" else "cuLaunchKernel"
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 2, "tid": tid,
            "args": {"correlation": corr}}


def kernel(ts, dur, corr, cat="kernel"):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "tid": STREAM,
            "args": args}


def step(t0):
    """One step from t0 (us): draws, prologue, a forward with a conv and a
    pool edge, a backward whose pool node runs on the engine's thread, and
    the update; their kernels run in turn from 2 ms on, 1 ms each: draws,
    prologue, conv, pool, pool backward, update."""
    c = t0  # correlation ids unique to the step
    return [
        span("trainer.step", t0, 900),
        span("trainer.draws", t0 + 10, 20), launch(t0 + 15, c + 1),
        span("trainer.prologue", t0 + 40, 20), launch(t0 + 45, c + 2),
        span("model.forward", t0 + 100, 300),
        span("model.edge.CONV.c1", t0 + 110, 50), op("aten::conv2d", t0 + 115, 10, seq=c + 10),
        launch(t0 + 120, c + 3, cat="cuda_driver"),
        span("model.edge.MAXPOOL.p1", t0 + 200, 50),
        op("aten::max_pool2d", t0 + 205, 10, seq=c + 11), launch(t0 + 210, c + 4),
        span("model.backward", t0 + 400, 300),
        op(spans.EVALUATE + ": MaxPool2DWithIndicesBackward0", t0 + 450, 50, ENGINE, c + 11),
        op("MaxPool2DWithIndicesBackward0", t0 + 451, 40, ENGINE, c + 11),
        launch(t0 + 460, c + 5, ENGINE),
        span("optim.update", t0 + 750, 100), launch(t0 + 760, c + 6),
        *[kernel(t0 + 1000 * (i + 1), 1000, c + i) for i in range(1, 7)],
    ]


def test_kernels_join_runtime_and_driver_launches():
    got = spans.credit(step(0), 1)
    assert got["stage"] == {"trainer.draws": 1.0, "trainer.prologue": 1.0, "model.forward": 2.0,
                            "model.backward": 1.0, "optim.update": 1.0}
    assert got["site"]["model.edge.CONV.c1"] == 1.0  # its launch was cuLaunchKernel
    assert got["busy_ms"] == 6.0 and got["uncredited_share"] == 0.0


def test_innermost_span_across_threads():
    """A launch on the engine's thread credits to the span the step's
    thread waits in; a span nested in an edge wins over the edge."""
    events = step(0) + [span("model.layer.inner", 130, 20), launch(140, 9),
                        kernel(8000, 500, 9)]
    got = spans.credit(events, 1)
    assert got["stage"]["model.backward"] == 1.0 and got["stage"]["model.forward"] == 2.5
    assert got["site"]["model.layer.inner"] == 0.5


def test_backward_node_credits_to_the_forward_edge():
    got = spans.credit(step(0), 1)
    assert got["site"]["model.edge.MAXPOOL.p1"] == 2.0
    assert got["kind"] == {"MAXPOOL": 2.0, "CONV": 1.0}
    assert "model.backward" not in got["site"] and got["unlinked_share"] == 0.0


def test_the_last_forward_operator_of_the_step_made_the_node():
    """An earlier operator with the node's number (it made no node) and one
    with the number in another step do not take the credit."""
    events = step(0) + step(10_000)
    events += [op("aten::add", 30, 1, seq=11), op("aten::conv2d", 10_115, 5, seq=11)]
    got = spans.credit(events, 2)
    assert got["kind"] == {"MAXPOOL": 2.0, "CONV": 1.0}


def test_uncredited_and_unlinked_remainders():
    events = step(0) + [
        kernel(8000, 500, None),  # no correlation
        kernel(8500, 500, 77),  # no launch
        launch(2000, 78), kernel(9000, 1000, 78),  # launched outside every span
        op(spans.EVALUATE + ": MulBackward0", 500, 20, ENGINE, 999),  # no forward op
        launch(505, 79, ENGINE), kernel(10_000, 2000, 79),
    ]
    got = spans.credit(events, 1)
    assert got["uncredited_share"] == pytest.approx(2.0 / 10.0)
    assert got["unlinked_share"] == pytest.approx(2.0 / 10.0)
    assert got["stage"]["model.backward"] == 3.0 and got["busy_ms"] == 10.0


@pytest.mark.parametrize("cut", ["a step", "the card"])
def test_a_stretch_short_of_steps_or_device_reads_none(cut):
    events = step(0) + step(10_000)
    if cut == "a step":
        events = [ev for ev in events if not (ev["name"] == "trainer.step" and ev["ts"] > 0)]
    else:
        events = [ev for ev in events if ev["cat"] != "kernel"]
    assert spans.credit(events, 2) is None


def test_copies_and_sets_are_credited():
    events = step(0) + [launch(770, 80), kernel(8000, 1000, 80, cat="gpu_memcpy"),
                        launch(780, 81), kernel(9000, 500, 81, cat="gpu_memset")]
    got = spans.credit(events, 1)
    assert got["stage"]["optim.update"] == 2.5


def test_span_metrics_follow_the_train_cells(root, run_cell):
    for at, name in ((REPO, "alexnet.train.b1024"), (REPO, "alexnet_local.train.b1024"),
                     (root, "tiny.train")):
        per_layer = {m["name"]: m for m in harness.Cell(at, name).per_layer}
        for metric in METRICS:
            assert per_layer[metric]["source"] == "program_span"
            assert per_layer[metric]["unit"] == "ms"
    line = run_cell("tiny.train", 2**31 + 11, trace=True)
    json.dumps(line)
    assert line["correct"] is True and not set(METRICS) & set(line["metrics"])


def test_span_readers_read_none_on_the_cpu(root):
    """The tiny cell's profiled stretch on the CPU: its steps are there, no
    device operation, so each reader gives None."""
    import time

    import torch

    from cellbench.kinds import train

    ctx = harness.Context(harness.Cell(root, "tiny.train"), torch.device("cpu"))
    got = {}

    def read_layers():
        got.update({m: ctx.cell.reader(m)(ctx) for m in METRICS})
        got["steps"] = spans.count_steps(
            spans.measure._events(ctx.program["step"], 2, ctx.device, host=True))
        return {}

    ctx.read_layers = read_layers
    train.run(ctx, 3, 0.1, True, time.perf_counter())
    assert got == {**{m: None for m in METRICS}, "steps": 2}
