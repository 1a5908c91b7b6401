"""The card's time in the train step, credited to the port's named spans
(`convnet_tpu_torch/utils/timers.py`).

The profiled stretch: the cell's step function (`ctx.program["step"]`)
runs `trace_steps` steps under torch.profiler with the host's operators
and the card's activity, no shapes and no stacks (`measure._events`),
once a run; every reader of a span metric reads that stretch. A stretch
that holds fewer `trainer.step` spans than steps or, on a card, no
device operation (the profiler has dropped events before) is taken
again, up to TAKES times, and else reads as None. On the CPU nothing
runs on a device, so the stretch credits nothing and reads as None.

Crediting (`credit`): each kernel, copy or set is joined to its launch,
a `cuda_runtime` or `cuda_driver` event (cuDNN uses both), by
`args.correlation`, and its own duration (so the profiler's cost to the
host stays out) goes to

- its stage: of the program spans (names under PREFIXES) that hold the
  launch's start, on any thread, the one directly under `trainer.step`,
  or `trainer.step` itself where none is under it. During the backward
  the launching thread is the autograd engine's, and the step's thread
  waits inside `model.backward`;
- its site: the innermost program span that holds the launch's start; or,
  for a launch under an `autograd::engine::evaluate_function` event, the
  innermost program span of the forward operator that made that node: the
  last operator of the same step, outside the backward, that carries the
  node's "Sequence number". A site `model.edge.<EDGE_TYPE>.<edge>` counts
  to its edge type.

An operation with no launch, or with no program span holding its launch,
is uncredited. A backward operation whose node leads to no forward
operator keeps its stage and counts as unlinked.
"""

from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Tuple

from cellbench import measure

PREFIXES = ("trainer.", "model.", "optim.", "parallel.")
STEP = "trainer.step"
EDGE = "model.edge."
EVALUATE = "autograd::engine::evaluate_function"
LAUNCHES = ("cuda_runtime", "cuda_driver")
#: stretches taken before a run's span metrics read as None
TAKES = 3


def credited(ctx) -> Optional[Dict]:
    """`credit` of the cell's profiled stretch, taken once a run (cached in
    ctx.program) and printed on standard error as one `spans {...}` line;
    None outside a train cell's traced run or where no stretch credits."""
    if ctx.kind != "train" or "step" not in ctx.program:
        return None
    if "spans" not in ctx.program:
        n, got = ctx.cell.traffic["trace_steps"], None
        for _ in range(TAKES if ctx.device.type == "cuda" else 1):
            got = credit(measure._events(ctx.program["step"], n, ctx.device, host=True), n)
            if got is not None:
                break
        ctx.program["spans"] = got
        if got is not None:
            print("spans " + json.dumps(got), file=sys.stderr, flush=True)
    return ctx.program["spans"]


def stage_ms(ctx, *stages: str) -> Optional[float]:
    """The card's ms a step of the step's own operations under these stages."""
    got = credited(ctx)
    return None if got is None else sum(got["stage"].get(s, 0.0) for s in stages)


def kind_ms(ctx, kind: str) -> Optional[float]:
    """The card's ms a step of the operations of this type's edges, forward
    and backward."""
    got = credited(ctx)
    return None if got is None else got["kind"].get(kind, 0.0)


def count_steps(events: List[Dict]) -> int:
    """The `trainer.step` spans of a trace."""
    return sum(1 for ev in events if ev.get("cat") == "user_annotation" and ev.get("name") == STEP)


def _device(events: List[Dict]) -> List[Dict]:
    return [ev for ev in events if ev.get("cat") in measure._DEVICE_CATS and "ts" in ev]


def _interval(ev: Dict) -> Tuple[float, float, str]:
    """(start us, end us, name) of a complete event."""
    t0 = float(ev["ts"])
    return t0, t0 + float(ev.get("dur", 0)), ev.get("name", "")


class _Index:
    """Intervals (start, end, payload) sorted by start, the outer first at
    equal starts."""

    def __init__(self, spans: List[tuple]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def holding(self, t: float) -> List[tuple]:
        """The intervals that hold t, outermost first."""
        return [s for s in self.spans[:bisect.bisect_right(self.starts, t)] if t <= s[1]]


def credit(events: List[Dict], steps: int) -> Optional[Dict]:
    """The card's ms a step of a stretch of `steps` train steps by stage,
    by edge type and by site (module docstring), with "busy_ms" (the union
    of the card's operations a step), "host_ms" (a `trainer.step` span's
    mean length), "spans_a_step", "uncredited_share" and "unlinked_share"
    (of the operations' summed time); None where the stretch holds fewer
    `trainer.step` spans than steps or no device operation."""
    device = _device(events)
    if count_steps(events) < steps or not device:
        return None
    program, evaluates, ops, launches = [], {}, [], {}
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        cat, name, args = ev.get("cat"), ev.get("name", ""), ev.get("args") or {}
        if cat == "user_annotation" and name.startswith(PREFIXES):
            program.append(_interval(ev))
        elif cat == "cpu_op" and name.startswith(EVALUATE):
            evaluates.setdefault(ev.get("tid"), []).append(
                (*_interval(ev), args.get("Sequence number")))
        elif cat == "cpu_op" and "Sequence number" in args:
            ops.append((float(ev["ts"]), ev.get("tid"), args["Sequence number"]))
        elif cat in LAUNCHES and "correlation" in args:
            launches.setdefault(args["correlation"], (float(ev["ts"]), ev.get("tid")))
    spans = _Index(program)
    step_spans = _Index([s for s in program if s[2] == STEP])
    backward = {tid: _Index([(t0, t1, seq) for t0, t1, _, seq in evs])
                for tid, evs in evaluates.items()}

    def node_at(tid, t):
        """The innermost backward node evaluated on thread tid at t, as
        (start, end, sequence number), or None."""
        held = backward[tid].holding(t) if tid in backward else []
        return held[-1] if held else None

    def step_of(t):
        held = step_spans.holding(t)
        return held[-1][0] if held else None

    # the forward operator that made each node: the last one of its step
    # with the node's sequence number, outside the backward
    made: Dict[tuple, float] = {}
    for t, tid, seq in sorted(ops):
        if node_at(tid, t) is None:
            made[(step_of(t), seq)] = t

    stage: Dict[str, float] = {}
    site: Dict[str, float] = {}
    total = uncredited = unlinked = 0.0
    for ev in device:
        dur = float(ev.get("dur", 0)) / 1e3
        total += dur
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        chain = spans.holding(launch[0]) if launch else []
        if not chain:
            uncredited += dur
            continue
        names = [s[2] for s in chain]
        i = names.index(STEP) + 1 if STEP in names else 0
        key = names[min(i, len(names) - 1)]
        stage[key] = stage.get(key, 0.0) + dur
        node = node_at(launch[1], launch[0])
        if node is None or node[2] is None:  # not in the backward, or AccumulateGrad
            where = names[-1]
        else:
            t = made.get((step_of(launch[0]), node[2]))
            held = spans.holding(t) if t is not None else []
            if not held:
                unlinked += dur
                continue
            where = held[-1][2]
        site[where] = site.get(where, 0.0) + dur
    kind: Dict[str, float] = {}
    for name, ms in site.items():
        if name.startswith(EDGE):
            k = name[len(EDGE):].split(".", 1)[0]
            kind[k] = kind.get(k, 0.0) + ms
    busy = measure.busy(events)["busy_s"] * 1e3

    def per_step(d):
        return {k: v / steps for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    host = [s[1] - s[0] for s in step_spans.spans]
    return {"steps": steps, "busy_ms": busy / steps,
            "host_ms": sum(host) / len(host) / 1e3, "spans_a_step": len(program) / len(host),
            "uncredited_share": uncredited / total if total else 0.0,
            "unlinked_share": unlinked / total if total else 0.0,
            "stage": per_step(stage), "kind": per_step(kind), "site": per_step(site)}
