"""The readings that the limits of `correct` are set from (the benchmark's
own runs do not run this):

    python3 -m cellbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds S] [--sample N] [--out FILE]

- sound: the cell run as the benchmark runs it (`harness.run`), a window of
  --seconds, one line of its compared numbers a seed (serve cells may
  compare one request in --sample); in a train cell, also a line each of
  the control and the "half" fault below put in the program's place for
  the three steps after the window, from the state that the window left
  ("after_" numbers);
- control: the reference that the configuration names put in the
  program's place, computed in the precision below the configuration's
  (bf16 -> fp8: the reference's precision "fp8"),
  against the float32 reference, a line a control seed;
- faults, in the reference put in the program's place, a line a control
  seed: train: half of the batch left out ("half"); serve: an answer
  altered where it is produced (each image given its neighbour's
  probabilities, "altered") and half of the batch left out (the second
  half answered with the first half's, "half"). A train state left
  unchanged reads 1 by the change's measure and needs no run;
- bf16 (train): the reference in the model's own precision in the
  program's place, a witness of what rounding alone reads.

Each line is JSON, printed and appended to --out.

    python3 -m cellbench.calibrate --workload <cell> --limits FILE...

sets the cell's limits (`cellbench/limits/<cell>.json`) from such lines
(`set_limits`) and writes beside them the readings that each was set from
(`cellbench/limits/<cell>.readings.json`); it needs no card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cellbench import check, harness
from cellbench.weights import make_batches, make_requests, make_weights


def controls(cell: harness.Cell, seed: int, device) -> dict:
    """The control's and the faults' numbers on one seed, at the cell's size."""
    net, cfg, tr = cell.net, cell.config, cell.traffic
    channels = net.shapes[net.input.name][2]
    args = (cfg["crop"], cfg["scale"], cfg["mean"])
    out = {}
    if tr["kind"] == "train":
        pool = make_batches(seed, 3, tr["batch"], tr["raw"], channels, net.output.channels,
                            device)
        batches = [(b["input"], b["labels"]) for b in pool]

        shapes = {f"{e}/{k}": s for e, p in net.param_shapes().items() for k, s in p.items()}
        coords = check.coordinates(shapes, seed, device)

        def steps(**kw):
            return cell.reference.train_steps(net, make_weights(net, seed, device, tr["init"]),
                                              batches, seed, *args, coords=coords, **kw)

        ref = steps()
        out["control"] = check.train_gaps(steps(precision="fp8"), ref)
        out["bf16"] = check.train_gaps(steps(precision="bf16"), ref)
        out["half"] = check.train_gaps(steps(rows=tr["batch"] // 2), ref)
        return out
    params = make_weights(net, seed, device, tr["init"])
    gaps = {(run, n): 0.0 for run in ("control", "altered", "half")
            for n in ("logit_gap", "prob_gap")}
    with cell.reference.exact_f32(), torch.no_grad():
        for req in make_requests(seed, tr["pool"], tr["batch"], tr["raw"], channels):
            x = net.prologue(torch.from_numpy(req).to(device), *args)
            p32 = net.probabilities(params, x).double().cpu().numpy()
            p8 = net.probabilities(params, x, precision="fp8").double().cpu().numpy()
            half = p32.copy()
            half[len(half) // 2:] = p32[:len(half) - len(half) // 2]
            ref = {0: p32}
            for run, p in (("control", p8), ("altered", np.roll(p32, 1, axis=0)),
                           ("half", half)):
                for n in ("logit_gap", "prob_gap"):
                    gaps[run, n] = max(gaps[run, n], getattr(check, n)([(0, p)], ref))
    out = {}
    for (run, n), v in gaps.items():
        out.setdefault(run, {})[n] = v
    return out


#: Where a limit sits between its lower and upper readings, on a log
#: scale from the lower: more room above the lower than below the upper.
PLACE = 0.6
#: Numbers that a train state left unchanged reads as 1 (a change of
#: nought, and a first momentum of nought), with no run.
UNCHANGED_READS_ONE = ("grad_gap", "change_gap", "grad_err", "change_err", "after_change_gap",
                       "after_change_err")


def set_limits(lines: Sequence[Dict]) -> Tuple[Dict[str, float], Dict[str, Dict]]:
    """(limits, readings) from calibration lines: each number's lower
    reading is the largest over the sound runs; its upper reading the
    least of the control's smallest, where that is 3x the lower or more,
    half a batch's smallest, where that is 10x or more, and 1 where a state
    left unchanged reads 1 and that is 3x or more; the limit lies PLACE of
    the way from the lower to the upper on a log scale, to two figures. A
    number with no upper reading is not compared (its readings say so)."""
    runs: Dict[str, Dict[str, List[float]]] = {}
    for line in lines:
        for k, v in line["checks"].items():
            runs.setdefault(k, {}).setdefault(line["run"], []).append(v)
    limits, readings = {}, {}
    for k, got in sorted(runs.items()):
        if k.endswith("leaves_left_out") or "sound" not in got:
            continue
        lower = max(got["sound"])
        upper = {}
        if got.get("control") and min(got["control"]) >= 3 * lower:
            upper["control"] = min(got["control"])
        if got.get("half") and min(got["half"]) >= 10 * lower:
            upper["half"] = min(got["half"])
        if k.split(":")[0] in UNCHANGED_READS_ONE and 1.0 >= 3 * lower:
            upper["unchanged"] = 1.0
        entry = {"sound": [min(got["sound"]), lower, len(got["sound"])]}
        entry.update({run: [min(v), max(v), len(v)] for run, v in got.items() if run != "sound"})
        if upper:
            source = min(upper, key=upper.get)
            limit = float(f"{lower * (upper[source] / lower) ** PLACE:.2g}")
            limits[k] = limit
            entry.update({"upper_from": source, "limit": limit})
        else:
            entry["limit"] = None
        readings[k] = entry
    return limits, readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Readings for the limits of `correct`.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--sample", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--limits", nargs="*", default=None)
    a = p.parse_args(argv)
    root = harness.ROOT
    if a.limits is not None:
        lines = [json.loads(t) for f in a.limits for t in Path(f).read_text().splitlines()
                 if t.strip()]
        limits, readings = set_limits([x for x in lines if x["workload"] == a.workload])
        base = root / "cellbench" / "limits" / a.workload
        Path(f"{base}.json").write_text(json.dumps(limits, indent=1) + "\n")
        Path(f"{base}.readings.json").write_text(json.dumps(readings, indent=1) + "\n")
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    dev = torch.device("cuda", 0)
    over = {"controls": True}
    if a.sample is not None:
        over["sample"] = a.sample

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(text + "\n")

    for s in filter(None, a.seeds.split(",")):
        t = time.perf_counter()
        got = {}
        line = harness.run(root, a.workload, int(s), a.seconds, False, dev, t, traffic=over,
                           readings=got)
        after = got.pop("controls", None) or {}
        emit({"workload": a.workload, "seed": int(s), "run": "sound", "checks": got,
              "metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "seconds": time.perf_counter() - t})
        for run, numbers in after.items():
            emit({"workload": a.workload, "seed": int(s), "run": run, "checks": numbers})
    cell = harness.Cell(root, a.workload)
    for s in filter(None, a.control_seeds.split(",")):
        t = time.perf_counter()
        for run, numbers in controls(cell, int(s), dev).items():
            emit({"workload": a.workload, "seed": int(s), "run": run, "checks": numbers})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
