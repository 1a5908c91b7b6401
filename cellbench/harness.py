"""The harness: finds a cell's pieces by name, runs it, and prints the
result line.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file found by its name under the benchmark's root (the directory
that holds BENCHMARK.json):

- `cellbench/configs/<config>.json`: the model file as it is run, and its
  cut from the source; its "reference", where it has one, names the plain
  reference that decides `correct`, `cellbench/reference/<reference>.py`
  (the shared `net` where it names none; what a reference provides:
  `cellbench/reference/__init__.py`);
- `cellbench/traffic/<traffic>.json`: the mix's parameters, whose "kind"
  names the module in `cellbench/kinds/` that runs them;
- `cellbench/metrics/<metric>.py`: a per-layer metric's reader, a
  function `read(ctx)` that returns the value or None where it finds
  nothing to read;
- `cellbench/limits/<cell>.json`: the limit of each number that decides
  `correct` (beside it `<cell>.readings.json`, the readings that each
  was set from: `python3 -m cellbench.calibrate`).

A cell in BENCHMARK.json pairs a configuration with a traffic mix, so a
later cell, mix, model or metric is added with files and entries alone.
An end-to-end metric is a quantity that the cell's kind measures itself,
by its name.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from cellbench import yardstick

#: Modules that no process of the benchmark may hold, by whole top-level name.
BANNED = ("jax", "jaxlib", "flax", "convnet_tpu")
ROOT = Path(__file__).resolve().parent.parent
#: The reference of a configuration that names none.
DEFAULT_REFERENCE = "net"


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def _load(path: Path, name: str):
    """The module of the file at `path`, held in sys.modules under `name`
    (where dataclasses look up the module of their class)."""
    if not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _module_name(kind: str, name: str) -> str:
    return f"cellbench_{kind}_" + name.replace(".", "_").replace("-", "_")


def banned_modules() -> List[str]:
    """The modules loaded in this process whose top-level name is banned."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


class Cell:
    """One entry of BENCHMARK.json's workloads, with its configuration,
    traffic, limits, metrics, the reference module that its configuration
    names (`reference`) and that module's network of the model (`net`)."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = _json(self.root / "BENCHMARK.json")
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if len(entry) != 1:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = entry[0]["chips"]
        data = self.root / "cellbench"
        config = entry[0]["config"]
        self.config = _json(data / "configs" / f"{config}.json")
        self.traffic = _json(data / "traffic" / f"{entry[0]['traffic']}.json")
        self.limits = _json(data / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        mine = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]
        ref = self.config.get("reference", DEFAULT_REFERENCE)
        self.reference = _load(data / "reference" / f"{ref}.py", _module_name("reference", ref))
        try:
            self.net = self.reference.Net("\n".join(self.config["model"]), self.config["crop"])
        except ValueError as err:
            raise ValueError(f"configuration {config}: reference {ref} refuses the model: "
                             f"{err}") from err

    def reader(self, metric: str) -> Callable:
        path = self.root / "cellbench" / "metrics" / f"{metric}.py"
        return _load(path, _module_name("metric", metric)).read


class Context:
    """What a cell's kind module fills in and a per-layer metric's reader
    reads: the cell, the device and its peaks, `window` (the measured
    window's figures), `trace` (the traced stretch's busy and idle time),
    and `program`, the port's objects that a reader times."""

    def __init__(self, cell: Cell, device: torch.device):
        self.cell = cell
        self.net = cell.net
        self.device = device
        self.kind = cell.traffic["kind"]
        self.card = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        self.peak_flops, self.peak_bytes = yardstick.peaks(self.card or "")
        self.window: Dict = {}
        self.trace: Optional[Dict] = None
        self.program: Dict = {}
        self._values: Dict[str, Optional[float]] = {}

    def port_graph(self):
        """The port's Graph of the configuration's model text at its crop,
        checked to hold the reference's parameter shapes (the weights
        that both are given)."""
        from convnet_tpu_torch import config
        from convnet_tpu_torch.graph import build_graph
        from convnet_tpu_torch.model import param_shapes

        cfg = self.cell.config
        graph = build_graph(config.parse_model("\n".join(cfg["model"])),
                            {self.net.input.name: cfg["crop"]})
        if param_shapes(graph) != self.net.param_shapes():
            raise ValueError("the port's parameter shapes differ from the reference's")
        return graph

    def value(self, metric: str) -> Optional[float]:
        """The metric's value, read once."""
        if metric not in self._values:
            self._values[metric] = self.cell.reader(metric)(self)
        return self._values[metric]

    def read_layers(self) -> Dict[str, Dict]:
        """Every per-layer metric of the cell that finds something to read."""
        out = {}
        for m in self.cell.per_layer:
            v = self.value(m["name"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def release(self) -> None:
        """Drop the port's objects and return their device memory."""
        self.program = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, traffic: Optional[Dict] = None,
        readings: Optional[Dict] = None) -> Dict:
    """Run one cell once on `device` and return its result line. For the
    calibration: traffic, parameters that take the place of the mix's;
    readings, a dict given every number the kind module read, those that the
    cell's limits do not name too."""
    cell = Cell(root, workload)
    cell.traffic.update(traffic or {})
    ctx = Context(cell, device)
    kind = importlib.import_module(f"cellbench.kinds.{ctx.kind}")
    out = kind.run(ctx, seed, seconds, trace, t_start)
    metrics = {}
    if trace:
        metrics = out["layers"]
    else:
        for m in cell.end_to_end:
            if m["name"] not in out["metrics"]:
                raise KeyError(f"cell {workload}: the {ctx.kind} kind gives no {m['name']}")
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    if readings is not None:
        readings.update(out["checks"])
        if out.get("controls"):
            readings["controls"] = out["controls"]
    missing = set(cell.limits) - set(out["checks"])
    if missing:
        raise KeyError(f"cell {workload}: the {ctx.kind} kind reads no {sorted(missing)}")
    checks = {k: {"value": out["checks"][k], "limit": lim} for k, lim in cell.limits.items()}
    correct = out["failed"] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                         for c in checks.values())
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": ctx.card, "count": 1,
               "memory_peak_bytes": out["memory_peak_bytes"]}
        if trace:
            dev["busy_s"] = ctx.trace["busy_s"] if ctx.trace else None
            dev["window_s"] = ctx.trace["window_s"] if ctx.trace else None
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        line["breakdown"] = {"device_ops": ctx.trace["device_ops"], "idle_gaps": out["gaps"]}
    line["checks"] = checks
    return line
