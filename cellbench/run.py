"""Run one cell of the port's benchmark once and print its result line.

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, cellbench/ and
the port (convnet_tpu_torch/). It builds the cell's inputs from --seed,
warms every shape the cell uses (set-up, `setup_s`), measures for
--seconds, checks what the timed path produced against the plain
reference (cellbench/reference/), and prints, last on standard output,
one JSON line: {"correct", "attempted", "failed", "metrics", "device",
["breakdown"], "checks"}. `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics, read from a short profiled
stretch inside the window and from timings after it. Each number
compared, with its limit, is also printed last on standard error.

It exits with another code than 0, and prints no result, where there is
no CUDA card or fewer than the cell asks for, and where the process holds
JAX or the JAX package once the window has closed. The port's kernels and
any extension or Triton cache are built under build/ in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_ROOT / "build" / "cellbench" / _sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from cellbench import harness

    cell = harness.Cell(_ROOT, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cell {a.workload} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = harness.run(_ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                       torch.device("cuda", 0), T_START)
    found = harness.banned_modules()
    if found:
        print(f"the process holds modules it must not: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
