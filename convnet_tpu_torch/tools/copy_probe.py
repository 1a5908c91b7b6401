"""The card's streaming rate: a two-in, one-out bf16 add over whole-row
tiles and over 128-column tiles (counterpart of the copy sweep of
`tools/r3_chip2.py:50-81` and `tools/r3_chip4.py:186-229`). Prints one
JSON line per tiling:

    python -m convnet_tpu_torch.tools.copy_probe [--device cuda|cpu]
        [--seed N] [--calls 20] [--rows 290400]

The kernel is `ops/copy_add.py`'s `copy_add(a, b, tile_rows, tile_cols)`:
o = a + b on row-major (m, n) bf16, `csrc/copy_add.cu` on the card (the
TPU kernel `tools/r3_chip2.py:56 copy_kernel`), one CTA of 256 threads a
tile_rows x tile_cols tile, array-equal to `a + b`.

The JAX sweep's six BlockSpec blocks, (rows, lanes) of the (290400, 1024)
pair (rnorm1 at batch 1024 in the r2d view), map to CTA tiles (rows //
ROW_SCALE, lanes): the same columns, and rows scaled so that the smallest
block, 2640 x 128, is one 16-byte word a thread of a 256-thread CTA (2640
* 128 / 8 / 256 = 165). Each tiling keeps the JAX blocks' ratios: whole
1024-column rows in 16 and 32-row tiles; 128-column blocks (256-byte
pieces of rows 2 KB apart) in 16, 32, 64 and 128-row tiles.

Each tiling on the card: `utils/card.py device_ms`, --calls calls queued
behind a spin kernel that outlasts their launches, one pair of CUDA events
around them, the median of 3 such runs over --calls: the card's time with
the host's launch cost hidden (on the CPU: the host clock, a synchronize
after each call, median of --calls after 3). GB/s = 3 * m * n * 2 bytes
over that; `torch_add_ms` is torch.add(a, b) timed the same way, the one
PyTorch call that computes the same function. Inputs are normal draws
from a torch.Generator seeded by --seed, rounded to bf16. The run's
device is the card unless --device cpu is given; with no card it exits
before measuring anything. A line holds the device's name and power limit
("device": "cpu" off a card) and "launches": every kernel's launches
(`ops.launch_counts()`) while that tiling and torch.add were timed, by
name.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import torch

from convnet_tpu_torch import ops
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.ops.copy_add import copy_add
from convnet_tpu_torch.utils import card

#: The JAX sweep's (rows, lanes) BlockSpec blocks, in its order.
JAX_BLOCKS = ((2640, 1024), (5280, 1024), (2640, 128), (5280, 128), (10560, 128), (21120, 128))
#: JAX block rows over CTA tile rows (see the module's docstring).
ROW_SCALE = 165
#: The JAX sweep's arrays: rnorm1 at batch 1024 in the r2d view.
ROWS, COLS = 55 * 55 * 96, 1024
#: (JAX block, (tile_rows, tile_cols)) for each of JAX_BLOCKS.
TILINGS = [((r, c), (r // ROW_SCALE, c)) for r, c in JAX_BLOCKS]
WARMUP = 3


def _ms(fn, device: torch.device, calls: int) -> float:
    if device.type == "cuda":
        return card.device_ms(fn, k=calls)
    return card.host_ms(fn, device, iters=calls, warmup=WARMUP)


def probe(device: torch.device, rows: int = ROWS, calls: int = 20,
          seed: int = 0) -> List[Dict]:
    """One line for each tiling: the kernel's ms and GB/s and torch.add's
    ms on the same (rows, COLS) inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    a, b = (torch.randn((rows, COLS), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    nbytes = 3 * rows * COLS * a.element_size()
    facts = card.device_facts(device)
    lines = []
    for block, (tile_rows, tile_cols) in TILINGS:
        before = ops.launch_counts()
        ms = _ms(lambda: copy_add(a, b, tile_rows, tile_cols), device, calls)
        torch_add_ms = _ms(lambda: torch.add(a, b), device, calls)
        after = ops.launch_counts()
        lines.append({
            "metric": "copy_add_gb_per_s", "gb_per_s": nbytes / ms / 1e6, "ms": ms,
            "torch_add_ms": torch_add_ms,
            "tile_rows": tile_rows, "tile_cols": tile_cols, "jax_block": list(block),
            "rows": rows, "cols": COLS, "bytes": nbytes, "calls": calls,
            "launches": {k: after[k] - before[k] for k in after}, **facts,
        })
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calls", type=int, default=20,
                   help="calls a timed run (on the card: queued behind one spin)")
    p.add_argument("--rows", type=int, default=ROWS)
    add_device_argument(p)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    for line in probe(dev, a.rows, a.calls, a.seed):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
