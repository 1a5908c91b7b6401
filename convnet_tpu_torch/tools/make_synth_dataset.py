"""Generate a procedural image-classification dataset in the toolkit's
HDF5 layout (datasets "data" uint8 NHWC + "labels" int32), written by the
port's own HDF5 module (counterpart of `tools/make_synth_dataset.py`; the
same arrays for the same arguments).

Ten visually distinct classes: oriented bars (0-4) and centered
blobs/rings/checkers (5-9), with brightness/position noise — learnable
by a small convnet to >95% but not linearly separable.

Usage:
    python -m convnet_tpu_torch.tools.make_synth_dataset OUT.h5 --rows 4096 \
        [--size 32] [--seed 0]
"""

from __future__ import annotations

import argparse

import numpy as np

from convnet_tpu_torch import hdf5


def render_class(rng: np.random.RandomState, label: int, size: int) -> np.ndarray:
    img = rng.randint(0, 40, (size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = size / 2 + rng.randn() * size / 12
    cx = size / 2 + rng.randn() * size / 12
    bright = 120 + rng.rand() * 120
    if label < 5:  # oriented bar, angle = label * 36 deg
        theta = label * np.pi / 5 + rng.randn() * 0.08
        d = np.abs((xx - cx) * np.sin(theta) - (yy - cy) * np.cos(theta))
        mask = (d < size / 10).astype(np.float32)
    elif label == 5:  # filled blob
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        mask = (r2 < (size / 5) ** 2).astype(np.float32)
    elif label == 6:  # ring
        r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        mask = ((r > size / 6) & (r < size / 4)).astype(np.float32)
    elif label == 7:  # checkerboard
        p = max(2, size // 8)
        mask = (((xx // p) + (yy // p)) % 2).astype(np.float32)
    elif label == 8:  # corner square
        q = size // 3
        mask = ((xx < q) & (yy < q)).astype(np.float32)
    else:  # cross
        w = size / 12
        mask = ((np.abs(xx - cx) < w) | (np.abs(yy - cy) < w)).astype(np.float32)
    color = rng.rand(3) * 0.5 + 0.5
    img += mask[:, :, None] * bright * color[None, None, :]
    return np.clip(img, 0, 255).astype(np.uint8)


def generate(rows: int, size: int, seed: int):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, rows).astype(np.int32)
    data = np.stack([render_class(rng, int(l), size) for l in labels])
    return data, labels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output")
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    data, labels = generate(args.rows, args.size, args.seed)
    with hdf5.File(args.output, "w") as f:
        f.create_dataset("data", data=data)
        f.create_dataset("labels", data=labels)
    print(f"wrote {args.output}: {args.rows} rows, {args.size}px, 10 classes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
